"""Multilevel synchronization: mac_sync + sync projection.

JAX equivalent of the reference's post-subcycle sync machinery
(SURVEY.md section 3.3):
  * MAC flux-register mismatch (MacProj mac_reg CrseInit/FineAdd,
    MacProj.cpp:304-348): the time-averaged fine interface MAC velocity
    minus the coarse MAC velocity, living on coarse C-F interface faces.
  * mac_sync_solve (MacProj.cpp:359-478): an elliptic solve spreads that
    interface divergence defect into a smooth correction velocity
    Ucorr = beta grad(phi_sync) with div(Ucorr) = the defect.
  * mac_sync_compute (MacProj.cpp:490-789): re-advect the coarse states
    with Ucorr as the fluxing velocity -> Vsync/Ssync corrections.
  * sync projection (Projection::MLsyncProject, Projection.cpp:457-614):
    project the velocity correction and add the pressure correction to
    both levels (phi interpolated to the fine level, SyncProjInterp).

Round 2: the composite machinery is genuine —
  * sync_project_composite: 2-level FAC solve over coarse + fine patch
    (MLsyncProject, Projection.cpp:457-614) with the nodal sync-register
    RHS assembled by sync_register_rhs (InitRHS semantics evaluated
    directly on the resident dense levels instead of incremental
    CrseInit/FineAdd registers).
  * implicit sync diffusion (diffuse_Vsync/diffuse_Ssync) lives in
    iamr_tpu.solvers.tensor and is applied in amr.multilevel.
  * velocity advective + viscous reflux feed Vsync (amr.multilevel).
SyncInterp implements the reference's full variant dispatch
(NavierStokesBase.cpp:3087-3108): PC / CellCons (the default every in-tree
call site uses, NavierStokesBase.H:372) / CellConsLin (joint
multi-component limiting) / CellConsProt (positivity-protected, used here
for density) — see sync_interp().

Union (multi-box) fine levels: the *_union primitives generalize every
register/reflux/sync operation to an arbitrary union of boxes advanced as
one bounding-box array (amr.multipatch). The covered mask `cmask` (1 on
coarse cells under the union) replaces the single-patch region slices:
interface faces/nodes are mask transitions, so seams between boxes and the
outer C-F boundary are handled by the same arithmetic — the level-wide
analogue of the reference's per-box register iteration
(SyncRegister.cpp:49-287, FluxRegister semantics).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax.numpy as jnp

from iamr_tpu.amr.hierarchy import LevelSpec, crse_region, prolong_cell
from iamr_tpu.ns.state import NSConfig
from iamr_tpu.ops import mg
from iamr_tpu.ops.stencil import mac_div, sl


def _restrict_face(ff, d, spec: LevelSpec):
    """Average a fine face array's boundary faces onto coarse interface
    faces: transverse mean over ratio^(dim-1) fine faces."""
    dim = ff.ndim
    r = spec.ratio
    out = {}
    for side in (0, 1):
        f = sl(ff, d, 0, 1) if side == 0 else sl(ff, d, -1, None)
        for e in range(dim):
            if e == d:
                continue
            m = f.shape[e] // r
            acc = None
            for k in range(r):
                idx = [slice(None)] * dim
                idx[e] = slice(k, k + r * m, r)
                t = f[tuple(idx)]
                acc = t if acc is None else acc + t
            f = acc / r
        out[side] = jnp.squeeze(f, axis=d)
    return out


def interface_delta_umac(crse_umac, fine_umac_avg, spec: LevelSpec):
    """delta[d]: coarse face arrays, nonzero ONLY on C-F interface faces,
    holding (restricted time-avg fine u_mac) - (coarse u_mac) — the MAC
    flux register content."""
    dim = len(crse_umac)
    deltas = []
    for d in range(dim):
        delta = jnp.zeros_like(crse_umac[d])
        fr = _restrict_face(fine_umac_avg[d], d, spec)
        for side in (0, 1):
            cf = (
                spec.crse_lo[d]
                if side == 0
                else spec.crse_lo[d] + spec.crse_ncell[d]
            )
            if cf <= 0 or cf >= crse_umac[d].shape[d] - 1:
                continue  # interface on the domain boundary
            idx = [
                slice(spec.crse_lo[e], spec.crse_lo[e] + spec.crse_ncell[e])
                for e in range(dim)
            ]
            idx[d] = cf
            mismatch = fr[side] - crse_umac[d][tuple(idx)]
            delta = delta.at[tuple(idx)].set(mismatch)
        deltas.append(delta)
    return tuple(deltas)


def mac_sync_velocity(
    cfg: NSConfig,
    rho,
    deltas,
    spec: LevelSpec,
    fixed_cycles: Optional[int] = None,
    cmask=None,
):
    """mac_sync_solve: correction velocity Ucorr with
    div(Ucorr) = div(delta) on uncovered cells (the interface defect).

    Solves -div(beta grad phi) = -defect with beta = 1/rho and returns
    Ucorr = beta grad(phi) (face arrays). cmask: level-wide covered mask of
    a union fine level (replaces the single-patch region zeroing)."""
    from iamr_tpu.solvers.mac import beta_from_rho, mac_poisson_bc

    dim = rho.ndim
    dx = cfg.geom.dx
    rhs = mac_div(deltas, dx)
    # zero under the fine patch (reference zeroes the Reflux there)
    if cmask is not None:
        rhs = rhs * (1.0 - cmask)
    else:
        rhs = rhs.at[crse_region(spec)].set(0.0)
    bc = mac_poisson_bc(cfg.dom)
    beta = beta_from_rho(rho, cfg.dom)
    phi, res, it = mg.mg_solve(
        -rhs, jnp.zeros_like(rho), beta, 0.0, 1.0, dx, bc,
        rtol=1e-10, atol=1e-14, fixed_cycles=fixed_cycles,
    )
    corr = mg.get_fluxes(phi, beta, 1.0, dx, bc)  # -beta grad phi
    return tuple(-c for c in corr), (res, it)


def sync_aofs(cfg: NSConfig, s, ucorr, scomp: int, iconserv: bool):
    """Advective tendency of s with Ucorr as the fluxing velocity
    (mac_sync_compute semantics)."""
    from iamr_tpu.ns.advance import fill_scal
    from iamr_tpu.ops.godunov import (
        compute_edge_states,
        compute_fluxes_and_aofs,
        grow_umac_transverse,
    )

    periodic = tuple(cfg.geom.periodic)
    s_g = fill_scal(cfg, s, 3, scomp)
    ug = grow_umac_transverse(ucorr, periodic)
    # dt enters the predictor only through the time-centering terms; the
    # sync correction uses the same machinery with the coarse dt
    edges = compute_edge_states(
        s_g, ug, 0.0, cfg.geom.dx, cfg.geom.ncell, iconserv=iconserv,
        periodic=periodic,
    )
    _, a = compute_fluxes_and_aofs(edges, ucorr, cfg.geom.dx, iconserv, s_cc=s)
    return a


def sync_aofs_vel(cfg: NSConfig, vel, ucorr, rho=None):
    """Advective sync tendencies of velocity with Ucorr as the fluxing
    velocity (MacProj::mac_sync_compute, MacProj.cpp:490-789). With
    ns.do_mom_diff=1 (pass rho) the advected state is the MOMENTUM
    rho*U, conservatively (MacProj.cpp:601,686 uses `momenta`), and the
    caller converts the momentum-units Vsync to velocity by dividing by
    rho^{n+1} (NavierStokes.cpp:1529-1546)."""
    from iamr_tpu.ns.advance import fill_scal, fill_vel
    from iamr_tpu.ops.godunov import (
        compute_edge_states,
        compute_fluxes_and_aofs,
        grow_umac_transverse,
    )

    periodic = tuple(cfg.geom.periodic)
    mom = rho is not None and cfg.do_mom_diff
    vel_g = fill_vel(cfg, vel, 3)
    if mom:
        rho_g = fill_scal(cfg, rho, 3, 0)
        vel_g = rho_g[None] * vel_g
    ug = grow_umac_transverse(ucorr, periodic)
    out = []
    for c in range(cfg.dim):
        edges = compute_edge_states(
            vel_g[c], ug, 0.0, cfg.geom.dx, cfg.geom.ncell, iconserv=mom,
            periodic=periodic,
        )
        _, a = compute_fluxes_and_aofs(
            edges, ucorr, cfg.geom.dx, mom,
            s_cc=None if mom else vel[c],
        )
        out.append(a)
    return jnp.stack(out)


def sync_project(
    cfg: NSConfig,
    vsync,
    rho,
    dt,
    spec: LevelSpec,
    fixed_cycles: Optional[int] = None,
):
    """Sync projection of the velocity correction (MLsyncProject,
    coarse-level form): L(phi) = D(Vsync/dt); Vsync -= dt sigma G(phi).

    Returns (projected vsync, phi node correction)."""
    from iamr_tpu.ops.mg_nodal import (
        div_cell_to_node,
        grad_node_to_cell,
        nodal_solve,
    )
    from iamr_tpu.solvers.nodal_proj import nodal_bc

    dim = rho.ndim
    dx = cfg.geom.dx
    bc = nodal_bc(cfg.dom)
    sigma = 1.0 / rho
    vs = tuple(vsync[d] / dt for d in range(dim))
    rhs = div_cell_to_node(vs, dx, bc)
    phi, res, it = nodal_solve(
        rhs, sigma, dx, bc, rtol=1e-10, atol=1e-14, fixed_cycles=fixed_cycles
    )
    gphi = grad_node_to_cell(phi, dx)
    out = jnp.stack([(vs[d] - sigma * gphi[d]) * dt for d in range(dim)])
    return out, phi


def interp_cell_to_fine(a, spec: LevelSpec):
    """SyncInterp: coarse correction -> fine patch increments with
    MC-limited cell-conservative interpolation (the reference's CellCons_T
    default, cell_cons_interp; NavierStokesBase::SyncInterp cpp:3071-3263,
    default arg NavierStokesBase.H:372 — prolong_cell is exactly
    conservative with limited slopes)."""
    return prolong_cell(a, spec.ratio)[
        tuple(
            slice(spec.lo[d], spec.lo[d] + spec.ncell[d]) for d in range(spec.dim)
        )
    ]


def _patch(spec: LevelSpec):
    return tuple(
        slice(spec.lo[d], spec.lo[d] + spec.ncell[d]) for d in range(spec.dim)
    )


def interp_cell_to_fine_lincc(fields, spec: LevelSpec):
    """CellConsLin_T (lincc_interp): conservative linear interpolation with
    JOINT limiting across components — one scale factor per coarse cell
    (the min over components of limited/unlimited slope ratio) multiplies
    every component's central slope, so the interpolation commutes with
    linear combinations of the components (the property lincc_interp
    exists for; reference dispatch NavierStokesBase.cpp:3103).

    fields: [ncomp, ...] coarse corrections. Returns [ncomp, fine patch].
    """
    from iamr_tpu.amr.hierarchy import _mc_slope

    r = spec.ratio
    dim = spec.dim
    out = fields
    for d in range(dim):
        out = jnp.repeat(out, r, axis=1 + d)
    for d in range(dim):
        m = fields.shape[1 + d]
        idx_c = [slice(None)] * dim
        idx_l = [slice(None)] * dim
        idx_h = [slice(None)] * dim
        idx_c[d] = slice(1, m - 1)
        idx_l[d] = slice(0, m - 2)
        idx_h[d] = slice(2, m)
        # per-component: unlimited central slope + MC-limited slope
        # (interior cells; boundary cells keep zero slope = PC there,
        # matching _mc_slope's zero-padded ends)
        cen = jnp.zeros_like(fields)
        cen = cen.at[(slice(None), *idx_c)].set(
            0.5 * (fields[(slice(None), *idx_h)]
                   - fields[(slice(None), *idx_l)])
        )
        lim = jnp.stack(
            [_mc_slope(fields[c], d) for c in range(fields.shape[0])]
        )
        # safe-divide: mask the denominator BEFORE dividing (1e-300
        # underflows to 0 in f32, and 0/0 in the unselected branch would
        # poison gradients through jnp.where)
        tiny = jnp.finfo(fields.dtype).tiny
        nonzero = jnp.abs(cen) > 0.0
        denom = jnp.where(nonzero, jnp.abs(cen), tiny)
        ratio_c = jnp.where(nonzero, jnp.abs(lim) / denom, 1.0)
        alpha = jnp.min(ratio_c, axis=0)  # shared per-cell scale
        slope = cen * alpha[None]
        for e in range(dim):
            slope = jnp.repeat(slope, r, axis=1 + e)
        n_f = slope.shape[1 + d]
        pos = (jnp.arange(n_f) % r).astype(fields.dtype)
        off = (pos + 0.5) / r - 0.5
        shape = [1] * dim
        shape[d] = n_f
        out = out + slope * off.reshape(shape)[None]
    return out[(slice(None), *_patch(spec))]


def sync_interp(a, spec: LevelSpec, which: str = "cellcons", fine_field=None):
    """SyncInterp variant dispatch (NavierStokesBase.cpp:3087-3108):
    'pc' (pc_interp), 'cellcons' (cell_cons_interp, the reference default
    NavierStokesBase.H:372), 'cellconslin' (lincc_interp; `a` must be
    [ncomp, ...]), 'protected' (protected_interp; needs `fine_field`)."""
    if which == "pc":
        return prolong_cell(a, spec.ratio, limited=False)[_patch(spec)]
    if which == "cellcons":
        return interp_cell_to_fine(a, spec)
    if which == "cellconslin":
        return interp_cell_to_fine_lincc(a, spec)
    if which == "protected":
        assert fine_field is not None
        return interp_cell_to_fine_protected(a, fine_field, spec)
    raise ValueError(f"unknown SyncInterp variant {which!r}")


def interp_cell_to_fine_protected(inc_c, fine_field, spec: LevelSpec):
    """protected_interp (the reference's CellConsProt SyncInterp for
    density, NavierStokesBase.H:353-359): limited cell-conservative
    interpolation of the correction, falling back to piecewise-constant in
    any coarse cell whose limited increment would drive the fine field
    negative (both variants are exactly conservative)."""
    dim = spec.dim
    r = spec.ratio
    patch = tuple(
        slice(spec.lo[d], spec.lo[d] + spec.ncell[d]) for d in range(dim)
    )
    inc_lim = prolong_cell(inc_c, r)[patch]
    inc_pc = prolong_cell(inc_c, r, limited=False)[patch]
    bad = (fine_field + inc_lim) < 0.0
    # per coarse cell: any offending fine child -> PC for the whole cell
    b = bad
    for d in range(dim):
        shp = list(b.shape)
        shp[d] //= r
        shp.insert(d + 1, r)
        b = jnp.any(b.reshape(shp), axis=d + 1)
    for d in range(dim):
        b = jnp.repeat(b, r, axis=d)
    return jnp.where(b, inc_pc, inc_lim)


# ---------------------------------------------------------------------------
# composite 2-level sync projection (MLsyncProject + SyncRegister RHS)


def _interface_node_mask(spec: LevelSpec, crse_geom, nshape, dtype):
    """1 on coarse nodes on the boundary of the coarsened fine patch (the
    SyncRegister's home, SyncRegister.H:12-14); patch faces lying on the
    physical domain boundary are excluded (no C-F interface there)."""
    import numpy as np

    dim = spec.dim
    m = np.zeros(nshape, dtype=np.float64)
    lo = spec.crse_lo
    nc = spec.crse_ncell
    for d in range(dim):
        for side in (0, 1):
            if spec.touches_domain(crse_geom, d, side):
                continue
            idx = [slice(lo[e], lo[e] + nc[e] + 1) for e in range(dim)]
            idx[d] = lo[d] if side == 0 else lo[d] + nc[d]
            m[tuple(idx)] = 1.0
    return jnp.asarray(m, dtype=dtype)


def sync_register_rhs(cfg: NSConfig, spec: LevelSpec, vel_c, vel_f_avg, dt_c):
    """The nodal sync-register RHS (SyncRegister::InitRHS equivalent,
    SyncRegister.cpp:49-287).

    The reference assembles, via CrseInit/FineAdd registers
    (Projection.cpp:402-427), the composite nodal divergence defect of the
    projected velocity field at the coarsened fine-boundary nodes: the
    coarse side contributes its (per-level div-free) field's half-stencil,
    the fine side the restriction of the time-averaged subcycled fine
    field. Design: with both levels' dense arrays resident we
    evaluate that composite divergence DIRECTLY — blend the coarse new
    velocity with the restricted time-averaged fine velocity, take the
    nodal divergence, and mask to the interface nodes (away from them the
    blended field is per-level projected and the divergence vanishes to
    solver tolerance; the fine-scale half-stencil detail is a truncation-
    order refinement the registers add that the blend approximates).
    Units: U/dt (the proj_2 scaling, Projection.cpp:419-423)."""
    from iamr_tpu.amr.hierarchy import avg_down
    from iamr_tpu.ops.mg_nodal import div_cell_to_node
    from iamr_tpu.solvers.nodal_proj import nodal_bc

    dim = cfg.dim
    bc = nodal_bc(cfg.dom)
    ub = tuple(
        avg_down(vel_c[c], vel_f_avg[c], spec) / dt_c for c in range(dim)
    )
    rh = div_cell_to_node(ub, cfg.geom.dx, bc)
    mask = _interface_node_mask(spec, cfg.geom, rh.shape, rh.dtype)
    return rh * mask


def _fine_sync_nodal_bc(cfg_f, spec: LevelSpec, crse_geom):
    """Fine-patch nodal BC for the sync solve: Dirichlet on C-F sides
    (values interpolated from the coarse phi), physical BC elsewhere."""
    from iamr_tpu.ops.mg_nodal import N_DIRICHLET
    from iamr_tpu.ops.mg_nodal import NodalBC
    from iamr_tpu.solvers.nodal_proj import nodal_bc

    nb = nodal_bc(cfg_f.dom)
    lo = list(nb.lo)
    hi = list(nb.hi)
    for d in range(spec.dim):
        if not spec.touches_domain(crse_geom, d, 0):
            lo[d] = N_DIRICHLET
        if not spec.touches_domain(crse_geom, d, 1):
            hi[d] = N_DIRICHLET
    return NodalBC(lo=tuple(lo), hi=tuple(hi))


def sync_project_composite(
    cfg: NSConfig,
    cfg_f: NSConfig,
    spec: LevelSpec,
    vsync,
    rho_c,
    rho_f,
    dt,
    rhnd=None,
    fixed_cycles: Optional[int] = None,
    n_fac: int = 2,
    union=None,
    vcorr=None,
    eb_c=None,
    eb_f=None,
):
    """Genuine 2-level composite sync projection (Projection::MLsyncProject,
    Projection.cpp:457-614): solve

        L_comp(phi) = D(Vsync/dt) [coarse] + D(Vcorr/dt) [fine] + rhnd

    over the coarse level AND the fine patch via a FAC (fast adaptive
    composite) iteration: coarse solve over the whole domain -> fine-patch
    solve with Dirichlet phi interpolated from the coarse solution at the
    C-F boundary -> restrict the fine phi into the covered region and
    re-solve the coarse residual equation. Each FAC sweep contracts the
    composite error; n_fac=2 reduces it below the correction's own
    truncation error. rhnd: the sync-register RHS (sync_register_rhs).

    eb_c / eb_f: per-level EBData — the FAC solves then run the EB nodal
    operator exactly as Projection::MLsyncProject does with the
    MLNodeLaplacian over an EB factory (Projection.cpp:457-614): operator
    coefficient sigma * vfrac (scaleVar zeroes sigma in covered regions,
    Projection.cpp:1238-1466), divergence of vfrac-weighted corrections,
    and fluid-masked projected output. refine_cutcells (the reference
    default) keeps every cut cell on the finest level, so the C-F
    interface faces feeding rhnd are regular fluid faces and the
    sync-register RHS needs no EB weighting.

    Returns (vsync_proj, vcorr_proj, phi_c, phi_f): the projected coarse /
    fine velocity corrections and the per-level pressure increments."""
    from iamr_tpu.amr.hierarchy import avg_down_node
    from iamr_tpu.ns.bcprovider import _prolong_node_patch
    from iamr_tpu.ops.mg_nodal import (
        apply_nodal,
        div_cell_to_node,
        grad_node_to_cell,
        nodal_solve,
    )
    from iamr_tpu.solvers.nodal_proj import nodal_bc

    dim = cfg.dim
    dxc = cfg.geom.dx
    dxf = cfg_f.geom.dx
    bc_c = nodal_bc(cfg.dom)
    bc_f = _fine_sync_nodal_bc(cfg_f, spec, cfg.geom)
    sigma_c = 1.0 / rho_c
    sigma_f = 1.0 / rho_f
    # EB: the operator runs vfrac-weighted sigma; the final velocity
    # correction uses the raw 1/rho (level_project's EB convention)
    vf_c = eb_c.vfrac if eb_c is not None else None
    vf_f = eb_f.vfrac if eb_f is not None else None
    sig_op_c = sigma_c * vf_c if vf_c is not None else sigma_c
    sig_op_f = sigma_f * vf_f if vf_f is not None else sigma_f
    fmask = nodemask_f = None
    if union is not None:
        # level-wide multi-box fine level: hole cells/nodes are interior
        # Dirichlet (nodal_proj union semantics); coarse restriction only
        # from nodes interior to the union
        fmask, nodemask_f = union
        sig_op_f = sig_op_f * fmask

    if vcorr is None:
        # SyncInterp Vsync -> fine V_corr (NavierStokesBase.cpp:1993-1994)
        vcorr = jnp.stack(
            [interp_cell_to_fine(vsync[c], spec) for c in range(dim)]
        )
    # else: the fine correction is its own field (initialSyncProject
    # projects each level's OWN acceleration dU/dt, Projection.cpp:970-1191)

    rhs_c = div_cell_to_node(
        tuple(
            (vf_c * vsync[d] if vf_c is not None else vsync[d]) / dt
            for d in range(dim)
        ),
        dxc, bc_c,
    )
    if rhnd is not None:
        rhs_c = rhs_c + rhnd
    rhs_f = div_cell_to_node(
        tuple(
            (vf_f * vcorr[d] if vf_f is not None else vcorr[d]) / dt
            for d in range(dim)
        ),
        dxf, bc_f,
    )

    phi_c = jnp.zeros_like(rhs_c)
    phi_f = None
    for it in range(n_fac):
        if it == 0:
            r_c = rhs_c
        else:
            # composite residual: covered nodes carry the restricted fine
            # solution; re-solve the coarse defect equation
            if union is None:
                phi_c = avg_down_node(phi_c, phi_f, spec)
            else:
                r = spec.ratio
                # restriction uses the node CLOSURE (box-boundary nodes
                # restrict like the single-patch path); only the SOLVE
                # uses the free-node mask
                node_cmask = node_closure_mask(fmask)[tuple(
                    slice(None, None, r) for _ in range(dim)
                )]
                phi_c = avg_down_node_union(phi_c, phi_f, spec, node_cmask)
            r_c = rhs_c - apply_nodal(phi_c, sig_op_c, dxc, bc_c)
        e_c, _, _ = nodal_solve(
            r_c, sig_op_c, dxc, bc_c, rtol=1e-10, atol=1e-14,
            fixed_cycles=fixed_cycles,
        )
        phi_c = phi_c + e_c
        phi_b = _prolong_node_patch(phi_c, spec)
        phi_f, _, _ = nodal_solve(
            rhs_f, sig_op_f, dxf, bc_f, rtol=1e-10, atol=1e-14,
            fixed_cycles=fixed_cycles, phi_bc=phi_b,
            interior_mask=nodemask_f,
        )

    gc = grad_node_to_cell(phi_c, dxc)
    gf = grad_node_to_cell(phi_f, dxf)
    vsync_p = jnp.stack(
        [vsync[d] - dt * sigma_c * gc[d] for d in range(dim)]
    )
    vcorr_p = jnp.stack(
        [vcorr[d] - dt * sigma_f * gf[d] for d in range(dim)]
    )
    if eb_c is not None:
        vsync_p = vsync_p * eb_c.fluid
    if eb_f is not None:
        vcorr_p = vcorr_p * eb_f.fluid
    return vsync_p, vcorr_p, phi_c, phi_f


# ---------------------------------------------------------------------------
# Union (multi-box level-wide) variants: masks instead of region slices
# ---------------------------------------------------------------------------


def _restrict_face_full(ff, d, r: int):
    """Restrict a WHOLE fine face array to coarse faces: subsample along d
    at stride r (coincident faces), mean over r fine faces per transverse
    dim (FluxRegister face agglomeration)."""
    dim = ff.ndim
    f = ff[tuple(
        slice(None, None, r) if e == d else slice(None) for e in range(dim)
    )]
    for e in range(dim):
        if e == d:
            continue
        m = f.shape[e] // r
        acc = None
        for k in range(r):
            idx = [slice(None)] * dim
            idx[e] = slice(k, k + r * m, r)
            t = f[tuple(idx)]
            acc = t if acc is None else acc + t
        f = acc / r
    return f


def _face_region(spec: LevelSpec, d: int):
    """Slice tuple of the coarse faces of the covered region (d-faces)."""
    out = []
    for e in range(spec.dim):
        n = spec.crse_ncell[e] + (1 if e == d else 0)
        out.append(slice(spec.crse_lo[e], spec.crse_lo[e] + n))
    return tuple(out)


def _nbr_masks(cmask, d):
    """(nbr_lo, nbr_hi): per-cell masks of whether the lo/hi neighbor along
    d is covered; domain edges clone the boundary cell (a C-F face never
    lies on the physical boundary: no outside cell there)."""
    dim = cmask.ndim
    pad = [(0, 0)] * dim
    pad[d] = (1, 1)
    mp = jnp.pad(cmask, pad, mode="edge")
    return sl(mp, d, 0, -2), sl(mp, d, 2, None)


def _embed_face_delta(crse_flux_d, fine_flux_d, bbox: LevelSpec, d: int):
    """Level-wide coarse face array holding (restricted fine flux - coarse
    flux) on the bbox's coarse faces, 0 elsewhere."""
    fr = _restrict_face_full(fine_flux_d, d, bbox.ratio)
    reg = _face_region(bbox, d)
    z = jnp.zeros_like(crse_flux_d)
    return z.at[reg].set(fr - crse_flux_d[reg])


def reflux_correct_union(
    crse, crse_flux, fine_flux, bbox: LevelSpec, cmask, dt_over_dx,
):
    """Masked level-wide flux-register correction: every uncovered coarse
    cell whose lo/hi neighbor along d is covered replaces its coarse
    interface flux with the restricted fine flux. Generalizes
    hierarchy.reflux_correct to unions of boxes (seam faces between a hole
    and a box are true C-F faces and corrected identically)."""
    dim = crse.ndim
    out = crse
    unc = 1.0 - cmask
    for d in range(dim):
        dF = _embed_face_delta(crse_flux[d], fine_flux[d], bbox, d)
        nbr_lo, nbr_hi = _nbr_masks(cmask, d)
        lo_vals = sl(dF, d, 0, -1)   # cell i's lo face
        hi_vals = sl(dF, d, 1, None)  # cell i's hi face
        out = out + dt_over_dx[d] * unc * (
            lo_vals * nbr_lo - hi_vals * nbr_hi
        )
    return out


def interface_delta_umac_union(crse_umac, fine_umac_avg, bbox: LevelSpec, cmask):
    """MAC flux-register content for a union fine level: coarse face arrays
    nonzero ONLY on true C-F interface faces (mask transitions), holding
    (restricted time-avg fine u_mac) - (coarse u_mac)."""
    dim = len(crse_umac)
    deltas = []
    for d in range(dim):
        dF = _embed_face_delta(crse_umac[d], fine_umac_avg[d], bbox, d)
        # face mask: covered on exactly one side (edge-clone padding keeps
        # domain-boundary faces out)
        pad = [(0, 0)] * dim
        pad[d] = (1, 1)
        mp = jnp.pad(cmask, pad, mode="edge")
        lo = sl(mp, d, 0, -1)
        hi = sl(mp, d, 1, None)
        iface = lo * (1.0 - hi) + hi * (1.0 - lo)
        deltas.append(dF * iface)
    return tuple(deltas)


def avg_down_union(crse, fine, bbox: LevelSpec, cmask_box):
    """avg_down restricted to covered cells of the bbox region (holes keep
    the coarse solution)."""
    from iamr_tpu.amr.hierarchy import restrict_cell

    reg = crse_region(bbox)
    return crse.at[reg].set(
        jnp.where(cmask_box > 0.0, restrict_cell(fine, bbox.ratio), crse[reg])
    )


def mask_umac_to_union(umac, fmask):
    """Zero MAC components on faces NOT interior to the union (a face
    survives iff both adjacent cells are covered; array-boundary faces iff
    their single adjacent cell is). Used when a level that is itself a
    multi-box union acts as the PARENT of a sync coupling: its holes are
    not part of the level (the reference's BoxArray simply has no cells
    there), so the sync correction velocity must carry no flux across the
    union interface — conservation over covered cells then telescopes
    exactly as on a single-patch level."""
    out = []
    dim = fmask.ndim
    for d, u in enumerate(umac):
        pad = [(0, 0)] * dim
        pad[d] = (1, 1)
        mp = jnp.pad(fmask, pad, mode="edge")
        lo = [slice(None)] * dim
        hi = [slice(None)] * dim
        lo[d] = slice(0, fmask.shape[d] + 1)
        hi[d] = slice(1, fmask.shape[d] + 2)
        out.append(u * jnp.minimum(mp[tuple(lo)], mp[tuple(hi)]))
    return tuple(out)


def node_closure_mask(fmask):
    """1 on fine nodes adjacent to ANY in-union cell — the union's node
    CLOSURE, the nodes the reference's nodal average_down restricts
    (including C-F interface / box-boundary nodes), as opposed to the
    FREE-node mask (all adjacent cells in-union) the elliptic solves use.
    On a fully-tiled bbox this is every node, making the union restriction
    identical to the single-patch avg_down_node (round-4 fix: using the
    free mask here skipped the patch-boundary nodes and left the coarse p
    O(1e-4) off the single-patch result at depth >= 2)."""
    import itertools

    dim = fmask.ndim
    mp = jnp.pad(fmask, 1, constant_values=0.0)
    out = None
    for t in itertools.product((0, 1), repeat=dim):
        sl_ = tuple(
            slice(t[d], t[d] + fmask.shape[d] + 1) for d in range(dim)
        )
        v = mp[sl_]
        out = v if out is None else jnp.maximum(out, v)
    return out


def avg_down_node_union(crse_p, fine_p, bbox: LevelSpec, node_cmask_box):
    """avg_down_node restricted to the given node mask (callers pass the
    node CLOSURE mask, node_closure_mask(fmask)[::r], so box-boundary
    nodes restrict like the single-patch path; hole-interior nodes keep
    the coarse solution)."""
    from iamr_tpu.amr.hierarchy import restrict_node

    reg = tuple(
        slice(bbox.crse_lo[d], bbox.crse_lo[d] + bbox.crse_ncell[d] + 1)
        for d in range(bbox.dim)
    )
    return crse_p.at[reg].set(
        jnp.where(
            node_cmask_box > 0.0, restrict_node(fine_p, bbox.ratio), crse_p[reg]
        )
    )


def _interface_node_mask_union(cmask):
    """1 on coarse nodes adjacent to BOTH covered and uncovered cells (the
    union SyncRegister home). Edge-clone padding excludes physical-domain
    boundary nodes of a domain-touching union side."""
    import itertools

    dim = cmask.ndim
    mp = jnp.pad(cmask, 1, mode="edge")
    nshape = tuple(n + 1 for n in cmask.shape)
    any_cov = None
    any_unc = None
    for t in itertools.product((0, 1), repeat=dim):
        cell = mp[tuple(slice(t[d], t[d] + nshape[d]) for d in range(dim))]
        c = cell
        u = 1.0 - cell
        any_cov = c if any_cov is None else jnp.maximum(any_cov, c)
        any_unc = u if any_unc is None else jnp.maximum(any_unc, u)
    return any_cov * any_unc


def sync_register_rhs_union(cfg: NSConfig, bbox: LevelSpec, cmask, vel_c,
                            vel_f_avg, dt_c):
    """sync_register_rhs for a union fine level: blend the coarse velocity
    with the restricted time-averaged fine field on covered cells, take the
    nodal divergence, mask to the union-interface nodes."""
    from iamr_tpu.amr.hierarchy import restrict_cell
    from iamr_tpu.ops.mg_nodal import div_cell_to_node
    from iamr_tpu.solvers.nodal_proj import nodal_bc

    dim = cfg.dim
    bc = nodal_bc(cfg.dom)
    reg = crse_region(bbox)
    cmask_box = cmask[reg]
    ub = []
    for c in range(dim):
        v = vel_c[c].at[reg].set(
            jnp.where(
                cmask_box > 0.0,
                restrict_cell(vel_f_avg[c], bbox.ratio),
                vel_c[c][reg],
            )
        )
        ub.append(v / dt_c)
    rh = div_cell_to_node(tuple(ub), cfg.geom.dx, bc)
    return rh * _interface_node_mask_union(cmask)
