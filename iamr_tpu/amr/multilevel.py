"""Two-level (coarse + fine patch) composite timestep.

JAX equivalent of the reference's multilevel advance in its
non-subcycled mode (amr.subcycling_mode=None, Docs/Debugging.rst:22-23):
both levels advance with the SAME dt each coarse step; afterwards
  * avgDown replaces covered coarse data with restricted fine data
    (NavierStokes.cpp:1844-1873)
  * reflux corrects uncovered coarse cells at the C-F interface with the
    advective flux mismatch for conservatively-advected scalars
    (NavierStokes.cpp:1735-1838)
The fine level's ghost cells / solver BCs come from the coarse level via a
CoarseFineBCProvider (FillPatch + coarse-fine Dirichlet semantics).

Subcycled advance (advance_hierarchy_subcycled): fine takes r steps per
coarse step; the coupling (_couple_levels) then runs the full sync
machinery — velocity/scalar advective + viscous reflux into Vsync/Ssync
(NavierStokes::reflux, cpp:1735-1838), mac_sync (Ucorr re-advection),
implicit sync diffusion (diffuse_Vsync/Ssync), and the composite 2-level
sync projection with nodal sync-register RHS (MLsyncProject + InitRHS;
iamr_tpu.amr.sync).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from iamr_tpu.amr.hierarchy import (
    LevelSpec,
    avg_down,
    avg_down_node,
    crse_region,
    prolong_cell,
    reflux_correct,
)
from iamr_tpu.ns.advance import advance, est_time_step, make_hit_forcing
from iamr_tpu.ns.bcprovider import CoarseFineBCProvider, _prolong_node_patch
from iamr_tpu.ns.state import NSConfig, NSState


class MLState(NamedTuple):
    crse: NSState
    fine: NSState


def make_fine_config(cfg: NSConfig, spec: LevelSpec) -> NSConfig:
    fine_geom = spec.fine_geom(cfg.geom)
    return dataclasses.replace(cfg, geom=fine_geom)


def init_fine_from_coarse(cfg: NSConfig, spec: LevelSpec, crse: NSState) -> NSState:
    """Interpolate the coarse state onto the fine patch (FillCoarsePatch /
    init-from-coarser semantics, NavierStokesBase.cpp:1759-1807)."""
    r = spec.ratio

    def pc(a):
        return prolong_cell(a, r)[
            tuple(slice(spec.lo[d], spec.lo[d] + spec.ncell[d]) for d in range(spec.dim))
        ]

    vel = jnp.stack([pc(crse.vel[c]) for c in range(crse.vel.shape[0])])
    trac = jnp.stack([pc(crse.trac[t]) for t in range(crse.trac.shape[0])])
    p = _prolong_node_patch(crse.p, spec)
    gradp = jnp.stack([pc(crse.gradp[c]) for c in range(crse.gradp.shape[0])])
    return NSState(
        vel=vel, rho=pc(crse.rho), trac=trac, temp=pc(crse.temp), p=p,
        gradp=gradp, time=crse.time, dt=crse.dt,
        dsdt=None if crse.dsdt is None else pc(crse.dsdt),
    )


def advance_two_level(
    ml: MLState,
    cfg: NSConfig,
    spec: LevelSpec,
    fixed_mg_cycles: Optional[int] = None,
    hit=None,
    return_umacs: bool = False,
):
    """One composite (non-subcycled) step. Returns the new MLState."""
    cfg_f = make_fine_config(cfg, spec)
    dim = cfg.dim
    r = spec.ratio
    dt = jnp.minimum(ml.crse.dt, ml.fine.dt)
    crse = ml.crse._replace(dt=dt)
    fine = ml.fine._replace(dt=dt)

    # --- 1. advance the coarse level (its own physical BCs) -------------
    crse_new, crse_aux = advance(
        crse, cfg, fixed_mg_cycles, hit=hit, return_aux=True
    )

    # --- 2. advance the fine level with coarse-fed BCs ------------------
    crse_old_d = {
        "vel": crse.vel, "rho": crse.rho, "trac": crse.trac, "temp": crse.temp
    }
    crse_new_d = {
        "vel": crse_new.vel, "rho": crse_new.rho, "trac": crse_new.trac,
        "temp": crse_new.temp,
    }
    bcp = CoarseFineBCProvider(
        cfg_f, spec, cfg.geom, crse_old_d, crse_new_d,
        crse_p=crse_new.p, crse_mac_phi=crse_aux["mac_phi"],
        crse_umac=crse_aux["umac"],
    )
    fine_new, fine_aux = advance(
        fine, cfg_f, fixed_mg_cycles, hit=hit, bcp=bcp, return_aux=True
    )

    # --- 3. avgDown (State, Press, Gradp; NavierStokes.cpp:1844-1873) ---
    rho_c = avg_down(crse_new.rho, fine_new.rho, spec)
    vel_c = jnp.stack(
        [avg_down(crse_new.vel[c], fine_new.vel[c], spec) for c in range(dim)]
    )
    trac_c = jnp.stack(
        [
            avg_down(crse_new.trac[t], fine_new.trac[t], spec)
            for t in range(cfg.ntrac)
        ]
    )
    p_c = avg_down_node(crse_new.p, fine_new.p, spec)
    gradp_c = jnp.stack(
        [avg_down(crse_new.gradp[c], fine_new.gradp[c], spec) for c in range(dim)]
    )

    # --- 4. reflux conservative scalars (rho always; tracers if
    # conservative) against the advective flux mismatch -------------------
    dxc = cfg.geom.dx
    dt_over_dx = tuple(dt / dxc[d] for d in range(dim))
    rho_c = reflux_correct(
        rho_c, crse_aux["flux_rho"], fine_aux["flux_rho"], spec, dt_over_dx
    )
    if cfg.do_cons_trac:
        trac_list = []
        for t in range(cfg.ntrac):
            trac_list.append(
                reflux_correct(
                    trac_c[t],
                    crse_aux["flux_trac"][t],
                    fine_aux["flux_trac"][t],
                    spec,
                    dt_over_dx,
                )
            )
        trac_c = jnp.stack(trac_list)

    temp_c = avg_down(crse_new.temp, fine_new.temp, spec)
    crse_out = crse_new._replace(
        rho=rho_c, vel=vel_c, trac=trac_c, temp=temp_c, p=p_c, gradp=gradp_c
    )

    # --- next dt: min over levels (computeNewDt, cpp:944-1035) -----------
    dt_c = est_time_step(cfg, crse_out)
    dt_f = est_time_step(cfg_f, fine_new)
    dt_next = jnp.minimum(jnp.minimum(dt_c, dt_f), cfg.change_max * dt)
    crse_out = crse_out._replace(dt=dt_next)
    fine_out = fine_new._replace(dt=dt_next)
    out = MLState(crse=crse_out, fine=fine_out)
    if return_umacs:
        return out, [crse_aux["umac"], fine_aux["umac"]]
    return out


def post_init_press_two_level(
    cfg: NSConfig,
    spec: LevelSpec,
    crse: NSState,
    fine: NSState,
    fixed_mg_cycles: Optional[int] = None,
    hit=None,
):
    """Initial composite pressure iterations for a 2-level start
    (NavierStokes::post_init_press + Projection::initialSyncProject,
    NavierStokes.cpp:1305-1432 / Projection.cpp:970-1191): iterate the
    non-subcycled composite first step; after each trial step, a 2-level
    composite nodal projection of the per-level accelerations
    dU/dt = (U_new - U_old)/dt (sigma = rho_half) produces the composite
    pressure increment phi, which is kept (P += phi, Gp += G(phi)) while
    every other field resets to its initial value."""
    if cfg.init_iter <= 0:
        return crse, fine
    from iamr_tpu.amr.sync import sync_project_composite
    from iamr_tpu.ops.mg_nodal import grad_node_to_cell

    cfg_f = make_fine_config(cfg, spec)
    dim = cfg.dim

    @jax.jit
    def _one(crse, fine):
        ml = advance_two_level(
            MLState(crse=crse, fine=fine), cfg, spec, fixed_mg_cycles,
            hit=hit,
        )
        dt = jnp.minimum(crse.dt, fine.dt)
        rho_h_c = 0.5 * (crse.rho + ml.crse.rho)
        rho_h_f = 0.5 * (fine.rho + ml.fine.rho)
        # ml.crse.vel is already avgDown'd, so dv_c/dv_f agree on covered
        # cells (the reference average_downs vel[lev-1] the same way)
        dv_c = ml.crse.vel - crse.vel
        dv_f = ml.fine.vel - fine.vel
        _, _, phi_c, phi_f = sync_project_composite(
            cfg, cfg_f, spec, dv_c, rho_h_c, rho_h_f, dt,
            fixed_cycles=fixed_mg_cycles, vcorr=dv_f,
        )
        gpc = grad_node_to_cell(phi_c, cfg.geom.dx)
        gpf = grad_node_to_cell(phi_f, cfg_f.geom.dx)
        crse2 = crse._replace(
            p=ml.crse.p + phi_c,
            gradp=ml.crse.gradp + jnp.stack([gpc[d] for d in range(dim)]),
        )
        fine2 = fine._replace(
            p=ml.fine.p + phi_f,
            gradp=ml.fine.gradp + jnp.stack([gpf[d] for d in range(dim)]),
        )
        return crse2, fine2

    for _ in range(max(0, cfg.init_iter)):
        crse, fine = _one(crse, fine)
    return crse, fine


def _interp_states(crse_old, crse_new, theta):
    return {
        "vel": (1 - theta) * crse_old.vel + theta * crse_new.vel,
        "rho": (1 - theta) * crse_old.rho + theta * crse_new.rho,
        "trac": (1 - theta) * crse_old.trac + theta * crse_new.trac,
        "temp": (1 - theta) * crse_old.temp + theta * crse_new.temp,
    }


def _couple_levels(
    cfg, cfg_f, spec, crse_new, crse_aux, fine_new, fine_avg,
    dt_c, fixed_mg_cycles, eb_c=None, eb_f=None, union=None,
    parent_cmask=None,
):
    """Parent/child post-subcycle coupling: avgDown + advective reflux +
    the sync machinery (mac_sync + sync projection; SURVEY section 3.3).
    Returns (crse_out, fine_out).

    eb_c/eb_f: per-level EBData; cut-cell restriction is volume-fraction
    weighted (EB_average_down semantics) and the sync solves assume the
    C-F interface itself lies in regular cells (refine the body).

    union: for a multi-box fine level advanced as one bounding-box array
    (amr.multipatch), {"cmask": level-wide coarse covered mask, "fmask":
    bbox fine cell mask, "nodemask": bbox fine free-node mask} — every
    region-slice operation switches to its mask-transition *_union variant
    so box seams and the outer boundary share one code path."""
    dim = cfg.dim
    cmask = union["cmask"] if union is not None else None

    if eb_f is not None:
        from iamr_tpu.amr.hierarchy import restrict_cell

        wf = jnp.maximum(restrict_cell(eb_f.vfrac, spec.ratio), 1e-12)
        cov_c = (
            eb_c.covered[crse_region(spec)]
            if eb_c is not None
            else jnp.zeros_like(wf)
        )

        def avg_down_eb(crse, fine):
            num = restrict_cell(eb_f.vfrac * fine, spec.ratio) / wf
            reg = crse_region(spec)
            # fully-covered coarse cells keep their body state (the
            # weighted restriction is 0/0 there)
            return crse.at[reg].set(
                jnp.where(cov_c > 0.0, crse[reg], num)
            )

        _avg = avg_down_eb
    elif union is not None:
        from iamr_tpu.amr.sync import avg_down_union

        cmask_box = cmask[crse_region(spec)]

        def _avg(crse, fine):
            return avg_down_union(crse, fine, spec, cmask_box)
    else:
        def _avg(crse, fine):
            return avg_down(crse, fine, spec)

    rho_c = _avg(crse_new.rho, fine_new.rho)
    vel_c = jnp.stack(
        [_avg(crse_new.vel[c], fine_new.vel[c]) for c in range(dim)]
    )
    trac_c = jnp.stack(
        [_avg(crse_new.trac[t], fine_new.trac[t]) for t in range(cfg.ntrac)]
    )
    temp_c = _avg(crse_new.temp, fine_new.temp)
    if union is not None:
        from iamr_tpu.amr.sync import avg_down_node_union, node_closure_mask

        # node CLOSURE mask (any adjacent cell covered), not the elliptic
        # free-node mask: box-boundary nodes restrict like the
        # single-patch avg_down_node (amrex nodal average_down includes
        # the C-F interface nodes)
        node_cmask = node_closure_mask(union["fmask"])[tuple(
            slice(None, None, spec.ratio) for _ in range(dim)
        )]
        p_c = avg_down_node_union(crse_new.p, fine_new.p, spec, node_cmask)
        gradp_c = jnp.stack(
            [_avg(crse_new.gradp[c], fine_new.gradp[c]) for c in range(dim)]
        )
    else:
        p_c = avg_down_node(crse_new.p, fine_new.p, spec)
        gradp_c = jnp.stack(
            [
                avg_down(crse_new.gradp[c], fine_new.gradp[c], spec)
                for c in range(dim)
            ]
        )
    dxc = cfg.geom.dx
    dt_over_dx = tuple(dt_c / dxc[d] for d in range(dim))
    if not getattr(cfg, "do_reflux", True):
        # ns.do_reflux=0 debugging toggle: avgDown only
        def _reflux(base, fc, ff):
            return base
    elif union is not None:
        from iamr_tpu.amr.sync import reflux_correct_union

        def _reflux(base, fc, ff):
            return reflux_correct_union(base, fc, tuple(ff), spec, cmask,
                                        dt_over_dx)
    else:
        def _reflux(base, fc, ff):
            return reflux_correct(base, fc, tuple(ff), spec, dt_over_dx)

    rho_c = _reflux(rho_c, crse_aux["flux_rho"], fine_avg["flux_rho"])
    crse_out = crse_new._replace(
        rho=rho_c, vel=vel_c, trac=trac_c, temp=temp_c, p=p_c, gradp=gradp_c
    )

    # --- flux-register reflux into Vsync/Ssync (NavierStokes::reflux,
    # cpp:1735-1838): velocity gets the advective mismatch plus, for the
    # convective form, the CN viscous mismatch divided by rho; diffused
    # tracers get their viscous mismatch (NonConservative: / rho) and
    # conservative tracers their advective mismatch -------------------------
    zero_c = jnp.zeros_like(rho_c)

    def _mismatch(fc, ff):
        return _reflux(zero_c, fc, ff)

    vsync_reflux = []
    for c in range(dim):
        v = _mismatch(crse_aux["flux_vel"][c], fine_avg["flux_vel"][c])
        if crse_aux["vflux_vel"] is not None:
            vm = _mismatch(
                crse_aux["vflux_vel"][c], fine_avg["vflux_vel"][c]
            )
            # convective form: viscous mismatch / rho here; momentum form
            # (do_mom_diff): BOTH components stay momentum-units and the
            # single / rho^{n+1} below converts them
            # (NavierStokes.cpp:1751-1756)
            v = v + (vm if cfg.do_mom_diff else vm / rho_c)
        vsync_reflux.append(v)
    ssync_reflux = []
    for t in range(cfg.ntrac):
        s = zero_c
        if cfg.do_cons_trac:
            s = _mismatch(crse_aux["flux_trac"][t], fine_avg["flux_trac"][t])
        if crse_aux["vflux_trac"][t] is not None:
            dv = _mismatch(
                crse_aux["vflux_trac"][t], fine_avg["vflux_trac"][t]
            )
            s = s + (dv if cfg.do_cons_trac else dv / rho_c)
        ssync_reflux.append(s)

    from iamr_tpu.amr.sync import (
        interface_delta_umac,
        interp_cell_to_fine,
        mac_sync_velocity,
        sync_aofs,
        sync_aofs_vel,
        sync_project,
    )
    from iamr_tpu.ns.bcprovider import _prolong_node_patch

    if union is not None:
        from iamr_tpu.amr.sync import interface_delta_umac_union

        deltas = interface_delta_umac_union(
            crse_aux["umac"], tuple(fine_avg["umac"]), spec, cmask
        )

        def uncovered(a):
            return a * (1.0 - cmask)
    else:
        deltas = interface_delta_umac(
            crse_aux["umac"], tuple(fine_avg["umac"]), spec
        )
        cov = crse_region(spec)

        def uncovered(a):
            return a.at[cov].set(0.0)

    ucorr, _ = mac_sync_velocity(
        cfg, crse_out.rho, deltas, spec, fixed_cycles=fixed_mg_cycles,
        cmask=cmask,
    )
    if parent_cmask is not None:
        # the COARSE level of this pair is itself a multi-box union: kill
        # sync-correction flux across its union interface so conservation
        # over covered cells telescopes like on a single-patch level (the
        # reference's BoxArray has no hole cells at all)
        from iamr_tpu.amr.sync import mask_umac_to_union

        ucorr = mask_umac_to_union(ucorr, parent_cmask)

    # Ssync: re-advect scalars with Ucorr (explicit, convective for tracers,
    # conservative for rho). The conservative rho correction stays in flux
    # form over the WHOLE level (total mass change telescopes to the domain
    # boundary flux = 0) and the covered part is handed to the fine level by
    # interpolation — the Pember DeltaSsync consistency
    # (NavierStokes.cpp:1495-1527). Convective tracers are zeroed under the
    # fine patch like the reference's Ssync.
    ssync_rho = -dt_c * sync_aofs(cfg, crse_out.rho, ucorr, 0, True)
    rho_sync = crse_out.rho + ssync_rho

    # implicit sync diffusion (diffuse_Ssync / diffuse_Vsync,
    # Source/Diffusion.cpp:960-1353): corrections see the CN operator so
    # the composite state stays consistent with the diffused levels
    from iamr_tpu.ns.advance import beta_faces, mu_faces
    from iamr_tpu.ns.bcprovider import PhysBCProvider
    from iamr_tpu.solvers.tensor import diffuse_ssync, diffuse_vsync

    bcp_c = PhysBCProvider(cfg)
    trac_sync = []
    for t in range(cfg.ntrac):
        ds = uncovered(
            -dt_c
            * sync_aofs(cfg, crse_out.trac[t], ucorr, 1 + t, cfg.do_cons_trac)
            + ssync_reflux[t]
        )
        coef = cfg.scal_diff_coefs[t] if t < len(cfg.scal_diff_coefs) else 0.0
        if coef > 0.0 and eb_c is None:
            ds = diffuse_ssync(
                cfg, bcp_c, ds, rho_sync, beta_faces(cfg, coef), dt_c,
                cfg.be_cn_theta, 1 + t, fixed_cycles=fixed_mg_cycles,
            )
        trac_sync.append(crse_out.trac[t] + ds)
    trac_sync = jnp.stack(trac_sync)

    # Vsync: velocity correction, then the sync projection; corrections are
    # added to the coarse level and interpolated onto the fine level
    vsync = jnp.stack(
        [
            uncovered(-dt_c * a + vsync_reflux[c])
            for c, a in enumerate(sync_aofs_vel(
                cfg, crse_out.vel, ucorr,
                rho=crse_out.rho if cfg.do_mom_diff else None,
            ))
        ]
    )
    if cfg.do_mom_diff:
        # momentum-units Vsync (reflux mismatch + Ucorr tendencies of
        # rho*U) -> velocity correction (NavierStokes.cpp:1529-1546)
        vsync = vsync / rho_sync
    if cfg.vel_visc_coef > 0.0 and eb_c is None:
        rho_half_c = 0.5 * (crse_new.rho + rho_sync)
        vsync = diffuse_vsync(
            cfg, bcp_c, vsync, rho_half_c, mu_faces(cfg), dt_c,
            cfg.be_cn_theta, fixed_cycles=fixed_mg_cycles,
        )
    if not getattr(cfg, "do_sync_proj", True):
        # ns.do_sync_proj=0 debugging toggle: apply the unprojected Vsync
        vel_sync = crse_out.vel + vsync
        p_sync = crse_out.p
        fine_out = fine_new
    elif (eb_c is None) == (eb_f is None):
        # genuine 2-level composite sync projection with the nodal
        # sync-register RHS (MLsyncProject + SyncRegister::InitRHS); EB
        # hierarchies run it with the EB nodal operator (the reference's
        # MLsyncProject over an EB MLNodeLaplacian, Projection.cpp:457-614
        # — refine_cutcells keeps the C-F interface in regular fluid, so
        # the register RHS itself needs no EB weighting)
        from iamr_tpu.amr.sync import (
            sync_project_composite,
            sync_register_rhs,
        )

        if union is not None:
            from iamr_tpu.amr.sync import sync_register_rhs_union

            rhnd = sync_register_rhs_union(
                cfg, spec, cmask, crse_new.vel, fine_avg["vel_new"], dt_c
            )
            u_arg = (union["fmask"], union["nodemask"])
        else:
            rhnd = sync_register_rhs(
                cfg, spec, crse_new.vel, fine_avg["vel_new"], dt_c
            )
            u_arg = None
        vsync_p, vcorr_p, phi_sync, phi_f = sync_project_composite(
            cfg, cfg_f, spec, vsync, crse_out.rho, fine_new.rho, dt_c,
            rhnd=rhnd, fixed_cycles=fixed_mg_cycles, union=u_arg,
            eb_c=eb_c, eb_f=eb_f,
        )
        from iamr_tpu.amr.sync import interp_cell_to_fine_protected

        vel_sync = crse_out.vel + vsync_p
        p_sync = crse_out.p + phi_sync
        fine_out = fine_new._replace(
            vel=fine_new.vel + vcorr_p,
            rho=fine_new.rho
            + interp_cell_to_fine_protected(ssync_rho, fine_new.rho, spec),
            p=fine_new.p + phi_f,
        )
    else:
        # EB: coarse-level sync projection + interpolated fine correction
        vsync_p, phi_sync = sync_project(
            cfg, vsync, crse_out.rho, dt_c, spec, fixed_cycles=fixed_mg_cycles
        )
        vel_sync = crse_out.vel + vsync_p
        p_sync = crse_out.p + phi_sync
        fine_out = fine_new._replace(
            vel=fine_new.vel
            + jnp.stack(
                [interp_cell_to_fine(vsync_p[c], spec) for c in range(dim)]
            ),
            rho=fine_new.rho + interp_cell_to_fine(ssync_rho, spec),
            p=fine_new.p + _prolong_node_patch(phi_sync, spec),
        )
    if eb_c is not None:
        vel_sync = vel_sync * eb_c.fluid
        rho_sync = eb_c.fluid * rho_sync + eb_c.covered * crse_new.rho
    if eb_f is not None:
        fine_out = fine_out._replace(vel=fine_out.vel * eb_f.fluid)
    crse_out = crse_out._replace(
        rho=rho_sync, trac=trac_sync, vel=vel_sync, p=p_sync
    )
    return crse_out, fine_out


def advance_subtree(
    cfgs, specs, states, lev, dt, fixed_mg_cycles=None, hit=None, bcp=None,
    ebs=None, boxlists=None, boxes=None,
):
    """The Amr::timeStep recursion: advance level `lev` by dt, then take
    specs[lev].ratio subcycles of level lev+1 (which recurse further), then
    couple (avgDown + reflux + sync). states: list of per-level NSState;
    specs[k]: the LevelSpec of level k+1 inside level k; cfgs[k]: per-level
    config (make_fine_config cumulatively). Returns (new states, aux of
    this level's advance, per-level subcycle-time-averaged umacs for
    levels lev.. — the composite MAC velocity field tracer particles
    advect with).

    boxlists: optional per-level TRUE box lists — boxlists[k] is the tuple
    of LevelSpec boxes making up level k+1 (fine index units relative to
    level k's patch), with specs[k] their union bounding box. A level with
    >1 box advances as a UNION level (UnionBCProvider: hole cells carry
    coarse-interpolated data, the elliptic solves run union-masked across
    the whole BoxArray like the reference's level-wide MLMG, and congruent
    boxes run the hyperbolic phases batched per box via UnionBoxExec) at
    ANY depth — the reference's BoxArray-of-many-grids data model
    (Docs/Software.rst:356-401) instead of a bounding-box collapse.
    boxes: UnionBoxExec for THIS level's advance (threaded by the parent).
    """
    crse_old = states[lev]
    eb_l = ebs[lev] if ebs else None
    crse_new, aux = advance(
        crse_old._replace(dt=dt), cfgs[lev], fixed_mg_cycles, hit=hit,
        bcp=bcp, return_aux=True, eb=eb_l, boxes=boxes,
    )
    out = list(states)
    out[lev] = crse_new
    umacs = [aux["umac"]]
    if lev + 1 < len(states):
        spec = specs[lev]
        r = spec.ratio
        blist = (
            tuple(boxlists[lev]) if boxlists is not None and boxlists[lev]
            else None
        )
        is_union_child = blist is not None and len(blist) > 1

        def _acc(sums, tree, w):
            """Accumulate w * tree into sums (matching None-preserving
            nested tuples/lists of arrays)."""
            if tree is None:
                return None
            if isinstance(tree, (tuple, list)):
                if sums is None:
                    sums = [None] * len(tree)
                return [
                    _acc(s0, t0, w) for s0, t0 in zip(sums, tree)
                ]
            return w * tree if sums is None else sums + w * tree

        fine_avg = {}
        u_masks = None
        bexec_f = None
        if is_union_child:
            from iamr_tpu.amr.boxbatch import UnionBoxExec, congruent

            if congruent(blist):
                bexec_f = UnionBoxExec(cfgs[lev].geom, blist, bbox=spec)
        for k in range(r):
            if is_union_child:
                from iamr_tpu.ns.bcprovider import UnionBCProvider

                bcp_f = UnionBCProvider(
                    cfgs[lev + 1], spec, blist, cfgs[lev].geom,
                    _interp_states(crse_old, crse_new, k / r),
                    _interp_states(crse_old, crse_new, (k + 1) / r),
                    crse_p=crse_new.p, crse_mac_phi=aux["mac_phi"],
                    crse_umac=aux["umac"],
                )
                u_masks = (bcp_f.cellmask, bcp_f.nodemask)
            else:
                bcp_f = CoarseFineBCProvider(
                    cfgs[lev + 1], spec, cfgs[lev].geom,
                    _interp_states(crse_old, crse_new, k / r),
                    _interp_states(crse_old, crse_new, (k + 1) / r),
                    crse_p=crse_new.p, crse_mac_phi=aux["mac_phi"],
                    crse_umac=aux["umac"],
                )
            out, aux_f, sub_umacs = advance_subtree(
                cfgs, specs, out, lev + 1, dt / r, fixed_mg_cycles, hit,
                bcp=bcp_f, ebs=ebs, boxlists=boxlists, boxes=bexec_f,
            )
            # subcycle time-average of every deeper level's umac
            for j, um in enumerate(sub_umacs):
                if len(umacs) <= 1 + j:
                    umacs.append(tuple(u / r for u in um))
                else:
                    umacs[1 + j] = tuple(
                        acc + u / r for acc, u in zip(umacs[1 + j], um)
                    )
            # time-averaged fine fluxes / fields over the subcycles (the
            # FineAdd * 1/crse_dt_ratio accumulation; Projection.cpp:413-426)
            for key in (
                "flux_rho", "umac", "flux_trac", "flux_vel",
                "vflux_vel", "vflux_trac",
            ):
                fine_avg[key] = _acc(fine_avg.get(key), aux_f[key], 1.0 / r)
            fine_avg["vel_new"] = _acc(
                fine_avg.get("vel_new"), out[lev + 1].vel, 1.0 / r
            )
        u_arg = None
        if is_union_child and u_masks is not None:
            from iamr_tpu.amr.multipatch import union_covered_mask_np

            u_arg = {
                "cmask": jnp.asarray(
                    union_covered_mask_np(blist, cfgs[lev].geom.ncell),
                    crse_new.rho.dtype,
                ),
                "fmask": u_masks[0],
                "nodemask": u_masks[1],
            }
        crse_out, fine_out = _couple_levels(
            cfgs[lev], cfgs[lev + 1], spec, crse_new, aux, out[lev + 1],
            fine_avg, dt, fixed_mg_cycles,
            eb_c=eb_l, eb_f=ebs[lev + 1] if ebs else None, union=u_arg,
            parent_cmask=(
                bcp.cellmask
                if bcp is not None and getattr(bcp, "is_union", False)
                else None
            ),
        )
        out[lev] = crse_out
        out[lev + 1] = fine_out
    return out, aux, umacs


def hierarchy_configs(cfg: NSConfig, specs):
    """Per-level configs from nested LevelSpecs."""
    cfgs = [cfg]
    for spec in specs:
        cfgs.append(make_fine_config(cfgs[-1], spec))
    return cfgs


def advance_hierarchy_subcycled(
    states, cfg: NSConfig, specs, fixed_mg_cycles=None, hit=None, ebs=None,
    return_umacs: bool = False, boxlists=None,
):
    """One coarse step of an arbitrary-depth subcycled hierarchy (levels
    0..len(specs)); computeNewDt-style min over levels with n_factor.
    return_umacs: also return the per-level (subcycle-time-averaged) MAC
    velocities, the field tracer particles advect with.
    boxlists: per-level true box lists (multi-box union levels at any
    depth; see advance_subtree)."""
    cfgs = hierarchy_configs(cfg, specs)
    dt_c = states[0].dt
    out, _, umacs = advance_subtree(
        cfgs, specs, list(states), 0, dt_c, fixed_mg_cycles, hit, ebs=ebs,
        boxlists=boxlists,
    )
    # next dt: min over levels of (prod of ratios up to lev) * est(lev)
    dt_next = est_time_step(cfgs[0], out[0])
    nfac = 1
    for lev in range(1, len(out)):
        nfac *= specs[lev - 1].ratio
        dt_next = jnp.minimum(dt_next, nfac * est_time_step(cfgs[lev], out[lev]))
    dt_next = jnp.minimum(dt_next, cfg.change_max * dt_c)
    result = []
    nfac = 1
    for lev in range(len(out)):
        if lev > 0:
            nfac *= specs[lev - 1].ratio
        result.append(out[lev]._replace(dt=dt_next / nfac))
    if return_umacs:
        return tuple(result), umacs
    return tuple(result)


def advance_two_level_subcycled(
    ml: MLState,
    cfg: NSConfig,
    spec: LevelSpec,
    fixed_mg_cycles: Optional[int] = None,
    hit=None,
):
    """One coarse step with r fine subcycles (the reference's default
    subcycled advance: Amr::timeStep recursion with n_cycle = ref_ratio,
    SURVEY.md section 2.3.6). Fine ghost fills use time-interpolated coarse
    data (FillPatchTwoLevels linear time interp); refluxing uses the
    time-averaged fine interface fluxes; afterwards the sync machinery runs
    (see _couple_levels / iamr_tpu.amr.sync). Depth-1 case of
    advance_hierarchy_subcycled."""
    out = advance_hierarchy_subcycled(
        (ml.crse, ml.fine), cfg, [spec], fixed_mg_cycles, hit
    )
    return MLState(crse=out[0], fine=out[1])


def make_two_level_step(
    cfg: NSConfig, spec: LevelSpec, fixed_mg_cycles=None,
    subcycle: bool = False, ebs=None,
):
    hit = make_hit_forcing(cfg)
    if ebs is not None:
        # EB multilevel runs subcycle (the reference default; the
        # non-subcycled composite path has no EB coupling)
        def fn(ml):
            out = advance_hierarchy_subcycled(
                (ml.crse, ml.fine), cfg, [spec], fixed_mg_cycles, hit,
                ebs=list(ebs),
            )
            return MLState(crse=out[0], fine=out[1])

        return jax.jit(fn)
    fn = advance_two_level_subcycled if subcycle else advance_two_level
    return jax.jit(
        lambda ml: fn(ml, cfg, spec, fixed_mg_cycles, hit=hit)
    )


def make_two_level_step_with_particles(
    cfg: NSConfig, spec: LevelSpec, fixed_mg_cycles=None,
    subcycle: bool = False,
):
    """Two-level step that also advects tracer particles with the
    composite (finest-containing-level) MAC velocities; fine umacs are the
    subcycle time-averages (AmrTracerParticleContainer semantics)."""
    from iamr_tpu.ns.particles import advect_with_umac_levels

    hit = make_hit_forcing(cfg)
    cfg_f = make_fine_config(cfg, spec)

    @jax.jit
    def step(ml, parts):
        dt = ml.crse.dt
        if subcycle:
            out, umacs = advance_hierarchy_subcycled(
                (ml.crse, ml.fine), cfg, [spec], fixed_mg_cycles, hit,
                return_umacs=True,
            )
            new = MLState(crse=out[0], fine=out[1])
        else:
            new, umacs = advance_two_level(
                ml, cfg, spec, fixed_mg_cycles, hit=hit, return_umacs=True
            )
        levels = [(umacs[0], cfg.geom), (umacs[1], cfg_f.geom)]
        parts = advect_with_umac_levels(parts, levels, dt)
        return new, parts

    return step
