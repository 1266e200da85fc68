"""The Navier-Stokes timestep (single level).

JAX re-implementation of NavierStokes::advance (reference
Source/NavierStokes.cpp:542-691; algorithm: Docs TimeStep.rst "Time Step --
Godunov"; Almgren-Bell-Colella-Howell-Welcome JCP 142, 1998):

  1. predict time-centered MAC velocities (Godunov PLM extrapolation with
     forcing (visc + rho g - Gp)/rho; NavierStokesBase.cpp:4376-4512)
  2. MAC-project them (MacProj::mac_project)
  3. Godunov advection of velocity (convective form) and scalars
     (ComputeAofs, NavierStokesBase.cpp:4555-5099)
  4. scalar updates: rho (conservative) then tracers, with semi-implicit CN
     diffusion (scalar_advection_update / scalar_diffusion_update)
  5. velocity update u* = u^n - dt aofs + dt (f - Gp)/rho_half, then CN
     viscous solve (velocity_update, NavierStokesBase.cpp:3487-3655)
  6. nodal approximate projection -> U^{n+1}, p^{n+1/2}, Gp

The whole step is one jit-compiled functional program over dense level
arrays; every stencil/solve is fused XLA. No host round-trips.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from iamr_tpu.parallel.reduce import invariant_mean
from iamr_tpu.core.bc import (
    BCRec,
    DomainBC,
    SCALAR_BC,
    make_bcrec,
    velocity_bcrec,
)
from iamr_tpu.core.fill import fill_ghost
from iamr_tpu.ops.godunov import (
    advect_field,
    compute_edge_states,
    compute_fluxes_and_aofs,
    extrap_vel_to_faces,
    grow_umac_transverse,
)
from iamr_tpu.ops.stencil import cell_to_face
from iamr_tpu.solvers import diffusion as diff
from iamr_tpu.solvers.mac import mac_project
from iamr_tpu.solvers.nodal_proj import level_project
from iamr_tpu.ns.state import NSConfig, NSState


# ---------------------------------------------------------------------------
# helpers


def _vel_bcrecs(cfg: NSConfig):
    return [
        velocity_bcrec(cfg.dom.phys_lo, cfg.dom.phys_hi, c) for c in range(cfg.dim)
    ]


def _scal_bcrec(cfg: NSConfig) -> BCRec:
    return make_bcrec(cfg.dom.phys_lo, cfg.dom.phys_hi, SCALAR_BC)


def _vel_bcvals(cfg: NSConfig, comp: int):
    """ext_dir values for velocity component comp per (dim, side)."""
    lo = tuple(cfg.dom.value(d, 0, comp) for d in range(cfg.dim))
    hi = tuple(cfg.dom.value(d, 1, comp) for d in range(cfg.dim))
    return lo, hi


def _scal_bcvals(cfg: NSConfig, scomp: int):
    """scomp: 0 = density, 1.. = tracers (bc_values layout dim + scomp)."""
    lo = tuple(cfg.dom.value(d, 0, cfg.dim + scomp) for d in range(cfg.dim))
    hi = tuple(cfg.dom.value(d, 1, cfg.dim + scomp) for d in range(cfg.dim))
    return lo, hi


def fill_vel(cfg: NSConfig, vel, ng: int):
    """Grow all velocity components with filled ghosts."""
    recs = _vel_bcrecs(cfg)
    out = []
    for c in range(cfg.dim):
        lo, hi = _vel_bcvals(cfg, c)
        out.append(fill_ghost(vel[c], ng, recs[c], lo, hi))
    return jnp.stack(out)


def fill_scal(cfg: NSConfig, s, ng: int, scomp: int):
    lo, hi = _scal_bcvals(cfg, scomp)
    return fill_ghost(s, ng, _scal_bcrec(cfg), lo, hi)


def mu_faces(cfg: NSConfig):
    """Constant-viscosity face coefficients."""
    n = cfg.geom.ncell
    out = []
    for d in range(cfg.dim):
        shp = list(n)
        shp[d] += 1
        out.append(jnp.full(shp, cfg.vel_visc_coef, dtype=cfg.jdtype))
    return tuple(out)


def beta_faces(cfg: NSConfig, coef: float):
    n = cfg.geom.ncell
    out = []
    for d in range(cfg.dim):
        shp = list(n)
        shp[d] += 1
        out.append(jnp.full(shp, coef, dtype=cfg.jdtype))
    return tuple(out)


def get_force(cfg: NSConfig, rho, time=None, hit=None):
    """Body force (rho-weighted, like the reference's getForce).

    Default: rho * gravity in the last dim (NS_getForce.cpp:121-141).
    HIT: + spectral turbulent forcing evaluated at `time`
    (Tutorials/HIT/NS_getForce.cpp override).
    """
    dim = cfg.dim
    f = [jnp.zeros_like(rho) for _ in range(dim)]
    if abs(cfg.gravity) > 1e-4:
        f[dim - 1] = cfg.gravity * rho
    out = jnp.stack(f)
    if hit is not None and time is not None:
        out = out + hit.eval(cfg.geom, time, dtype=cfg.jdtype)
    return out


def make_hit_forcing(cfg: NSConfig):
    """Build the HIT forcing mode tables when configured (turb.* namespace),
    or a user-registered forcing (prob.forcing = name;
    iamr_tpu.plugins.forcing — the NS_getForce override seam)."""
    from iamr_tpu.plugins import FORCINGS

    if cfg.forcing in FORCINGS:
        return FORCINGS[cfg.forcing](cfg)
    if cfg.forcing != "hit":
        return None
    from iamr_tpu.ns.forcing_hit import HITForcing

    return HITForcing.create(
        cfg.geom,
        nmodes=int(cfg.turb_param("nmodes", 4)),
        div_free=bool(cfg.turb_param("div_free_force", 1)),
        mode_start=int(cfg.turb_param("mode_start", 0)),
        force_scale=float(cfg.turb_param("force_scale", 1.0)),
        seed=int(cfg.turb_param("seed", 111397)),
    )


def visc_terms_vel(cfg: NSConfig, vel):
    """Explicit div mu grad u per component (getViscTerms)."""
    if cfg.vel_visc_coef <= 0.0:
        return jnp.zeros_like(vel)
    mf = mu_faces(cfg)
    recs = _vel_bcrecs(cfg)
    out = []
    for c in range(cfg.dim):
        lo, hi = _vel_bcvals(cfg, c)
        out.append(
            diff.visc_terms_component(vel[c], mf, cfg.geom.dx, recs[c], lo, hi)
        )
    return jnp.stack(out)


def est_time_step(cfg: NSConfig, state: NSState, hit=None):
    """CFL timestep (estTimeStep, NavierStokesBase.cpp:1353-1510):
    dt = cfl * min over cells/dims of dx_d / max|u_d|, plus the force
    limit sqrt(2 dx_d / max|f_d|) with f = (tforces - Gp)/rho evaluated
    per cell (cpp:1436-1447). ns.fixed_dt short-circuits (cpp:1357-1371);
    viscous terms are excluded (CN is unconditionally stable)."""
    if cfg.fixed_dt > 0.0:
        return jnp.asarray(cfg.fixed_dt, dtype=cfg.jdtype)
    dx = cfg.geom.dx
    small = 1e-8
    dt = jnp.asarray(1e20, dtype=cfg.jdtype)
    fallback = jnp.asarray(1e20, dtype=cfg.jdtype)
    tf = get_force(cfg, state.rho, state.time, hit)
    # per-field input-fused max-reductions: XLA fuses abs+max into the
    # producers without materializing a stacked array (max is exactly
    # order-invariant, so the results are bitwise identical)
    inv_rho = 1.0 / state.rho
    ax = tuple(range(1, 1 + cfg.dim))
    maxes = jnp.stack([
        jnp.max(jnp.abs(state.vel), axis=ax),
        jnp.max(jnp.abs((tf - state.gradp) * inv_rho), axis=ax),
        jnp.max(jnp.abs(tf * inv_rho), axis=ax),
    ])
    for d in range(cfg.dim):
        umax = maxes[0, d]
        dt = jnp.where(
            umax > small, jnp.minimum(dt, dx[d] / jnp.maximum(umax, small)), dt
        )
        fmax = maxes[1, d]
        dt = jnp.where(
            fmax > small,
            jnp.minimum(dt, jnp.sqrt(2.0 * dx[d] / jnp.maximum(fmax, small))),
            dt,
        )
        # raw body-force timescale, used ONLY when nothing else bounds dt
        # (the reference aborts and demands ns.init_dt there, cpp:1460-1483;
        # a perfectly balanced quiescent gravity state has tf - Gp = 0)
        fraw = maxes[2, d]
        fallback = jnp.where(
            fraw > small,
            jnp.minimum(
                fallback, jnp.sqrt(2.0 * dx[d] / jnp.maximum(fraw, small))
            ),
            fallback,
        )
    ok = dt < 1e19
    if cfg.init_dt > 0.0:
        return jnp.where(ok, cfg.cfl * dt, cfg.init_dt)
    return cfg.cfl * jnp.where(ok, dt, fallback)


# ---------------------------------------------------------------------------
# the step


def advance(
    state: NSState,
    cfg: NSConfig,
    fixed_mg_cycles: Optional[int] = None,
    hit=None,
    return_umac: bool = False,
    bcp=None,
    return_aux: bool = False,
    eb=None,
    spectral: bool = False,
    boxes=None,
):
    """One timestep: consumes state^n, returns state^{n+1}.

    spectral: all-periodic uniform-rho constant-mu fast path — every
    implicit solve (MAC/nodal projection, CN diffusion) runs in Fourier
    space (solvers.spectral), exactly inverting the same discrete
    operators. Callers decide eligibility host-side before tracing
    (solvers.spectral.spectral_eligible); forced off here for EB/RZ/union
    advances.

    fixed_mg_cycles: when set, all linear solves run a fixed number of
    V-cycles (benchmark mode) instead of tolerance-driven while_loops.
    hit: optional HITForcing mode tables (make_hit_forcing).
    bcp: boundary-condition provider (default PhysBCProvider; fine AMR
    levels pass a CoarseFineBCProvider).
    return_aux: also return {"umac", "mac_phi", "flux_rho", "flux_trac"}
    for particle advection and coarse-fine flux registers.
    boxes: optional amr.boxbatch.UnionBoxExec for a union (bbox) advance of
    a congruent multi-box level — the hyperbolic phases (Godunov extrap +
    advection) then execute per box (gather -> vmap -> scatter, reference
    MFIter-over-BoxArray execution) with bitwise-identical results, while
    the elliptic solves stay on the masked union. Requires a union bcp;
    ignored for EB/RZ/BDS where only the bbox-wide path exists.
    eb: optional EBData cut-cell geometry. The step then follows the
    reference's EB path (EBGodunov + redistribution + MLEB* operators,
    NavierStokesBase.cpp:4477-5001): advective tendencies get the hybrid
    divergence + flux redistribution, the projections and diffusion use
    area/volume-fraction-weighted operators with an implicit EB no-slip
    wall drag, and covered cells carry the body state (vel 0).
    """
    if bcp is None:
        from iamr_tpu.ns.bcprovider import PhysBCProvider

        bcp = PhysBCProvider(cfg)
    # level-wide multi-box union advance (amr/multipatch.py): every elliptic
    # solve runs on the box union with coarse-interpolated interior Dirichlet
    # data in the bbox holes (reference MLMG solves each AMR level across its
    # whole BoxArray, SURVEY.md section 2.2)
    is_union = getattr(bcp, "is_union", False)
    umask = bcp.cellmask if is_union else None
    dim = cfg.dim
    if spectral:
        # under an active multi-chip mesh the FFT solves stay distributed
        # (pencil all_to_all transforms, parallel/pfft.py) when the shapes
        # divide the mesh; otherwise fall back to halo-exchange MG rather
        # than let GSPMD all-gather whole levels around a dense FFT
        from iamr_tpu.parallel.context import active as _mesh_active
        from iamr_tpu.parallel.pfft import pencil_eligible as _pe

        _pm = _mesh_active()
        spectral = (
            eb is None and not is_union
            and cfg.geom.coord_sys == 0 and not cfg.do_les
            and all(cfg.geom.periodic)
            and (_pm is None or _pe(cfg.geom.ncell, _pm))
        )
    dx = cfg.geom.dx
    dt = state.dt
    vel, rho, trac, p, gradp = state.vel, state.rho, state.trac, state.p, state.gradp
    recs = [bcp.vel_bcrec(c) for c in range(dim)]
    periodic = tuple(cfg.geom.periodic)
    scheme = {
        "Godunov_PLM": "plm", "Godunov_PPM": "ppm", "BDS": "bds",
    }.get(cfg.advection_scheme, "plm")
    # diffusion systems are strongly diagonally dominant (alpha = rho/dt
    # >> theta*dt*beta/dx^2 at CFL-limited dt), so in fixed-cycle benchmark
    # mode they get a quarter of the projection V-cycle budget (tolerance
    # mode is unaffected: the while_loop stops itself)
    diff_cycles = (
        None if fixed_mg_cycles is None else max(1, fixed_mg_cycles // 4)
    )
    rz = None
    if cfg.geom.coord_sys == 1:
        # RZ axisymmetric (2D r-z); the reference forbids RZ + viscosity
        # (NavierStokesBase.cpp:246-256)
        if cfg.vel_visc_coef > 0.0 or cfg.do_les:
            raise NotImplementedError("RZ with viscosity is not supported "
                                      "(matches the reference restriction)")
        if eb is not None:
            raise NotImplementedError("RZ + EB not supported")
        import jax.numpy as _jnp

        rc, rf = cfg.geom.rz_radii()
        rz = (_jnp.asarray(rc, cfg.jdtype), _jnp.asarray(rf, cfg.jdtype))
    # BDS applies to advected quantities; MAC prediction stays Godunov
    # (reference passes the scheme only to ComputeFluxesOnBoxFromState,
    # NavierStokesBase.cpp:4654-4656; ExtrapVelToFaces is Godunov-only)
    mac_scheme = "plm" if scheme == "bds" else scheme
    t_half = state.time + 0.5 * dt

    # effective face viscosity: molecular + LES eddy viscosity at t^n
    # (getViscosity + calc_mut_LES hook, NavierStokes.cpp:2139-2152)
    if cfg.do_les:
        from iamr_tpu.ns.les import eddy_viscosity_faces

        mut = eddy_viscosity_faces(cfg, bcp, vel)
        mu_eff = tuple(m + t for m, t in zip(mu_faces(cfg), mut))
    else:
        mu_eff = None

    def _mu():
        return mu_eff if mu_eff is not None else mu_faces(cfg)

    # EB: face-fraction-scaled viscosity, wall-drag coefficient, body fill
    if eb is not None:
        from iamr_tpu.eb.redist import eb_aofs, set_body_state

        ebmul = lambda mf: tuple(m * af for m, af in zip(mf, eb.afrac))
        drag_v = cfg.vel_visc_coef * eb.aeb_vol / eb.d_eb  # mu Aeb/(V d)
        vfs = jnp.maximum(eb.vfrac, 1e-12)

    # --- 1. predict MAC velocities -------------------------------------
    if (cfg.vel_visc_coef > 0.0 or cfg.do_les) and cfg.be_cn_theta != 1.0:
        mf0 = _mu() if eb is None else ebmul(_mu())
        visc = jnp.stack(
            [
                diff.visc_terms_component(
                    vel[c], mf0, dx, recs[c],
                    poisson_bc=bcp.vel_diff_bc(c)[0],
                    poisson_bvals=bcp.vel_diff_bc(c)[1],
                )
                for c in range(dim)
            ]
        )
        if eb is not None:
            # volume-weighted apply -> per-volume term + explicit wall drag
            visc = jnp.stack(
                [eb.fluid * (visc[c] / vfs - drag_v * vel[c]) for c in range(dim)]
            )
        if cfg.do_les and eb is None:
            # variable-viscosity tensor cross terms (MLTensorOp semantics)
            from iamr_tpu.ns.les import tensor_cross_terms

            visc = visc + tensor_cross_terms(cfg, bcp, vel, mf0)
    else:
        visc = jnp.zeros_like(vel)
    tf = get_force(cfg, rho, t_half, hit)
    forcing = (tf + visc - gradp) / rho  # (visc + rho g - Gp)/rho, cpp:4447-4471
    if eb is not None:
        forcing = forcing * eb.fluid
    vel_g = bcp.fill_vel(vel, 3)
    force_g = bcp.fill_force(forcing)
    bcvals_lo = tuple(bcp.vel_bcvals(c)[0] for c in range(dim))
    bcvals_hi = tuple(bcp.vel_bcvals(c)[1] for c in range(dim))
    # reorganize per-dim: extrap wants bcvals_lo[d][c]
    bl = tuple(tuple(bcvals_lo[c][d] for c in range(dim)) for d in range(dim))
    bh = tuple(tuple(bcvals_hi[c][d] for c in range(dim)) for d in range(dim))
    if boxes is not None and (eb is not None or rz is not None):
        boxes = None  # only the bbox-wide path handles EB/RZ
    # batched elliptic solves (gather -> batch MG -> scatter); bitwise
    # hyperbolic-parity tests construct UnionBoxExec(solve_elliptic=False)
    sboxes = (
        boxes if boxes is not None and getattr(boxes, "solve_elliptic", True)
        else None
    )
    if boxes is not None:
        umac = boxes.extrap_batched(
            vel_g, force_g, dt, dx, recs, bl, bh, mac_scheme,
            cfg.use_forces_in_trans,
        )
    else:
        umac = extrap_vel_to_faces(
            vel_g, force_g, dt, dx, cfg.geom.ncell, recs, bl, bh,
            use_forces_in_trans=cfg.use_forces_in_trans, scheme=mac_scheme,
        )

    # --- 2. MAC projection ---------------------------------------------
    # thermal divergence source S = div(lambda/cp grad T)/(rho T)
    # (calc_divu, NavierStokes.cpp:1879-1957)
    divu_src = None
    if cfg.do_temp and cfg.temp_cond_coef > 0.0:
        lam = beta_faces(cfg, cfg.temp_cond_coef)
        tbc, tbv = bcp.temp_diff_bc()
        lapT = diff.visc_terms_component(
            state.temp, lam, dx, bcp._temp_rec, poisson_bc=tbc, poisson_bvals=tbv
        )
        divu_src = lapT / (rho * state.temp)

    # MAC RHS time-centering: divu + dt/2 * dsdt with dsdt from the
    # previous step (create_mac_rhs, NavierStokes.cpp:594-641)
    mac_divu = divu_src
    if divu_src is not None and state.dsdt is not None:
        mac_divu = divu_src + 0.5 * dt * state.dsdt

    mac_bc, mac_bvals = bcp.mac_bc()
    if cfg.do_mac_proj:
        umac, mac_phi, _ = mac_project(
            umac, rho, cfg.dom, dx, divu_src=mac_divu,
            rtol=cfg.mac_tol, atol=cfg.mac_abs_tol,
            fixed_cycles=fixed_mg_cycles,
            bc=mac_bc, bvals=mac_bvals, eb=eb, rz=rz,
            interior_mask=umask,
            interior_vals=bcp.union_vals_mac() if is_union else None,
            spectral_beta0=(1.0 / invariant_mean(rho)) if spectral else None,
            boxes=sboxes,
        )
    else:
        # ns.do_mac_proj=0 debugging toggle: advect with the predicted
        # (unprojected) MAC velocities (NavierStokes.cpp do_mac_proj)
        mac_phi = jnp.zeros(tuple(cfg.geom.ncell), cfg.jdtype)
    if boxes is not None and is_union:
        # box-batched extrap never computed strictly-hole faces; give them
        # the same coarse-interpolated values grow_umac pastes so the
        # normal-grown ghosts (umac_n) and aux consumers (particles, sync
        # registers) see the union path's data bitwise
        umac = bcp.paste_hole_faces(umac)
    umac_g = bcp.grow_umac(umac)

    # box-batched advection (amr/boxbatch.py): one vmapped advect per field
    # over all boxes; BDS falls back to the bbox-wide path (its corner
    # coupling needs the periodic wrap advect_field owns)
    adv_batched = boxes is not None and scheme in ("plm", "ppm")
    if adv_batched:
        from iamr_tpu.amr.boxbatch import grow_umac_normal_union

        umac_n = grow_umac_normal_union(umac, periodic)

    # fills for every advected field up front (pure functions of state^n)
    mom_diff = cfg.do_mom_diff
    rho_g = bcp.fill_scal(rho, 3, 0)
    trac_gs = [bcp.fill_scal(trac[t], 3, 1 + t) for t in range(cfg.ntrac)]
    t_g = bcp.fill_temp(state.temp, 3) if cfg.do_temp else None

    if eb is not None and cfg.use_forces_in_trans:
        # match the reference abort (NavierStokesBase.cpp:566-567)
        raise NotImplementedError(
            "use_forces_in_trans not implemented within EB Godunov. "
            "Set godunov.use_forces_in_trans=0."
        )

    def _adv(s_g_, icons, s_cc_=None, fg_=None):
        """Advect one field (edge states, fluxes, aofs)."""
        if adv_batched:
            return boxes.advect_batched(
                s_g_, umac, umac_g, umac_n, dt, dx, icons, s_cc=s_cc_,
                force_g=fg_, scheme=scheme,
            )
        return advect_field(
            s_g_, umac, umac_g, dt, dx, cfg.geom.ncell, icons, s_cc=s_cc_,
            force_g=fg_, periodic=periodic, scheme=scheme, rz=rz, eb=eb,
            use_forces_in_trans=cfg.use_forces_in_trans,
        )

    # --- 3. velocity advection -------------------------------------------
    # convective form by default; ns.do_mom_diff=1 advects momentum rho*U
    # conservatively (velocity_advection, NavierStokesBase.cpp:3358-3485;
    # mom-diff update divides by rho^{n+1} in velocity_advection_update,
    # cpp:3523-3626)
    aofs_vel = []
    flux_vel = []
    for c in range(dim):
        sg = vel_g[c] if not mom_diff else rho_g * vel_g[c]
        fl, a = _adv(
            sg, mom_diff, s_cc_=vel[c] if not mom_diff else None,
            fg_=force_g[c],
        )
        if eb is not None:
            a = eb_aofs(
                fl, umac, eb, dx, mom_diff,
                s_cc=vel[c] if not mom_diff else rho * vel[c],
                periodic=periodic, rtype=cfg.redist_type, dt=dt,
            )
        aofs_vel.append(a)
        flux_vel.append(fl)
    aofs_vel = jnp.stack(aofs_vel)

    # --- 4. scalar advection + updates ----------------------------------
    # density: conservative, no forcing
    flux_rho, aofs_rho = _adv(rho_g, True)
    if eb is not None:
        aofs_rho = eb_aofs(
            flux_rho, umac, eb, dx, True, s_cc=rho, periodic=periodic,
            rtype=cfg.redist_type, dt=dt,
        )
    rho_new = rho - dt * aofs_rho
    if cfg.do_denminmax:
        rho_new = _scal_min_max(rho_g, rho_new)
    if eb is not None:
        rho_new = set_body_state(rho_new, eb) + eb.covered * rho
    rho_half = 0.5 * (rho + rho_new)

    # tracers: convective by default (do_cons_trac for conservative)
    trac_new = []
    flux_trac = []
    vflux_trac = []
    for t in range(cfg.ntrac):
        s = trac[t]
        s_g = trac_gs[t]
        icons = cfg.do_cons_trac
        flux_s, aofs_s = _adv(s_g, icons, s_cc_=s)
        if eb is not None:
            aofs_s = eb_aofs(
                flux_s, umac, eb, dx, icons, s_cc=s, periodic=periodic,
                rtype=cfg.redist_type, dt=dt,
            )
        flux_trac.append(flux_s)
        s_star = s - dt * aofs_s
        coef = cfg.scal_diff_coefs[t] if t < len(cfg.scal_diff_coefs) else 0.0
        if coef > 0.0:
            sbc, sbv = bcp.scal_diff_bc(1 + t)
            bcoef = beta_faces(cfg, coef)
            if eb is None:
                s_star, _ = diff.diffuse_scalar(
                    s_star, s, rho_new, rho, bcoef, dt, dx,
                    bcp._scal_rec, theta=cfg.be_cn_theta,
                    rtol=cfg.visc_tol, fixed_cycles=diff_cycles,
                    poisson_bc=sbc, poisson_bvals=sbv,
                    interior_mask=umask,
                    interior_vals=(
                        bcp.union_vals_scal(1 + t) if is_union else None
                    ),
                    spectral=(
                        (invariant_mean(rho_new), coef) if spectral else None
                    ),
                    boxes=sboxes,
                )
            else:
                # volume-weighted EB operator; no-flux at the EB wall
                a_rhs = eb.vfrac * rho_new + eb.covered
                s_star, _ = diff.diffuse_scalar(
                    eb.fluid * s_star, eb.fluid * s, a_rhs,
                    eb.vfrac * rho + eb.covered, ebmul(bcoef), dt, dx,
                    bcp._scal_rec, theta=cfg.be_cn_theta,
                    rtol=cfg.visc_tol, fixed_cycles=diff_cycles,
                    poisson_bc=sbc, poisson_bvals=sbv,
                )
        if eb is not None:
            s_star = eb.fluid * s_star + eb.covered * s
        # CN viscous flux for the coarse-fine viscous flux registers
        # (scalar_diffusion_update register increments,
        # NavierStokes.cpp:949-994): F = -beta grad((1-th)s^n + th s^{n+1})
        if return_aux and coef > 0.0 and eb is None:
            th = cfg.be_cn_theta
            from iamr_tpu.ops import mg as _mg

            sbc_, sbv_ = bcp.scal_diff_bc(1 + t)
            vflux_trac.append(
                _mg.get_fluxes(
                    (1.0 - th) * s + th * s_star, bcoef, 1.0, dx, sbc_,
                    bvals=sbv_,
                )
            )
        else:
            vflux_trac.append(None)
        trac_new.append(s_star)
    trac_new = jnp.stack(trac_new)

    # --- 4b. temperature: advect (convective) + CN conduction -------------
    temp_new = state.temp
    if cfg.do_temp:
        flux_t, aofs_t = _adv(t_g, False, s_cc_=state.temp)
        if eb is not None:
            aofs_t = eb_aofs(
                flux_t, umac, eb, dx, False, s_cc=state.temp,
                periodic=periodic, rtype=cfg.redist_type, dt=dt,
            )
        temp_new = state.temp - dt * aofs_t
        if cfg.temp_cond_coef > 0.0:
            tbc, tbv = bcp.temp_diff_bc()
            # rho cp dT/dt = div lambda grad T -> alpha = rho (cp folded
            # into temp_cond_coef = lambda/cp, NavierStokes.cpp:2061-2187)
            lamf = beta_faces(cfg, cfg.temp_cond_coef)
            a_new, a_old = rho_new, rho
            if eb is not None:
                lamf = ebmul(lamf)
                a_new = eb.vfrac * rho_new + eb.covered
                a_old = eb.vfrac * rho + eb.covered
            temp_new, _ = diff.diffuse_scalar(
                temp_new, state.temp, a_new, a_old, lamf, dt, dx,
                bcp._temp_rec, theta=cfg.be_cn_theta,
                rtol=cfg.visc_tol, fixed_cycles=diff_cycles,
                poisson_bc=tbc, poisson_bvals=tbv,
                interior_mask=umask,
                interior_vals=bcp.union_vals_temp() if is_union else None,
                spectral=(
                    (invariant_mean(a_new), cfg.temp_cond_coef) if spectral else None
                ),
                boxes=sboxes,
            )
        if eb is not None:
            temp_new = eb.fluid * temp_new + eb.covered * state.temp

    # --- 5. velocity update + CN viscous solve ---------------------------
    tf_half = get_force(cfg, rho_half, t_half, hit)
    if mom_diff:
        # (rho u)^* = rho^n u^n - dt div(rho u u_mac) + dt (F - Gp);
        # u* = (rho u)^*/rho^{n+1}
        vel_star = jnp.stack(
            [
                (rho * vel[c] - dt * aofs_vel[c] + dt * (tf_half[c] - gradp[c]))
                / rho_new
                for c in range(dim)
            ]
        )
    else:
        vel_star = jnp.stack(
            [
                vel[c] - dt * aofs_vel[c] + dt * (tf_half[c] - gradp[c]) / rho_half
                for c in range(dim)
            ]
        )
    if eb is not None:
        vel_star = vel_star * eb.fluid
    if cfg.vel_visc_coef > 0.0 or cfg.do_les:
        mf = _mu()
        alpha = rho_half / dt
        theta = cfg.be_cn_theta
        if cfg.do_les and eb is None:
            # variable viscosity: FULL implicit tensor solve (MLTensorOp
            # semantics, Diffusion.cpp:713-958) — cross terms inside the
            # CN operator via segregated outer iteration
            from iamr_tpu.solvers.tensor import diffuse_tensor_velocity

            vel_star = diffuse_tensor_velocity(
                cfg, bcp, vel_star, vel, rho_half, mf, dt, theta,
                rtol=cfg.visc_tol, fixed_cycles=diff_cycles,
            )
        elif eb is None and spectral:
            # all-periodic constant-mu: batch the 3 component Helmholtz
            # solves into ONE vmapped spectral solve (one batched rfftn
            # instead of 3 separate transforms)
            vbc, vbv = bcp.vel_diff_bc(0)
            sp_args = (invariant_mean(alpha), cfg.vel_visc_coef)

            def _cn_one(ss, so):
                return diff.diffuse_scalar(
                    ss, so, alpha, alpha, mf, 1.0, dx, recs[0], theta=theta,
                    rtol=cfg.visc_tol, fixed_cycles=diff_cycles,
                    poisson_bc=vbc, poisson_bvals=vbv, spectral=sp_args,
                )[0]

            vel_star = jax.vmap(_cn_one)(vel_star, vel)
        elif eb is None:
            comps = []
            for c in range(dim):
                vbc, vbv = bcp.vel_diff_bc(c)
                u_new, _ = diff.diffuse_scalar(
                    vel_star[c], vel[c], alpha, alpha, mf,
                    1.0,  # dt folded into alpha: (alpha - theta*L), alpha=rho/dt
                    dx, recs[c], theta=theta,
                    rtol=cfg.visc_tol, fixed_cycles=diff_cycles,
                    poisson_bc=vbc, poisson_bvals=vbv,
                    interior_mask=umask,
                    interior_vals=(
                        bcp.union_vals_vel(c) if is_union else None
                    ),
                    boxes=sboxes,
                )
                comps.append(u_new)
            vel_star = jnp.stack(comps)
        else:
            # EB: volume-weighted MLEB operator + implicit no-slip wall drag
            # (theta-weighted like the interior CN terms)
            a_rhs = eb.vfrac * alpha + eb.covered
            a_op = a_rhs + theta * drag_v
            mf = ebmul(mf)
            comps = []
            for c in range(dim):
                vbc, vbv = bcp.vel_diff_bc(c)
                # CN explicit half of the wall drag moves into the rhs via
                # s_star (rhs = a_rhs*s_star' = a_rhs*s* - (1-th)*drag*u^n)
                vs = vel_star[c] - (1.0 - theta) * drag_v * vel[c] / a_rhs
                u_new, _ = diff.diffuse_scalar(
                    vs, eb.fluid * vel[c], a_rhs, a_rhs, mf,
                    1.0, dx, recs[c], theta=theta,
                    rtol=cfg.visc_tol, fixed_cycles=diff_cycles,
                    poisson_bc=vbc, poisson_bvals=vbv, alpha_op=a_op,
                )
                comps.append(u_new * eb.fluid)
            vel_star = jnp.stack(comps)

    # CN viscous fluxes for the velocity viscous flux registers
    # (diffuse_velocity register increments)
    vflux_vel = None
    if (
        return_aux
        and (cfg.vel_visc_coef > 0.0 or cfg.do_les)
        and eb is None
    ):
        from iamr_tpu.ops import mg as _mg

        th = cfg.be_cn_theta
        mfv = _mu()
        vflux_vel = []
        for c in range(dim):
            vbc, vbv = bcp.vel_diff_bc(c)
            vflux_vel.append(
                _mg.get_fluxes(
                    (1.0 - th) * vel[c] + th * vel_star[c], mfv, 1.0, dx,
                    vbc, bvals=vbv,
                )
            )
        if cfg.do_les:
            # the tensor solve's registers carry the FULL stress flux
            # mu (grad u + grad u^T) (reference computeExtensiveFluxes,
            # Diffusion.cpp:1463-1539): add the theta-weighted transpose
            # (cross) fluxes so variable-mu/LES C-F refluxing is exact
            from iamr_tpu.ns.les import tensor_cross_fluxes

            u_th = (1.0 - th) * vel + th * vel_star
            xf = tensor_cross_fluxes(cfg, bcp, u_th, mfv)
            vflux_vel = [
                tuple(f + x for f, x in zip(vflux_vel[c], xf[c]))
                for c in range(dim)
            ]

    # --- 6. nodal projection ---------------------------------------------
    divu_new = None
    if cfg.do_temp and cfg.temp_cond_coef > 0.0:
        lam = beta_faces(cfg, cfg.temp_cond_coef)
        tbc, tbv = bcp.temp_diff_bc()
        lapT_new = diff.visc_terms_component(
            temp_new, lam, dx, bcp._temp_rec, poisson_bc=tbc, poisson_bvals=tbv
        )
        divu_new = lapT_new / (rho_new * temp_new)
    nodal_bc_, nodal_phi_bc = bcp.nodal()
    if nodal_phi_bc is None and abs(cfg.gravity) > 1e-4:
        from iamr_tpu.core.bc import PhysBC
        from iamr_tpu.solvers.nodal_proj import hydrostatic_phi_bc

        if any(
            p == PhysBC.Outflow
            for p in list(cfg.dom.phys_lo) + list(cfg.dom.phys_hi)
        ):
            nodal_phi_bc = hydrostatic_phi_bc(
                cfg.geom, cfg.dom, rho_half, cfg.gravity
            )
    vel_new, p_new, gradp_new, _ = level_project(
        vel_star, rho_half, p, gradp, dt, cfg.dom, dx,
        rtol=cfg.proj_tol, atol=cfg.proj_abs_tol, fixed_cycles=fixed_mg_cycles,
        bc=nodal_bc_, phi_bc=nodal_phi_bc, divu_src=divu_new, eb=eb, rz=rz,
        union=(bcp.cellmask, bcp.nodemask) if is_union else None,
        spectral_sigma0=(1.0 / invariant_mean(rho_half)) if spectral else None,
        boxes=sboxes,
    )

    # dsdt for the next step's MAC RHS (calc_dsdt, NavierStokes.cpp:631-641)
    dsdt_new = None
    if divu_new is not None and divu_src is not None:
        dsdt_new = (divu_new - divu_src) / dt

    # box-batched advance: the hyperbolic phases never computed hole cells
    # (bbox minus the box union), so give them well-defined time-correct
    # coarse data — holes only feed the masked solves' coefficients and the
    # next fill re-pastes them anyway (UnionBCProvider._paste_holes)
    if boxes is not None and is_union:
        cm = bcp.cellmask > 0.0
        rho_new = jnp.where(cm, rho_new, bcp.union_vals_scal(0))
        vel_new = jnp.stack(
            [jnp.where(cm, vel_new[c], bcp.union_vals_vel(c)) for c in range(dim)]
        )
        trac_new = jnp.stack(
            [
                jnp.where(cm, trac_new[t], bcp.union_vals_scal(1 + t))
                for t in range(cfg.ntrac)
            ]
        )
        if cfg.do_temp:
            temp_new = jnp.where(cm, temp_new, bcp.union_vals_temp())

    # --- next dt ----------------------------------------------------------
    new_state = NSState(
        vel=vel_new,
        rho=rho_new,
        trac=trac_new,
        temp=temp_new,
        p=p_new,
        gradp=gradp_new,
        time=state.time + dt,
        dt=dt,
        dsdt=dsdt_new,
    )
    dt_next = est_time_step(cfg, new_state, hit)
    dt_next = jnp.minimum(dt_next, cfg.change_max * dt)
    new_state = new_state._replace(dt=dt_next)
    if return_aux:
        aux = {
            "umac": umac,
            "mac_phi": mac_phi,
            "flux_rho": flux_rho,
            "flux_trac": tuple(flux_trac),
            "flux_vel": tuple(flux_vel),
            "vflux_vel": tuple(vflux_vel) if vflux_vel is not None else None,
            "vflux_trac": tuple(vflux_trac),
        }
        return new_state, aux
    if return_umac:
        return new_state, umac
    return new_state


def _scal_min_max(s_g, s_new):
    """Clamp each new value to the 3x3(x3) old-neighborhood min/max
    (ConvectiveScalMinMax, NavierStokesBase.cpp:4256-4368)."""
    dim = s_new.ndim
    ng = (s_g.shape[0] - s_new.shape[0]) // 2
    lo = hi = None
    import itertools

    for off in itertools.product((-1, 0, 1), repeat=dim):
        sl_ = s_g[
            tuple(
                slice(ng + off[d], ng + off[d] + s_new.shape[d]) for d in range(dim)
            )
        ]
        lo = sl_ if lo is None else jnp.minimum(lo, sl_)
        hi = sl_ if hi is None else jnp.maximum(hi, sl_)
    return jnp.clip(s_new, lo, hi)


def make_step(cfg: NSConfig, fixed_mg_cycles: Optional[int] = None, eb=None,
              spectral: bool = False):
    """jit-compiled step function closed over the static config."""
    hit = make_hit_forcing(cfg)
    return jax.jit(lambda s: advance(s, cfg, fixed_mg_cycles, hit=hit, eb=eb,
                                     spectral=spectral))


def make_step_with_particles(cfg: NSConfig, fixed_mg_cycles: Optional[int] = None,
                             spectral: bool = False):
    """Step that also advects tracer particles with the step's MAC
    velocities (AdvectWithUmac in advance, NavierStokes.cpp:672-677)."""
    from iamr_tpu.ns.particles import advect_with_umac

    hit = make_hit_forcing(cfg)

    @jax.jit
    def step(state, parts):
        new_state, umac = advance(
            state, cfg, fixed_mg_cycles, hit=hit, return_umac=True,
            spectral=spectral,
        )
        parts = advect_with_umac(parts, umac, state.dt, cfg.geom)
        return new_state, parts

    return step
