"""Godunov PLM advection: MAC velocity prediction and scalar edge states.

JAX equivalent of AMReX-Hydro's Godunov kernels (reference call sites:
Source/NavierStokesBase.cpp:4477-4491 ExtrapVelToFaces,
NavierStokesBase.cpp:4701-4820 ComputeFluxesOnBoxFromState/ComputeDivergence/
ComputeConvectiveTerm). Implements the corner-transport-upwind scheme of
Almgren-Bell-Colella-Howell-Welcome (JCP 142, 1998) with 4th-order
monotonicity-limited slopes:

  1. limited slopes of each quantity in each dim,
  2. normal predictor: characteristic extrapolation of L/R states to faces
     at t + dt/2,
  3. transverse corrections using upwinded "hat" states on transverse faces,
  4. Riemann upwinding at the face.

All arrays are dense level arrays; inputs arrive pre-grown with filled ghost
cells (nghost_state = 3, reference NavierStokesBase.cpp:4539-4547;
nghost_force = 1). Every step is a fused elementwise stencil over the whole
level; no per-box loops.

Conventions: cell quantities grown by ng ghosts have shape n+2ng; face-d
arrays on the real domain have shape n_d+1 in dim d and n_e in dims e != d.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax.numpy as jnp

from iamr_tpu.core.bc import BCRec, MathBC
from iamr_tpu.ops.stencil import sl


def _shift(a, d, off, extent):
    """Slice of length `extent` along d starting at offset `off`."""
    return sl(a, d, off, off + extent)


def slope2(qg, d):
    """2nd-order monotonized-central limited slope along d.

    Input extent m in dim d; output extent m-2 (valid where i +/- 1 exist).
    """
    m = qg.shape[d]
    c = _shift(qg, d, 1, m - 2)
    lo = _shift(qg, d, 0, m - 2)
    hi = _shift(qg, d, 2, m - 2)
    dc = 0.5 * (hi - lo)
    dl = 2.0 * (c - lo)
    dr = 2.0 * (hi - c)
    dlim = jnp.minimum(jnp.abs(dl), jnp.abs(dr))
    dlim = jnp.where(dl * dr > 0.0, dlim, 0.0)
    return jnp.sign(dc) * jnp.minimum(jnp.abs(dc), dlim)


def slope4(qg, d):
    """4th-order MC limited slope along d (input extent m -> output m-4)."""
    m = qg.shape[d]
    s2 = slope2(qg, d)  # extent m-2, centered at cells 1..m-2
    c = _shift(qg, d, 2, m - 4)
    lo = _shift(qg, d, 1, m - 4)
    hi = _shift(qg, d, 3, m - 4)
    s2_lo = _shift(s2, d, 0, m - 4)
    s2_hi = _shift(s2, d, 2, m - 4)
    dc = (4.0 / 3.0) * 0.5 * (hi - lo) - (1.0 / 6.0) * (s2_hi + s2_lo)
    dl = 2.0 * (c - lo)
    dr = 2.0 * (hi - c)
    dlim = jnp.minimum(jnp.abs(dl), jnp.abs(dr))
    dlim = jnp.where(dl * dr > 0.0, dlim, 0.0)
    return jnp.sign(dc) * jnp.minimum(jnp.abs(dc), dlim)


def slope4_eb(qg, d, fluid_g):
    """Near-wall-aware limited slope (input extent m -> output m-4).

    The reference's EBGodunov reconstructs near-wall slopes with a
    least-squares fit over UNCOVERED neighbors instead of the regular
    4th-order stencil (AMReX-Hydro EBGodunov slopes; IAMR call site
    NavierStokesBase.cpp:4477-4480). Dense equivalent: away from the body
    the standard slope4; where any cell of the 5-point stencil is covered,
    fall back to the validity-masked 1D fit — central difference when both
    face neighbors are fluid, one-sided when one is, zero when isolated —
    with monotonized-central limiting over the valid sides. Covered cells
    themselves get zero slope."""
    m = qg.shape[d]
    s4 = slope4(qg, d)
    # masked slope at cells 2..m-2 (extent m-4)
    c = _shift(qg, d, 2, m - 4)
    lo = _shift(qg, d, 1, m - 4)
    hi = _shift(qg, d, 3, m - 4)
    f_c = _shift(fluid_g, d, 2, m - 4)
    f_lo = _shift(fluid_g, d, 1, m - 4)
    f_hi = _shift(fluid_g, d, 3, m - 4)
    both = (f_lo > 0.0) & (f_hi > 0.0)
    dc = jnp.where(
        both,
        0.5 * (hi - lo),
        jnp.where(f_hi > 0.0, hi - c, jnp.where(f_lo > 0.0, c - lo, 0.0)),
    )
    dl = jnp.where(f_lo > 0.0, 2.0 * (c - lo), jnp.inf)
    dr = jnp.where(f_hi > 0.0, 2.0 * (hi - c), jnp.inf)
    dlim = jnp.minimum(jnp.abs(dl), jnp.abs(dr))
    ok = jnp.where(both, dl * dr > 0.0, True)
    dlim = jnp.where(ok, dlim, 0.0)
    s_m = jnp.sign(dc) * jnp.minimum(jnp.abs(dc), dlim)
    s_m = s_m * f_c
    # near-wall: any covered cell within the 5-point stencil
    near = jnp.zeros_like(f_c, dtype=bool)
    for o in range(5):
        near = near | (_shift(fluid_g, d, o, m - 4) == 0.0)
    return jnp.where(near, s_m, s4)


def ppm_lr(q3, d, cfl_L, cfl_R):
    """PPM (Colella-Woodward 1984) normal predictor: L/R face states.

    q3: quantity with 3 ghosts in dim d (extent n_d+6) and ng=1 transverse
    extents matching the face arrays. cfl_L/cfl_R: nonnegative CFL numbers
    of the L (from below) and R (from above) characteristics on the n_d+1
    faces of the ng=1 region (extent n_d+3 cells -> n_d+1 interior... faces
    between consecutive ng=1 cells).

    Matches AMReX-Hydro Godunov_PPM.H: 4th-order interface interpolation,
    the CW monotonization, and the parabola integral over the domain of
    dependence. Returns (pL, pR) with extent n_d+1 in d.
    """
    m = q3.shape[d]
    # 4th-order interface values on faces k+1/2 for k = 1..m-3
    s_k = _shift(q3, d, 1, m - 3)
    s_kp = _shift(q3, d, 2, m - 3)
    s_km = _shift(q3, d, 0, m - 3)
    s_kpp = _shift(q3, d, 3, m - 3)
    sface = (7.0 / 12.0) * (s_k + s_kp) - (1.0 / 12.0) * (s_km + s_kpp)
    # clamp interface values between the adjacent cell averages (limiter)
    smin = jnp.minimum(s_k, s_kp)
    smax = jnp.maximum(s_k, s_kp)
    sface = jnp.clip(sface, smin, smax)

    # per-cell (s_minus, s_plus) for cells 2..m-3 (extent m-4 = ng=1 cells)
    mf = sface.shape[d]
    sm = _shift(sface, d, 0, mf - 1)
    sp = _shift(sface, d, 1, mf - 1)
    c = _shift(q3, d, 2, m - 4)

    # CW monotonization
    extremum = (sp - c) * (c - sm) <= 0.0
    sm = jnp.where(extremum, c, sm)
    sp = jnp.where(extremum, c, sp)
    delta = sp - sm
    s6 = 6.0 * (c - 0.5 * (sm + sp))
    over_p = delta * s6 > delta * delta
    over_m = -delta * delta > delta * s6
    sm = jnp.where(over_p, 3.0 * c - 2.0 * sp, sm)
    sp = jnp.where(over_m, 3.0 * c - 2.0 * sm, sp)
    delta = sp - sm
    s6 = 6.0 * (c - 0.5 * (sm + sp))

    # trace to faces at t+dt/2: face between ng=1 cells k (L) and k+1 (R)
    mc = c.shape[d]  # n_d + 2
    spL = _shift(sp, d, 0, mc - 1)
    dL = _shift(delta, d, 0, mc - 1)
    s6L = _shift(s6, d, 0, mc - 1)
    smR = _shift(sm, d, 1, mc - 1)
    dR = _shift(delta, d, 1, mc - 1)
    s6R = _shift(s6, d, 1, mc - 1)
    pL = spL - 0.5 * cfl_L * (dL - (1.0 - 2.0 * cfl_L / 3.0) * s6L)
    pR = smR + 0.5 * cfl_R * (dR + (1.0 - 2.0 * cfl_R / 3.0) * s6R)
    return pL, pR


def _trim(a, keep_ng, have_ng, dims=None):
    """Trim a grown array from have_ng to keep_ng ghosts (per selected dims)."""
    dim = a.ndim
    cut = have_ng - keep_ng
    idx = []
    for d in range(dim):
        if dims is None or d in dims:
            idx.append(slice(cut, a.shape[d] - cut))
        else:
            idx.append(slice(None))
    return a[tuple(idx)]


def _riemann_self(ul, ur):
    """Upwind state for self-advected normal velocity (Burgers Riemann):
    ul if compression moves right, ur if left, 0 at expansions/ties —
    the reference's thresholded pick (AMReX-Hydro Godunov; the round-4
    tie-band ε-blend was reverted: it did not close the sharded-layout
    outlier class it targeted and cost six orders of cross-path exactness
    — see tests/test_parallel.py for the honest sharded contract)."""
    avg = ul + ur
    out = jnp.where((ul > 0.0) & (avg > 0.0), ul, 0.0)
    out = jnp.where((ur < 0.0) & (avg < 0.0), ur, out)
    return out


def _upwind(sl_, sr, speed, eps=1e-14):
    small = jnp.abs(speed) < eps
    out = jnp.where(speed > 0.0, sl_, sr)
    return jnp.where(small, 0.5 * (sl_ + sr), out)


def extrap_vel_to_faces(
    vel_g,
    force_g,
    dt: float,
    dx: Sequence[float],
    ncell: Sequence[int],
    bcrecs: Sequence[BCRec],
    bcvals_lo,
    bcvals_hi,
    use_forces_in_trans: bool = False,
    scheme: str = "plm",
):
    """Predict time-centered normal velocities on faces (the MAC velocities).

    vel_g: (dim, n+6, ...) velocity with 3 filled ghosts per dim
    force_g: (dim, n+2, ...) force (tf + visc - gradp)/rho with 1 ghost
    bcrecs[c]: BCRec for velocity component c; bcvals_lo/hi[(d)][c]: ext_dir
    values used to pin faces on inflow/no-slip boundaries.

    Returns tuple of face arrays u_mac[d] with shape n_d+1 in dim d.
    """
    dim = vel_g.shape[0]
    ng = 3
    n = tuple(ncell)

    # use_forces_in_trans=true moves the 0.5*dt*f term from the final face
    # states into the normal-predictor (hat) states feeding the transverse
    # terms (AMReX-Hydro Godunov semantics; IAMR plumbs it at
    # NavierStokesBase.cpp:556-557,4491).

    # limited slopes of every component in every dim, on the ng=1 region
    # slope4 output has ghost extent ng-2 = 1 in its own dim; trim others to 1
    slopes = [[None] * dim for _ in range(dim)]  # [comp][dir]
    if scheme != "ppm":
        for c in range(dim):
            for d in range(dim):
                s = slope4(vel_g[c], d)  # ng-2 ghosts in d, ng elsewhere
                s = _trim(s, 1, ng, dims=[e for e in range(dim) if e != d])
                slopes[c][d] = s  # now ng=1 in every dim: extent n+2

    vel_1 = jnp.stack([_trim(vel_g[c], 1, ng) for c in range(dim)])  # ng=1

    # --- hat states: normal predictor + Riemann, on faces of the ng=1 region
    # hat[d][c]: component c predicted to d-faces; extent n_d+1 in d
    # (real faces), n_e+2 in e != d (one ghost row for transverse terms)
    hat = [[None] * dim for _ in range(dim)]
    for d in range(dim):
        m = vel_1[0].shape[d]  # n_d + 2
        un_L = _shift(vel_1[d], d, 0, m - 1)
        un_R = _shift(vel_1[d], d, 1, m - 1)
        for c in range(dim):
            if scheme == "ppm":
                q3 = _trim(
                    vel_g[c], 1, ng, dims=[e for e in range(dim) if e != d]
                )
                cl = dt / dx[d] * jnp.maximum(un_L, 0.0)
                cr = dt / dx[d] * jnp.maximum(-un_R, 0.0)
                hat[d][c] = ppm_lr(q3, d, cl, cr)
                continue
            q = vel_1[c]
            sq = slopes[c][d]
            # L from cell k, R from cell k+1, faces between all adjacent
            # ng=1 cells: extent m-1 = n_d+1 real faces (ghost-to-real faces
            # at each end are the domain boundary faces)
            qL_c = _shift(q, d, 0, m - 1)
            qR_c = _shift(q, d, 1, m - 1)
            sL = _shift(sq, d, 0, m - 1)
            sR = _shift(sq, d, 1, m - 1)
            cfl_L = dt / dx[d] * jnp.maximum(un_L, 0.0)
            cfl_R = dt / dx[d] * jnp.minimum(un_R, 0.0)
            qL = qL_c + 0.5 * (1.0 - cfl_L) * sL
            qR = qR_c - 0.5 * (1.0 + cfl_R) * sR
            hat[d][c] = (qL, qR)
        if use_forces_in_trans:
            # forces enter the predictor states (and thus the transverse
            # terms) instead of the final face states
            for c in range(dim):
                qL, qR = hat[d][c]
                fL = _shift(force_g[c], d, 0, m - 1)
                fR = _shift(force_g[c], d, 1, m - 1)
                hat[d][c] = (qL + 0.5 * dt * fL, qR + 0.5 * dt * fR)

    # Riemann-resolved hat values (advective face velocities + upwinded
    # transverse components)
    hat_vel = [None] * dim  # normal face velocity on d-faces (ng=1 transverse)
    hat_comp = [[None] * dim for _ in range(dim)]  # [face-dir][comp]
    for d in range(dim):
        uL, uR = hat[d][d]
        uadv = _riemann_self(uL, uR)
        hat_vel[d] = uadv
        for c in range(dim):
            qL, qR = hat[d][c]
            hat_comp[d][c] = _upwind(qL, qR, uadv) if c != d else uadv

    # --- full face states with transverse corrections, on REAL faces only
    u_mac = []
    for d in range(dim):
        # L/R base states restricted to real transverse cells
        uL, uR = hat[d][d]

        def real_transverse(a, face_dim):
            idx = []
            for e in range(dim):
                if e == face_dim:
                    idx.append(slice(None))
                else:
                    idx.append(slice(1, 1 + n[e]))
            return a[tuple(idx)]

        uL = real_transverse(uL, d)
        uR = real_transverse(uR, d)

        # transverse corrections: for the L state (cell k = i-1 at ng=1 index
        # 0..n_d) and R state (cell k+1)
        corr_L = 0.0
        corr_R = 0.0
        for e in range(dim):
            if e == d:
                continue
            # hat_e arrays: extent n_e+1 in e, n+2 in others
            hv = hat_vel[e]
            hq = hat_comp[e][d]  # component d on e-faces
            # cell (ng=1 index kd in d, real idx in others): e-faces at
            # real-face indices ke-1, ke for real cell ke-1 -> slices 0:n_e
            # and 1:n_e+1 along e; along d keep full ng=1 extent; along other
            # transverse dims f restrict to real cells (index shift 1)
            def cell_faces(a):
                lo_idx, hi_idx = [], []
                for f in range(dim):
                    if f == e:
                        lo_idx.append(slice(0, n[e]))
                        hi_idx.append(slice(1, n[e] + 1))
                    elif f == d:
                        lo_idx.append(slice(None))
                        hi_idx.append(slice(None))
                    else:
                        lo_idx.append(slice(1, 1 + n[f]))
                        hi_idx.append(slice(1, 1 + n[f]))
                return a[tuple(lo_idx)], a[tuple(hi_idx)]

            hv_lo, hv_hi = cell_faces(hv)
            hq_lo, hq_hi = cell_faces(hq)
            vbar = 0.5 * (hv_lo + hv_hi)
            dq = hq_hi - hq_lo
            t = -0.5 * dt / dx[e] * vbar * dq  # per-cell transverse increment
            # t extent: d: n_d+2 (ng=1), others: real. L uses cells 0..n_d,
            # R uses cells 1..n_d+1
            corr_L = corr_L + _shift(t, d, 0, n[d] + 1)
            corr_R = corr_R + _shift(t, d, 1, n[d] + 1)

        if use_forces_in_trans:
            # force already entered via the hat/predictor states
            uL_full = uL + corr_L
            uR_full = uR + corr_R
        else:
            # forces (dt/2 * f), force has ng=1: cells at ng=1 index k
            fcomp = force_g[d]
            f_real = fcomp[
                tuple(
                    slice(None) if e == d else slice(1, 1 + n[e])
                    for e in range(dim)
                )
            ]
            f_L = _shift(f_real, d, 0, n[d] + 1)
            f_R = _shift(f_real, d, 1, n[d] + 1)
            uL_full = uL + corr_L + 0.5 * dt * f_L
            uR_full = uR + corr_R + 0.5 * dt * f_R

        face = _riemann_self(uL_full, uR_full)
        u_mac.append(_pin_faces(face, d, bcrecs[d], bcvals_lo, bcvals_hi))

    return tuple(u_mac)


def _pin_faces(face, d, bcr, bcvals_lo, bcvals_hi):
    """Pin ext_dir domain faces to the BC value (velFill semantics,
    NS_bcfill.H:101-170); reflect_odd (symmetry) faces are zero."""
    if bcr.lo[d] == MathBC.ext_dir:
        face = _set_face(face, d, 0, bcvals_lo[d][d])
    elif bcr.lo[d] == MathBC.reflect_odd:
        face = _set_face(face, d, 0, 0.0)
    if bcr.hi[d] == MathBC.ext_dir:
        face = _set_face(face, d, -1, bcvals_hi[d][d])
    elif bcr.hi[d] == MathBC.reflect_odd:
        face = _set_face(face, d, -1, 0.0)
    return face


def _set_face(a, d, pos, val):
    idx = [slice(None)] * a.ndim
    idx[d] = slice(0, 1) if pos == 0 else slice(-1, None)
    return a.at[tuple(idx)].set(val)


def grow_umac_transverse(umac, bc_periodic: Sequence[bool]):
    """Add one ghost row to each MAC component in its transverse dims.

    Periodic dims wrap; others copy the edge row (foextrap — only used for
    upwinding weights in ghost columns, consistent with the reference's
    create_umac_grown ghost fill for single-level, NavierStokesBase.cpp:1102).
    """
    out = []
    for d, u in enumerate(umac):
        for e in range(u.ndim):
            if e == d:
                continue
            if bc_periodic[e]:
                lo = sl(u, e, -1, None)
                hi = sl(u, e, 0, 1)
            else:
                lo = sl(u, e, 0, 1)
                hi = sl(u, e, -1, None)
            u = jnp.concatenate([lo, u, hi], axis=e)
        out.append(u)
    return tuple(out)


def advect_field(
    s_g,
    umac,
    umac_g,
    dt,
    dx,
    ncell,
    iconserv: bool,
    s_cc=None,
    force_g=None,
    periodic=None,
    scheme: str = "plm",
    rz=None,
    eb=None,
    umac_gn=None,
    use_forces_in_trans: bool = False,
):
    """Edge states + fluxes + advective tendency for one field: composes
    compute_edge_states + compute_fluxes_and_aofs. Returns (fluxes, aofs).

    umac_gn: optional MAC velocities ALSO grown by one face in their own
    (normal) dim — a box of a box-batched level passes these so the
    conservative d(umac)/dx ghost terms use the true neighbor faces
    (sibling/coarse data) instead of the single-level wrap/edge-copy."""
    fluid_g = None
    if eb is not None and scheme != "ppm":
        # near-wall least-squares slopes need the grown fluid mask; domain
        # ghosts hold valid (extrapolated/BC) data -> fluid
        ng = (s_g.shape[0] - ncell[0]) // 2
        fluid_g = jnp.pad(eb.fluid, ng, mode="constant", constant_values=1.0)
    edges = compute_edge_states(
        s_g, umac_g, dt, dx, ncell, iconserv, force_g=force_g,
        periodic=periodic, scheme=scheme, fluid_g=fluid_g, umac_gn=umac_gn,
        use_forces_in_trans=use_forces_in_trans,
    )
    return compute_fluxes_and_aofs(edges, umac, dx, iconserv, s_cc=s_cc, rz=rz)


def compute_edge_states(
    s_g,
    umac_grown,
    dt: float,
    dx: Sequence[float],
    ncell: Sequence[int],
    iconserv: bool,
    force_g=None,
    periodic: Optional[Sequence[bool]] = None,
    scheme: str = "plm",
    fluid_g=None,
    umac_gn=None,
    use_forces_in_trans: bool = False,
):
    """Predict scalar edge states on all faces given time-centered u_mac.

    s_g: scalar with 3 filled ghosts; umac_grown: MAC velocities with one
    transverse ghost row (grow_umac_transverse). force_g: optional forcing
    with 1 ghost. Returns tuple of face arrays (real faces).

    Transverse correction: conservative form uses the flux difference
    d(v_mac s_hat)/dy; convective form uses vbar * d(s_hat)/dy.

    scheme: "plm" (4th-order limited slopes) or "ppm" (parabolic
    reconstruction) — the reference's ns.advection_scheme Godunov_PLM /
    Godunov_PPM normal predictors (NavierStokesBase.cpp:548-554).
    """
    dim = s_g.ndim
    ng = 3
    n = tuple(ncell)

    if scheme == "bds":
        from iamr_tpu.ops.bds import bds_edge_states

        # BDS handles its transverse (corner-coupling) terms inside the
        # characteristic-region integrals — no hat-state pass needed
        return bds_edge_states(
            s_g, umac_grown, dt, dx, ncell, force_g=force_g, periodic=periodic
        )

    slopes = []
    if scheme != "ppm":
        for d in range(dim):
            s = (
                slope4(s_g, d) if fluid_g is None
                else slope4_eb(s_g, d, fluid_g)
            )
            s = _trim(s, 1, ng, dims=[e for e in range(dim) if e != d])
            slopes.append(s)
    s_1 = _trim(s_g, 1, ng)

    def _predict(d):
        """Normal-predictor L/R states on the faces of the ng=1 region.
        With use_forces_in_trans the 0.5*dt*f term joins here (feeding the
        transverse terms via the hat states) instead of the final face
        states (AMReX-Hydro Godunov; NavierStokesBase.cpp:4715)."""
        u_f = umac_grown[d]  # extent n_d+1 in d, n_e+2 transverse
        if scheme == "ppm":
            q3 = _trim(s_g, 1, ng, dims=[e for e in range(dim) if e != d])
            cl = dt / dx[d] * jnp.maximum(u_f, 0.0)
            cr = dt / dx[d] * jnp.maximum(-u_f, 0.0)
            pL, pR = ppm_lr(q3, d, cl, cr)
        else:
            q = s_1
            m = q.shape[d]
            qL = _shift(q, d, 0, m - 1)
            qR = _shift(q, d, 1, m - 1)
            sL = _shift(slopes[d], d, 0, m - 1)
            sR = _shift(slopes[d], d, 1, m - 1)
            cfl = dt / dx[d] * u_f
            pL = qL + 0.5 * (1.0 - cfl) * sL
            pR = qR - 0.5 * (1.0 + cfl) * sR
        if use_forces_in_trans and force_g is not None:
            mf = force_g.shape[d]
            pL = pL + 0.5 * dt * _shift(force_g, d, 0, mf - 1)
            pR = pR + 0.5 * dt * _shift(force_g, d, 1, mf - 1)
        return pL, pR

    # hat states on faces of the ng=1 region (extent n_d+1 in d, n_e+2 else)
    hat_s = []
    for d in range(dim):
        pL, pR = _predict(d)
        hat_s.append(_upwind(pL, pR, umac_grown[d]))

    edges = []
    for d in range(dim):
        pL, pR = _predict(d)

        def to_real(a, face_dim):
            idx = []
            for e in range(dim):
                if e == face_dim:
                    idx.append(slice(None))
                else:
                    idx.append(slice(1, 1 + n[e]))
            return a[tuple(idx)]

        pL = to_real(pL, d)
        pR = to_real(pR, d)

        corr_L = 0.0
        corr_R = 0.0
        for e in range(dim):
            if e == d:
                continue

            def cell_faces(a):
                lo_idx, hi_idx = [], []
                for f in range(dim):
                    if f == e:
                        lo_idx.append(slice(0, n[e]))
                        hi_idx.append(slice(1, n[e] + 1))
                    elif f == d:
                        lo_idx.append(slice(None))
                        hi_idx.append(slice(None))
                    else:
                        lo_idx.append(slice(1, 1 + n[f]))
                        hi_idx.append(slice(1, 1 + n[f]))
                return a[tuple(lo_idx)], a[tuple(hi_idx)]

            hq_lo, hq_hi = cell_faces(hat_s[e])
            # u_mac on the e-faces of each cell: umac_grown[e] has extent
            # n_e+1 in e and n_f+2 in f != e; align to (d: ng=1, others real)
            ue = umac_grown[e]

            def mac_faces(a):
                lo_idx, hi_idx = [], []
                for f in range(dim):
                    if f == e:
                        lo_idx.append(slice(0, n[e]))
                        hi_idx.append(slice(1, n[e] + 1))
                    elif f == d:
                        lo_idx.append(slice(None))
                        hi_idx.append(slice(None))
                    else:
                        lo_idx.append(slice(1, 1 + n[f]))
                        hi_idx.append(slice(1, 1 + n[f]))
                return a[tuple(lo_idx)], a[tuple(hi_idx)]

            uv_lo, uv_hi = mac_faces(ue)
            if iconserv:
                t = -0.5 * dt / dx[e] * (uv_hi * hq_hi - uv_lo * hq_lo)
            else:
                vbar = 0.5 * (uv_lo + uv_hi)
                t = -0.5 * dt / dx[e] * vbar * (hq_hi - hq_lo)
            corr_L = corr_L + _shift(t, d, 0, n[d] + 1)
            corr_R = corr_R + _shift(t, d, 1, n[d] + 1)

        if iconserv:
            # conservative correction: +dt/2 * s * d(u_mac_d)/dx_d per cell
            # (completes div(u s) vs u.grad(s) in the normal direction)
            if umac_gn is not None:
                # true neighbor-face divergence from the normal-grown MAC
                # field (box-batch path: ghost faces hold sibling/coarse
                # data, so box seams stay flux-consistent level-wide)
                ug = umac_gn[d]
                dudx = (sl(ug, d, 1, None) - sl(ug, d, 0, -1)) / dx[d]
            else:
                ud = umac_grown[d]
                dudx = (sl(ud, d, 1, None) - sl(ud, d, 0, -1)) / dx[d]
                # dudx covers real cells in d (extent n_d); the ng=1 extent
                # needs the normal-ghost cells too: wrap for periodic
                # (constancy preservation demands the true wrapped
                # divergence), edge-copy otherwise
                if periodic is not None and periodic[d]:
                    dudx = jnp.concatenate(
                        [sl(dudx, d, -1, None), dudx, sl(dudx, d, 0, 1)],
                        axis=d,
                    )
                else:
                    dudx = jnp.concatenate(
                        [sl(dudx, d, 0, 1), dudx, sl(dudx, d, -1, None)],
                        axis=d,
                    )
            q_cc = s_1
            # umac_gn carries NO transverse ghosts (real extent n_e), the
            # grow_umac_transverse field carries one per side (n_e + 2)
            toff = 0 if umac_gn is not None else 1
            t = -0.5 * dt * q_cc[
                tuple(slice(None) if e == d else slice(1, 1 + n[e]) for e in range(dim))
            ] * dudx[
                tuple(
                    slice(None) if e == d else slice(toff, toff + n[e])
                    for e in range(dim)
                )
            ]
            corr_L = corr_L + _shift(t, d, 0, n[d] + 1)
            corr_R = corr_R + _shift(t, d, 1, n[d] + 1)

        if force_g is not None and not use_forces_in_trans:
            f_real = force_g[
                tuple(
                    slice(None) if e == d else slice(1, 1 + n[e]) for e in range(dim)
                )
            ]
            corr_L = corr_L + 0.5 * dt * _shift(f_real, d, 0, n[d] + 1)
            corr_R = corr_R + 0.5 * dt * _shift(f_real, d, 1, n[d] + 1)

        sLf = pL + corr_L
        sRf = pR + corr_R
        u_real = umac_grown[d][
            tuple(slice(None) if e == d else slice(1, 1 + n[e]) for e in range(dim))
        ]
        edges.append(_upwind(sLf, sRf, u_real))
    return tuple(edges)


def compute_fluxes_and_aofs(
    edges,
    umac,
    dx: Sequence[float],
    iconserv: bool,
    s_cc=None,
    rz=None,
):
    """Fluxes F_d = u_mac_d * s_edge_d and the advective tendency.

    Conservative: aofs = div(F). Convective: aofs = div(F) - s * div(u_mac)
    (reference HydroUtils::ComputeConvectiveTerm semantics). Updates apply as
    S_new = S_old - dt * aofs.

    rz: optional (r_cell, r_face) radius arrays for 2D axisymmetric
    geometry (coord_sys=1): div = (1/r) d(r F_r)/dr + dF_z/dz (the
    reference's RZ volume/area weighting, Projection.cpp radMult scaling).
    """
    dim = len(edges)
    fluxes = tuple(umac[d] * edges[d] for d in range(dim))

    def _div(fs):
        if rz is None:
            out = 0.0
            for d in range(dim):
                out = out + (sl(fs[d], d, 1, None) - sl(fs[d], d, 0, -1)) / dx[d]
            return out
        r_cell, r_face = rz
        fr = r_face * fs[0]
        out = (sl(fr, 0, 1, None) - sl(fr, 0, 0, -1)) / dx[0] / r_cell
        out = out + (sl(fs[1], 1, 1, None) - sl(fs[1], 1, 0, -1)) / dx[1]
        return out

    div = _div(fluxes)
    if iconserv:
        return fluxes, div
    return fluxes, div - s_cc * _div(umac)
