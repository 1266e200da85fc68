"""BDS (Bell-Dawson-Shubin) advection edge states.

JAX equivalent of AMReX-Hydro/BDS (selected via
ns.advection_scheme=BDS, reference NavierStokesBase.cpp:548-554; regtests
Exec/run2d/regtest.2d.traceradvect_bds, run3d/regtest.3d.traceradvect_bds;
algorithm: Bell-Dawson-Shubin 1988; unsplit 3D form: Nonaka et al.).

Method: per cell, a limited bi/tri-linear reconstruction built from corner
(node) values; edge states are the EXACT average of the upwind cell's
profile over the space-time characteristic domain of dependence of the face
(a sheared parallelepiped: normal sweep u*dt deep, sheared by the cell's
transverse velocities). For a multilinear profile those averages are closed
form; the moment integrals below are derived by averaging each monomial
over the swept region (the dt^2/3 and dt^3/4 terms of the BDS papers).

Corner coupling (the reference's gamma terms, AMReX-Hydro BDS_2D/3D): as
the transverse CFL grows, the sheared characteristic region spills into
DIAGONAL neighbor cells. The reference accumulates nested "gamma"
correction integrals; here the SAME integral is evaluated directly on the
piecewise reconstruction: at each backward time tau the face footprint is
decomposed by cell membership into 2^(dim-1) boxes (per transverse dim e,
a band of width a_e = |v_e| tau lies in the neighbor opposite v_e), each
box's average of its OWN cell's multilinear profile is the profile at the
box centroid (multilinear => centroid rule is exact), and the tau integral
of the resulting polynomial (degree <= 5) is done with 3-point
Gauss-Legendre, which is exact. The edge state is therefore a convex
combination of limited in-cell profile values: conservative (flux form)
and monotone with no extra clamping.
"""

from __future__ import annotations

import itertools
from typing import Optional, Sequence

import jax.numpy as jnp

from iamr_tpu.ops.stencil import sl


def _shift(a, d, off, extent):
    return sl(a, d, off, off + extent)


def _pairwise(a, d, op):
    return op(sl(a, d, 0, -1), sl(a, d, 1, None))


def _corner_stats(s2, dim):
    """Corner (node) values = average of the 2^dim adjacent cells, plus the
    per-corner min/max bounds of those cells. s2: ng=2 cells (extent n+4);
    output extent n+3 per dim (nodes of the ng=1 cell region)."""
    avg, lo, hi = s2, s2, s2
    for d in range(dim):
        avg = _pairwise(avg, d, lambda x, y: 0.5 * (x + y))
        lo = _pairwise(lo, d, jnp.minimum)
        hi = _pairwise(hi, d, jnp.maximum)
    return jnp.clip(avg, lo, hi), lo, hi


def _cell_corners(corners, dim, sigma):
    """Corner array values at offset sigma in {0,1}^dim for every ng=1 cell
    (extent n+2 per dim)."""
    m = corners.shape
    return corners[
        tuple(slice(sigma[d], m[d] - 1 + sigma[d]) for d in range(dim))
    ]


def bds_coefficients(s_g, dx: Sequence[float]):
    """Per-cell multilinear coefficients on the ng=1 region.

    s_g: scalar with >=2 filled ghosts (we use exactly 2 beyond ng=1).
    Returns dict of monomial coefficients keyed by sign tuples of the
    participating dims, e.g. 2D: {(1,0): sx, (0,1): sy, (1,1): sxy};
    the constant term is the cell value itself (mean preservation).
    """
    dim = s_g.ndim
    ng = (s_g.shape[0] - 1) // 2 if False else None
    # trim to ng=2
    have = 3
    s2 = s_g[tuple(slice(have - 2, s_g.shape[d] - (have - 2)) for d in range(dim))]
    s1 = s_g[tuple(slice(have - 1, s_g.shape[d] - (have - 1)) for d in range(dim))]

    corners, clo, chi = _corner_stats(s2, dim)
    sigmas = list(itertools.product((0, 1), repeat=dim))
    C = {sg: _cell_corners(corners, dim, sg) for sg in sigmas}
    Lo = {sg: _cell_corners(clo, dim, sg) for sg in sigmas}
    Hi = {sg: _cell_corners(chi, dim, sg) for sg in sigmas}

    # iterative mean-preserving limiter (AMReX BDS bdslim-style): clamp
    # each corner to its neighborhood bounds, then shift all corners to
    # restore the cell mean; 3 rounds, final clamp wins
    ncor = float(len(sigmas))
    for it in range(3):
        C = {sg: jnp.clip(C[sg], Lo[sg], Hi[sg]) for sg in sigmas}
        mean = sum(C.values()) / ncor
        corr = s1 - mean
        C = {sg: C[sg] + corr for sg in sigmas}
    C = {sg: jnp.clip(C[sg], Lo[sg], Hi[sg]) for sg in sigmas}

    # monomial coefficients from corner values: for monomial set M
    # (subset of dims), coef = sum_sg prod_{d in M} (2 sg_d - 1) C_sg
    #                          / (2^dim * prod_{d in M} dx_d/2)
    coefs = {}
    for mset in itertools.product((0, 1), repeat=dim):
        if sum(mset) == 0:
            continue
        acc = 0.0
        for sg in sigmas:
            w = 1.0
            for d in range(dim):
                if mset[d]:
                    w *= 2.0 * sg[d] - 1.0
            acc = acc + w * C[sg]
        denom = 2.0**dim
        for d in range(dim):
            if mset[d]:
                denom *= dx[d] / 2.0
        coefs[mset] = acc / denom
    coefs[(0,) * dim] = s1
    cmin = C[sigmas[0]]
    cmax = C[sigmas[0]]
    for sg in sigmas[1:]:
        cmin = jnp.minimum(cmin, C[sg])
        cmax = jnp.maximum(cmax, C[sg])
    return coefs, (cmin, cmax)


def bds_edge_states(
    s_g,
    umac_grown,
    dt,
    dx: Sequence[float],
    ncell: Sequence[int],
    force_g=None,
    periodic: Optional[Sequence[bool]] = None,
):
    """BDS edge states on all real faces (same contract as
    godunov.compute_edge_states)."""
    dim = s_g.ndim
    n = tuple(ncell)
    coefs, (cmin, cmax) = bds_coefficients(s_g, dx)

    # cell-centered transverse velocities on the ng=1 region: average the
    # two faces; extend along the face-normal dim by edge copy / wrap so
    # ghost cells have a value
    def cell_vel(e):
        ue = umac_grown[e]  # extent n_e+1 in e, n_f+2 transverse
        vb = 0.5 * (sl(ue, e, 0, -1) + sl(ue, e, 1, None))  # n_e cells
        if periodic is not None and periodic[e]:
            lo = sl(vb, e, -1, None)
            hi = sl(vb, e, 0, 1)
        else:
            lo = sl(vb, e, 0, 1)
            hi = sl(vb, e, -1, None)
        return jnp.concatenate([lo, vb, hi], axis=e)  # n_e+2

    vcell = [cell_vel(e) for e in range(dim)]

    # 3-point Gauss-Legendre on [0, 1]: exact for the <= degree-5
    # tau-polynomial integrand (see module docstring)
    _s = 0.5 * (0.6 ** 0.5)
    GL3 = ((0.5 - _s, 5.0 / 18.0), (0.5, 8.0 / 18.0), (0.5 + _s, 5.0 / 18.0))

    edges = []
    for d in range(dim):
        u_f = umac_grown[d]  # extent n_d+1 in d, n_e+2 transverse
        tdims = [e for e in range(dim) if e != d]

        def to_face_pair(a, shifts=None):
            """upwind-cell L/R arrays on the n_d+1 faces, real transverse;
            shifts: optional {e: +-1} transverse cell offset (the diagonal
            neighbor the sheared region spills into)."""
            m = a.shape[d]
            L = _shift(a, d, 0, m - 1)
            R = _shift(a, d, 1, m - 1)
            idx = tuple(
                slice(None) if e == d
                else slice(1 + (shifts or {}).get(e, 0),
                           1 + (shifts or {}).get(e, 0) + n[e])
                for e in range(dim)
            )
            return L[idx], R[idx]

        u_real = u_f[
            tuple(slice(None) if e == d else slice(1, 1 + n[e]) for e in range(dim))
        ]
        au = jnp.abs(u_real)
        su = jnp.sign(u_real)
        up = u_real > 0.0

        # upwind cell's transverse velocities (cell-constant characteristics)
        v = {}
        for e in tdims:
            vL, vR = to_face_pair(vcell[e])
            v[e] = jnp.where(up, vL, vR)

        # upwind-selected profile coefficients of the cell the footprint
        # subset S lands in: for e in S the neighbor is opposite v_e
        # (runtime sign -> blend the two shifted variants)
        subsets = []
        for r in range(len(tdims) + 1):
            subsets.extend(itertools.combinations(tdims, r))

        def coef_sel(mset, S):
            out = None
            for sgs in itertools.product((-1, 1), repeat=len(S)):
                L, R = to_face_pair(coefs[mset], dict(zip(S, sgs)))
                c = jnp.where(up, L, R)
                w = None
                for e, sg in zip(S, sgs):
                    # v_e > 0: band exits the LOW side -> neighbor -1
                    m = (v[e] > 0.0) if sg == -1 else (v[e] <= 0.0)
                    w = m if w is None else jnp.logical_and(w, m)
                c = c if w is None else jnp.where(w, c, 0.0)
                out = c if out is None else out + c
            return out

        csel = {S: {mset: coef_sel(mset, S) for mset in coefs} for S in subsets}

        out = 0.0
        for tq, wq in GL3:
            tau = tq * dt
            X = su * (0.5 * dx[d] - jnp.minimum(au * tau, dx[d]))
            a_e = {e: jnp.minimum(jnp.abs(v[e]) * tau, dx[e]) for e in tdims}
            sg_e = {e: jnp.sign(v[e]) for e in tdims}
            for S in subsets:
                # footprint fraction in this membership box
                w_S = 1.0
                mu = {}
                for e in tdims:
                    if e in S:
                        w_S = w_S * (a_e[e] / dx[e])
                        mu[e] = sg_e[e] * 0.5 * (dx[e] - a_e[e])
                    else:
                        w_S = w_S * (1.0 - a_e[e] / dx[e])
                        mu[e] = -sg_e[e] * 0.5 * a_e[e]
                # multilinear profile of the box's own cell at the box
                # centroid (exact average)
                P = 0.0
                for mset, c in csel[S].items():
                    term = c
                    if mset[d]:
                        term = term * X
                    for e in tdims:
                        if mset[e]:
                            term = term * mu[e]
                    P = P + term
                out = out + wq * w_S * P

        if force_g is not None:
            f_real = force_g[
                tuple(
                    slice(None) if e == d else slice(1, 1 + n[e]) for e in range(dim)
                )
            ]
            m = f_real.shape[d]
            fL = _shift(f_real, d, 0, m - 1)
            fR = _shift(f_real, d, 1, m - 1)
            out = out + 0.5 * dt * jnp.where(u_real > 0.0, fL, fR)
        edges.append(out)
    return tuple(edges)
