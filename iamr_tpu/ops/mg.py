"""Geometric multigrid for the cell-centered ABecLaplacian.

JAX equivalent of amrex MLABecLaplacian + MLMG (reference call sites:
Source/Diffusion.cpp:325-352 for Crank-Nicolson diffusion solves,
Source/MacProj.cpp:1133-1183 for the MAC Poisson solve). Solves

    (a_scalar * alpha(x)  -  b_scalar * div(beta(x) grad)) phi = rhs

with beta on faces (MAC staggering), on one dense level array per MG level.

Design (idiomatic XLA, not a port):
  * MG hierarchy is built by factor-2 coarsening at trace time (static level
    count); the V-cycle recursion unrolls in the jaxpr.
  * Smoother: red-black Gauss-Seidel via checkerboard masks — each color
    update is one fused stencil evaluation over the whole level (bandwidth
    bound; XLA fuses the residual and the masked update into one loop).
  * Domain BCs per (dim, side): periodic / Dirichlet-on-face / Neumann.
    Inhomogeneous Dirichlet/Neumann values are folded into the RHS once
    (boundary lifting), so all MG internals are homogeneous.
  * Tolerance-driven iteration with lax.while_loop (no host round-trips);
    fixed-cycle mode for benchmarking.

Dirichlet ghost uses the 3-point 2nd-order formula g = (8/3)b - 2c0 + (1/3)c1
(face value b), matching MLMG's maxorder=3-equivalent accuracy.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from iamr_tpu.ops.stencil import checkerboard, sl
from iamr_tpu.parallel.reduce import invariant_matvec, invariant_mean, invariant_sum

# BC kinds (static ints)
PERIODIC = 0
DIRICHLET = 1
NEUMANN = 2


@dataclasses.dataclass(frozen=True)
class PoissonBC:
    """Per-dim, per-side BC kinds for a cell-centered solve."""

    lo: Tuple[int, ...]
    hi: Tuple[int, ...]

    @property
    def dim(self):
        return len(self.lo)


def _pad_phi(phi, bc: PoissonBC):
    """Fill one homogeneous ghost layer around phi per the BC kinds."""
    for d in range(phi.ndim):
        n = phi.shape[d]
        if bc.lo[d] == PERIODIC:
            lo = sl(phi, d, n - 1, n)
            hi = sl(phi, d, 0, 1)
        else:
            c0l, c1l = sl(phi, d, 0, 1), sl(phi, d, 1, 2)
            c0h, c1h = sl(phi, d, n - 1, n), sl(phi, d, n - 2, n - 1)
            if bc.lo[d] == DIRICHLET:
                lo = -2.0 * c0l + (1.0 / 3.0) * c1l
            else:  # NEUMANN: zero-flux
                lo = c0l
            if bc.hi[d] == DIRICHLET:
                hi = -2.0 * c0h + (1.0 / 3.0) * c1h
            else:
                hi = c0h
        phi = jnp.concatenate([lo, phi, hi], axis=d)
    return phi


def _boundary_lift(shape, bc: PoissonBC, bvals, dtype):
    """Ghost-only array holding the inhomogeneous part of the BC fill.

    bvals: dict (d, side) -> face-value array broadcastable to the boundary
    slice (Dirichlet: value on face; Neumann: prescribed gradient d(phi)/dn
    outward). Returns phi-with-ghosts sized array that is zero in the
    interior; adding it to the homogeneous ghost fill of phi reproduces the
    inhomogeneous fill (fill is affine in (phi, bvals)).
    """
    dim = len(shape)
    g = jnp.zeros(tuple(s + 2 for s in shape), dtype=dtype)
    if not bvals:
        return g
    for (d, side), val in bvals.items():
        if bc.lo[d] == PERIODIC:
            continue
        kind = bc.lo[d] if side == 0 else bc.hi[d]
        idx = [slice(1, -1)] * dim
        idx[d] = slice(0, 1) if side == 0 else slice(-1, None)
        v = jnp.asarray(val, dtype=dtype)
        if v.ndim == dim - 1:
            v = jnp.expand_dims(v, axis=d)
        if kind == DIRICHLET:
            contrib = (8.0 / 3.0) * v
        else:  # NEUMANN with prescribed outward gradient: ghost = c0 + dn*dx...
            # handled by caller scaling; here ghost += val (val = grad*dx)
            contrib = v
        g = g.at[tuple(idx)].add(contrib)
    return g


def _face_lo(beta_d, d):
    return sl(beta_d, d, 0, -1)


def _face_hi(beta_d, d):
    return sl(beta_d, d, 1, None)


def apply_op(phi_g, alpha, beta, a, b, dx, shape):
    """L(phi) given phi WITH one filled ghost layer (phi_g)."""
    dim = len(shape)
    ctr = phi_g[tuple(slice(1, -1) for _ in range(dim))]
    out = a * alpha * ctr if a != 0.0 else jnp.zeros_like(ctr)
    for d in range(dim):
        idx_lo = [slice(1, -1)] * dim
        idx_hi = [slice(1, -1)] * dim
        idx_lo[d] = slice(0, -2)
        idx_hi[d] = slice(2, None)
        lo_n = phi_g[tuple(idx_lo)]
        hi_n = phi_g[tuple(idx_hi)]
        bl = _face_lo(beta[d], d)
        bh = _face_hi(beta[d], d)
        lap = (bh * (hi_n - ctr) - bl * (ctr - lo_n)) / (dx[d] * dx[d])
        out = out - b * lap
    return out


def _diag(alpha, beta, a, b, dx, bc: PoissonBC, shape, dtype):
    """Diagonal of the operator, including boundary-modified coefficients.

    Interior face contributes beta/dx^2; a Dirichlet boundary face contributes
    3*beta/dx^2 (from the 3-point ghost), a Neumann boundary face 0.
    """
    dim = len(shape)
    diag = a * alpha if a != 0.0 else jnp.zeros(shape, dtype=dtype)
    for d in range(dim):
        bl = _face_lo(beta[d], d)
        bh = _face_hi(beta[d], d)
        cl = jnp.ones(shape, dtype=dtype)
        ch = jnp.ones(shape, dtype=dtype)
        edge_lo = [slice(None)] * dim
        edge_lo[d] = slice(0, 1)
        edge_hi = [slice(None)] * dim
        edge_hi[d] = slice(-1, None)
        if bc.lo[d] == DIRICHLET:
            cl = cl.at[tuple(edge_lo)].set(3.0)
        elif bc.lo[d] == NEUMANN:
            cl = cl.at[tuple(edge_lo)].set(0.0)
        if bc.hi[d] == DIRICHLET:
            ch = ch.at[tuple(edge_hi)].set(3.0)
        elif bc.hi[d] == NEUMANN:
            ch = ch.at[tuple(edge_hi)].set(0.0)
        diag = diag + b * (cl * bl + ch * bh) / (dx[d] * dx[d])
    return diag


def _coarsen_cell(a, dim):
    """2x average coarsening of a cell array."""
    for d in range(dim):
        a = 0.5 * (a[_every2(a, d, 0)] + a[_every2(a, d, 1)])
    return a


def _every2(a, d, offset):
    idx = [slice(None)] * a.ndim
    idx[d] = slice(offset, None, 2)
    return tuple(idx)


def _coarsen_face(beta_d, d, dim):
    """Coarsen a face coefficient array for faces normal to d."""
    # average transverse pairs, take every other face in the normal dim
    out = beta_d
    for t in range(dim):
        if t == d:
            continue
        out = 0.5 * (out[_every2(out, t, 0)] + out[_every2(out, t, 1)])
    out = out[_every2(out, d, 0)]
    return out


def _prolong(e_c, dim):
    """Piecewise-constant prolongation (2x repeat per dim)."""
    for d in range(dim):
        e_c = jnp.repeat(e_c, 2, axis=d)
    return e_c


@dataclasses.dataclass
class MGLevelData:
    alpha: jnp.ndarray
    beta: Tuple[jnp.ndarray, ...]
    diag: jnp.ndarray
    dx: Tuple[float, ...]
    shape: Tuple[int, ...]
    red: jnp.ndarray
    black: jnp.ndarray


def build_hierarchy(
    alpha,
    beta,
    a: float,
    b: float,
    dx: Sequence[float],
    bc: PoissonBC,
    min_size: int = 2,
    max_levels: int = 30,
    stop_dofs: int = 0,
):
    """Build the MG level list (runs under jit; level count is static).

    stop_dofs: also stop coarsening once a level has <= stop_dofs cells
    (the dense-bottom truncation: the ladder of tiny levels below ~8^3
    costs fixed kernel-launch overhead per V-cycle and is replaced by one
    direct solve — the analogue of AMReX MLMG's agglomeration +
    bottom solver, SURVEY.md section 2.2)."""
    from iamr_tpu.parallel.context import constrain, constrain_tuple

    dim = alpha.ndim
    levels = []
    shape = tuple(alpha.shape)
    dtype = alpha.dtype
    cur_alpha, cur_beta, cur_dx = alpha, tuple(beta), tuple(dx)
    import numpy as _np

    while True:
        # multi-chip: pin each level's layout (fine levels sharded on the
        # spatial mesh, coarse levels replicated — the agglomeration policy,
        # iamr_tpu.parallel.context)
        cur_alpha = constrain(cur_alpha)
        cur_beta = constrain_tuple(cur_beta)
        diag = constrain(
            _diag(cur_alpha, cur_beta, a, b, cur_dx, bc, shape, dtype)
        )
        red = checkerboard(shape, 0, dtype)
        black = checkerboard(shape, 1, dtype)
        levels.append(
            MGLevelData(cur_alpha, cur_beta, diag, cur_dx, shape, red, black)
        )
        if (
            len(levels) >= max_levels
            or any(n % 2 != 0 for n in shape)
            or min(shape) <= min_size
            or int(_np.prod(shape)) <= stop_dofs
        ):
            break
        cur_alpha = _coarsen_cell(cur_alpha, dim)
        cur_beta = tuple(_coarsen_face(cur_beta[d], d, dim) for d in range(dim))
        cur_dx = tuple(2.0 * h for h in cur_dx)
        shape = tuple(n // 2 for n in shape)
    return levels


def _smooth_rb(phi, rhs, lev: MGLevelData, a, b, bc, nsweeps: int):
    """nsweeps red-black Gauss-Seidel sweeps."""

    def one_color(phi, mask):
        phi_g = _pad_phi(phi, bc)
        r = rhs - apply_op(phi_g, lev.alpha, lev.beta, a, b, lev.dx, lev.shape)
        return phi + mask * r / lev.diag

    def body(_, phi):
        phi = one_color(phi, lev.red)
        phi = one_color(phi, lev.black)
        return phi

    return jax.lax.fori_loop(0, nsweeps, body, phi)


def _residual(phi, rhs, lev: MGLevelData, a, b, bc):
    phi_g = _pad_phi(phi, bc)
    return rhs - apply_op(phi_g, lev.alpha, lev.beta, a, b, lev.dx, lev.shape)


def _bottom_cg(rhs, lev: MGLevelData, a, b, bc, iters: int = 32):
    """Conjugate-gradient bottom solve (the reference MLMG default bottom
    solver is bicgcg, SURVEY section 2.2; the ABecLaplacian is SPD so plain
    CG suffices). Fixed iteration count keeps the program static; the
    bottom level is tiny so the cost is negligible — what CG buys over
    smoother sweeps is convergence on anisotropic/stretched coefficients
    where point relaxation stalls."""

    def matvec(p):
        return apply_op(_pad_phi(p, bc), lev.alpha, lev.beta, a, b, lev.dx,
                        lev.shape)

    singular = a == 0.0 and all(
        bc.lo[d] != DIRICHLET and bc.hi[d] != DIRICHLET
        for d in range(len(lev.shape))
    )

    def demean(x):
        # layout-invariant reductions: last-bit layout differences here
        # seed thresholded-branch flips downstream (parallel/reduce.py)
        return x - invariant_mean(x) if singular else x

    rhs = demean(rhs)
    x = jnp.zeros_like(rhs)
    r = rhs
    p = r
    rs = invariant_sum(r * r)
    eps = jnp.asarray(1e-30, rhs.dtype)

    def body(_, carry):
        x, r, p, rs = carry
        # freeze once converged: iterating CG past convergence with fixed
        # iteration counts amplifies roundoff noise (rs/pap -> 0/0) and made
        # sharded and unsharded runs diverge at 1e-4 level
        active = rs > jnp.maximum(1e-28 * rs0, eps)
        ap = matvec(p)
        pap = invariant_sum(p * ap)
        alpha_k = jnp.where(active & (pap > eps), rs / jnp.maximum(pap, eps),
                            0.0)
        x = x + alpha_k * p
        r = demean(r - alpha_k * ap)
        rs_new = invariant_sum(r * r)
        beta_k = jnp.where(active, rs_new / jnp.maximum(rs, eps), 0.0)
        p = r + beta_k * p
        return x, r, p, rs_new

    rs0 = rs
    x, _, _, _ = jax.lax.fori_loop(0, iters, body, (x, r, p, rs))
    return x


# dense-bottom size cap: largest level solved by direct (pseudo)inverse
DENSE_BOTTOM_DOFS = 512


def _bottom_dense_inv(lev: MGLevelData, a, b, bc):
    """Materialize the bottom-level operator on the identity basis and
    invert it ONCE per solve. Replaces the per-cycle 32-iteration CG: each
    CG iteration is several tiny sequential kernels whose fixed launch cost
    dwarfs the arithmetic, while the dense apply is one matvec per cycle.
    Exact (direct) bottom solve — strictly better convergence than
    truncated CG. Singular (all-periodic/Neumann, a=0)
    operators are regularized on the constants nullspace.

    The reference reaches the same regime via MLMG agglomeration + a
    bottom solver on the consolidated grid (SURVEY.md section 2.2)."""
    import numpy as _np

    shape = lev.shape
    ndof = int(_np.prod(shape))
    if ndof > 4096:
        # hierarchy stopped early (odd extent) on a level too big to
        # materialize — fall back to the CG bottom
        return None
    dtype = lev.alpha.dtype
    eye = jnp.eye(ndof, dtype=dtype).reshape((ndof,) + shape)
    cols = jax.vmap(
        lambda e: apply_op(
            _pad_phi(e, bc), lev.alpha, lev.beta, a, b, lev.dx, shape
        ).ravel()
    )(eye)
    A = cols.T  # A[i, j] = (L e_j)_i
    # EB/covered DOFs: a cell whose diagonal is (near-)zero has every face
    # coefficient zero too, so its row AND column vanish — the matrix would
    # be singular and inv() garbage. Decouple them with identity rows; their
    # solution is pinned to 0 in _bottom_solve.
    scale = invariant_mean(jnp.abs(lev.diag))
    alive = (jnp.abs(lev.diag) > 1e-10 * scale).astype(dtype).ravel()
    A = A + jnp.diag(1.0 - alive)
    singular = a == 0.0 and all(
        bc.lo[d] != DIRICHLET and bc.hi[d] != DIRICHLET
        for d in range(len(shape))
    )
    if singular:
        # rank-1 shift off the (alive-restricted) constants nullspace
        w = alive / jnp.linalg.norm(alive)
        A = A + scale * jnp.outer(w, w)
    return jnp.linalg.inv(A), alive


def _bottom_solve(rhs, lev: MGLevelData, a, b, bc, binv):
    if binv is None:
        return _bottom_cg(rhs, lev, a, b, bc)
    inv, alive = binv
    singular = a == 0.0 and all(
        bc.lo[d] != DIRICHLET and bc.hi[d] != DIRICHLET
        for d in range(len(lev.shape))
    )
    nalive = invariant_sum(alive)
    r = alive * rhs.ravel()
    if singular:
        r = alive * (r - invariant_sum(r) / nalive)
    x = alive * invariant_matvec(inv, r)
    if singular:
        x = alive * (x - invariant_sum(x) / nalive)
    return x.reshape(lev.shape)


def _use_dense_bottom() -> bool:
    import os

    return os.environ.get("IAMR_BOTTOM", "") != "cg"


def _vcycle(rhs, levels, a, b, bc, lev_idx, nu1, nu2, nu_bottom, binv=None):
    from iamr_tpu.parallel.context import constrain

    lev = levels[lev_idx]
    dim = len(lev.shape)
    phi = jnp.zeros_like(rhs)
    if lev_idx == len(levels) - 1:
        if binv is not None:
            # direct bottom: no smoothing needed, the solve is exact
            return _bottom_solve(rhs, lev, a, b, bc, binv)
        phi = _smooth_rb(phi, rhs, lev, a, b, bc, min(nu_bottom, 4))
        phi = phi + _bottom_cg(
            rhs - apply_op(_pad_phi(phi, bc), lev.alpha, lev.beta, a, b,
                           lev.dx, lev.shape),
            lev, a, b, bc,
        )
        return phi
    phi = _smooth_rb(phi, rhs, lev, a, b, bc, nu1)
    r = _residual(phi, rhs, lev, a, b, bc)
    r_c = constrain(_coarsen_cell(r, dim))
    e_c = _vcycle(r_c, levels, a, b, bc, lev_idx + 1, nu1, nu2, nu_bottom,
                  binv)
    phi = constrain(phi + _prolong(e_c, dim))
    phi = _smooth_rb(phi, rhs, lev, a, b, bc, nu2)
    return phi


def union_dirichlet_coeffs(mask, alpha, beta, a, b, dx):
    """Coefficient transform that embeds a union-of-boxes Dirichlet problem
    into the full rectangular solve (the level-wide multi-box solve,
    reference MLMG solving one AMR level across its whole BoxArray).

    mask: 1.0 on cells of the union (the real fine level), 0.0 on 'hole'
    cells of the bounding box whose values are KNOWN (coarse-interpolated
    Dirichlet data). The transform:
      * zeroes beta on every face touching a hole cell (removes coupling),
      * adds the removed faces' coefficients back into the union cells'
        alpha so their diagonal still carries the Dirichlet term,
      * pins hole cells through the identity (alpha=1 there; their rhs is
        zeroed by the caller so they solve to exactly 0).
    With the rhs lifted by -L_full(g_ext), the solution of the transformed
    system is x with x=0 in holes and x+g_ext the union Dirichlet solution.
    No smoother/V-cycle/bottom changes are needed — it is just data.

    Returns (alpha', beta', a'). b is unchanged.
    """
    dim = mask.ndim
    a_eff = 1.0 if a == 0.0 else a
    alpha_eff = mask * (a * alpha / a_eff if a != 0.0 else 0.0)
    beta_m = []
    seam_comp = jnp.zeros_like(mask)
    for d in range(dim):
        # face (d, i) sits between cells i-1 and i; domain-edge faces keep
        # their coefficient (bc handles them), so pad the mask with ones
        pad = [(0, 0)] * dim
        pad[d] = (1, 1)
        mp = jnp.pad(mask, pad, constant_values=1.0)
        fmask = sl(mp, d, 0, -1) * sl(mp, d, 1, None)
        beta_m.append(beta[d] * fmask)
        # diagonal compensation: seam-face beta lost from union cells
        lost = beta[d] * (1.0 - fmask)
        seam_comp = seam_comp + (
            _face_lo(lost, d) + _face_hi(lost, d)
        ) / (dx[d] * dx[d])
    alpha_eff = alpha_eff + mask * (b / a_eff) * seam_comp + (1.0 - mask)
    return alpha_eff, tuple(beta_m), a_eff


def mg_solve(
    rhs,
    alpha,
    beta,
    a: float,
    b: float,
    dx: Sequence[float],
    bc: PoissonBC,
    phi0=None,
    bvals: Optional[Dict] = None,
    rtol: float = 1e-11,
    atol: float = 1e-16,
    max_vcycles: int = 100,
    nu1: int = 2,
    nu2: int = 2,
    nu_bottom: int = 16,
    fixed_cycles: Optional[int] = None,
    mixed: bool = False,
    interior_mask=None,
    interior_vals=None,
):
    """Solve (a*alpha - b*div(beta grad)) phi = rhs to tolerance.

    Singular (all-periodic/Neumann, a=0) problems are handled by projecting
    the mean out of rhs and phi each cycle.

    mixed: for f64 inputs, run the V-cycle in f32 with the f64
    residual/correction outside — iterative refinement reaching f64
    tolerances at f32 smoothing cost. Off unless the caller asks.

    interior_mask/interior_vals: solve only on the union of boxes where
    interior_mask==1, with interior Dirichlet data interior_vals on the
    mask==0 'hole' cells (the level-wide multi-box solve; see
    union_dirichlet_coeffs). Requires a non-singular problem (the bounding
    box of a fine AMR level always has Dirichlet coarse-fine faces).

    Returns (phi, final_resnorm, n_cycles).
    """
    dim = rhs.ndim
    dtype = rhs.dtype
    shape = tuple(rhs.shape)
    phi = jnp.zeros_like(rhs) if phi0 is None else phi0

    singular = (
        a == 0.0
        and interior_mask is None
        and all(
            bc.lo[d] != DIRICHLET and bc.hi[d] != DIRICHLET
            for d in range(dim)
        )
    )

    # boundary lifting: fold inhomogeneous BC values into the RHS
    if bvals:
        g = _boundary_lift(shape, bc, bvals, dtype)
        rhs = rhs - apply_op(g, alpha, beta, a, b, dx, shape)

    g_ext = None
    if interior_mask is not None:
        m = interior_mask
        if interior_vals is not None:
            # interior Dirichlet lifting with the FULL (untransformed)
            # operator: the seam coupling of the hole values moves into rhs
            g_ext = (1.0 - m) * interior_vals
            rhs = rhs - apply_op(_pad_phi(g_ext, bc), alpha, beta, a, b, dx,
                                 shape)
        rhs = m * rhs
        alpha, beta, a = union_dirichlet_coeffs(m, alpha, beta, a, b, dx)
        phi = m * phi

    if singular:
        rhs = rhs - invariant_mean(rhs)

    from iamr_tpu.parallel.context import constrain

    rhs = constrain(rhs)
    phi = constrain(phi)
    dense = _use_dense_bottom()
    stop = DENSE_BOTTOM_DOFS if dense else 0
    levels = build_hierarchy(alpha, beta, a, b, dx, bc, stop_dofs=stop)

    use_mixed = (
        jnp.dtype(dtype) == jnp.float64
        and mixed
    )
    if use_mixed:
        f32 = jnp.float32
        # b may be a traced f64 scalar (theta*dt) — cast or it re-promotes
        # the f32 hierarchy
        b32 = b if isinstance(b, (int, float)) else jnp.asarray(b, f32)
        levels32 = build_hierarchy(
            alpha.astype(f32), tuple(bd.astype(f32) for bd in beta),
            a, b32, dx, bc, stop_dofs=stop,
        )
        binv = _bottom_dense_inv(levels32[-1], a, b32, bc) if dense else None
    else:
        binv = _bottom_dense_inv(levels[-1], a, b, bc) if dense else None

    bnorm = jnp.max(jnp.abs(rhs))
    tol = jnp.maximum(rtol * bnorm, atol)

    def residual_f64(phi):
        return _residual(phi, rhs, levels[0], a, b, bc)

    def residual_df(phi):
        # fused compensated-f32 residual (ops/df32.py) for the EARLY mixed
        # cycles; the approach to tolerance always runs on the f64
        # residual (see mg_nodal.nodal_solve for why: whole-program XLA
        # optimization can degrade the compensation in large programs)
        from iamr_tpu.ops.df32 import residual_cell_df

        lev0 = levels[0]
        return residual_cell_df(phi, rhs, lev0.alpha, lev0.beta, a, b,
                                lev0.dx, bc)

    def do_cycle(phi, r, resid_fn):
        if use_mixed:
            e = _vcycle(
                r.astype(jnp.float32), levels32, a, b32, bc, 0,
                nu1, nu2, nu_bottom, binv,
            ).astype(dtype)
        else:
            e = _vcycle(r, levels, a, b, bc, 0, nu1, nu2, nu_bottom, binv)
        phi = phi + e
        if singular:
            phi = phi - invariant_mean(phi)
        return phi, resid_fn(phi)

    def finalize(phi):
        return phi if g_ext is None else phi + g_ext

    if fixed_cycles is not None:
        r = residual_df(phi) if use_mixed else residual_f64(phi)
        for _ in range(fixed_cycles):
            phi, r = do_cycle(phi, r, residual_df if use_mixed
                              else residual_f64)
        if use_mixed:  # report the true residual, not the df32 one
            r = residual_f64(phi)
        res = jnp.max(jnp.abs(r))
        return finalize(phi), res, jnp.asarray(fixed_cycles)

    def cond_phase(tol_phase):
        def cond(state):
            _, _, res, it = state
            return jnp.logical_and(res > tol_phase, it < max_vcycles)
        return cond

    def body_with(resid_fn):
        def body(state):
            phi, r, _, it = state
            phi, r = do_cycle(phi, r, resid_fn)
            return phi, r, jnp.max(jnp.abs(r)), it + 1
        return body

    if use_mixed:
        switch = jnp.maximum(tol, 1e-7 * bnorm)
        r0 = residual_df(phi)
        phi, _, _, itA = jax.lax.while_loop(
            cond_phase(switch), body_with(residual_df),
            (phi, r0, jnp.max(jnp.abs(r0)), jnp.asarray(0)),
        )

        # phase B: incremental residual r <- r - L(e) with L(e) in df32
        # (error relative to |L(e)| ~ |r|, so drift << tol); one f64
        # residual at entry, one to verify, cleanup loop only on drift
        # (see mg_nodal.nodal_solve)
        from iamr_tpu.ops.df32 import residual_cell_df as _rdf

        lev0 = levels[0]

        def apply_df(e):
            return -_rdf(e, jnp.zeros_like(e), lev0.alpha, lev0.beta, a, b,
                         lev0.dx, bc)

        def bodyB(state):
            phi, r, _, it = state
            e = _vcycle(
                r.astype(jnp.float32), levels32, a, b32, bc, 0,
                nu1, nu2, nu_bottom, binv,
            ).astype(dtype)
            phi = phi + e
            if singular:
                phi = phi - invariant_mean(phi)  # constants in L's nullspace
            r = r - apply_df(e)
            return phi, r, jnp.max(jnp.abs(r)), it + 1

        rB = residual_f64(phi)
        phi, _, _, itB = jax.lax.while_loop(
            cond_phase(0.5 * tol), bodyB,
            (phi, rB, jnp.max(jnp.abs(rB)), jnp.asarray(0)),
        )
        rV = residual_f64(phi)
        phi, _, res, itC = jax.lax.while_loop(
            cond_phase(tol), body_with(residual_f64),
            (phi, rV, jnp.max(jnp.abs(rV)), jnp.asarray(0)),
        )
        return finalize(phi), res, itA + itB + itC

    r0 = residual_f64(phi)
    phi, _, res, it = jax.lax.while_loop(
        cond_phase(tol), body_with(residual_f64),
        (phi, r0, jnp.max(jnp.abs(r0)), jnp.asarray(0)),
    )
    return finalize(phi), res, it


def get_fluxes(phi, beta, b: float, dx, bc: PoissonBC, bvals: Optional[Dict] = None):
    """-b * beta * grad(phi) on all faces (for flux registers / MAC correction).

    Returns a tuple of face arrays (shape +1 in dim d).
    """
    dim = phi.ndim
    phi_g = _pad_phi(phi, bc)
    if bvals:
        phi_g = phi_g + _boundary_lift(tuple(phi.shape), bc, bvals, phi.dtype)
    fluxes = []
    for d in range(dim):
        idx_all = [slice(1, -1)] * dim
        idx_all[d] = slice(None)
        line = phi_g[tuple(idx_all)]
        # note: ghost-difference at a Dirichlet face equals the 2nd-order
        # one-sided gradient (-8/3 b + 3 c0 - 1/3 c1)/dx exactly
        grad = (sl(line, d, 1, None) - sl(line, d, 0, -1)) / dx[d]
        fluxes.append(-b * beta[d] * grad)
    return tuple(fluxes)
