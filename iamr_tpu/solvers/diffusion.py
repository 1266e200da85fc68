"""Crank-Nicolson diffusion solves (the Diffusion engine).

JAX equivalent of reference Source/Diffusion.cpp:
  * diffuse_scalar (Diffusion.cpp:207-600): semi-implicit CN update
        (alpha/dt - theta div beta grad) S^{n+1}
            = alpha/dt S* + (1-theta) div beta grad S^n
    with alpha the time-level-appropriate rho weighting (rho_flag variants)
  * diffuse_velocity (Diffusion.cpp:603-958): per-component CN solve for
    viscous stress. The reference uses the full tensor operator
    (MLTensorOp); for constant viscosity and solenoidal U the tensor
    divergence reduces to componentwise div mu grad; the tensor coupling
    terms are a planned extension (NS_LES variable-viscosity path).
  * getViscTerms (Diffusion.cpp:1540-1779): explicit operator apply.

theta = be_cn_theta = 0.5 default (reference NavierStokesBase.cpp:505-508).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from iamr_tpu.core.bc import BCRec, MathBC
from iamr_tpu.ops import mg
from iamr_tpu.ops.mg import DIRICHLET, NEUMANN, PERIODIC, PoissonBC


def poisson_bc_from_bcrec(bcrec: BCRec) -> PoissonBC:
    """Map per-variable math BCs to diffusion-solve BC kinds.

    ext_dir -> Dirichlet (value on face); reflect_odd -> homogeneous
    Dirichlet; int_dir -> periodic; foextrap/hoextrap/reflect_even ->
    Neumann (zero diffusive flux through the boundary).
    """

    def kind(b: MathBC):
        if b == MathBC.int_dir:
            return PERIODIC
        if b in (MathBC.ext_dir, MathBC.reflect_odd):
            return DIRICHLET
        return NEUMANN

    return PoissonBC(lo=tuple(kind(b) for b in bcrec.lo), hi=tuple(kind(b) for b in bcrec.hi))


def bvals_from_scalar(bcrec: BCRec, vals_lo, vals_hi, dim) -> Dict:
    """Dirichlet face values for ext_dir sides (reflect_odd gives 0)."""
    out = {}
    for d in range(dim):
        if bcrec.lo[d] == MathBC.ext_dir:
            out[(d, 0)] = vals_lo[d]
        elif bcrec.lo[d] == MathBC.reflect_odd:
            out[(d, 0)] = 0.0
        if bcrec.hi[d] == MathBC.ext_dir:
            out[(d, 1)] = vals_hi[d]
        elif bcrec.hi[d] == MathBC.reflect_odd:
            out[(d, 1)] = 0.0
    return out


def apply_diffusion_op(s, beta, dx, bc: PoissonBC, bvals: Optional[Dict] = None):
    """Explicit div(beta grad s) with inhomogeneous BCs (getViscTerms)."""
    shape = tuple(s.shape)
    phi_g = mg._pad_phi(s, bc)
    if bvals:
        phi_g = phi_g + mg._boundary_lift(shape, bc, bvals, s.dtype)
    # our operator is (a alpha - b div beta grad); apply with a=0, b=-1 to
    # get +div beta grad
    return mg.apply_op(phi_g, jnp.zeros_like(s), beta, 0.0, -1.0, dx, shape)


def diffuse_scalar(
    s_star,
    s_old,
    alpha_new,
    alpha_old,
    beta,
    dt,
    dx: Sequence[float],
    bcrec: BCRec,
    bvals_lo=None,
    bvals_hi=None,
    theta: float = 0.5,
    rtol: float = 1e-10,
    atol: float = 1e-14,
    fixed_cycles: Optional[int] = None,
    poisson_bc: Optional[PoissonBC] = None,
    poisson_bvals: Optional[Dict] = None,
    alpha_op=None,
    interior_mask=None,
    interior_vals=None,
    spectral=None,
    boxes=None,
):
    """CN diffusion update after advection.

    boxes: optional amr.boxbatch.UnionBoxExec — congruent multi-box union
    solves run on the box batch (ops/mg_batch.py) instead of the masked
    bbox MG; same system, same return convention.

    spectral: optional (alpha0, beta0) SCALARS of an all-periodic
    constant-coefficient solve — the Helmholtz solve runs in Fourier space
    (solvers.spectral), exact for the same 7-point discrete operator.
    Caller guarantees uniformity (spectral_eligible).

    interior_mask/interior_vals: level-wide multi-box solve (mg_solve
    union path) — the implicit solve runs on the box union with
    coarse-interpolated new-time values as interior Dirichlet data; the
    explicit old-time operator reads hole values straight from the filled
    s_old (cell-value Dirichlet, same order of accuracy).

    Solves (alpha_op - theta dt div beta grad) S^{n+1}
         = alpha_old_weighted RHS:  alpha_new S* + (1-theta) dt div beta grad S^n

    alpha_op defaults to alpha_new; EB callers pass alpha_op with the
    implicit wall-drag coefficient added (MLEBABecLap EB-Dirichlet flux
    folded into the diagonal) while alpha_new stays the rhs weight.

    where S* already contains the advective + forcing update (the reference
    assembles the same RHS split, Diffusion.cpp:380-470: old-time operator
    apply with b = -(1-theta)dt then the new-time solve). alpha_* are cell
    arrays (rho weightings; pass ones for constant-density passive scalars).

    Returns (S^{n+1}, fluxes) with fluxes = -theta*dt*beta*grad(S^{n+1})
    - (1-theta)*dt*beta*grad(S^n) scaled for flux registers... (flux register
    wiring arrives with multilevel support).
    """
    dim = s_star.ndim
    if poisson_bc is not None:
        bc = poisson_bc
        bvals = poisson_bvals or {}
    else:
        bc = poisson_bc_from_bcrec(bcrec)
        vals_lo = bvals_lo if bvals_lo is not None else (0.0,) * dim
        vals_hi = bvals_hi if bvals_hi is not None else (0.0,) * dim
        bvals = bvals_from_scalar(bcrec, vals_lo, vals_hi, dim)

    lap_old = apply_diffusion_op(s_old, beta, dx, bc, bvals)
    rhs = alpha_new * s_star + (1.0 - theta) * dt * lap_old

    if alpha_op is None:
        alpha_op = alpha_new

    if theta == 0.0:
        return rhs / alpha_op, None

    if spectral is not None and interior_mask is None:
        from iamr_tpu.solvers.spectral import solve_cell_helmholtz

        alpha0, beta0 = spectral
        s_new = solve_cell_helmholtz(rhs, alpha0, theta * dt * beta0, dx)
        return s_new, (jnp.zeros((), s_star.dtype), 0)

    if boxes is not None and interior_mask is not None:
        s_new, res, it = boxes.solve_cell(
            rhs, alpha_op, beta, 1.0, theta * dt, dx, bc, bvals,
            interior_vals, phi0=s_star, rtol=rtol, atol=atol,
            fixed_cycles=fixed_cycles,
        )
        return s_new, (res, it)
    s_new, res, it = mg.mg_solve(
        rhs,
        alpha_op,
        beta,
        1.0,
        theta * dt,
        dx,
        bc,
        phi0=s_star,
        bvals=bvals,
        rtol=rtol,
        atol=atol,
        fixed_cycles=fixed_cycles,
        interior_mask=interior_mask,
        interior_vals=interior_vals,
    )
    return s_new, (res, it)


def diffuse_velocity_component(
    u_star,
    u_old,
    rho_half,
    mu_faces,
    dt,
    dx: Sequence[float],
    bcrec: BCRec,
    bvals_lo=None,
    bvals_hi=None,
    theta: float = 0.5,
    rtol: float = 1e-10,
    atol: float = 1e-14,
    fixed_cycles: Optional[int] = None,
):
    """CN viscous solve for one velocity component:

    (rho_half - theta dt div mu grad) u^{n+1}
        = rho_half u* + (1-theta) dt div mu grad u^n

    u* is the post-advection/forcing provisional velocity
    (velocity_advection_update, reference NavierStokesBase.cpp:3523-3626).
    """
    return diffuse_scalar(
        u_star,
        u_old,
        rho_half,
        rho_half,
        mu_faces,
        dt,
        dx,
        bcrec,
        bvals_lo,
        bvals_hi,
        theta,
        rtol,
        atol,
        fixed_cycles,
    )


def visc_terms_component(
    u,
    mu_faces,
    dx,
    bcrec: BCRec,
    bvals_lo=None,
    bvals_hi=None,
    poisson_bc: Optional[PoissonBC] = None,
    poisson_bvals: Optional[Dict] = None,
):
    """Explicit viscous term div mu grad u (getViscTerms equivalent)."""
    dim = u.ndim
    if poisson_bc is not None:
        return apply_diffusion_op(u, mu_faces, dx, poisson_bc, poisson_bvals or {})
    bc = poisson_bc_from_bcrec(bcrec)
    vals_lo = bvals_lo if bvals_lo is not None else (0.0,) * dim
    vals_hi = bvals_hi if bvals_hi is not None else (0.0,) * dim
    bvals = bvals_from_scalar(bcrec, vals_lo, vals_hi, dim)
    return apply_diffusion_op(u, mu_faces, dx, bc, bvals)
