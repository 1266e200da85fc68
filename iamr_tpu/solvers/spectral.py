"""Spectral (FFT) solvers for all-periodic, constant-coefficient problems.

The MAC projection, nodal projection, and CN diffusion solves of an
all-periodic run with uniform density and constant viscosity are
constant-coefficient operators: their discrete stencils (7-point cell
ABecLaplacian, 27-point FEM nodal Laplacian) are convolutions, so one
rfftn + symbol divide + irfftn solves them EXACTLY (to roundoff) — the
analogue of AMReX's FFT Poisson path (amrex/Src/FFT), replacing
4+ multigrid V-cycles per solve with two transforms and a better answer.
MLMG (ops.mg / ops.mg_nodal) remains the general path for every other BC /
coefficient configuration; eligibility is decided host-side before jit
(`spectral_eligible`) and via ns.fft_solve (-1 auto / 0 off / 1 on).

The symbols are the exact Fourier transforms of the SAME discrete
operators the multigrid solves (ops.mg.apply_op with constant beta;
ops.mg_nodal.apply_nodal with constant sigma) — not continuous-operator
approximations — so the projected divergence / CN update is bit-for-bit
the converged MG answer, and the solve-quality metrics (max divergence
after step) improve.

Reference: Source/MacProj.cpp:225-352, Source/Projection.cpp:166-449,
Source/Diffusion.cpp:380-470 define the systems; this module only swaps
the linear solver underneath them.
"""

from __future__ import annotations

from typing import Sequence

import jax.numpy as jnp
import numpy as np


def _cell_minus_lap_symbol(shape, dx, dtype):
    """Symbol of MINUS the 7-point cell Laplacian: sum_d (2-2cos k_d)/h_d^2
    (positive semidefinite), rfftn layout over `shape`."""
    dim = len(shape)
    sym = None
    for d in range(dim):
        n = shape[d]
        if d == dim - 1:
            k = 2.0 * np.pi * np.fft.rfftfreq(n)
        else:
            k = 2.0 * np.pi * np.fft.fftfreq(n)
        s = (2.0 - 2.0 * np.cos(k)) / (dx[d] * dx[d])
        sh = [1] * dim
        sh[d] = len(k)
        sym = s.reshape(sh) if sym is None else sym + s.reshape(sh)
    return jnp.asarray(sym, dtype=dtype)


def _nodal_minus_lap_symbol(shape, dx, dtype):
    """Symbol of MINUS apply_nodal with sigma == 1 on the n^d periodic node
    lattice: sum_d (2-2cos k_d)/h_d^2 * prod_{e!=d} (4+2cos k_e)/6.

    Derivation: apply_nodal assembles -(1/V) sum_d S_d (x) prod M_e
    (mg_nodal._fem_element_matrix); the assembled periodic 1D stiffness
    S = (1/h)[[1,-1],[-1,1]] has symbol (2-2cos k)/h and the assembled 1D
    mass M = (h/6)[[2,1],[1,2]] has symbol h(4+2cos k)/6; dividing by
    V = prod h leaves the per-dim h^-2 stiffness factor and unit-weight
    mass factors."""
    dim = len(shape)
    stiff = []
    mass = []
    for d in range(dim):
        n = shape[d]
        if d == dim - 1:
            k = 2.0 * np.pi * np.fft.rfftfreq(n)
        else:
            k = 2.0 * np.pi * np.fft.fftfreq(n)
        stiff.append((2.0 - 2.0 * np.cos(k)) / (dx[d] * dx[d]))
        mass.append((4.0 + 2.0 * np.cos(k)) / 6.0)
    sym = None
    for d in range(dim):
        term = None
        for e in range(dim):
            f = stiff[e] if e == d else mass[e]
            sh = [1] * dim
            sh[e] = len(f)
            t = f.reshape(sh)
            term = t if term is None else term * t
        sym = term if sym is None else sym + term
    return jnp.asarray(sym, dtype=dtype)


def solve_cell_helmholtz(rhs, a_alpha0, b_beta0, dx: Sequence[float]):
    """Solve (a_alpha0 - b_beta0 * lap7) phi = rhs on the all-periodic cell
    grid with SCALAR coefficients (exact constant-coefficient ABecLaplacian
    inverse). a_alpha0 = a*alpha (may be a traced scalar), b_beta0 = b*beta.
    a_alpha0 == 0 (Poisson) is singular: the zero mode of rhs is discarded
    and phi returned mean-free (the MG solve has the same nullspace)."""
    shape = rhs.shape
    dtype = rhs.dtype
    from iamr_tpu.parallel.context import active as _active

    pm = _active()
    if pm is not None:
        from iamr_tpu.parallel.pfft import (
            pencil_eligible,
            solve_cell_helmholtz_pencil,
        )

        if pencil_eligible(shape, pm):
            return solve_cell_helmholtz_pencil(rhs, a_alpha0, b_beta0, dx, pm)
    sym = _cell_minus_lap_symbol(shape, dx, dtype)
    rh = jnp.fft.rfftn(rhs)
    denom = a_alpha0 + b_beta0 * sym
    zero = (0,) * rhs.ndim
    # regularize the (0,...,0) mode; exact when a_alpha0 > 0
    denom = denom.at[zero].set(jnp.where(jnp.abs(denom[zero]) > 0.0,
                                         denom[zero], 1.0))
    ph = rh / denom
    ph = jnp.where(jnp.asarray(a_alpha0, dtype) > 0.0,
                   ph, ph.at[zero].set(0.0))
    return jnp.fft.irfftn(ph, s=shape).astype(dtype)


def solve_nodal_poisson(rhs_nodes, sigma0, dx: Sequence[float]):
    """Solve apply_nodal(phi, sigma0*ones) = rhs on all-periodic NODES
    ((n+1)^d arrays whose last slice duplicates the first). Singular:
    solved mean-free over the n^d independent nodes. Returns the full
    (n+1)^d wrapped phi."""
    dim = rhs_nodes.ndim
    dtype = rhs_nodes.dtype
    inner = rhs_nodes[(slice(0, -1),) * dim]
    shape = inner.shape
    from iamr_tpu.parallel.context import active as _active

    pm = _active()
    phi = None
    if pm is not None:
        from iamr_tpu.parallel.pfft import (
            pencil_eligible,
            solve_nodal_poisson_pencil,
        )

        if pencil_eligible(shape, pm):
            phi = solve_nodal_poisson_pencil(inner, sigma0, dx, pm)
    if phi is None:
        sym = _nodal_minus_lap_symbol(shape, dx, dtype)
        # apply_nodal = -(assembled) -> minus symbol
        rh = jnp.fft.rfftn(-inner)
        zero = (0,) * dim
        denom = sym.at[zero].set(1.0) * sigma0
        ph = (rh / denom).at[zero].set(0.0)
        phi = jnp.fft.irfftn(ph, s=shape).astype(dtype)
    # wrap back to the (n+1)^d node array
    for d in range(dim):
        first = phi[tuple(
            slice(0, 1) if e == d else slice(None) for e in range(dim)
        )]
        phi = jnp.concatenate([phi, first], axis=d)
    return phi


def spectral_eligible(cfg, rho0_array=None) -> bool:
    """Host-side (pre-trace) eligibility of the FFT fast path for single
    level, non-EB, non-RZ advances: every side periodic, no LES (variable
    viscosity), and — in auto mode — a uniform initial density. ns.fft_solve:
    1 forces on (caller guarantees uniform rho), 0 off, -1 auto."""
    mode = getattr(cfg, "fft_solve", -1)
    if mode == 0:
        return False
    dim = cfg.dim
    if not all(cfg.dom.is_periodic(d) for d in range(dim)):
        return False
    if getattr(cfg, "do_les", False):
        return False
    if mode == 1:
        return True
    if rho0_array is None:
        return False
    import numpy as _np

    r = _np.asarray(rho0_array)
    return bool(_np.all(r == r.flat[0]))
