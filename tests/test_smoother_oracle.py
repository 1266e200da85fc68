"""The XLA multigrid smoothers and residuals against numpy float64 oracles.

Cell: red-black Gauss-Seidel on the ABecLaplacian (mg._smooth_rb,
mg._residual) against a plain numpy ghost-fill + 7-point apply written here.
Nodal: damped Jacobi on the FEM nodal Laplacian (mg_nodal._jacobi,
mg_nodal._nodal_residual) against ops/np_nodal.np_apply_nodal. The grids
cover every BC kind, 2D and 3D, anisotropic spacings, with and without the
alpha term, and 0-3 sweeps.

Reference smoothers: AMReX MLMG GSRB (MLABecLaplacian,
Source/Diffusion.cpp:345-352) and Jacobi (MLNodeLaplacian,
Source/Projection.cpp:2512).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from iamr_tpu.ops import mg
from iamr_tpu.ops import mg_nodal as mn
from iamr_tpu.ops.mg import DIRICHLET, NEUMANN, PERIODIC, PoissonBC
from iamr_tpu.ops.mg_nodal import (
    N_DIRICHLET,
    N_NEUMANN,
    N_PERIODIC,
    NodalBC,
    build_nodal_hierarchy,
)
from iamr_tpu.ops.np_nodal import np_apply_nodal

P, D, N = PERIODIC, DIRICHLET, NEUMANN


def _np_sl(a, d, i0, i1):
    idx = [slice(None)] * a.ndim
    idx[d] = slice(i0, i1)
    return a[tuple(idx)]


def np_cell_pad(phi, bc):
    """One homogeneous ghost layer: wrap, Dirichlet-on-face
    (-2 c0 + c1/3) or zero-flux Neumann (c0)."""
    for d in range(phi.ndim):
        n = phi.shape[d]
        c0l, c1l = _np_sl(phi, d, 0, 1), _np_sl(phi, d, 1, 2)
        c0h, c1h = _np_sl(phi, d, n - 1, n), _np_sl(phi, d, n - 2, n - 1)
        if bc.lo[d] == P:
            lo, hi = c0h, c0l
        else:
            lo = -2.0 * c0l + c1l / 3.0 if bc.lo[d] == D else c0l
            hi = -2.0 * c0h + c1h / 3.0 if bc.hi[d] == D else c0h
        phi = np.concatenate([lo, phi, hi], axis=d)
    return phi


def np_cell_apply(phi, alpha, beta, a, b, dx, bc):
    """(a alpha - b div beta grad) phi in numpy float64."""
    dim = phi.ndim
    g = np_cell_pad(phi, bc)
    inner = tuple(slice(1, -1) for _ in range(dim))
    out = a * alpha * phi
    for d in range(dim):
        lo = list(inner)
        hi = list(inner)
        lo[d] = slice(0, -2)
        hi[d] = slice(2, None)
        bl = _np_sl(beta[d], d, 0, -1)
        bh = _np_sl(beta[d], d, 1, None)
        out = out - b * (bh * (g[tuple(hi)] - phi)
                         - bl * (phi - g[tuple(lo)])) / dx[d] ** 2
    return out


def np_cell_diag(alpha, beta, a, b, dx, bc):
    """Operator diagonal: an interior face adds beta/dx^2, a Dirichlet
    boundary face 3 beta/dx^2, a Neumann boundary face nothing."""
    dim = alpha.ndim
    diag = a * alpha
    for d in range(dim):
        cl = np.ones(alpha.shape)
        ch = np.ones(alpha.shape)
        if bc.lo[d] != P:
            first = [slice(None)] * dim
            first[d] = 0
            cl[tuple(first)] = 3.0 if bc.lo[d] == D else 0.0
            last = [slice(None)] * dim
            last[d] = -1
            ch[tuple(last)] = 3.0 if bc.hi[d] == D else 0.0
        diag = diag + b * (cl * _np_sl(beta[d], d, 0, -1)
                           + ch * _np_sl(beta[d], d, 1, None)) / dx[d] ** 2
    return diag


def np_gsrb(phi, rhs, alpha, beta, a, b, dx, bc, nsweeps):
    diag = np_cell_diag(alpha, beta, a, b, dx, bc)
    parity = sum(np.indices(phi.shape)) % 2
    for _ in range(nsweeps):
        for color in (0, 1):
            r = rhs - np_cell_apply(phi, alpha, beta, a, b, dx, bc)
            phi = phi + (parity == color) * r / diag
    return phi


def _mkbeta(rng, shape, bc):
    out = []
    for d in range(len(shape)):
        bshape = [s + (1 if d == e else 0) for e, s in enumerate(shape)]
        bd = 0.5 + rng.rand(*bshape)
        if bc.lo[d] == P:
            # periodic face arrays are wrap-consistent: face n == face 0
            _np_sl(bd, d, -1, None)[...] = _np_sl(bd, d, 0, 1)
        out.append(bd)
    return out


CELL_CASES = [
    # (shape, bc, a, b, dx or None for 1/n, nsweeps)
    ((16, 16, 16), PoissonBC((P, P, P), (P, P, P)), 0.0, 0.7, None, 2),
    ((16, 16, 16), PoissonBC((D, N, P), (N, D, P)), 1.0, 0.7, None, 2),
    ((16, 16), PoissonBC((D, P), (N, P)), 1.0, 0.7, None, 1),
    ((32, 16, 16), PoissonBC((P, P, P), (P, P, P)), 0.0, 0.7, None, 2),
    ((32, 16, 16), PoissonBC((D, N, D), (N, D, N)), 1.0, 0.7, None, 2),
    ((32, 16, 16), PoissonBC((D, P, P), (D, P, P)), 0.0, 0.7, None, 1),
    ((48, 16, 16), PoissonBC((N, P, D), (D, P, N)), 1.0, 0.7, None, 2),
    ((16, 12, 8), PoissonBC((P, N, D), (P, N, D)), 2.0, 0.7,
     (0.1, 0.2, 0.3), 1),
    ((16, 8), PoissonBC((N, P), (D, P)), 0.0, 1.0, (0.1, 0.2), 1),
]


@pytest.mark.parametrize("shape,bc,a,b,dx,nsweeps", CELL_CASES)
def test_cell_gsrb_matches_numpy(shape, bc, a, b, dx, nsweeps):
    rng = np.random.RandomState(0)
    dx = dx or tuple(1.0 / s for s in shape)
    phi = rng.rand(*shape)
    rhs = rng.rand(*shape)
    alpha = 1.0 + rng.rand(*shape) if a != 0.0 else np.zeros(shape)
    beta = _mkbeta(rng, shape, bc)
    lev = mg.build_hierarchy(jnp.asarray(alpha),
                             tuple(jnp.asarray(x) for x in beta),
                             a, b, dx, bc)[0]
    np.testing.assert_allclose(
        np.asarray(lev.diag), np_cell_diag(alpha, beta, a, b, dx, bc),
        rtol=1e-13)
    got = mg._smooth_rb(jnp.asarray(phi), jnp.asarray(rhs), lev, a, b, bc,
                        nsweeps)
    want = np_gsrb(phi, rhs, alpha, beta, a, b, dx, bc, nsweeps)
    scale = np.max(np.abs(want))
    assert np.max(np.abs(np.asarray(got) - want)) < 1e-12 * scale
    r_got = mg._residual(got, jnp.asarray(rhs), lev, a, b, bc)
    r_want = rhs - np_cell_apply(want, alpha, beta, a, b, dx, bc)
    rscale = max(np.max(np.abs(r_want)), 1.0)
    assert np.max(np.abs(np.asarray(r_got) - r_want)) < 1e-10 * rscale


def _periodic_consistent(a, bc):
    """Duplicated periodic node DOFs carry equal values (phi[0] == phi[-1])."""
    for d in range(a.ndim):
        if bc.lo[d] == N_PERIODIC:
            _np_sl(a, d, -1, None)[...] = _np_sl(a, d, 0, 1)
    return a


PER3 = NodalBC((N_PERIODIC,) * 3, (N_PERIODIC,) * 3)
NODAL_CASES = [
    # (cell shape, bc, dx or None for 1/n, nsweeps, omega or None for lev's)
    ((16, 16, 16), PER3, None, 2, None),
    ((16, 16, 16), NodalBC((N_NEUMANN, N_DIRICHLET, N_PERIODIC),
                           (N_DIRICHLET, N_NEUMANN, N_PERIODIC)),
     None, 2, None),
    ((16, 16), NodalBC((N_NEUMANN, N_PERIODIC), (N_DIRICHLET, N_PERIODIC)),
     None, 3, None),
    ((32, 16, 16), PER3, None, 2, None),
    ((32, 16, 16), NodalBC((N_NEUMANN, N_DIRICHLET, N_NEUMANN),
                           (N_DIRICHLET, N_NEUMANN, N_DIRICHLET)),
     None, 2, None),
    ((48, 16, 16), NodalBC((N_NEUMANN, N_PERIODIC, N_DIRICHLET),
                           (N_NEUMANN, N_PERIODIC, N_DIRICHLET)),
     None, 3, None),
    ((32, 16, 16), PER3, None, 2, 0.85),
    ((32, 16, 16), NodalBC((N_NEUMANN, N_DIRICHLET, N_NEUMANN),
                           (N_DIRICHLET, N_NEUMANN, N_DIRICHLET)),
     None, 2, 0.85),
    ((24, 16, 16), NodalBC((N_NEUMANN, N_PERIODIC, N_DIRICHLET),
                           (N_NEUMANN, N_PERIODIC, N_DIRICHLET)),
     None, 3, 0.85),
    ((32, 16, 16), PER3, None, 0, 0.85),
    ((16, 8), NodalBC((N_NEUMANN, N_PERIODIC), (N_NEUMANN, N_PERIODIC)),
     (0.1, 0.25), 1, 0.85),
    ((8, 8, 8), PER3, (0.1, 0.2, 0.15), 1, None),
]


@pytest.mark.parametrize("cshape,bc,dx,nsweeps,omega", NODAL_CASES)
def test_nodal_jacobi_matches_numpy(cshape, bc, dx, nsweeps, omega):
    rng = np.random.RandomState(1)
    nshape = tuple(c + 1 for c in cshape)
    dx = dx or tuple(1.0 / c for c in cshape)
    sigma = 0.5 + rng.rand(*cshape)
    phi = _periodic_consistent(rng.rand(*nshape), bc)
    rhs = _periodic_consistent(rng.rand(*nshape), bc)
    lev = build_nodal_hierarchy(jnp.asarray(sigma), dx, bc)[0]
    w = lev.omega if omega is None else omega
    # diag and mask are data here (nodal_diag has its own dense-FEM oracle
    # in test_mg_nodal); the oracle checks the sweep and the residual
    diag = np.asarray(lev.diag)
    mask = np.asarray(lev.mask)
    want = phi
    for _ in range(nsweeps):
        want = want + w * mask * (
            rhs - np_apply_nodal(want, sigma, dx, bc)) / diag
    got = mn._jacobi(jnp.asarray(phi), jnp.asarray(rhs), lev, bc, nsweeps, w)
    scale = np.max(np.abs(want))
    assert np.max(np.abs(np.asarray(got) - want)) < 1e-12 * scale
    r_got = mn._nodal_residual(got, jnp.asarray(rhs), lev, bc)
    r_want = mask * (rhs - np_apply_nodal(want, sigma, dx, bc))
    rscale = max(np.max(np.abs(r_want)), 1.0)
    assert np.max(np.abs(np.asarray(r_got) - r_want)) < 1e-10 * rscale
