"""nodal_solve_df: the non-x64 df32-resident nodal solve
(mg_nodal.py:nodal_solve_df) must reach f64-grade residuals with no f64 array in the program, verified
against host numpy float64 ground truth (ops/np_nodal.py).

Reference contract: the nodal projection MLMG driven to proj_tol
(/root/reference/Source/Projection.cpp:17-36)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from iamr_tpu.ops.mg_nodal import (
    N_PERIODIC, NodalBC, div_cell_to_node, nodal_solve, nodal_solve_df,
)
from iamr_tpu.ops.np_nodal import (
    np_div_cell_to_node, np_residual_nodal,
)


def _pair(x64):
    hi = np.asarray(x64, np.float32)
    lo = np.asarray(x64 - hi.astype(np.float64), np.float32)
    return jnp.asarray(hi), jnp.asarray(lo)


def _setup(n):
    dx = (1.0 / n,) * 3
    bc = NodalBC((N_PERIODIC,) * 3, (N_PERIODIC,) * 3)
    rng = np.random.RandomState(11)
    x = (np.arange(n) + 0.5) / n
    X, Y, _ = np.meshgrid(x, x, x, indexing="ij")
    rho = 1.0 + 0.5 * np.sin(2 * np.pi * X) * np.cos(2 * np.pi * Y)
    sigma = 1.0 / rho
    u = tuple(rng.rand(n, n, n) - 0.5 for _ in range(3))
    rhs = np_div_cell_to_node(u, dx, bc)
    # host-f64 demean over owned DOFs (the caller contract of
    # nodal_solve_df for the singular all-periodic system)
    own = np.ones(rhs.shape)
    own[-1, :, :] = 0.0
    own[:, -1, :] = 0.0
    own[:, :, -1] = 0.0
    rhs = rhs - (rhs * own).sum() / own.sum()
    return dx, bc, sigma, u, rhs


def test_np_div_matches_jnp():
    n = 16
    dx, bc, _, u, _ = _setup(n)
    got = np_div_cell_to_node(u, dx, bc)
    want = np.asarray(div_cell_to_node(
        tuple(jnp.asarray(ud, jnp.float64) for ud in u), dx, bc))
    assert np.max(np.abs(got - want)) < 1e-12


def test_df32_solve_reaches_f64_grade_residual():
    n = 32
    dx, bc, sigma, _, rhs = _setup(n)
    rh, rl = _pair(rhs)
    sh, sl = _pair(sigma)

    f = jax.jit(lambda a, b, c, d: nodal_solve_df(
        a, b, c, d, dx, bc, rtol=1e-10, atol=0.0))
    yh, yl, res, it = f(rh, rl, sh, sl)
    assert int(it) < 60, "df32 solve failed to converge"

    phi = np.asarray(yh, np.float64) + np.asarray(yl, np.float64)
    r_true = np_residual_nodal(phi, rhs, sigma, None, dx, bc)
    bnorm = np.max(np.abs(rhs))
    rel = np.max(np.abs(r_true)) / bnorm
    # in-context XLA:CPU whole-module optimization can degrade the df32
    # compensation to ~1e-8 relative (df32.py module docstring); the
    # structural-failure floor (plain f32 apply) is ~1e-4, so 1e-7 cleanly
    # separates "compensated arithmetic working" from "broken"
    assert rel < 1e-7, f"true residual {rel:.3e} not f64-grade"
    # the reported (df32-computed) residual must not understate the truth
    # by more than the same in-context degradation allowance
    assert np.max(np.abs(r_true)) < float(res) + 1e-7 * bnorm


def test_df32_solve_matches_x64_solve():
    """Same system solved by the x64 mixed path: solutions agree to f64
    grade (up to the singular system's constant)."""
    n = 16
    dx, bc, sigma, _, rhs = _setup(n)
    rh, rl = _pair(rhs)
    sh, sl = _pair(sigma)
    yh, yl, _, _ = jax.jit(lambda a, b, c, d: nodal_solve_df(
        a, b, c, d, dx, bc, rtol=1e-10, atol=0.0))(rh, rl, sh, sl)
    phi_df = np.asarray(yh, np.float64) + np.asarray(yl, np.float64)

    phi64, _, _ = nodal_solve(
        jnp.asarray(rhs, jnp.float64), jnp.asarray(sigma, jnp.float64),
        dx, bc, rtol=1e-12, atol=0.0, mixed=False)
    phi64 = np.asarray(phi64)
    d = phi_df - phi64
    d = d - d.mean()
    scale = np.max(np.abs(phi64))
    assert np.max(np.abs(d)) / scale < 1e-6
