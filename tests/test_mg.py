"""Multigrid tests against manufactured solutions (reference tolerances:
nodal/MAC rtol 1e-12...1e-11, Source/Projection.cpp:18-20, MacProj.cpp:49-51)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from iamr_tpu.ops.mg import (
    DIRICHLET,
    NEUMANN,
    PERIODIC,
    PoissonBC,
    apply_op,
    _pad_phi,
    get_fluxes,
    mg_solve,
)
from iamr_tpu.ops.stencil import cell_to_face


def _grid(n, dim, lo=0.0, hi=1.0):
    dx = (hi - lo) / n
    xs = [lo + (np.arange(n) + 0.5) * dx for _ in range(dim)]
    return np.meshgrid(*xs, indexing="ij"), dx


def _ones_beta(shape, dim, dtype=jnp.float64):
    out = []
    for d in range(dim):
        s = list(shape)
        s[d] += 1
        out.append(jnp.ones(s, dtype=dtype))
    return tuple(out)


def test_periodic_poisson_2d_exact():
    n = 64
    (X, Y), dx = _grid(n, 2)
    k = 2 * np.pi
    phi_exact = np.sin(k * X) * np.cos(k * Y)
    rhs = -2 * k**2 * phi_exact  # lap(phi) = rhs -> solve -div(grad phi) = -rhs
    bc = PoissonBC(lo=(PERIODIC, PERIODIC), hi=(PERIODIC, PERIODIC))
    beta = _ones_beta((n, n), 2)
    phi, res, it = mg_solve(
        jnp.asarray(-rhs), jnp.zeros((n, n)), beta, 0.0, 1.0, (dx, dx), bc,
        rtol=1e-12,
    )
    assert float(res) < 1e-12 * np.max(np.abs(rhs))
    err = np.asarray(phi - phi.mean()) - (phi_exact - phi_exact.mean())
    # discretization error ~ O(dx^2)
    assert np.max(np.abs(err)) < 2e-3
    assert int(it) < 20


def test_periodic_poisson_convergence_order():
    errs = []
    for n in (32, 64):
        (X, Y), dx = _grid(n, 2)
        k = 2 * np.pi
        phi_exact = np.sin(k * X) * np.cos(k * Y)
        rhs = 2 * k**2 * phi_exact
        bc = PoissonBC(lo=(PERIODIC, PERIODIC), hi=(PERIODIC, PERIODIC))
        phi, res, _ = mg_solve(
            jnp.asarray(rhs), jnp.zeros((n, n)), _ones_beta((n, n), 2),
            0.0, 1.0, (dx, dx), bc, rtol=1e-12,
        )
        err = np.asarray(phi - phi.mean()) - (phi_exact - phi_exact.mean())
        errs.append(np.max(np.abs(err)))
    order = np.log2(errs[0] / errs[1])
    assert order > 1.8, f"order {order}, errs {errs}"


def test_dirichlet_poisson_2d():
    n = 64
    (X, Y), dx = _grid(n, 2)
    # phi = sin(pi x) sin(pi y), phi=0 on boundary
    phi_exact = np.sin(np.pi * X) * np.sin(np.pi * Y)
    rhs = 2 * np.pi**2 * phi_exact
    bc = PoissonBC(lo=(DIRICHLET, DIRICHLET), hi=(DIRICHLET, DIRICHLET))
    phi, res, it = mg_solve(
        jnp.asarray(rhs), jnp.zeros((n, n)), _ones_beta((n, n), 2),
        0.0, 1.0, (dx, dx), bc, rtol=1e-12,
    )
    assert float(res) < 1e-12 * np.max(np.abs(rhs))
    assert np.max(np.abs(np.asarray(phi) - phi_exact)) < 5e-4


def test_inhomogeneous_dirichlet():
    # phi = x^2 + y^2 is in the discrete null... use linear+quad exact to dx^2
    n = 32
    (X, Y), dx = _grid(n, 2)
    phi_exact = X * X + Y * Y
    rhs = -4.0 * np.ones_like(X)  # -lap(phi)... lap = 4 -> -div grad phi = -4
    bc = PoissonBC(lo=(DIRICHLET, DIRICHLET), hi=(DIRICHLET, DIRICHLET))
    xf = (np.arange(n) + 0.5) * dx
    bvals = {
        (0, 0): jnp.asarray(0.0 + xf**2),     # x=0 face: y^2
        (0, 1): jnp.asarray(1.0 + xf**2),     # x=1 face: 1+y^2
        (1, 0): jnp.asarray(xf**2 + 0.0),
        (1, 1): jnp.asarray(xf**2 + 1.0),
    }
    phi, res, it = mg_solve(
        jnp.asarray(rhs), jnp.zeros((n, n)), _ones_beta((n, n), 2),
        0.0, 1.0, (dx, dx), bc, bvals=bvals, rtol=1e-12,
    )
    err = np.max(np.abs(np.asarray(phi) - phi_exact))
    assert err < 1e-8, err  # quadratic is exactly represented by the stencil


def test_neumann_dirichlet_mixed():
    n = 64
    (X, Y), dx = _grid(n, 2)
    # phi = cos(pi x) * sin(pi y): dphi/dx = 0 at x=0,1 (Neumann), phi=0 at y=0,1
    phi_exact = np.cos(np.pi * X) * np.sin(np.pi * Y)
    rhs = 2 * np.pi**2 * phi_exact
    bc = PoissonBC(lo=(NEUMANN, DIRICHLET), hi=(NEUMANN, DIRICHLET))
    # rtol 1e-11: the f64 roundoff floor is ~|L| * |rhs| * eps ~ 8e-12 here
    phi, res, it = mg_solve(
        jnp.asarray(rhs), jnp.zeros((n, n)), _ones_beta((n, n), 2),
        0.0, 1.0, (dx, dx), bc, rtol=1e-11,
    )
    assert float(res) < 1e-11 * np.max(np.abs(rhs))
    assert np.max(np.abs(np.asarray(phi) - phi_exact)) < 1e-3


def test_variable_coefficient_abec():
    # (alpha - div beta grad) phi = rhs with manufactured solution,
    # rhs computed by applying the DISCRETE operator (checks solver, not disc.)
    n = 32
    (X, Y), dx = _grid(n, 2)
    key = jax.random.PRNGKey(0)
    phi_exact = jnp.asarray(np.sin(2 * np.pi * X) * np.cos(2 * np.pi * Y))
    alpha = 1.0 + jnp.asarray(0.5 * np.cos(2 * np.pi * X))
    rho = 1.0 + 0.7 * jnp.asarray(np.sin(2 * np.pi * (X + Y)))
    beta = tuple(cell_to_face(1.0 / rho, d, bc_wrap=True) for d in range(2))
    bc = PoissonBC(lo=(PERIODIC, PERIODIC), hi=(PERIODIC, PERIODIC))
    a, b = 2.0, 0.5
    phi_g = _pad_phi(phi_exact, bc)
    rhs = apply_op(phi_g, alpha, beta, a, b, (dx, dx), (n, n))
    phi, res, it = mg_solve(
        rhs, alpha, beta, a, b, (dx, dx), bc, rtol=1e-12,
    )
    assert float(res) < 1e-12 * float(jnp.max(jnp.abs(rhs)))
    assert float(jnp.max(jnp.abs(phi - phi_exact))) < 1e-10


def test_3d_periodic_poisson():
    n = 32
    dx = 1.0 / n
    x = (np.arange(n) + 0.5) * dx
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    k = 2 * np.pi
    phi_exact = np.sin(k * X) * np.cos(k * Y) * np.sin(k * Z)
    rhs = 3 * k**2 * phi_exact
    bc = PoissonBC(lo=(PERIODIC,) * 3, hi=(PERIODIC,) * 3)
    phi, res, it = mg_solve(
        jnp.asarray(rhs), jnp.zeros((n, n, n)), _ones_beta((n, n, n), 3),
        0.0, 1.0, (dx,) * 3, bc, rtol=1e-11,
    )
    assert float(res) < 1e-11 * np.max(np.abs(rhs))
    err = np.asarray(phi - phi.mean()) - (phi_exact - phi_exact.mean())
    assert np.max(np.abs(err)) < 1e-2


def test_fluxes_match_gradient():
    n = 32
    (X, Y), dx = _grid(n, 2)
    phi = jnp.asarray(np.sin(2 * np.pi * X) * np.cos(2 * np.pi * Y))
    bc = PoissonBC(lo=(PERIODIC, PERIODIC), hi=(PERIODIC, PERIODIC))
    beta = _ones_beta((n, n), 2)
    fx, fy = get_fluxes(phi, beta, 1.0, (dx, dx), bc)
    assert fx.shape == (n + 1, n) and fy.shape == (n, n + 1)
    # interior face check: flux = -(phi_i - phi_{i-1})/dx
    expect = -(np.asarray(phi)[1:, :] - np.asarray(phi)[:-1, :]) / dx
    np.testing.assert_allclose(np.asarray(fx)[1:-1, :], expect, rtol=1e-12)
    # periodic wrap consistency
    np.testing.assert_allclose(np.asarray(fx)[0], np.asarray(fx)[-1], rtol=1e-12)


def test_jit_and_fixed_cycles():
    n = 32
    (X, Y), dx = _grid(n, 2)
    rhs = jnp.asarray(np.sin(2 * np.pi * X) * np.cos(2 * np.pi * Y))
    bc = PoissonBC(lo=(PERIODIC, PERIODIC), hi=(PERIODIC, PERIODIC))
    beta = _ones_beta((n, n), 2)

    @jax.jit
    def run(r):
        phi, res, it = mg_solve(
            r, jnp.zeros((n, n)), beta, 0.0, 1.0, (dx, dx), bc, fixed_cycles=10
        )
        return phi, res

    phi, res = run(rhs)
    assert float(res) < 1e-10 * float(jnp.max(jnp.abs(rhs)))


def test_bottom_cg_solves_exactly():
    """The CG bottom solve (reference default bottom solver bicgcg,
    SURVEY section 2.2) reproduces the dense solution of a small
    variable-coefficient Dirichlet problem to solver accuracy — point
    relaxation alone leaves an O(1) error at this size in few sweeps."""
    import numpy as np
    import jax.numpy as jnp
    from iamr_tpu.ops.mg import (
        DIRICHLET,
        PoissonBC,
        _bottom_cg,
        _pad_phi,
        apply_op,
        build_hierarchy,
    )

    n = (8, 8)
    dx = (1.0 / 8, 1.0 / 8)
    rng = np.random.RandomState(7)
    rhs = jnp.asarray(rng.rand(*n) - 0.5)
    beta = tuple(
        jnp.asarray(0.1 + rng.rand(*[m + (1 if d == e else 0)
                                     for e, m in enumerate(n)]) ** 2 * 10)
        for d in range(2)
    )
    bc = PoissonBC((DIRICHLET, DIRICHLET), (DIRICHLET, DIRICHLET))
    alpha = jnp.zeros(n)
    lev = build_hierarchy(alpha, beta, 0.0, 1.0, dx, bc, min_size=8)[0]
    x = _bottom_cg(rhs, lev, 0.0, 1.0, bc, iters=80)
    r = rhs - apply_op(_pad_phi(x, bc), lev.alpha, lev.beta, 0.0, 1.0, dx, n)
    assert float(jnp.max(jnp.abs(r))) < 1e-8 * float(jnp.max(jnp.abs(rhs)))


def test_moderate_anisotropy_converges():
    """10:1 anisotropy: the V-cycle with the CG bottom still reaches a
    usable tolerance (point smoothers degrade with anisotropy; line
    smoothers/semi-coarsening are the full fix and are out of scope)."""
    import numpy as np
    import jax.numpy as jnp
    from iamr_tpu.ops.mg import PoissonBC, DIRICHLET, mg_solve

    n = (32, 32)
    dx = (1.0 / 32, 0.2 / 32)
    rng = np.random.RandomState(4)
    rhs = jnp.asarray(rng.rand(*n) - 0.5)
    beta = tuple(
        jnp.ones(tuple(m + (1 if d == e else 0) for e, m in enumerate(n)))
        for d in range(2)
    )
    bc = PoissonBC((DIRICHLET, DIRICHLET), (DIRICHLET, DIRICHLET))
    phi, res, it = mg_solve(
        rhs, jnp.zeros(n), beta, 0.0, 1.0, dx, bc, rtol=1e-8,
        max_vcycles=80,
    )
    bnorm = float(jnp.max(jnp.abs(rhs)))
    assert float(res) < 1e-6 * bnorm, (float(res), int(it))


def test_mixed_precision_cell_reaches_f64_tolerance():
    """Iterative refinement: f32 V-cycles with f64 residual/correction
    reach rtol 1e-11 on an f64 variable-coefficient problem (the
    tolerance the pure-f32 path stalls 5 decades short of)."""
    P, D, N = PERIODIC, DIRICHLET, NEUMANN
    n = 32
    shape = (n, n, n)
    dx = tuple(1.0 / n for _ in range(3))
    rng = np.random.RandomState(5)
    x = (np.arange(n) + 0.5) / n
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    rhs = jnp.asarray(
        np.sin(2 * np.pi * X) * np.cos(2 * np.pi * Y) * np.sin(2 * np.pi * Z),
        jnp.float64,
    )
    alpha = jnp.asarray(1.0 + rng.rand(*shape), jnp.float64)
    bc = PoissonBC((P, D, N), (P, N, D))
    beta = []
    for d in range(3):
        bshape = [s + (1 if d == e else 0) for e, s in enumerate(shape)]
        bd = (0.5 + rng.rand(*bshape)).astype(np.float64)
        if d == 0:
            bd[-1] = bd[0]
        beta.append(jnp.asarray(bd))
    phi, res, it = mg_solve(
        rhs, alpha, tuple(beta), 1.0, 0.1, dx, bc, rtol=1e-11, mixed=True,
    )
    bnorm = float(jnp.max(jnp.abs(rhs)))
    assert float(res) < 1e-11 * bnorm, (float(res), int(it))
    assert phi.dtype == jnp.float64
