"""Nodal multigrid tests: FEM-operator oracle (dense assembly via quadrature),
D/G adjointness, and manufactured-solution solves."""

import itertools

import jax.numpy as jnp
import numpy as np

from iamr_tpu.ops.mg_nodal import (
    N_DIRICHLET,
    N_NEUMANN,
    N_PERIODIC,
    NodalBC,
    apply_nodal,
    div_cell_to_node,
    grad_node_to_cell,
    nodal_diag,
    nodal_solve,
)


def _dense_fem_matrix(ncell, dx, sigma):
    """Independent dense assembly of the sigma-weighted FEM Laplacian using
    2-point Gauss quadrature per dim (oracle for apply_nodal)."""
    dim = len(ncell)
    nn = tuple(n + 1 for n in ncell)
    nnodes = int(np.prod(nn))
    A = np.zeros((nnodes, nnodes))

    gp = np.array([0.5 - 0.5 / np.sqrt(3), 0.5 + 0.5 / np.sqrt(3)])
    gw = np.array([0.5, 0.5])

    def shape_grads(xi):  # xi in [0,1]^dim; returns (2^dim, dim) gradients
        corners = list(itertools.product((0, 1), repeat=dim))
        out = np.zeros((len(corners), dim))
        for a_i, a in enumerate(corners):
            for d in range(dim):
                g = 1.0
                for e in range(dim):
                    if e == d:
                        g *= (1.0 if a[e] == 1 else -1.0) / dx[e]
                    else:
                        g *= a[e] * xi[e] + (1 - a[e]) * (1 - xi[e])
                out[a_i, d] = g
        return out

    def nid(idx):
        out = 0
        for d in range(dim):
            out = out * nn[d] + idx[d]
        return out

    corners = list(itertools.product((0, 1), repeat=dim))
    vol = float(np.prod(dx))
    for cell in itertools.product(*[range(n) for n in ncell]):
        Kloc = np.zeros((len(corners), len(corners)))
        for q in itertools.product(range(2), repeat=dim):
            xi = np.array([gp[q[d]] for d in range(dim)])
            w = float(np.prod([gw[q[d]] for d in range(dim)])) * vol
            G = shape_grads(xi)
            Kloc += w * (G @ G.T)
        Kloc *= sigma[cell]
        ids = [nid(tuple(cell[d] + a[d] for d in range(dim))) for a in corners]
        for i, gi in enumerate(ids):
            for j, gj in enumerate(ids):
                A[gi, gj] -= Kloc[i, j] / vol
    return A


def test_apply_nodal_matches_dense_fem_2d():
    rng = np.random.default_rng(0)
    ncell = (6, 4)
    dx = (0.3, 0.2)
    sigma = rng.uniform(0.5, 2.0, ncell)
    bc = NodalBC(lo=(N_NEUMANN, N_NEUMANN), hi=(N_NEUMANN, N_NEUMANN))
    A = _dense_fem_matrix(ncell, dx, sigma)
    phi = rng.standard_normal((7, 5))
    expect = (A @ phi.ravel()).reshape(7, 5)
    got = np.asarray(apply_nodal(jnp.asarray(phi), jnp.asarray(sigma), dx, bc))
    np.testing.assert_allclose(got, expect, rtol=1e-12, atol=1e-12)


def test_apply_nodal_matches_dense_fem_3d():
    rng = np.random.default_rng(1)
    ncell = (4, 4, 2)
    dx = (0.25, 0.25, 0.5)
    sigma = rng.uniform(0.5, 2.0, ncell)
    bc = NodalBC(lo=(N_NEUMANN,) * 3, hi=(N_NEUMANN,) * 3)
    A = _dense_fem_matrix(ncell, dx, sigma)
    nn = tuple(n + 1 for n in ncell)
    phi = rng.standard_normal(nn)
    expect = (A @ phi.ravel()).reshape(nn)
    got = np.asarray(apply_nodal(jnp.asarray(phi), jnp.asarray(sigma), dx, bc))
    np.testing.assert_allclose(got, expect, rtol=1e-12, atol=1e-12)


def test_diag_matches_dense():
    rng = np.random.default_rng(2)
    ncell = (4, 6)
    dx = (0.1, 0.25)
    sigma = rng.uniform(0.5, 2.0, ncell)
    bc = NodalBC(lo=(N_NEUMANN, N_NEUMANN), hi=(N_NEUMANN, N_NEUMANN))
    A = _dense_fem_matrix(ncell, dx, sigma)
    got = np.asarray(nodal_diag(jnp.asarray(sigma), dx, bc))
    np.testing.assert_allclose(got.ravel(), np.diag(A), rtol=1e-12)


def test_div_grad_adjoint_walls():
    rng = np.random.default_rng(3)
    ncell = (8, 6)
    dx = (0.125, 0.2)
    bc = NodalBC(lo=(N_NEUMANN, N_NEUMANN), hi=(N_NEUMANN, N_NEUMANN))
    u = tuple(jnp.asarray(rng.standard_normal(ncell)) for _ in range(2))
    phi = jnp.asarray(rng.standard_normal((9, 7)))
    Du = div_cell_to_node(u, dx, bc)
    Gphi = grad_node_to_cell(phi, dx)
    lhs = float(jnp.sum(Du * phi))
    rhs = -sum(float(jnp.sum(u[d] * Gphi[d])) for d in range(2))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-12)


def test_grad_exact_linear():
    n = 8
    dx = (1.0 / n, 1.0 / n)
    xn = np.arange(n + 1) * dx[0]
    X, Y = np.meshgrid(xn, xn, indexing="ij")
    phi = 2.0 * X - 3.0 * Y
    gx, gy = grad_node_to_cell(jnp.asarray(phi), dx)
    np.testing.assert_allclose(np.asarray(gx), 2.0, rtol=1e-13)
    np.testing.assert_allclose(np.asarray(gy), -3.0, rtol=1e-13)


def test_nodal_solve_periodic_2d():
    n = 64
    dx = (1.0 / n, 1.0 / n)
    xn = np.arange(n + 1) * dx[0]
    X, Y = np.meshgrid(xn, xn, indexing="ij")
    k = 2 * np.pi
    phi_exact = np.sin(k * X) * np.cos(k * Y)
    bc = NodalBC(lo=(N_PERIODIC, N_PERIODIC), hi=(N_PERIODIC, N_PERIODIC))
    sigma = jnp.ones((n, n))
    # rhs from the discrete operator so the solve is exact up to tolerance
    rhs = apply_nodal(jnp.asarray(phi_exact), sigma, dx, bc)
    phi, res, it = nodal_solve(rhs, sigma, dx, bc, rtol=1e-11)
    assert float(res) < 1e-11 * float(jnp.max(jnp.abs(rhs))), (float(res), int(it))
    err = np.asarray(phi) - phi_exact
    err -= err.mean()
    assert np.max(np.abs(err)) < 1e-8, np.max(np.abs(err))


def test_nodal_solve_walls_variable_sigma():
    n = 32
    dx = (1.0 / n, 1.0 / n)
    rng = np.random.default_rng(4)
    sigma = jnp.asarray(rng.uniform(0.5, 2.0, (n, n)))
    bc = NodalBC(lo=(N_NEUMANN, N_NEUMANN), hi=(N_NEUMANN, N_NEUMANN))
    xn = np.arange(n + 1) * dx[0]
    X, Y = np.meshgrid(xn, xn, indexing="ij")
    phi_exact = np.cos(np.pi * X) * np.cos(2 * np.pi * Y)
    rhs = apply_nodal(jnp.asarray(phi_exact), sigma, dx, bc)
    phi, res, it = nodal_solve(rhs, sigma, dx, bc, rtol=1e-10)
    assert float(res) < 1e-10 * float(jnp.max(jnp.abs(rhs))), (float(res), int(it))
    err = np.asarray(phi) - phi_exact
    err -= err.mean()
    assert np.max(np.abs(err)) < 1e-7, np.max(np.abs(err))


def test_nodal_solve_outflow_dirichlet():
    n = 32
    dx = (1.0 / n, 1.0 / n)
    sigma = jnp.ones((n, n))
    # outflow at xhi: phi=0 on that face; walls elsewhere
    bc = NodalBC(lo=(N_NEUMANN, N_NEUMANN), hi=(N_DIRICHLET, N_NEUMANN))
    xn = np.arange(n + 1) * dx[0]
    X, Y = np.meshgrid(xn, xn, indexing="ij")
    phi_exact = np.cos(0.5 * np.pi * X) * np.cos(np.pi * Y)  # zero at x=1
    rhs = apply_nodal(jnp.asarray(phi_exact), sigma, dx, bc)
    # mask rhs rows at Dirichlet nodes (solver enforces phi=0 there)
    phi, res, it = nodal_solve(rhs, sigma, dx, bc, rtol=1e-10)
    assert float(res) < 1e-10 * float(jnp.max(jnp.abs(rhs))), (float(res), int(it))
    assert np.max(np.abs(np.asarray(phi)[-1, :])) == 0.0
    err = np.asarray(phi) - phi_exact
    assert np.max(np.abs(err)) < 1e-7, np.max(np.abs(err))


def test_nodal_solve_3d_periodic():
    n = 16
    dx = (1.0 / n,) * 3
    xn = np.arange(n + 1) * dx[0]
    X, Y, Z = np.meshgrid(xn, xn, xn, indexing="ij")
    k = 2 * np.pi
    phi_exact = np.sin(k * X) * np.cos(k * Y) * np.sin(k * Z)
    bc = NodalBC(lo=(N_PERIODIC,) * 3, hi=(N_PERIODIC,) * 3)
    sigma = jnp.ones((n, n, n))
    rhs = apply_nodal(jnp.asarray(phi_exact), sigma, dx, bc)
    phi, res, it = nodal_solve(rhs, sigma, dx, bc, rtol=1e-10)
    assert float(res) < 1e-10 * float(jnp.max(jnp.abs(rhs))), (float(res), int(it))


def test_mixed_precision_nodal_reaches_f64_tolerance():
    from iamr_tpu.ops.mg_nodal import build_nodal_hierarchy

    n = 32
    cshape = (n, n, n)
    nshape = (n + 1,) * 3
    dx = tuple(1.0 / n for _ in range(3))
    rng = np.random.RandomState(6)
    sigma = jnp.asarray(0.5 + rng.rand(*cshape), jnp.float64)
    rhs = jnp.asarray(rng.rand(*nshape) - 0.5, jnp.float64)
    bc = NodalBC((N_NEUMANN, N_DIRICHLET, N_NEUMANN),
                 (N_DIRICHLET, N_NEUMANN, N_DIRICHLET))
    phi, res, it = nodal_solve(rhs, sigma, dx, bc, rtol=1e-11, mixed=True)
    # nodal_solve masks the rhs; compare against the masked norm
    mask = build_nodal_hierarchy(sigma, dx, bc)[0].mask
    bnorm = float(jnp.max(jnp.abs(mask * rhs)))
    assert float(res) < 1e-11 * bnorm, (float(res), int(it))
    assert phi.dtype == jnp.float64
