"""Invariants of the XLA Godunov PLM predictor (ops/godunov.py).

extrap_vel_to_faces and advect_field are checked for what the scheme must
satisfy whatever its arithmetic order:
  * equivariance under a periodic shift of every input;
  * a uniform state stays uniform (uniform flow, with and without a uniform
    force; a constant scalar in a discretely divergence-free MAC field);
  * conservative periodic advection changes no total (sum of aofs = 0);
  * float32 agrees with float64 to the f32 floor;
  * edge states scale with the field (x2, exact) and shift with an offset.
The grids are 3D, periodic and walled (edge-filled ghosts), with and without
a force (AMReX-Hydro Godunov, reference NavierStokesBase.cpp:4477-4820).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from iamr_tpu.core.bc import BCRec, MathBC
from iamr_tpu.ops.godunov import (
    advect_field,
    compute_edge_states,
    extrap_vel_to_faces,
    grow_umac_transverse,
)

DT = 0.004
INT_RECS = [BCRec((MathBC.int_dir,) * 3, (MathBC.int_dir,) * 3)
            for _ in range(3)]
ZERO3 = ((0.0,) * 3,) * 3
SHIFT = (3, 5, 2)


def _pad(a, ng, periodic):
    return np.pad(a, ng, mode="wrap" if periodic else "edge")


def _roll_cells(a, shift=SHIFT):
    return np.roll(a, shift, axis=tuple(range(a.ndim)))


def _roll_face(u, d, shift=SHIFT):
    """Shift a wrap-consistent face array (face n == face 0)."""
    inner = np.take(u, np.arange(u.shape[d] - 1), axis=d)
    inner = _roll_cells(inner, shift)
    return np.concatenate([inner, np.take(inner, [0], axis=d)], axis=d)


def _max_rel(a, b):
    scale = max(float(np.max(np.abs(b))), 1.0)
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b)))) / scale


def _extrap(vel, force, n, periodic, dtype=jnp.float64):
    vel_g = np.stack([_pad(vel[c], 3, periodic) for c in range(3)])
    force_g = np.stack([_pad(force[c], 1, periodic) for c in range(3)])
    dx = tuple(1.0 / x for x in n)
    return extrap_vel_to_faces(
        jnp.asarray(vel_g, dtype), jnp.asarray(force_g, dtype), DT, dx, n,
        INT_RECS, ZERO3, ZERO3,
    )


@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("force", [True, False])
@pytest.mark.parametrize("n", [(16, 16, 16), (16, 24, 32), (8, 8, 16)])
def test_extrap_invariants(periodic, force, n):
    rng = np.random.RandomState(0)
    vel = 0.4 * rng.randn(3, *n)
    f = rng.randn(3, *n) if force else np.zeros((3,) + n)
    ref = _extrap(vel, f, n, periodic)
    for d in range(3):
        assert ref[d].shape == tuple(x + (d == e) for e, x in enumerate(n))

    got32 = _extrap(vel, f, n, periodic, jnp.float32)
    for d in range(3):
        assert got32[d].dtype == jnp.float32
        assert _max_rel(got32[d], ref[d]) < 1e-4, d

    if periodic:
        rolled = _extrap(
            np.stack([_roll_cells(v) for v in vel]),
            np.stack([_roll_cells(x) for x in f]), n, periodic,
        )
        for d in range(3):
            want = _roll_face(np.asarray(ref[d]), d)
            assert _max_rel(rolled[d], want) < 1e-13, d

    # uniform flow is preserved exactly (no force: slopes and transverse
    # terms vanish)
    U = (0.3, -0.2, 0.1)
    uni = np.stack([np.full(n, u) for u in U])
    faces = _extrap(uni, np.zeros((3,) + n), n, periodic)
    for d in range(3):
        assert _max_rel(faces[d], np.full(faces[d].shape, U[d])) < 1e-15


def test_extrap_uniform_flow_uniform_force():
    """A uniform force enters every face state as dt/2 * f."""
    n = (16, 16, 16)
    U = (0.3, -0.2, 0.1)
    F = (1.5, -0.5, 2.0)
    uni = np.stack([np.full(n, u) for u in U])
    f = np.stack([np.full(n, x) for x in F])
    faces = _extrap(uni, f, n, True)
    for d in range(3):
        want = np.full(faces[d].shape, U[d] + 0.5 * DT * F[d])
        assert _max_rel(faces[d], want) < 1e-15


def _divfree_umac(rng, n, periodic):
    """Discretely divergence-free MAC field from a stream function on the
    (x, y) edges, plus a constant z velocity."""
    psi = 0.05 * rng.randn(n[0] + 1, n[1] + 1, n[2])
    if periodic:
        psi[-1] = psi[0]
        psi[:, -1] = psi[:, 0]
    dx = tuple(1.0 / x for x in n)
    ux = (psi[:, 1:] - psi[:, :-1]) / dx[1]
    uy = -(psi[1:] - psi[:-1]) / dx[0]
    uz = np.full((n[0], n[1], n[2] + 1), 0.1)
    return ux, uy, uz


def _advect(s, umac, n, periodic, iconserv, force=None, dtype=jnp.float64):
    dx = tuple(1.0 / x for x in n)
    per = (periodic,) * 3
    um = tuple(jnp.asarray(u, dtype) for u in umac)
    ug = grow_umac_transverse(um, per)
    fg = None if force is None else jnp.asarray(_pad(force, 1, periodic),
                                                dtype)
    return advect_field(
        jnp.asarray(_pad(s, 3, periodic), dtype), um, ug, DT, dx, n,
        iconserv, s_cc=None if iconserv else jnp.asarray(s, dtype),
        force_g=fg, periodic=per,
    )


@pytest.mark.parametrize("iconserv", [True, False])
@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("force", [False, True])
def test_advect_invariants(iconserv, periodic, force):
    n = (16, 16, 16)
    rng = np.random.RandomState(1)
    umac = _divfree_umac(rng, n, periodic)
    s = rng.rand(*n)
    f = rng.rand(*n) - 0.5 if force else None
    fl, aofs = _advect(s, umac, n, periodic, iconserv, f)
    assert aofs.shape == n

    _, a32 = _advect(s, umac, n, periodic, iconserv, f, jnp.float32)
    assert a32.dtype == jnp.float32
    assert _max_rel(a32, aofs) < 1e-4

    if periodic:
        rumac = tuple(_roll_face(u, d) for d, u in enumerate(umac))
        rf = None if f is None else _roll_cells(f)
        _, ra = _advect(_roll_cells(s), rumac, n, periodic, iconserv, rf)
        assert _max_rel(ra, _roll_cells(np.asarray(aofs))) < 1e-13
        if iconserv:
            # telescoping fluxes: advection moves mass, creates none
            total = float(jnp.sum(aofs)) * float(np.prod([1.0 / x for x in n]))
            assert abs(total) < 1e-13 * float(np.max(np.abs(aofs)))

    # a constant field in a divergence-free flow stays constant
    _, a0 = _advect(np.full(n, 0.7), umac, n, periodic, iconserv)
    assert float(jnp.max(jnp.abs(a0))) < 1e-12


@pytest.mark.parametrize("periodic", [True, False])
def test_edge_states_scale_and_offset(periodic):
    """Limited slopes, predictor and upwinding are homogeneous of degree 1
    and commute with adding a constant: edges(2 s + k) = 2 edges(s) + k."""
    n = (16, 16, 16)
    rng = np.random.RandomState(2)
    umac = _divfree_umac(rng, n, periodic)
    per = (periodic,) * 3
    dx = tuple(1.0 / x for x in n)
    ug = grow_umac_transverse(tuple(jnp.asarray(u) for u in umac), per)
    s = rng.rand(*n)

    def edges(q):
        return compute_edge_states(
            jnp.asarray(_pad(q, 3, periodic)), ug, DT, dx, n, False,
            periodic=per,
        )

    base = edges(s)
    scaled = edges(2.0 * s)
    shifted = edges(s + 3.0)
    for d in range(3):
        assert _max_rel(scaled[d], 2.0 * np.asarray(base[d])) == 0.0, d
        assert _max_rel(shifted[d], np.asarray(base[d]) + 3.0) < 1e-14, d
