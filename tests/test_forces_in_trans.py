"""godunov.use_forces_in_trans semantics (NavierStokesBase.cpp:556-557,
4491,4715 -> AMReX-Hydro Godunov): the 0.5*dt*f term moves from the final
face states into the normal-predictor (hat) states feeding the transverse
terms. A/B contract against the default path:

  * zero forcing: the flag is EXACTLY a no-op (bitwise);
  * nonzero forcing: the two forms differ only through the transverse
    derivative of the force term, an O(dt^2) difference — both stay
    consistent (same result as dt -> 0).
"""

import numpy as np
import jax.numpy as jnp

from iamr_tpu.core.bc import BCRec, MathBC
from iamr_tpu.ops.godunov import (
    advect_field,
    compute_edge_states,
    extrap_vel_to_faces,
    grow_umac_transverse,
)


def _setup(n=16, dim=3, seed=3):
    rng = np.random.RandomState(seed)
    ng = 3
    shape_g = (n + 2 * ng,) * dim
    vel_g = jnp.asarray(rng.rand(dim, *shape_g) - 0.5)
    force_g = jnp.asarray(rng.rand(dim, *((n + 2,) * dim)) - 0.5)
    dx = (1.0 / n,) * dim
    recs = [BCRec((MathBC.int_dir,) * dim, (MathBC.int_dir,) * dim)
            for _ in range(dim)]
    zeros = tuple(tuple(0.0 for _ in range(dim)) for _ in range(dim))
    return vel_g, force_g, 0.01, dx, (n,) * dim, recs, zeros, zeros


def test_extrap_noop_with_zero_force():
    vel_g, force_g, dt, dx, n, recs, bl, bh = _setup()
    fz = jnp.zeros_like(force_g)
    a = extrap_vel_to_faces(vel_g, fz, dt, dx, n, recs, bl, bh,
                            use_forces_in_trans=False)
    b = extrap_vel_to_faces(vel_g, fz, dt, dx, n, recs, bl, bh,
                            use_forces_in_trans=True)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_extrap_difference_is_second_order_in_dt():
    vel_g, force_g, dt0, dx, n, recs, bl, bh = _setup()
    diffs = []
    for dt in (0.01, 0.005):
        a = extrap_vel_to_faces(vel_g, force_g, dt, dx, n, recs, bl, bh,
                                use_forces_in_trans=False)
        b = extrap_vel_to_faces(vel_g, force_g, dt, dx, n, recs, bl, bh,
                                use_forces_in_trans=True)
        diffs.append(max(float(jnp.max(jnp.abs(x - y)))
                         for x, y in zip(a, b)))
    assert diffs[0] > 0.0  # the flag actually does something
    # halving dt must cut the A/B difference ~4x (second order)
    assert diffs[1] < 0.35 * diffs[0], diffs


def test_edge_states_noop_with_zero_force_and_dt2_difference():
    vel_g, force_g, dt0, dx, n, recs, bl, bh = _setup()
    rng = np.random.RandomState(7)
    s_g = jnp.asarray(rng.rand(*vel_g.shape[1:]))
    umac = tuple(
        jnp.asarray(rng.rand(*[nn + (1 if d == e else 0) for e, nn in
                               enumerate(n)]) - 0.5)
        for d in range(3)
    )
    umac_g = grow_umac_transverse(umac, (True,) * 3)
    fz = jnp.zeros(tuple(x + 2 for x in n))
    fg = jnp.asarray(rng.rand(*fz.shape) - 0.5)
    a = compute_edge_states(s_g, umac_g, 0.01, dx, n, True, force_g=fz,
                            periodic=(True,) * 3,
                            use_forces_in_trans=False)
    b = compute_edge_states(s_g, umac_g, 0.01, dx, n, True, force_g=fz,
                            periodic=(True,) * 3,
                            use_forces_in_trans=True)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    diffs = []
    for dt in (0.01, 0.005):
        a = compute_edge_states(s_g, umac_g, dt, dx, n, True, force_g=fg,
                                periodic=(True,) * 3,
                                use_forces_in_trans=False)
        b = compute_edge_states(s_g, umac_g, dt, dx, n, True, force_g=fg,
                                periodic=(True,) * 3,
                                use_forces_in_trans=True)
        diffs.append(max(float(jnp.max(jnp.abs(x - y)))
                         for x, y in zip(a, b)))
    assert diffs[0] > 0.0
    assert diffs[1] < 0.35 * diffs[0], diffs


def test_advect_field_threads_flag():
    # the advect_field wrapper must hand the flag down: with a force and
    # the flag on, results differ from flag off
    vel_g, force_g, dt, dx, n, recs, bl, bh = _setup()
    rng = np.random.RandomState(11)
    s_g = jnp.asarray(rng.rand(*vel_g.shape[1:]))
    umac = tuple(
        jnp.asarray(rng.rand(*[nn + (1 if d == e else 0) for e, nn in
                               enumerate(n)]) - 0.5)
        for d in range(3)
    )
    umac_g = grow_umac_transverse(umac, (True,) * 3)
    fg = jnp.asarray(rng.rand(*tuple(x + 2 for x in n)) - 0.5)
    _, a = advect_field(s_g, umac, umac_g, dt, dx, n, True, force_g=fg,
                        periodic=(True,) * 3, use_forces_in_trans=False)
    _, b = advect_field(s_g, umac, umac_g, dt, dx, n, True, force_g=fg,
                        periodic=(True,) * 3, use_forces_in_trans=True)
    assert float(jnp.max(jnp.abs(a - b))) > 0.0
