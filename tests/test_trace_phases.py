"""trace_phases.py off the card: the trace reduction on synthetic and on
recorded host-only traces, and the phase programs at a tiny size."""

import glob
import os
import sys

import jax
import jax.numpy as jnp
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tp():
    sys.path.insert(0, REPO)
    try:
        import trace_phases
    finally:
        sys.path.remove(REPO)
    return trace_phases


def test_reduce_trace_and_top_kernels(tp):
    events = {
        "/device:GPU:0/Stream #13(Compute)": [
            ("loop_add_fusion", 3000.0), ("loop_select_fusion", 1000.0),
            ("loop_add_fusion", 3000.0), ("loop_select_fusion", 1000.0),
        ],
        "/device:GPU:0/Stream #14(MemcpyD2D)": [("MemcpyD2D", 500.0)] * 2,
    }
    kernels, secs = tp.reduce_trace(events, calls=2)
    assert kernels == 3.0
    assert secs == pytest.approx(4.5e-6)
    top = tp.top_kernels(events, calls=2, k=2)
    assert list(top) == ["loop_add_fusion", "loop_select_fusion"]
    assert top["loop_add_fusion"] == 3.0


def test_device_events_ignores_host_planes(tp, tmp_path):
    f = jax.jit(lambda x: jnp.sin(x) * 2.0)
    x = jnp.ones((64, 64))
    jax.block_until_ready(f(x))
    jax.profiler.start_trace(str(tmp_path))
    jax.block_until_ready(f(x))
    jax.profiler.stop_trace()
    path = glob.glob(str(tmp_path / "plugins" / "profile" / "*" /
                         "*.xplane.pb"))[0]
    assert tp.device_events(path) == {}


def test_phase_programs_run_small(tp):
    n = 8
    for name, (fn, args, nbytes) in tp._phases(n).items():
        out = jax.block_until_ready(fn(*args))
        leaves = jax.tree_util.tree_leaves(out)
        assert leaves and all(bool(jnp.all(jnp.isfinite(a))) for a in leaves)
        # every phase moves at least its n^3 float32 inputs and outputs
        assert nbytes >= 2 * 4 * n**3, name
