"""Profiling + debug utilities (the BL_PROFILE / TinyProfiler and
Docs/Debugging.rst equivalents; reference main.cpp:32-33,147-150).

* trace(path): context manager around any region -> jax.profiler trace
  viewable in xprof/tensorboard.
* step_timing_table(cfg, state, steps): per-stage wall times
  (TinyProfiler-style summary; stages compiled separately, so sums exceed
  the fused full step which overlaps them).
* enable_debug_nans(): jax_debug_nans (exit-on-NaN, the reference's NaN
  scans NavierStokes.cpp:847-854 made automatic).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict


def enable_debug_nans():
    import jax

    jax.config.update("jax_debug_nans", True)


@contextlib.contextmanager
def trace(path: str):
    import jax

    jax.profiler.start_trace(path)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def step_timing_table(cfg, state, steps: int = 3, fixed_mg_cycles=4) -> Dict[str, float]:
    import jax
    import jax.numpy as jnp

    from iamr_tpu.ns.advance import advance
    from iamr_tpu.solvers.mac import mac_project
    from iamr_tpu.solvers.nodal_proj import level_project

    out = {}

    def timeit(name, fn, *args):
        r = fn(*args)
        jax.block_until_ready(r)
        t0 = time.perf_counter()
        for _ in range(steps):
            r = fn(*args)
        jax.block_until_ready(r)
        out[name] = (time.perf_counter() - t0) / steps
        return r

    full = jax.jit(lambda s: advance(s, cfg, fixed_mg_cycles))
    timeit("full_step", full, state)

    umac0 = tuple(
        jnp.zeros(
            tuple(
                cfg.geom.ncell[e] + (1 if e == d else 0)
                for e in range(cfg.dim)
            ),
            cfg.jdtype,
        )
        for d in range(cfg.dim)
    )
    timeit(
        "mac_project",
        jax.jit(
            lambda u, r: mac_project(
                u, r, cfg.dom, cfg.geom.dx, fixed_cycles=fixed_mg_cycles
            )[0]
        ),
        umac0,
        state.rho,
    )
    timeit(
        "nodal_project",
        jax.jit(
            lambda v, r, p, gp: level_project(
                v, r, p, gp, 0.01, cfg.dom, cfg.geom.dx,
                fixed_cycles=fixed_mg_cycles,
            )[0]
        ),
        state.vel,
        state.rho,
        state.p,
        state.gradp,
    )
    return out
