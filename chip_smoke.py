"""Smoke run of the IAMR step on one NVIDIA GPU, through the entry points a
user calls, at the benchmark's size, with every result checked.

Phases, in one process on one card:
  1. device: JAX's device must be a GPU; prints its kind, the card's name
     and power limit (nvidia-smi) and the JAX version.
  2. main path, f64: `python -m iamr_tpu examples/inputs.3d.hit_forced`
     at 256^3 for 3 steps (the forced HIT tutorial; spectral solvers).
  3. multigrid path, f32: the same case with ns.dtype=float32
     ns.fft_solve=0 (the path every walled or variable-density run takes).
  4. subcycled AMR: a 2-level double shear layer with a 512^2 coarse level
     through the driver's multilevel runner, 3 coarse steps.
  5. parity against the plain reference: a 64^3 HIT step on the GPU against
     the same step on the host CPU, and one f64 nodal solve whose residual
     numpy recomputes (ops/np_nodal.py).
  6. for phases 2-4: compiled.memory_analysis() of the step, the device's
     peak bytes in use, backend compile seconds and steady step seconds.
     These are set-up figures, not benchmark results.

`--four` runs only the sharded path on four cards and what it is compared
with: the 256^3 f64 spectral HIT step sharded over four cards (pencil
all-to-all FFTs) against one card, then __graft_entry__.dryrun_multichip(4).

The last line of standard output is one JSON object,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
A phase that fails raises, and the script exits non-zero. Without a GPU it
exits 1 before any phase runs.

Usage: python chip_smoke.py [--four]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.setrecursionlimit(100000)  # the step traces a deep graph

REPO = os.path.dirname(os.path.abspath(__file__))
HIT_INPUTS = os.path.join(REPO, "examples", "inputs.3d.hit_forced")

# max|du| / max|u| after 3 steps, GPU f64 vs CPU f64: reduction order and
# cuFFT vs the CPU FFT differ only in rounding
F64_LIMIT = 1e-10
# GPU f32 vs CPU f64: the f32 floor (the HIT forcing and LES einsums ask for
# HIGHEST precision, so no TF32 product enters the step)
F32_LIMIT = 1e-4
# nodal solve tolerance, checked on the numpy-recomputed residual
NODAL_RTOL = 1e-11
# sharded (4 cards) vs one card, f64: distributed FFT and halo exchanges
# change only the rounding
SHARD_LIMIT = 1e-10


def log(msg: str) -> None:
    print(msg, flush=True)


class CompileClock:
    """Sums JAX's backend compile durations while active."""

    def __init__(self):
        from jax import monitoring

        self.seconds = 0.0
        self.active = False
        monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, name, secs, **_):
        if self.active and name == "/jax/core/compile/backend_compile_duration":
            self.seconds += secs

    def __enter__(self):
        self.seconds = 0.0
        self.active = True
        return self

    def __exit__(self, *exc):
        self.active = False


def _peak_bytes(device) -> str:
    stats = device.memory_stats()
    if not stats or "peak_bytes_in_use" not in stats:
        return "not available on this backend"
    return f"{stats['peak_bytes_in_use']} (process peak so far)"


def _max_rel(a, b) -> float:
    import numpy as np

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _check_finite(label, arr, shape):
    import jax.numpy as jnp

    if tuple(arr.shape) != tuple(shape):
        raise AssertionError(f"{label}: shape {arr.shape}, expected {shape}")
    if not bool(jnp.all(jnp.isfinite(arr))):
        raise FloatingPointError(f"{label}: non-finite values")


def _set_up_figures(label, step, args, clock, device, reps=3):
    """Phase 6 for one program: memory analysis of `step` lowered on
    `args`, backend compile seconds of the driver run, steady seconds of
    the compiled step."""
    import jax

    compiled = step.lower(*args).compile()
    jax.block_until_ready(compiled(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = compiled(*args)
    jax.block_until_ready(out)
    steady = (time.perf_counter() - t0) / reps
    log(f"[6] {label}: memory_analysis {compiled.memory_analysis()}")
    log(f"[6] {label}: peak_bytes_in_use {_peak_bytes(device)}; backend "
        f"compile {clock.seconds:.3f} s during the driver run; steady step "
        f"{steady:.6f} s (mean of {reps})")
    return steady


def phase_device():
    """Phase 1. Returns the device record; exits 1 without a GPU."""
    import jax

    from iamr_tpu.utils.device_info import (
        card_name_and_power_limit,
        device_record,
    )

    rec = device_record()
    if rec["platform"] != "gpu":
        print(f"chip_smoke: no GPU (JAX's default device is "
              f"{rec['platform']}); nothing was run", file=sys.stderr)
        sys.exit(1)
    from iamr_tpu import native
    from iamr_tpu.utils.compile_cache import cache_dir, enable_compile_cache

    enable_compile_cache()
    log(f"[1] device_kind {rec['kind']}; {rec['count']} device(s); "
        f"jax {jax.__version__}")
    log(f"[1] compile cache {cache_dir()}; native library loaded: "
        f"{native.available()}")
    log(f"[1] nvidia-smi name, power.limit: {card_name_and_power_limit()}")
    return rec


def phase_cli(label, n, overrides, clock):
    """Phases 2-3: the CLI path on the HIT tutorial at n^3, 3 steps."""
    import jax
    import jax.numpy as jnp

    from iamr_tpu import __main__ as cli
    from iamr_tpu.config.parmparse import ParmParse
    from iamr_tpu.ns.advance import make_step
    from iamr_tpu.ns.probs import init_state
    from iamr_tpu.ns.state import config_from_inputs
    from iamr_tpu.solvers.spectral import spectral_eligible

    argv = [HIT_INPUTS, f"amr.n_cell={n} {n} {n}", "max_step=3",
            "amr.plot_int=-1", *overrides]
    t0 = time.perf_counter()
    with clock:
        state = cli.run(argv)
        jax.block_until_ready(state)
    wall = time.perf_counter() - t0
    cfg = config_from_inputs(ParmParse.from_file(argv[0], argv[1:]))
    _check_finite(label, state.vel, (3, n, n, n))
    if state.vel.dtype != jnp.dtype(cfg.dtype):
        raise AssertionError(f"{label}: dtype {state.vel.dtype}, "
                             f"expected {cfg.dtype}")
    # the driver decides on the initial density, as here
    sp = spectral_eligible(cfg, init_state(cfg).rho)
    log(f"[{label}] {n}^3 {cfg.dtype} spectral={sp}: 3 steps through "
        f"python -m iamr_tpu in {wall:.3f} s wall (compiles included), "
        f"max|u| {float(jnp.max(jnp.abs(state.vel))):.6g}")
    _set_up_figures(label, make_step(cfg, None, spectral=sp), (state,),
                    clock, jax.devices()[0])
    return state


def amr_config(n):
    from iamr_tpu.config.parmparse import ParmParse
    from iamr_tpu.ns.state import config_from_inputs

    pp = ParmParse.from_string(
        f"""
        max_step = 3
        ns.cfl = 0.5
        ns.init_iter = 1
        amr.n_cell = {n} {n}
        amr.max_level = 1
        geometry.is_periodic = 1 1
        prob.probtype = 5
        prob.density_ic = 1.0
        """
    )
    return config_from_inputs(pp)


def phase_amr(n, clock):
    """Phase 4: 2-level subcycled run through the driver, 3 coarse steps."""
    import jax

    from iamr_tpu.amr.multilevel import make_two_level_step
    from iamr_tpu.ns.driver import default_fine_spec, run_multilevel

    jax.config.update("jax_enable_x64", True)
    cfg = amr_config(n)
    t0 = time.perf_counter()
    with clock:
        ml = run_multilevel(cfg, verbose=True, subcycle=True)
        jax.block_until_ready(ml)
    wall = time.perf_counter() - t0
    spec = default_fine_spec(cfg)
    _check_finite("4 coarse", ml.crse.vel, (2, n, n))
    _check_finite("4 fine", ml.fine.vel, (2,) + tuple(spec.ncell))
    log(f"[4] 2-level subcycled, coarse {n}^2, fine {spec.ncell} at lo "
        f"{spec.lo}: 3 coarse steps in {wall:.3f} s wall (compiles "
        "included)")
    _set_up_figures("4", make_two_level_step(cfg, spec, None, subcycle=True),
                    (ml,), clock, jax.devices()[0])
    return ml


def _hit_steps(n, dtype, device, nsteps=3):
    """nsteps of the HIT step at n^3, from the seeded initial state, with
    every array and the program placed on `device`."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from iamr_tpu.config.parmparse import ParmParse
    from iamr_tpu.ns.advance import make_step
    from iamr_tpu.ns.probs import init_state
    from iamr_tpu.ns.state import config_from_inputs
    from iamr_tpu.solvers.spectral import spectral_eligible

    cfg = config_from_inputs(ParmParse.from_file(
        HIT_INPUTS, [f"amr.n_cell={n} {n} {n}"]))
    cfg = dataclasses.replace(cfg, dtype=dtype)
    with jax.default_device(device):
        state = init_state(cfg)
        state = state._replace(dt=jnp.asarray(5e-3, cfg.jdtype))
        sp = spectral_eligible(cfg, state.rho)
        step = make_step(cfg, None, spectral=sp)
        for _ in range(nsteps):
            state = step(state)
        vel = jax.block_until_ready(state.vel)
    if list(vel.devices()) != [device]:
        raise AssertionError(f"step ran on {vel.devices()}, not {device}")
    return vel


def nodal_problem(n):
    """A variable-coefficient periodic nodal Poisson problem (demeaned rhs,
    as the singular system needs) in numpy float64."""
    import numpy as np

    from iamr_tpu.ops.mg_nodal import N_PERIODIC, NodalBC
    from iamr_tpu.ops.np_nodal import np_div_cell_to_node

    dx = (1.0 / n,) * 3
    bc = NodalBC((N_PERIODIC,) * 3, (N_PERIODIC,) * 3)
    rng = np.random.RandomState(11)
    x = (np.arange(n) + 0.5) / n
    X, Y, _ = np.meshgrid(x, x, x, indexing="ij")
    sigma = 1.0 / (1.0 + 0.5 * np.sin(2 * np.pi * X) * np.cos(2 * np.pi * Y))
    u = tuple(rng.rand(n, n, n) - 0.5 for _ in range(3))
    rhs = np_div_cell_to_node(u, dx, bc)
    own = np.ones(rhs.shape)
    own[-1] = 0.0
    own[:, -1] = 0.0
    own[:, :, -1] = 0.0
    rhs = rhs - (rhs * own).sum() / own.sum()
    return rhs, sigma, dx, bc


def phase_parity(n, nodal_n, device, host):
    """Phase 5: the step on `device` against the same step on `host`, and
    one f64 nodal solve checked by the numpy oracle. Raises on a breach."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from iamr_tpu.ops.mg_nodal import nodal_solve
    from iamr_tpu.ops.np_nodal import np_residual_nodal

    jax.config.update("jax_enable_x64", True)
    ref = _hit_steps(n, "float64", host)
    errs = {
        "f64": (_max_rel(_hit_steps(n, "float64", device), ref), F64_LIMIT),
        "f32": (_max_rel(_hit_steps(n, "float32", device), ref), F32_LIMIT),
    }
    for name, (err, lim) in errs.items():
        log(f"[5] {n}^3 HIT, 3 steps, {device.platform} {name} vs "
            f"{host.platform} f64: max|du|/max|u| = {err:.3e} "
            f"(limit {lim:.0e})")

    rhs, sigma, dx, bc = nodal_problem(nodal_n)
    with jax.default_device(device):
        solve = jax.jit(lambda r, s: nodal_solve(r, s, dx, bc,
                                                 rtol=NODAL_RTOL, atol=0.0))
        phi, _, cycles = solve(jnp.asarray(rhs), jnp.asarray(sigma))
    resid = np_residual_nodal(np.asarray(phi), rhs, sigma, None, dx, bc)
    rel = float(np.max(np.abs(resid)) / np.max(np.abs(rhs)))
    log(f"[5] {nodal_n}^3 f64 nodal solve on {device.platform}: "
        f"{int(cycles)} V-cycles, numpy-recomputed max|r|/max|rhs| = "
        f"{rel:.3e} (limit {NODAL_RTOL:.0e})")
    errs["nodal"] = (rel, NODAL_RTOL)
    bad = {k: v for k, v in errs.items() if not v[0] <= v[1]}
    if bad:
        raise AssertionError(f"parity limits breached: {bad}")


def phase_sharded(n, devices):
    """--four: the f64 spectral HIT step sharded over `devices` against the
    same step on devices[0] alone."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from iamr_tpu.config.parmparse import ParmParse
    from iamr_tpu.ns.advance import make_step
    from iamr_tpu.ns.probs import init_state
    from iamr_tpu.ns.state import config_from_inputs
    from iamr_tpu.parallel import SpatialMesh, shard_state, use_mesh
    from iamr_tpu.solvers.spectral import spectral_eligible

    jax.config.update("jax_enable_x64", True)
    cfg = config_from_inputs(ParmParse.from_file(
        HIT_INPUTS, [f"amr.n_cell={n} {n} {n}"]))
    cfg = dataclasses.replace(cfg, dtype="float64")
    with jax.default_device(devices[0]):
        state = init_state(cfg)
        state = state._replace(dt=jnp.asarray(5e-3, cfg.jdtype))
    if not spectral_eligible(cfg, state.rho):
        raise AssertionError("HIT config is not on the spectral path")

    def three_steps(step, s):
        for _ in range(3):
            s = step(s)
        return jax.block_until_ready(s.vel)

    pmesh = SpatialMesh.create(len(devices), dim=3, devices=devices)
    with use_mesh(pmesh):
        sh = shard_state(state, pmesh)
        step = make_step(cfg, None, spectral=True).lower(sh).compile()
        counts = step.as_text().count("all-to-all(")
        t0 = time.perf_counter()
        out = three_steps(step, sh)
        wall = time.perf_counter() - t0
    with jax.default_device(devices[0]):
        ref = three_steps(make_step(cfg, None, spectral=True), state)
    err = _max_rel(out, ref)
    log(f"[four] {n}^3 f64 spectral HIT, 3 steps on mesh "
        f"{'x'.join(map(str, pmesh.shape))} ({len(devices)} devices, "
        f"{counts} all-to-all ops in the step): sharded vs one device "
        f"max|du|/max|u| = {err:.3e} (limit {SHARD_LIMIT:.0e}); "
        f"{wall:.3f} s wall")
    if not err <= SHARD_LIMIT:
        raise AssertionError(f"sharded step differs: {err:.3e}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="only the sharded path on four cards")
    args = ap.parse_args(argv)

    device = phase_device()
    import jax

    if args.four:
        if device["count"] < 4:
            raise RuntimeError(f"--four needs 4 GPUs, found {device['count']}")
        import __graft_entry__

        phase_sharded(256, jax.devices()[:4])
        __graft_entry__.dryrun_multichip(4)
    else:
        clock = CompileClock()
        phase_cli("2", 256, [], clock)
        phase_cli("3", 256, ["ns.dtype=float32", "ns.fft_solve=0"], clock)
        phase_amr(512, clock)
        phase_parity(64, 128, jax.devices()[0], jax.devices("cpu")[0])
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
