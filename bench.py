"""Headline benchmark: cell-updates/sec on 3D HIT forced isotropic
turbulence on one GPU (the BASELINE.md target config: reference
Tutorials/HIT/inputs.3d.forced scaled to 256^3, spectral low-wavenumber
forcing, tracer particles, full projection-method step: Godunov advection +
MAC projection + CN diffusion + nodal projection), in float32. The
all-periodic uniform-rho HIT config selects the exact spectral solvers
(solvers/spectral.py) like any production run (ns.fft_solve auto); the
fixed-4-V-cycle multigrid step every walled config takes is timed too.

Prints ONE JSON line naming the device (platform, device_kind, count) and
the card (nvidia-smi name and power.limit), with:
  * "value": cell-updates/s of the spectral-path step;
  * "mg_path_cells_per_s": the same for the multigrid step;
  * "max_div_after_step" (+ normalized) and "max_mac_div": solve quality of
    the final state — a fast step that under-solves shows up here;
  * "mlmg_rtol1e11_seconds" / "_cycles" / "mlmg_final_rel_resid": one nodal
    projection solve at n^3 driven to rtol 1e-11 by the df32 solve
    (mg_nodal.nodal_solve_df, no x64 needed), its residual recomputed in
    numpy float64 (reference tolerance Projection.cpp:18-20);
  * "nodal_div_f32_over_f64": post-step nodal divergence of a 32^3 f32 run
    over the same run in f64 (x64 is enabled for this last measurement).

Any platform other than "gpu", and any failure, exits non-zero.

Usage: python bench.py [n=256] [steps=3] [nparticles=65536]
"""

import dataclasses
import json
import sys
import time

import numpy as np

sys.setrecursionlimit(100000)  # the step traces a deep graph


def _hit_config(n, steps, dtype):
    from iamr_tpu.config.parmparse import ParmParse
    from iamr_tpu.ns.state import config_from_inputs

    # the HIT forced config (Tutorials/HIT/inputs.3d.forced) at n^3
    pp = ParmParse.from_string(
        f"""
        max_step = {steps}
        amr.n_cell = {n} {n} {n}
        ns.cfl = 0.7
        ns.init_iter = 0
        ns.vel_visc_coef = 1.e-4
        ns.scal_diff_coefs = 0.0
        geometry.prob_lo = -0.5 -0.5 -0.5
        geometry.prob_hi = 0.5 0.5 0.5
        geometry.is_periodic = 1 1 1
        ns.lo_bc = 0 0 0
        ns.hi_bc = 0 0 0
        prob.probtype = 100
        turb.nmodes = 4
        turb.div_free_force = 1
        """
    )
    return dataclasses.replace(config_from_inputs(pp), dtype=dtype)


def _mlmg_to_tolerance(n: int):
    """Nodal-projection MLMG wall time to rtol 1e-11 (BASELINE.md metric),
    by the df32 solve; the relative residual is recomputed host-side in
    numpy float64 (ops/np_nodal) outside the timed region.
    Returns (seconds, cycles, true relative residual)."""
    import jax
    import jax.numpy as jnp

    from iamr_tpu.ops.mg_nodal import N_PERIODIC, NodalBC, nodal_solve_df
    from iamr_tpu.ops.np_nodal import np_div_cell_to_node, np_residual_nodal

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

    def pair(a):
        hi = np.asarray(a, np.float32)
        lo = np.asarray(a - hi.astype(np.float64), np.float32)
        return jnp.asarray(hi), jnp.asarray(lo)

    rh, rl = pair(rhs)
    sh, sl = pair(sigma)
    f = jax.jit(lambda a, b, c, d: nodal_solve_df(a, b, c, d, dx, bc,
                                                  rtol=1e-11, atol=0.0))
    jax.block_until_ready(f(rh, rl, sh, sl))
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        out = f(rh, rl, sh, sl)
    jax.block_until_ready(out)
    secs = (time.perf_counter() - t0) / reps
    yh, yl, _, it = out
    phi = np.asarray(yh, np.float64) + np.asarray(yl, np.float64)
    r_true = np_residual_nodal(phi, rhs, sigma, None, dx, bc)
    return secs, int(it), float(np.max(np.abs(r_true))) / float(
        np.max(np.abs(rhs)))


def _nodal_div_norm(n: int, steps: int, dtype: str) -> float:
    """Post-step max nodal divergence / (max|u| / dx) of the HIT step at n^3
    with fixed-cycle solves (tests/test_nodal_quality.py at bench time)."""
    import jax.numpy as jnp

    from iamr_tpu.ns.advance import advance, make_hit_forcing
    from iamr_tpu.ns.probs import init_state
    from iamr_tpu.ops.mg_nodal import N_PERIODIC, NodalBC, div_cell_to_node

    cfg = _hit_config(n, steps, dtype)
    state = init_state(cfg)
    state = state._replace(dt=jnp.asarray(5e-3, cfg.jdtype))
    hit = make_hit_forcing(cfg)
    for _ in range(steps):
        state = advance(state, cfg, fixed_mg_cycles=4, hit=hit)
    bc = NodalBC((N_PERIODIC,) * 3, (N_PERIODIC,) * 3)
    div = div_cell_to_node(tuple(state.vel[d] for d in range(3)),
                           cfg.geom.dx, bc)
    umax = float(jnp.max(jnp.abs(state.vel)))
    return float(jnp.max(jnp.abs(div))) / (umax / float(cfg.geom.dx[0]))


def main(argv=()):
    import jax

    from iamr_tpu.utils.compile_cache import enable_compile_cache
    from iamr_tpu.utils.device_info import (
        card_name_and_power_limit,
        require_gpu,
    )

    device = require_gpu()
    card_name, card_power_limit = card_name_and_power_limit().rsplit(", ", 1)
    enable_compile_cache()
    import jax.numpy as jnp
    from jax import lax

    n = int(argv[0]) if len(argv) > 0 else 256
    steps = int(argv[1]) if len(argv) > 1 else 3
    nparticles = int(argv[2]) if len(argv) > 2 else 65536

    from iamr_tpu.ns.advance import advance, make_hit_forcing
    from iamr_tpu.ns.particles import advect_with_umac, from_positions
    from iamr_tpu.ns.probs import init_state
    from iamr_tpu.solvers.spectral import spectral_eligible

    cfg = _hit_config(n, steps, "float32")
    state = init_state(cfg)
    state = state._replace(dt=jnp.asarray(5e-3, dtype=cfg.jdtype))
    hit = make_hit_forcing(cfg)
    rng = np.random.RandomState(7)
    parts = from_positions(
        jnp.asarray(rng.rand(nparticles, 3) - 0.5, cfg.jdtype), dtype=cfg.jdtype
    )
    sp = spectral_eligible(cfg, np.asarray(state.rho))

    def _make_runner(spectral_flag):
        """All timed steps inside ONE jitted fori_loop: one dispatch for the
        whole window, as production runs amortize dispatch over many inner
        steps. The last step's MAC velocities ride the carry so the
        divergence check below needs no second full-step compile."""

        @jax.jit
        def run(state, parts, nsteps):
            umac0 = tuple(
                jnp.zeros_like(state.rho, shape=tuple(
                    nc + (1 if d == e else 0)
                    for e, nc in enumerate(cfg.geom.ncell)))
                for d in range(3)
            )

            def body(_, carry):
                s, p, _ = carry
                ns, umac = advance(
                    s, cfg, fixed_mg_cycles=4, hit=hit, return_umac=True,
                    spectral=spectral_flag,
                )
                p = advect_with_umac(p, umac, s.dt, cfg.geom)
                return ns, p, tuple(umac)

            return lax.fori_loop(0, nsteps, body, (state, parts, umac0))

        return run

    def timed_window(run):
        # the first call compiles (1 step); the window reuses the program
        s, p, _ = jax.block_until_ready(run(state, parts, 1))
        t0 = time.perf_counter()
        out = jax.block_until_ready(run(s, p, steps))
        return out, time.perf_counter() - t0

    (s, _, umac_f), dt_wall = timed_window(_make_runner(sp))
    umax = float(jnp.max(jnp.abs(s.vel)))
    if not np.isfinite(umax):
        raise FloatingPointError("non-finite state after bench steps")

    # the reference's check_div_cond (MacProj.cpp:792-846): max divergence
    # of the MAC-projected face velocities of the final step
    mac_div = sum(
        (umac_f[d][tuple(slice(1, None) if e == d else slice(None)
                         for e in range(3))]
         - umac_f[d][tuple(slice(0, -1) if e == d else slice(None)
                           for e in range(3))]) / cfg.geom.dx[d]
        for d in range(3)
    )
    max_mac_div = float(jnp.max(jnp.abs(mac_div)))

    from iamr_tpu.ops.mg_nodal import N_PERIODIC, NodalBC, div_cell_to_node

    bc = NodalBC((N_PERIODIC,) * 3, (N_PERIODIC,) * 3)
    div = div_cell_to_node(tuple(s.vel[d] for d in range(3)), cfg.geom.dx, bc)
    max_div = float(jnp.max(jnp.abs(div)))

    # the fixed-cycle MG step: the path every wall/inflow config uses
    (s2, _, _), dt_wall_mg = timed_window(_make_runner(False))
    if not np.isfinite(float(jnp.max(jnp.abs(s2.vel)))):
        raise FloatingPointError("non-finite state after MG-path steps")

    mlmg_secs, mlmg_cycles, mlmg_resid = _mlmg_to_tolerance(n)
    if not mlmg_resid <= 1e-10:
        raise RuntimeError(f"MLMG solve missed rtol 1e-11: {mlmg_resid:.3e}")

    jax.config.update("jax_enable_x64", True)
    nq32 = _nodal_div_norm(32, 3, "float32")
    nq64 = _nodal_div_norm(32, 3, "float64")

    cells = n**3
    print(json.dumps({
        "metric": f"cell-updates/sec (3D HIT {n}^3 forced, "
                  f"{nparticles} particles)",
        "value": cells * steps / dt_wall,
        "unit": "cells/s",
        "platform": device["platform"],
        "device_kind": device["kind"],
        "device_count": device["count"],
        "card_name": card_name,
        "card_power_limit": card_power_limit,
        "spectral_solvers": bool(sp),
        "max_div_after_step": max_div,
        "max_div_over_umax_dx": max_div / (umax / (1.0 / n)),
        "max_mac_div": max_mac_div,
        "max_mac_div_over_umax_dx": max_mac_div / (umax / (1.0 / n)),
        "mg_path_cells_per_s": cells * steps / dt_wall_mg,
        "nodal_div_norm_f32_32cubed": nq32,
        "nodal_div_norm_f64_32cubed": nq64,
        "nodal_div_f32_over_f64": nq32 / nq64,
        "mlmg_rtol1e11_seconds": mlmg_secs,
        "mlmg_rtol1e11_cycles": mlmg_cycles,
        "mlmg_final_rel_resid": mlmg_resid,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
