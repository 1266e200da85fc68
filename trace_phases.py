"""Device kernels, device time and HBM-roofline share of the step's
Godunov extrapolation, advection and multigrid-smoother phases, as XLA
compiles them for the GPU, at HIT 256^3 in float32.

Each phase is jitted alone, warmed up, then traced for `calls` calls in a
jax.profiler session of its own, so every device event in that trace
belongs to the phase. Per call the script reports the number of device
kernels, their summed device time, the bytes the algorithm must move
(computed from the shapes: each input read once, each output written once)
and that byte count's time at the card's peak bandwidth over the measured
time (the roofline share).

Usage: python trace_phases.py [n=256] [calls=5] [tracedir=.traces]
Prints one JSON line per phase, then the card's name and power limit. Each
trace is deleted once reduced.
"""

from __future__ import annotations

import glob
import json
import os
import shutil
import sys

import numpy as np

# published HBM bandwidth by device_kind (NVIDIA H100 SXM data sheet)
PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def device_events(xplane_path: str):
    """{line name: [(kernel name, duration ns), ...]} over the GPU device
    planes of one trace, leaving out the XLA module/op summary lines (their
    events span the kernels and would count them twice)."""
    from jax.profiler import ProfileData

    out = {}
    for plane in ProfileData.from_file(xplane_path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if line.name.startswith("XLA ") or line.name == "Steps":
                continue
            evs = [(e.name, e.duration_ns) for e in line.events]
            if evs:
                out[f"{plane.name}/{line.name}"] = evs
    return out


def reduce_trace(events, calls: int):
    """(kernels per call, device seconds per call) from device_events."""
    n = sum(len(v) for v in events.values())
    ns = sum(d for v in events.values() for _, d in v)
    return n / calls, ns * 1e-9 / calls


def top_kernels(events, calls: int, k: int = 6):
    """The k kernel names with the most device time, in microseconds per
    call."""
    tot = {}
    for v in events.values():
        for name, d in v:
            tot[name] = tot.get(name, 0.0) + d
    top = sorted(tot.items(), key=lambda kv: -kv[1])[:k]
    return {name: round(d * 1e-3 / calls, 1) for name, d in top}


def _phases(n: int):
    """name -> (jitted fn, args, algorithmic bytes per call)."""
    import jax
    import jax.numpy as jnp

    from iamr_tpu.core.bc import BCRec, MathBC
    from iamr_tpu.ops import mg, mg_nodal
    from iamr_tpu.ops.godunov import (
        advect_field,
        extrap_vel_to_faces,
        grow_umac_transverse,
    )

    f32 = jnp.float32
    B = 4  # bytes per f32
    rng = np.random.RandomState(0)
    shape = (n, n, n)
    dx = (1.0 / n,) * 3
    cells = n**3
    faces = (n + 1) * n * n

    def rand(*s):
        return jnp.asarray(rng.rand(*s) - 0.5, f32)

    per = (True,) * 3
    recs = [BCRec((MathBC.int_dir,) * 3, (MathBC.int_dir,) * 3)] * 3
    zero3 = ((0.0,) * 3,) * 3
    vel_g = rand(3, n + 6, n + 6, n + 6)
    force_g = rand(3, n + 2, n + 2, n + 2)
    extrap = jax.jit(lambda v, f: extrap_vel_to_faces(
        v, f, 1e-3, dx, shape, recs, zero3, zero3))
    extrap_bytes = B * (3 * (n + 6) ** 3 + 3 * (n + 2) ** 3 + 3 * faces)

    umac = tuple(rand(*(n + (d == e) for e in range(3))) for d in range(3))
    umac_g = grow_umac_transverse(umac, per)
    s_g = rand(n + 6, n + 6, n + 6)
    s_cc = s_g[3:-3, 3:-3, 3:-3]
    f_g = force_g[0]
    advect = jax.jit(lambda s, u, ug, sc, f: advect_field(
        s, u, ug, 1e-3, dx, shape, False, s_cc=sc, force_g=f, periodic=per))
    ug_elems = sum(int(np.prod(u.shape)) for u in umac_g)
    # in: s (grown), umac, grown umac, s_cc, force; out: 3 fluxes + aofs
    advect_bytes = B * ((n + 6) ** 3 + 3 * faces + ug_elems + cells
                        + (n + 2) ** 3 + 3 * faces + cells)

    bc = mg.PoissonBC((mg.PERIODIC,) * 3, (mg.PERIODIC,) * 3)
    beta = tuple(1.0 + 0.5 * jnp.abs(u) for u in umac)
    lev = mg.build_hierarchy(jnp.zeros(shape, f32), beta, 0.0, 1.0, dx, bc)[0]
    sweeps = 2

    # level data enter as arguments, as inside the step (closed-over arrays
    # would be baked into the program as constants)
    @jax.jit
    def gsrb(p, r, alpha, beta, diag, red, black):
        lv = mg.MGLevelData(alpha, beta, diag, dx, shape, red, black)
        p = mg._smooth_rb(p, r, lv, 0.0, 1.0, bc, sweeps)
        return p, mg._residual(p, r, lv, 0.0, 1.0, bc)

    # per colour: read phi, rhs, diag, 3 beta; write phi. Then the
    # residual: read phi, rhs, 3 beta; write r
    gsrb_bytes = B * (2 * sweeps * (6 * cells + cells) + 6 * cells)

    nbc = mg_nodal.NodalBC((mg_nodal.N_PERIODIC,) * 3,
                           (mg_nodal.N_PERIODIC,) * 3)
    sigma = 1.0 + 0.5 * jnp.abs(rand(*shape))
    nlev = mg_nodal.build_nodal_hierarchy(sigma, dx, nbc)[0]
    nodes = (n + 1) ** 3

    @jax.jit
    def jacobi(p, r, sig, diag, mask):
        lv = mg_nodal.NodalLevel(sig, diag, mask, dx, nlev.nshape, nlev.omega)
        p = mg_nodal._jacobi(p, r, lv, nbc, sweeps)
        return p, mg_nodal._nodal_residual(p, r, lv, nbc)

    # per sweep: read phi, rhs, sigma, diag, mask; write phi. Then the
    # residual: read phi, rhs, sigma, mask; write r
    jacobi_bytes = B * (sweeps * (4 * nodes + cells + nodes)
                        + 3 * nodes + cells + nodes)

    phi_c, rhs_c = rand(*shape), rand(*shape)
    phi_n, rhs_n = rand(n + 1, n + 1, n + 1), rand(n + 1, n + 1, n + 1)
    return {
        "extrap_vel_to_faces": (extrap, (vel_g, force_g), extrap_bytes),
        "advect_field_1": (advect, (s_g, umac, umac_g, s_cc, f_g),
                           advect_bytes),
        "cell_gsrb_2sweeps_resid": (
            gsrb, (phi_c, rhs_c, lev.alpha, lev.beta, lev.diag, lev.red,
                   lev.black), gsrb_bytes),
        "nodal_jacobi_2sweeps_resid": (
            jacobi, (phi_n, rhs_n, nlev.sigma, nlev.diag, nlev.mask),
            jacobi_bytes),
    }


def main(argv=()):
    import jax

    from iamr_tpu.utils.compile_cache import enable_compile_cache
    from iamr_tpu.utils.device_info import (
        card_name_and_power_limit,
        require_gpu,
    )

    device = require_gpu()
    enable_compile_cache()
    n = int(argv[0]) if len(argv) > 0 else 256
    calls = int(argv[1]) if len(argv) > 1 else 5
    out_dir = argv[2] if len(argv) > 2 else os.path.join(
        os.path.dirname(os.path.abspath(__file__)), ".traces")
    peak = PEAK_BYTES_PER_S[device["kind"]]
    for name, (fn, args, nbytes) in _phases(n).items():
        jax.block_until_ready(fn(*args))
        tdir = os.path.join(out_dir, name)
        jax.profiler.start_trace(tdir)
        for _ in range(calls):
            jax.block_until_ready(fn(*args))
        jax.profiler.stop_trace()
        path = sorted(glob.glob(os.path.join(
            tdir, "plugins", "profile", "*", "*.xplane.pb")))[-1]
        events = device_events(path)
        shutil.rmtree(tdir)  # traces are large; the reduction is kept
        kernels, secs = reduce_trace(events, calls)
        print(json.dumps({
            "phase": name, "n": n, "dtype": "float32",
            "kernels_per_call": kernels,
            "device_seconds_per_call": secs,
            "algorithmic_bytes": nbytes,
            "hbm_bound_seconds": nbytes / peak,
            "hbm_roofline_share": (nbytes / peak) / secs if secs else None,
            "lines": {k: len(v) for k, v in events.items()},
            "top_kernels_us_per_call": top_kernels(events, calls),
            "device": device,
        }), flush=True)
    print(f"card: {card_name_and_power_limit()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
