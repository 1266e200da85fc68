"""Smoke sweep: run EVERY reference inputs file a few steps and report
health — the analogue of the reference's CI smoke runs (gcc.yml run
blocks: `mpiexec -n 2 ./amr3d... regtest.3d.flow_past_cylinder-z
max_step=3`), but across the whole Tutorials + Exec regtest catalog.

Unlike regression/runner.py (golden comparisons on a fixed subset), this
asserts only liveness invariants — finite fields and a sane dt — so it
covers every config cheaply and catches wiring breaks (a config silently
parsing as the wrong dimension, a diverging solve, a NaN feedback) the
moment they appear.

Usage:
    python regression/sweep.py              # everything
    python regression/sweep.py --only 2d    # substring filter on paths
    python regression/sweep.py --steps 3
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402

from iamr_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

jax.config.update("jax_enable_x64", True)
enable_compile_cache()

REF = "/root/reference"

PATTERNS = [
    f"{REF}/Tutorials/*/inputs*",
    f"{REF}/Exec/run2d/regtest.2d.*",
    f"{REF}/Exec/run3d/regtest.3d.*",
    f"{REF}/Exec/eb_run2d/regtest.2d.*",
    f"{REF}/Exec/eb_run3d/regtest.3d.*",
    f"{REF}/Exec/run_2d_particles/regtest.inputs",
]

# configs that need taming for a CPU smoke run
SIZE_OVERRIDES = {
    "inputs.3d.forced": ("amr.n_cell=32 32 32",),  # HIT 128^3 -> 32^3
}
SKIP = {
    # covered by the restart test in tests/test_io.py; the raw file points
    # at a checkpoint that does not exist in a fresh tree
    "regtest.3d.euler-restart",
}
def _amr_overrides(f, cap_cells):
    """Run each file at its NATIVE amr.max_level (its own
    refinement_indicators / tagging wiring), capping the coarse grid so a
    1-core CPU smoke run stays cheap: halve n_cell while the product
    exceeds cap_cells and every component stays even (MG-coarsenable)."""
    from iamr_tpu.config.parmparse import ParmParse

    pp = ParmParse.from_file(f)
    max_lvl = int(pp.query("amr.max_level", 0))
    out = []
    ncell = [int(v) for v in pp.getarr("amr.n_cell")]
    capped = list(ncell)
    while True:
        prod = 1
        for v in capped:
            prod *= v
        if prod <= cap_cells or any(v % 2 or v <= 16 for v in capped):
            break
        capped = [v // 2 for v in capped]
    if capped != ncell:
        out.append("amr.n_cell=" + " ".join(map(str, capped)))
        if max_lvl > 0:
            # keep fine-grid box generation legal on the smaller grid
            out.append("amr.blocking_factor=8")
            out.append("amr.max_grid_size=1024")
    return tuple(out)


def _leaf_states(s):
    """Flatten any runner return (NSState, MLState, level lists/tuples,
    multipatch containers) to the per-level NSState leaves."""
    if hasattr(s, "vel") and hasattr(s, "dt"):
        return [s]
    out = []
    if isinstance(s, (list, tuple)):
        for x in s:
            out.extend(_leaf_states(x))
        return out
    for name in ("crse", "fine", "fines", "levels", "states"):
        v = getattr(s, name, None)
        if v is not None:
            out.extend(_leaf_states(v))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="")
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args()

    import jax.numpy as jnp
    import numpy as np

    from iamr_tpu.ns.driver import run_from_inputs

    files = []
    for pat in PATTERNS:
        files.extend(sorted(glob.glob(pat)))
    files = [f for f in files if os.path.basename(f) not in SKIP]
    if args.only:
        files = [f for f in files if args.only in f]

    overrides = (
        f"max_step={args.steps}", "ns.init_iter=1", "amr.plot_int=-1",
        "amr.check_int=-1", "amr.plot_per=-1", "stop_time=1e30",
    )
    failures = []
    for f in files:
        tag = "/".join(f.split("/")[-2:])
        extra = SIZE_OVERRIDES.get(os.path.basename(f), ())
        extra = extra + _amr_overrides(f, cap_cells=32**3)
        t0 = time.time()
        try:
            state = run_from_inputs(f, overrides=overrides + extra)
            # AMR runs return multilevel containers (MLState, level lists,
            # multipatch tuples): health-check EVERY level's velocity
            flat = _leaf_states(state)
            m = max(float(jnp.max(jnp.abs(s.vel))) for s in flat)
            dt0 = min(float(s.dt) for s in flat)
            ok = bool(np.isfinite(m)) and dt0 > 1e-15
            status = "OK " if ok else "BAD"
            if not ok:
                failures.append(tag)
            print(f"[{status}] {tag}: max|u|={m:.3g} dt={dt0:.3g}"
                  f" ({time.time() - t0:.0f}s)", flush=True)
        except Exception as e:  # noqa: BLE001 - report and continue
            failures.append(tag)
            print(f"[ERR] {tag}: {type(e).__name__}: {str(e)[:160]}",
                  flush=True)
    print(f"\n{len(files) - len(failures)}/{len(files)} configs healthy")
    if failures:
        print("FAILURES:", failures)
        sys.exit(1)


if __name__ == "__main__":
    main()
