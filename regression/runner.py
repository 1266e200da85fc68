"""Golden-plotfile regression harness.

JAX equivalent of the reference's Test/IAMR-tests.ini +
regression_testing workflow (SURVEY.md section 4): each named test runs a
REFERENCE inputs file (verbatim, with short-run overrides), writes the final
state, and tolerance-compares every field against a stored benchmark.

Comparison tolerance is 1e-8 relative: the solves are tolerance-driven
(rtol ~1e-12 on residuals), so two algorithmically-equivalent builds agree
to ~1e-9 in solution units (solver-stopping noise); real regressions are
orders of magnitude larger. Goldens are regenerated ONLY on intentional
algorithm changes (git history documents each).

Usage:
    python regression/runner.py --make-benchmarks   # (re)generate goldens
    python regression/runner.py                     # run + compare
    python regression/runner.py --only euler,poiseuille_2d

Benchmarks are stored as npz files under regression/benchmarks/ (f64 CPU
runs; COMMITTED, like the reference's stored benchmark plotfiles, so the
suite proves parity against a fixed answer instead of only detecting
change). Multilevel configs store both levels' fields (crse_*/fine_*).

Run lengths: 10 steps single-level / 5 subcycled coarse steps 2-level, so
the goldens exercise the sync machinery (reflux + mac_sync + composite
sync projection) well past startup, not just the first transient.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# goldens are f64 CPU runs (like the reference's CPU regression suite)
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

REF = "/root/reference"

# (name, inputs file, overrides, tolerance)
TESTS = [
    ("lid_driven_cavity_2d",
     f"{REF}/Tutorials/LidDrivenCavity/inputs.2d.lid_driven_cavity",
     ("max_step=10",), 1e-8),
    ("poiseuille_2d", f"{REF}/Exec/run2d/regtest.2d.poiseuille",
     ("max_step=10", "amr.max_level=0"), 1e-8),
    ("hotspot_2d", f"{REF}/Exec/run2d/regtest.2d.hotspot",
     ("max_step=10", "amr.max_level=0"), 1e-8),
    ("hotspot_rz", f"{REF}/Exec/run2d/regtest.2d.hotspot_rz",
     ("max_step=10", "amr.max_level=0", "amr.n_cell=32 64"), 1e-8),
    ("traceradvect_bds_2d", f"{REF}/Exec/run2d/regtest.2d.traceradvect_bds",
     ("max_step=10", "amr.max_level=0"), 1e-8),
    ("euler_3d", f"{REF}/Exec/run3d/regtest.3d.euler",
     ("max_step=10", "amr.max_level=0", "amr.n_cell=16 16 16"), 1e-8),
    ("taylorgreen_3d", f"{REF}/Exec/run3d/regtest.3d.taylorgreen",
     ("max_step=10", "amr.max_level=0", "amr.n_cell=16 16 16"), 1e-8),
    ("flow_past_cylinder_2d",
     f"{REF}/Tutorials/FlowPastCylinder/inputs.2d.flow_past_cylinder-x",
     ("max_step=10", "stop_time=-1", "amr.max_level=0", "amr.n_cell=64 64",
      "ns.init_iter=1"), 1e-8),
    ("double_shear_layer_2d",
     f"{REF}/Tutorials/DoubleShearLayer/inputs.2d.double_shear_layer-rotate",
     ("max_step=10", "amr.max_level=0", "eb2.geom_type=all_regular"), 1e-8),
    # --- 2-level AMR configs (subcycled; the sync machinery is exercised:
    # reflux + mac_sync + composite sync projection) ----------------------
    ("rayleigh_taylor_2d_2lev",
     f"{REF}/Tutorials/RayleighTaylor/inputs.2d.rayleightaylor",
     ("max_step=5", "amr.max_level=1", "amr.n_cell=32 64",
      "amr.regrid_int=0"), 1e-8),
    ("euler_3d_2lev", f"{REF}/Exec/run3d/regtest.3d.euler",
     ("max_step=5", "amr.max_level=1", "amr.n_cell=16 16 16",
      "amr.regrid_int=0"), 1e-8),
    ("hotspot_2d_2lev", f"{REF}/Exec/run2d/regtest.2d.hotspot",
     ("max_step=5", "amr.max_level=1", "amr.regrid_int=0"), 1e-8),
    # 2-level vorticity-tagged AMR with 30 tracer particles (the reference
    # particle regression, Exec/run_2d_particles/regtest.inputs)
    ("particles_2d_2lev", f"{REF}/Exec/run_2d_particles/regtest.inputs",
     ("max_step=5", "particles.timestamp_dir=/tmp/iamr_regr_particles"),
     1e-8),
    # EB + AMR: cut-cell cylinder with a refined level over it
    # (Exec/eb_run2d regtests run 2-level with EB natively)
    ("eb_flow_past_cylinder_2lev",
     f"{REF}/Exec/eb_run2d/regtest.2d.flow_past_cylinder-x",
     ("max_step=5", "ns.init_iter=1"), 1e-8),
    # --- 3D EB (the reference test matrix's four 3D EB entries,
    # Test/IAMR-tests.ini:275-359 + Exec/eb_run3d/regtest.3d.*; short
    # runs, reduced grids where the native size is CPU-prohibitive) ------
    ("eb_flow_past_cylinder_3d",
     f"{REF}/Exec/eb_run3d/regtest.3d.flow_past_cylinder-x",
     ("max_step=5", "stop_time=-1", "ns.init_iter=1"), 1e-8),
    ("eb_hotspot_3d_2lev", f"{REF}/Exec/eb_run3d/regtest.3d.hotspot",
     ("max_step=5", "amr.max_level=1", "amr.regrid_int=0",
      "amr.n_cell=16 16 16"), 1e-8),
    ("eb_shock_past_sphere_3d",
     f"{REF}/Exec/eb_run3d/regtest.3d.shock_past_sphere",
     ("max_step=5", "stop_time=-1", "amr.regrid_int=0",
      "amr.n_cell=32 16 16", "ns.init_iter=1"), 1e-8),
    ("eb_double_shear_layer_3d",
     f"{REF}/Exec/eb_run3d/regtest.3d.double_shear_layer",
     ("max_step=5", "stop_time=-1", "amr.regrid_int=0",
      "amr.n_cell=32 32 32", "ns.init_iter=1"), 1e-8),
]

BENCH_DIR = os.path.join(REPO, "regression", "benchmarks")


def state_fields(state):
    # multilevel runs return MLState, (crse, fines, specs) tuples, or a
    # per-level state list (run_hierarchy): store every level's fields.
    # ORDER MATTERS: NSState is a NamedTuple (ns/state.py:24), i.e. a tuple —
    # the leaf `vel` check must come before the list/tuple recursion.
    if hasattr(state, "crse"):
        out = {}
        for lev, s in (("crse", state.crse), ("fine", state.fine)):
            out.update({f"{lev}_{k}": v for k, v in state_fields(s).items()})
        return out
    if hasattr(state, "vel"):
        return {"vel": np.asarray(state.vel), "rho": np.asarray(state.rho),
                "trac": np.asarray(state.trac), "p": np.asarray(state.p)}
    if isinstance(state, (list, tuple)):
        if (len(state) == 3 and hasattr(state[0], "vel")
                and isinstance(state[1], (list, tuple))
                and not hasattr(state[1], "vel")):
            # run_multipatch: (crse, [fine boxes...], specs)
            out = {f"lev0_{k}": v for k, v in state_fields(state[0]).items()}
            for i, f in enumerate(state[1]):
                out.update({
                    f"lev1_box{i}_{k}": v for k, v in state_fields(f).items()
                })
            return out
        # run_hierarchy: [lev0 state, lev1 state, ...]
        out = {}
        for lev, s in enumerate(state):
            out.update({f"lev{lev}_{k}": v for k, v in state_fields(s).items()})
        return out
    raise TypeError(f"unrecognized state container: {type(state)!r}")


def run_test(name, inputs, overrides):
    from iamr_tpu.ns.driver import run_from_inputs

    print(f"[{name}] running {os.path.relpath(inputs, REF)} {overrides}")
    state = run_from_inputs(
        inputs,
        overrides=tuple(overrides)
        + ("amr.plot_int=-1", "amr.check_int=-1"),
    )
    return state_fields(state)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--make-benchmarks", action="store_true")
    ap.add_argument("--only", default="")
    args = ap.parse_args()
    only = set(x for x in args.only.split(",") if x)

    os.makedirs(BENCH_DIR, exist_ok=True)
    failures = []
    for name, inputs, overrides, tol in TESTS:
        if only and name not in only:
            continue
        bench_path = os.path.join(BENCH_DIR, f"{name}.npz")
        try:
            fields = run_test(name, inputs, overrides)
        except Exception as e:  # noqa: BLE001 - harness reports all failures
            print(f"[{name}] FAILED to run: {e}")
            failures.append(name)
            continue
        if args.make_benchmarks:
            np.savez(bench_path, **fields)
            print(f"[{name}] benchmark written")
            continue
        if not os.path.exists(bench_path):
            # a name in TESTS without a stored golden is a harness failure,
            # not a skip — otherwise missing goldens regress silently
            print(f"[{name}] FAIL (no benchmark; run --make-benchmarks)")
            failures.append(name)
            continue
        gold = np.load(bench_path)
        ok = True
        for k, v in fields.items():
            g = gold[k]
            scale = max(1.0, float(np.max(np.abs(g))))
            err = float(np.max(np.abs(v - g))) / scale
            if err > tol:
                print(f"[{name}] FAIL field {k}: rel err {err:.3e} > {tol}")
                ok = False
        print(f"[{name}] {'PASS' if ok else 'FAIL'}")
        if not ok:
            failures.append(name)
    if failures:
        print("FAILURES:", failures)
        sys.exit(1)
    print("all regression tests passed")


if __name__ == "__main__":
    main()
