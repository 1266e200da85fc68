"""CLI entry point: `python -m iamr_tpu <inputs-file> [key=value ...]`

Mirrors the reference's executable convention (main.cpp:26-156):
`./amr2d.ex inputs max_step=3 ns.v=1`.
"""

import sys

import jax


def run(argv):
    """Run an inputs file with key=value overrides; returns the driver's
    final state (an NSState, or the level states of an AMR run)."""
    path, overrides = argv[0], argv[1:]
    from iamr_tpu.config.parmparse import ParmParse
    from iamr_tpu.ns.state import config_from_inputs, dim_hint_from_path
    from iamr_tpu.utils.compile_cache import enable_compile_cache

    cfg_probe = config_from_inputs(
        ParmParse.from_file(path, overrides),
        dim_hint=dim_hint_from_path(path),
    )
    # x64 follows the run dtype (ns.dtype; default f64)
    jax.config.update("jax_enable_x64", cfg_probe.dtype == "float64")
    enable_compile_cache()
    from iamr_tpu.ns.driver import run_from_inputs

    return run_from_inputs(path, overrides, verbose=True)


def main(argv):
    if not argv:
        print("usage: python -m iamr_tpu <inputs-file> [key=value ...]")
        return 1
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
