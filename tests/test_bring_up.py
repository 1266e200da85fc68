"""One rule for every platform: f64 by default, f64 FFT solvers allowed,
mixed-precision multigrid only on request, the compile cache at one fixed
place, and no device measurement without a GPU."""

import inspect
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from iamr_tpu.config.parmparse import ParmParse
from iamr_tpu.ns.state import config_from_inputs
from iamr_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIT = os.path.join(REPO, "examples", "inputs.3d.hit_forced")


@pytest.fixture
def on_gpu(monkeypatch):
    """Report a GPU backend to any code that asks."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")


def test_default_dtype_is_f64_on_gpu(on_gpu):
    cfg = config_from_inputs(ParmParse.from_file(HIT))
    assert cfg.dtype == "float64"
    single = config_from_inputs(ParmParse.from_file(HIT, ["ns.dtype=32"]))
    assert single.dtype == "float32"


def test_f64_spectral_eligible_on_gpu(on_gpu):
    from iamr_tpu.ns.probs import init_state
    from iamr_tpu.solvers.spectral import spectral_eligible

    cfg = config_from_inputs(ParmParse.from_file(HIT, ["amr.n_cell=8 8 8"]))
    assert cfg.dtype == "float64"
    assert spectral_eligible(cfg, np.asarray(init_state(cfg).rho))


def _cell_problem(n=16):
    from iamr_tpu.ops.mg import PERIODIC, PoissonBC

    rng = np.random.RandomState(3)
    shape = (n, n, n)
    rhs = jnp.asarray(rng.rand(*shape) - 0.5)
    beta = tuple(jnp.ones(tuple(s + (d == e) for e, s in enumerate(shape)))
                 for d in range(3))
    bc = PoissonBC((PERIODIC,) * 3, (PERIODIC,) * 3)
    return rhs, beta, bc


@pytest.mark.parametrize("solver", ["mg_solve", "nodal_solve"])
def test_mixed_precision_is_off_by_default(on_gpu, solver):
    """An f64 solve stays f64 unless the caller passes mixed=True."""
    from iamr_tpu.ops import mg, mg_nodal

    fn = getattr(mg if solver == "mg_solve" else mg_nodal, solver)
    assert inspect.signature(fn).parameters["mixed"].default is False
    rhs, beta, bc = _cell_problem()
    dx = (1.0 / 16,) * 3
    if solver == "mg_solve":
        out, res, _ = mg.mg_solve(rhs, jnp.zeros_like(rhs), beta, 0.0, 1.0,
                                  dx, bc, rtol=1e-12, atol=0.0)
    else:
        nbc = mg_nodal.NodalBC((mg_nodal.N_PERIODIC,) * 3,
                               (mg_nodal.N_PERIODIC,) * 3)
        rhs_n = jnp.pad(rhs, ((0, 1),) * 3, mode="wrap")
        out, res, _ = mg_nodal.nodal_solve(rhs_n, jnp.ones_like(rhs), dx,
                                           nbc, rtol=1e-12, atol=0.0)
        rhs = rhs_n
    assert out.dtype == jnp.float64
    assert float(res) < 1e-12 * float(jnp.max(jnp.abs(rhs - rhs.mean())))


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.cache_dir() == str(tmp_path)
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; nothing is set in code
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_repo(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    want = os.path.join(REPO, ".jax_cache")
    assert compile_cache.cache_dir() == want
    assert compile_cache.enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want


def test_require_gpu_refuses_cpu():
    from iamr_tpu.utils.device_info import device_record, require_gpu

    assert device_record()["platform"] == "cpu"
    with pytest.raises(RuntimeError, match="no GPU"):
        require_gpu()


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_scripts_exit_nonzero_without_gpu(script, tmp_path):
    """Run as a user would, on the CPU: a non-zero exit and no line on
    standard output (no number is printed as a device metric)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, script)], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert out.stdout == ""
    assert "GPU" in out.stderr


def test_chip_smoke_main_exits_nonzero_on_cpu(capsys):
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code != 0
    assert capsys.readouterr().out == ""


def test_bench_main_refuses_cpu():
    sys.path.insert(0, REPO)
    try:
        import bench
    finally:
        sys.path.remove(REPO)
    with pytest.raises(RuntimeError, match="no GPU"):
        bench.main([])


def test_dryrun_multichip_needs_devices_or_cpu_flag():
    """No silent switch to the CPU: too few devices is an error."""
    sys.path.insert(0, REPO)
    try:
        import __graft_entry__
    finally:
        sys.path.remove(REPO)
    with pytest.raises(RuntimeError, match="cpu=True"):
        __graft_entry__.dryrun_multichip(len(jax.devices()) + 1)


def test_collective_counts_read_async_gpu_ops():
    """GPU HLO carries collectives as async start/done pairs."""
    sys.path.insert(0, REPO)
    try:
        import __graft_entry__
    finally:
        sys.path.remove(REPO)
    text = (
        "%cp = collective-permute(%x)\n"
        "%s = collective-permute-start(%y)\n"
        "%d = collective-permute-done(%s)\n"
        "%ag = all-gather-start(%z)\n%agd = all-gather-done(%ag)\n"
        "%a2a = all-to-all(%w)\n"
    )
    counts = __graft_entry__._collective_counts(text)
    assert counts["collective-permute"] == 2
    assert counts["all-gather"] == 1
    assert counts["all-to-all"] == 1
    assert counts["all-reduce"] == 0
