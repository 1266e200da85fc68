"""chip_smoke.py's phases at tiny sizes on the CPU: the same code the card
runs at full size (the CLI path, the multilevel driver, the parity checks
and the sharded path on four virtual devices), here with the host as both
device and reference."""

import os
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    return chip_smoke


@pytest.fixture(autouse=True)
def keep_x64():
    """The phases switch x64 with the run dtype; restore the suite's."""
    yield
    jax.config.update("jax_enable_x64", True)


@pytest.mark.parametrize("label,overrides,dtype,spectral", [
    ("2", [], "float64", True),
    ("3", ["ns.dtype=float32", "ns.fft_solve=0"], "float32", False),
])
def test_cli_phase(smoke, label, overrides, dtype, spectral, capsys):
    state = smoke.phase_cli(label, 16, overrides, smoke.CompileClock())
    assert state.vel.shape == (3, 16, 16, 16)
    assert str(state.vel.dtype) == dtype
    out = capsys.readouterr().out
    assert "STEP 3 " in out
    # the set-up figures time the step the driver ran
    assert f"spectral={spectral}" in out
    assert "memory_analysis" in out and "steady step" in out


def test_amr_phase(smoke, capsys):
    ml = smoke.phase_amr(32, smoke.CompileClock())
    assert ml.crse.vel.shape == (2, 32, 32)
    assert "STEP 3 " in capsys.readouterr().out


def test_parity_phase(smoke, capsys):
    cpu = jax.devices("cpu")[0]
    smoke.phase_parity(16, 16, cpu, cpu)
    out = capsys.readouterr().out
    assert out.count("(limit") == 3


def test_sharded_phase_four_devices(smoke, capsys):
    smoke.phase_sharded(16, jax.devices()[:4])
    out = capsys.readouterr().out
    assert "mesh 2x2x1" in out


def test_parity_phase_detects_a_breach(smoke, monkeypatch):
    monkeypatch.setattr(smoke, "F32_LIMIT", 1e-12)
    cpu = jax.devices("cpu")[0]
    with pytest.raises(AssertionError, match="f32"):
        smoke.phase_parity(16, 16, cpu, cpu)


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip: decided when the test runs, never at
    import, so every worker collects the same tests."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU backend in this process")


@pytest.mark.gpu
def test_parity_phase_on_gpu(smoke, gpu_device):
    smoke.phase_parity(32, 32, gpu_device, jax.devices("cpu")[0])
