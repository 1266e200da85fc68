import os

import pytest

from iamr_tpu.config.parmparse import ParmParse

TAYLOR_GREEN = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples", "inputs.3d.taylor_green")

SAMPLE = """
# comment line
max_step 				= 100000
stop_time 				= -1
ns.stop_when_steady 	= 1
ns.steady_tol 		= 1.0e-5
amr.n_cell			= 64 64
ns.cfl                  = 0.9  # CFL number used to set dt
geometry.prob_lo     	=  0. 0.
geometry.is_periodic 	=  0 0
ns.lo_bc             	= 5 5
yhi.velocity            =   1.  0.  0.
prob.probtype = 1
amr.derive_plot_vars    = ALL
xlo.type = mass_inflow
"""


def test_scalars_and_lists():
    pp = ParmParse.from_string(SAMPLE)
    assert pp.get("max_step") == 100000
    assert pp.get("stop_time") == -1
    ns = pp.scoped("ns")
    assert ns.get("cfl") == 0.9
    assert ns.get("steady_tol") == 1.0e-5
    amr = pp.scoped("amr")
    assert amr.getarr("n_cell") == [64, 64]
    assert pp.scoped("yhi").getarr("velocity") == [1.0, 0.0, 0.0]
    assert pp.scoped("xlo").get("type") == "mass_inflow"
    assert pp.scoped("amr").get("derive_plot_vars") == "ALL"


def test_query_defaults_and_required():
    pp = ParmParse.from_string(SAMPLE)
    ns = pp.scoped("ns")
    assert ns.query("nonexistent", 42) == 42
    with pytest.raises(KeyError):
        ns.get("nonexistent")


def test_overrides_last_wins():
    pp = ParmParse.from_string(SAMPLE, overrides=["max_step=3", "ns.cfl = 0.5"])
    assert pp.get("max_step") == 3
    assert pp.scoped("ns").get("cfl") == 0.5


def test_reference_inputs_parse():
    # the reference Tutorials inputs files must parse unchanged
    pp = ParmParse.from_file(
        "/root/reference/Tutorials/LidDrivenCavity/inputs.2d.lid_driven_cavity"
    )
    assert pp.scoped("ns").get("cfl") == 0.9
    assert pp.scoped("amr").getarr("n_cell") == [64, 64]
    assert pp.scoped("prob").get("probtype") == 1
    pp2 = ParmParse.from_file(
        "/root/reference/Tutorials/TaylorGreen/inputs.2d.taylorgreen"
    )
    assert pp2.scoped("geometry").getarr("is_periodic") == [1, 1, 1]


def test_ns_dtype_wiring():
    # ns.dtype selects the run precision; the default is f64 on every
    # platform (reference semantics)
    from iamr_tpu.ns.state import config_from_inputs

    base = TAYLOR_GREEN
    assert config_from_inputs(
        ParmParse.from_file(base, ["ns.dtype=float32"])
    ).dtype == "float32"
    assert config_from_inputs(
        ParmParse.from_file(base, ["ns.dtype=64"])
    ).dtype == "float64"
    assert config_from_inputs(ParmParse.from_file(base)).dtype == "float64"


def test_f32_tolerance_floors():
    """f32 runs floor the f64-calibrated solver tolerances (otherwise
    tolerance-mode solves spin max_vcycles chasing 1e-12 in f32)."""
    from iamr_tpu.ns.state import config_from_inputs

    base = TAYLOR_GREEN
    c32 = config_from_inputs(ParmParse.from_file(base, ["ns.dtype=float32"]))
    assert c32.proj_tol >= 3e-6 and c32.visc_tol >= 3e-6
    c64 = config_from_inputs(ParmParse.from_file(base, ["ns.dtype=float64"]))
    assert c64.proj_tol == 1e-12 and c64.visc_tol == 1e-10
    # explicit proj.proj_tol parses (Projection.cpp proj_tol intake)
    c = config_from_inputs(ParmParse.from_file(base, ["proj.proj_tol=1e-9"]))
    assert c.proj_tol == 1e-9
