"""User-problem plug-in seam.

The reference extends problems by overriding source files in a problem dir
ahead of Source/ in the VPATH (SURVEY.md section 2.2b; e.g. Tutorials/HIT
overrides prob_init.cpp and NS_getForce.cpp, GNUmakefile:53-55). The six
extension points are: initial conditions, body forcing, BC fill functions,
derived fields, error-tagging indicators, and EB geometry. The JAX
equivalent is a code-level registry: import iamr_tpu.plugins and register
plain functions before building the config/state; everything downstream
(driver, tagging, IO) picks them up by probtype / name.

    import iamr_tpu.plugins as plug

    @plug.problem_ic(200)
    def my_ic(cfg, X, fields):
        fields["vel"][0] = np.sin(2 * np.pi * X[1]) ...   # mutate in place

    @plug.forcing("my_jet")                 # prob.forcing = my_jet
    def make_jet(cfg):
        def eval(geom, time, dtype): ...    # -> (dim, *ncell) array
        return SimpleNamespace(eval=eval)

    @plug.derive_field("q_criterion")       # usable in amr.refinement_
    def qcrit(cfg, state): ...              # indicators field_name too

    @plug.eb_geometry("my_nozzle")          # eb2.geom_type = my_nozzle
    def psi(pp, dim): ...                   # -> implicit fn psi(*x)

Custom physical-BC fills plug in per run via the `bcp` argument of
ns.advance.advance (any object with the BCProvider interface,
ns/bcprovider.py) — they are state-dependent closures, not globals.
"""

from __future__ import annotations

from typing import Callable, Dict

PROBLEM_ICS: Dict[int, Callable] = {}
FORCINGS: Dict[str, Callable] = {}
DERIVES: Dict[str, Callable] = {}
EB_GEOMETRIES: Dict[str, Callable] = {}


def problem_ic(probtype: int):
    """Register fn(cfg, X, fields) for prob.probtype = `probtype`.

    X: list of dim cell-center coordinate arrays; fields: dict of mutable
    numpy arrays (vel (dim,*n), rho, trac (ntrac,*n), temp) pre-filled
    with the quiescent defaults. Mutate in place (or return a dict of
    replacements)."""

    def deco(fn):
        PROBLEM_ICS[int(probtype)] = fn
        return fn

    return deco


def forcing(name: str):
    """Register factory(cfg) -> forcing object with
    .eval(geom, time, dtype) -> (dim, *ncell) body-force array, selected
    by `prob.forcing = name` (the NS_getForce override seam)."""

    def deco(fn):
        FORCINGS[str(name)] = fn
        return fn

    return deco


def derive_field(name: str):
    """Register fn(cfg, state) -> cell array under `name` for plotfile
    derives AND amr.refinement_indicators field_name (NS_derive/NS_error
    seam — tagging resolves unknown fields through ns.derive)."""

    def deco(fn):
        DERIVES[str(name)] = fn
        return fn

    return deco


def eb_geometry(name: str):
    """Register fn(pp, dim) -> implicit function psi(*x) (fluid-positive)
    for `eb2.geom_type = name` (the NS_init_eb2 / EB2::UserDefined seam)."""

    def deco(fn):
        EB_GEOMETRIES[str(name)] = fn
        return fn

    return deco
