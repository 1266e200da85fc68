"""Navier-Stokes level state and solver configuration.

State mirrors the reference's StateData organization (NS_setup.cpp:228-341):
cell-centered velocity + scalars (Density, Tracer(s), [Temp later]),
node-centered pressure, cell-centered Gradp — as one functional pytree per
level instead of old/new StateData pairs (time levels are carried by the
step function: it consumes state^n and returns state^{n+1}).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from iamr_tpu.config.parmparse import ParmParse
from iamr_tpu.core.bc import BC_NAMES, DomainBC, PhysBC
from iamr_tpu.core.geometry import Geometry


class NSState(NamedTuple):
    """Single-level flow state (a jax pytree).

    temp is carried even when ns.do_temp=0 (constant ones; the reference
    adds/removes the Temp state component at setup, NS_setup.cpp:285-320 —
    a fixed pytree schema keeps jit signatures stable instead)."""

    vel: jnp.ndarray      # (dim, *ncell)
    rho: jnp.ndarray      # (*ncell)
    trac: jnp.ndarray     # (ntrac, *ncell)
    temp: jnp.ndarray     # (*ncell)
    p: jnp.ndarray        # (*ncell+1) node-centered
    gradp: jnp.ndarray    # (dim, *ncell)
    time: jnp.ndarray     # scalar
    dt: jnp.ndarray       # scalar (dt used for the NEXT step)
    # d(divu)/dt from the previous step (Dsdt_Type; calc_dsdt,
    # NavierStokes.cpp:631-641). None unless ns.do_temp with conduction —
    # feeds the MAC RHS time-centering divu + dt/2 * dsdt (cpp:594-595).
    dsdt: Optional[jnp.ndarray] = None


@dataclasses.dataclass(frozen=True)
class NSConfig:
    """Static solver configuration (hashable; safe as a jit static arg).

    Defaults reproduce the reference's (SURVEY.md section 5.6;
    NavierStokesBase.cpp:97-180, NavierStokes.cpp:85-311).
    """

    geom: Geometry
    dom: DomainBC
    ntrac: int = 1
    cfl: float = 0.8
    init_shrink: float = 1.0
    init_iter: int = 2
    init_vel_iter: int = 1
    init_dt: float = -1.0
    change_max: float = 1.1
    fixed_dt: float = -1.0
    dt_cutoff: float = 0.0
    gravity: float = 0.0
    vel_visc_coef: float = 0.0
    scal_diff_coefs: Tuple[float, ...] = (0.0,)
    do_temp: bool = False
    temp_cond_coef: float = 0.0
    do_les: bool = False
    les_model: str = "Smagorinsky"
    smago_cs: float = 0.18
    sigma_cs: float = 1.5
    be_cn_theta: float = 0.5
    do_init_proj: bool = True
    do_mom_diff: bool = False
    do_cons_trac: bool = False
    do_denminmax: bool = False
    # ns.fft_solve: -1 auto (all-periodic uniform-rho runs use the exact
    # spectral solvers, solvers/spectral.py), 0 off, 1 force on
    fft_solve: int = -1
    do_scalminmax: bool = False
    stop_when_steady: bool = False
    steady_tol: float = 1e-10
    advection_scheme: str = "Godunov_PLM"
    # EB small-cell stabilization (ns.redistribution_type; reference default
    # StateRedist, NavierStokesBase.cpp:573-578)
    redist_type: str = "StateRedist"
    use_forces_in_trans: bool = False
    visc_tol: float = 1e-10
    visc_abs_tol: float = 1e-14
    mac_tol: float = 1e-12
    mac_abs_tol: float = 1e-16
    mac_sync_tol: float = 1e-10
    proj_tol: float = 1e-12
    proj_abs_tol: float = 1e-16
    # debugging toggles (NavierStokesBase::read_params defaults)
    do_reflux: bool = True
    do_sync_proj: bool = True
    do_mac_proj: bool = True
    # ns.debug = 1: per-step runtime self-checks (ns/checks.py — MAC
    # divergence condition, periodic umac consistency, NaN/BogusValue scans;
    # reference MacProj.cpp:792-846,977-1080 + ghost poisoning)
    debug: bool = False
    # EB: tag every cut cell for refinement (reference default true,
    # NavierStokesBase.cpp refine_cutcells intake)
    refine_cutcells: bool = True
    # manual_tags_placement outflow policy (NavierStokesBase.cpp:136-138)
    do_refine_outflow: bool = False
    do_derefine_outflow: bool = True
    nbuf_outflow: int = 1
    # initial velocity projection: iteration count and sigma weighting
    # (NavierStokesBase.cpp:99, Projection.cpp:24 — default UNITY sigma)
    init_vel_iter: int = 1
    rho_wgt_vel_proj: bool = False
    max_step: int = -1
    stop_time: float = -1.0
    probtype: int = 1
    # BL_USE_VELOCITY plotfile ingestion (NavierStokes.cpp:356-422): ADD
    # scale * plotfile velocity to the IC velocity after prob_initData
    velocity_plotfile: str = ""
    velocity_plotfile_xvel_name: str = "x_velocity"
    velocity_plotfile_scale: float = 1.0
    prob: Tuple[Tuple[str, float], ...] = ()
    forcing: str = "default"  # "default" (buoyancy) | "hit" (spectral)
    turb: Tuple[Tuple[str, float], ...] = ()  # turb.* namespace (HIT)
    max_level: int = 0
    ref_ratio: int = 2
    # static fine patch (fine-level index space): lo then size per dim —
    # the fixed-grids analogue of amr.regrid_file (Docs RunningProblems.rst)
    fine_patch: Tuple[int, ...] = ()
    dtype: str = "float64"

    @property
    def dim(self) -> int:
        return self.geom.dim

    @property
    def jdtype(self):
        return jnp.dtype(self.dtype)

    def prob_param(self, name: str, default: float = 0.0) -> float:
        for k, v in self.prob:
            if k == name:
                return v
        return default

    def turb_param(self, name: str, default: float = 0.0) -> float:
        for k, v in self.turb:
            if k == name:
                return v
        return default


def _phys_bcs(pp: ParmParse, dim: int, periodic):
    ns = pp.scoped("ns")
    lo = ns.queryarr("lo_bc", [0] * dim)[:dim]
    hi = ns.queryarr("hi_bc", [0] * dim)[:dim]
    names = ["x", "y", "z"][:dim]
    phys_lo, phys_hi = [], []
    for d in range(dim):
        plo, phi_ = PhysBC(int(lo[d])), PhysBC(int(hi[d]))
        # string BC blocks override integer codes (xlo.type = mass_inflow...)
        for side, cur in (("lo", plo), ("hi", phi_)):
            t = pp.scoped(f"{names[d]}{side}").query("type")
            if t is not None:
                cur = BC_NAMES[str(t).lower()]
            if side == "lo":
                plo = cur
            else:
                phi_ = cur
        if periodic[d]:
            plo = phi_ = PhysBC.Interior
        phys_lo.append(plo)
        phys_hi.append(phi_)
    # BC values: <side>.velocity / density / tracer / temp
    bc_values = {}
    for d in range(dim):
        for s, side in ((0, "lo"), (1, "hi")):
            sc = pp.scoped(f"{names[d]}{side}")
            vals = []
            v = sc.queryarr("velocity")
            vals.extend([float(x) for x in (v[:dim] if v else [0.0] * dim)])
            rho = sc.query("density", 1.0)
            vals.append(float(rho))
            tr = sc.queryarr("tracer", [0.0])
            vals.extend(float(x) for x in tr)
            vals.append(float(sc.query("temp", 1.0)))
            bc_values[(d, s)] = tuple(vals)
    return tuple(phys_lo), tuple(phys_hi), bc_values


def dim_hint_from_path(path) -> Optional[int]:
    """Infer the spatial dimension from the reference's inputs-file naming
    convention (inputs.2d.*, regtest.3d.*, inputs.3d, ...).

    The reference fixes DIM at compile time (amr2d.ex vs amr3d.ex built in
    Exec/run2d / run3d) and its inputs files often carry 3-component
    geometry arrays regardless (e.g. Tutorials/FlowPastCylinder
    inputs.2d.flow_past_cylinder-x has `amr.n_cell = 64 64 16`), so
    len(n_cell) alone mis-detects those as 3D. The `.2d.`/`.3d.` filename
    token is the reference's own convention for which executable runs the
    file; use it when present."""
    import os
    import re

    name = os.path.basename(str(path)).lower()
    m = re.search(r"(?:^|[._-])([23])d(?:$|[._-])", name)
    return int(m.group(1)) if m else None


def config_from_inputs(pp: ParmParse, dim_hint: Optional[int] = None) -> NSConfig:
    """Build an NSConfig from a reference-format inputs table."""
    amr = pp.scoped("amr")
    geo = pp.scoped("geometry")
    ns = pp.scoped("ns")
    prob = pp.scoped("prob")

    ncell = [int(x) for x in amr.getarr("n_cell")]
    dim = dim_hint or len(ncell)
    ncell = ncell[:dim]
    prob_lo = [float(x) for x in geo.queryarr("prob_lo", [0.0] * dim)[:dim]]
    prob_hi = [float(x) for x in geo.queryarr("prob_hi", [1.0] * dim)[:dim]]
    periodic = [bool(int(x)) for x in geo.queryarr("is_periodic", [0] * dim)[:dim]]
    geom = Geometry(
        ncell=tuple(ncell),
        prob_lo=tuple(prob_lo),
        prob_hi=tuple(prob_hi),
        periodic=tuple(periodic),
        coord_sys=int(geo.query("coord_sys", 0)),
    )
    phys_lo, phys_hi, bc_values = _phys_bcs(pp, dim, periodic)
    dom = DomainBC(phys_lo=phys_lo, phys_hi=phys_hi, bc_values=bc_values)

    diff = ns.queryarr("scal_diff_coefs", [0.0])
    # prob.* intake (prob_init.cpp:30-70): scalars pass through; list-valued
    # keys expand to per-dim names (blob_center -> blob_x/blob_y/blob_z,
    # velocity_ic -> velocity_x/...)
    prob_params = []
    for k in prob.keys():
        if k == "probtype":
            continue
        vals = prob.getarr(k)
        if len(vals) == 1 and isinstance(vals[0], str):
            prob_params.append((k, str(vals[0])))
            continue
        if not all(isinstance(v, (int, float)) for v in vals):
            continue
        if len(vals) == 1:
            prob_params.append((k, float(vals[0])))
        else:
            base = {"blob_center": "blob", "velocity_ic": "velocity"}.get(k, k)
            for d, v in enumerate(vals[:3]):
                prob_params.append((f"{base}_{'xyz'[d]}", float(v)))
    prob_params = tuple(prob_params)
    turb = pp.scoped("turb")
    turb_params = tuple(
        (k, float(turb.get(k)))
        for k in turb.keys()
        if isinstance(turb.query(k), (int, float))
    )
    probtype = int(prob.query("probtype", 1))
    forcing = str(prob.query("forcing", "")) or (
        "hit" if (probtype == 100 or turb.contains("nmodes")) else "default"
    )

    # ns.dtype: float32|float64 (or 32|64). Default f64 on every platform
    # (the reference's semantics).
    dt_raw = str(ns.query("dtype", "")).strip()
    dtype = "float32" if dt_raw in ("32", "float32", "single") else "float64"

    return NSConfig(
        geom=geom,
        dom=dom,
        ntrac=max(1, len(diff)),
        cfl=float(ns.query("cfl", 0.8)),
        init_shrink=float(ns.query("init_shrink", 1.0)),
        init_iter=int(ns.query("init_iter", 2)),
        init_dt=float(ns.query("init_dt", -1.0)),
        change_max=float(ns.query("change_max", 1.1)),
        fixed_dt=float(ns.query("fixed_dt", -1.0)),
        dt_cutoff=float(ns.query("dt_cutoff", 0.0)),
        gravity=float(ns.query("gravity", 0.0)),
        vel_visc_coef=float(ns.query("vel_visc_coef", 0.0)),
        scal_diff_coefs=tuple(float(x) for x in diff),
        do_temp=ns.query_bool("do_temp", False),
        temp_cond_coef=float(ns.query("temp_cond_coef", 0.0)),
        do_les=ns.query_bool("do_LES", False),
        les_model=str(ns.query("LES_model", "Smagorinsky")),
        smago_cs=float(ns.query("smago_Cs_cst", 0.18)),
        sigma_cs=float(ns.query("sigma_Cs_cst", 1.5)),
        be_cn_theta=float(ns.query("be_cn_theta", 0.5)),
        do_init_proj=ns.query_bool("do_init_proj", True),
        do_mom_diff=ns.query_bool("do_mom_diff", False),
        do_cons_trac=ns.query_bool("do_cons_trac", False),
        do_denminmax=ns.query_bool("do_denminmax", False),
        fft_solve=int(ns.query("fft_solve", -1)),
        do_scalminmax=ns.query_bool("do_scalminmax", False),
        stop_when_steady=ns.query_bool("stop_when_steady", False),
        steady_tol=float(ns.query("steady_tol", 1e-10)),
        advection_scheme=str(ns.query("advection_scheme", "Godunov_PLM")),
        # godunov.use_forces_in_trans (NavierStokesBase.cpp:556-557):
        # forces enter the normal-predictor states feeding the transverse
        # terms instead of the final face states
        use_forces_in_trans=pp.scoped("godunov").query_bool("use_forces_in_trans", False),
        redist_type=str(ns.query("redistribution_type", "StateRedist")),
        velocity_plotfile=str(ns.query("velocity_plotfile", "")),
        velocity_plotfile_xvel_name=str(
            ns.query("velocity_plotfile_xvel_name", "x_velocity")
        ),
        velocity_plotfile_scale=float(
            ns.query("velocity_plotfile_scale", 1.0)
        ),
        # f32 floors: an f32 run can never reach the f64-calibrated
        # defaults, and tolerance-mode solves would spin max_vcycles
        visc_tol=max(
            float(ns.query("visc_tol", 1e-10)),
            3e-6 if dtype == "float32" else 0.0,
        ),
        proj_tol=max(
            float(pp.scoped("proj").query("proj_tol", 1e-12)),
            3e-6 if dtype == "float32" else 0.0,
        ),
        proj_abs_tol=max(
            float(pp.scoped("proj").query("proj_abs_tol", 1e-16)),
            1e-9 if dtype == "float32" else 0.0,
        ),
        mac_tol=max(
            float(pp.scoped("mac").query("mac_tol", 1e-12)),
            3e-6 if dtype == "float32" else 0.0,
        ),
        mac_abs_tol=max(
            float(pp.scoped("mac").query("mac_abs_tol", 1e-16)),
            1e-9 if dtype == "float32" else 0.0,
        ),
        mac_sync_tol=max(
            float(pp.scoped("mac").query("mac_sync_tol", 1e-10)),
            3e-6 if dtype == "float32" else 0.0,
        ),
        do_reflux=ns.query_bool("do_reflux", True),
        do_sync_proj=ns.query_bool("do_sync_proj", True),
        do_mac_proj=ns.query_bool("do_mac_proj", True),
        debug=ns.query_bool("debug", False),
        refine_cutcells=ns.query_bool("refine_cutcells", True),
        do_refine_outflow=ns.query_bool("do_refine_outflow", False),
        do_derefine_outflow=ns.query_bool("do_derefine_outflow", True),
        nbuf_outflow=int(ns.query("Nbuf_outflow", 1)),
        init_vel_iter=int(ns.query("init_vel_iter", 1)),
        rho_wgt_vel_proj=bool(
            int(pp.scoped("proj").query("rho_wgt_vel_proj", 0))
        ),
        max_step=int(pp.query("max_step", -1)),
        stop_time=float(pp.query("stop_time", -1.0)),
        probtype=probtype,
        prob=prob_params,
        forcing=forcing,
        turb=turb_params,
        max_level=int(amr.query("max_level", 0)),
        ref_ratio=int(amr.queryarr("ref_ratio", [2])[0]),
        fine_patch=tuple(
            int(x) for x in amr.queryarr("fixed_fine_patch", [])
        ),
        dtype=dtype,
    )
