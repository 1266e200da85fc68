"""Error tagging and regridding.

JAX equivalent of the reference's refinement machinery
(Source/NS_error.cpp:10-145): runtime-configurable refinement indicators
from `amr.refinement_indicators` supporting value_greater / value_less /
vorticity_greater / adjacent_difference_greater, each tied to a field
(derived or state) with optional start/end time and max-level gates.

Clustering: the tagged cells are reduced (on host, between jitted step
segments) to a single rectangular patch — the bounding box of the tags,
padded by n_error_buf and aligned to blocking_factor — the dense-patch
analogue of Berger-Rigoutsos box generation. Regridding is out-of-band:
when the patch changes, the step function recompiles for the new shapes
and the state transfers (fine-where-overlap, interpolate-coarse elsewhere).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import jax.numpy as jnp

from iamr_tpu.amr.hierarchy import LevelSpec, prolong_cell
from iamr_tpu.config.parmparse import ParmParse
from iamr_tpu.ns.derive import derive, mag_vort
from iamr_tpu.ns.state import NSConfig, NSState


@dataclasses.dataclass(frozen=True)
class ErrorTag:
    """One refinement indicator (AMRErrorTag semantics, NS_error.cpp:10-115).

    values: per-level thresholds (AMRErrorTag picks value[min(level,
    len-1)]). in_box: optional (lo, hi) physical RealBox gating the tagged
    region (amr.<name>.in_box_lo/in_box_hi, NS_error.cpp:26-31); with test
    "in_box" the box itself IS the indicator (NS_error.cpp:79-82)."""

    field: str               # state/derived field name
    test: str                # value_greater | value_less | adjacent_difference_greater | vorticity_greater | in_box
    values: tuple = (0.0,)
    start_time: float = -1e200
    end_time: float = 1e200
    max_level: int = 10
    in_box: tuple = ()       # ((lo...), (hi...)) or empty

    @property
    def value(self) -> float:
        return self.values[0]

    def value_at(self, level: int) -> float:
        return self.values[min(level, len(self.values) - 1)]


def parse_refinement_indicators(pp: ParmParse) -> List[ErrorTag]:
    """amr.refinement_indicators = name1 name2...; amr.name1.field_name etc.
    (Docs RunningProblems.rst / NS_error.cpp intake)."""
    amr = pp.scoped("amr")
    names = amr.queryarr("refinement_indicators", [])
    tags = []
    for name in names:
        sc = pp.scoped(f"amr.{name}")
        field = str(sc.query("field_name", name))
        in_box = ()
        if sc.contains("in_box_lo"):
            lo = tuple(float(v) for v in sc.getarr("in_box_lo"))
            hi = tuple(float(v) for v in sc.getarr("in_box_hi"))
            in_box = (lo, hi)

        def _vals(key):
            return tuple(float(v) for v in sc.getarr(key))

        if sc.contains("value_greater"):
            test, values = "value_greater", _vals("value_greater")
        elif sc.contains("value_less"):
            test, values = "value_less", _vals("value_less")
        elif sc.contains("adjacent_difference_greater"):
            test, values = "adjacent_difference_greater", _vals(
                "adjacent_difference_greater"
            )
        elif sc.contains("vorticity_greater"):
            test, values = "vorticity_greater", _vals("vorticity_greater")
            field = "mag_vort"
        elif in_box:
            test, values = "in_box", (0.0,)
        else:
            raise ValueError(f"refinement indicator {name}: no test given")
        tags.append(
            ErrorTag(
                field=field,
                test=test,
                values=values,
                start_time=float(sc.query("start_time", -1e200)),
                end_time=float(sc.query("end_time", 1e200)),
                max_level=int(sc.query("max_level", 10)),
                in_box=in_box,
            )
        )
    return tags


def _realbox_mask(cfg: NSConfig, in_box):
    """Cell-center mask of a physical RealBox."""
    lo, hi = in_box
    geom = cfg.geom
    m = None
    for d in range(cfg.dim):
        x = geom.prob_lo[d] + (np.arange(geom.ncell[d]) + 0.5) * geom.dx[d]
        shape = [1] * cfg.dim
        shape[d] = geom.ncell[d]
        md = jnp.asarray(
            ((x >= lo[d]) & (x <= hi[d])).reshape(shape)
        )
        m = md if m is None else m & md
    return jnp.broadcast_to(m, tuple(geom.ncell))


def _get_field(cfg: NSConfig, state: NSState, name: str):
    if name in ("density", "rho"):
        return state.rho
    if name == "tracer":
        return state.trac[0]
    if name in ("temp", "temperature"):
        return state.temp
    if name in ("x_velocity", "y_velocity", "z_velocity"):
        return state.vel["xyz".index(name[0])]
    if name == "mag_vort":
        return mag_vort(cfg, state)
    return derive(cfg, state, name)


def tag_cells(cfg: NSConfig, state: NSState, tags: List[ErrorTag], level: int = 0):
    """Boolean tag array over the level (errorEst, NS_error.cpp:118-145).

    level: this level's index — gates per-tag max_level and selects the
    per-level threshold (AMRErrorTag::operator())."""
    out = jnp.zeros(cfg.geom.ncell, dtype=bool)
    t = float(state.time)
    for tag in tags:
        if not (tag.start_time <= t <= tag.end_time):
            continue
        if level >= tag.max_level:
            continue
        val = tag.value_at(level)
        if tag.test == "in_box":
            m = _realbox_mask(cfg, tag.in_box)
            out = out | m
            continue
        f = _get_field(cfg, state, tag.field)
        if tag.test in ("value_greater", "vorticity_greater"):
            m = f > val
        elif tag.test == "value_less":
            m = f < val
        elif tag.test == "adjacent_difference_greater":
            m = jnp.zeros_like(out)
            for d in range(cfg.dim):
                df = jnp.abs(jnp.diff(f, axis=d))
                pad_lo = [(0, 0)] * cfg.dim
                pad_lo[d] = (1, 0)
                pad_hi = [(0, 0)] * cfg.dim
                pad_hi[d] = (0, 1)
                m = m | (jnp.pad(df, pad_hi) > val) | (
                    jnp.pad(df, pad_lo) > val
                )
        else:
            raise ValueError(tag.test)
        if tag.in_box:
            m = m & _realbox_mask(cfg, tag.in_box)
        out = out | m
    return out


def cluster_to_patch(
    tags_np: np.ndarray,
    ratio: int,
    n_error_buf: int = 1,
    blocking_factor: int = 4,
    min_size: int = 8,
) -> Optional[LevelSpec]:
    """Bounding-box clustering of tagged coarse cells -> a fine LevelSpec.

    Host-side (runs between jitted segments at regrid_int cadence). Returns
    None when nothing is tagged."""
    if not tags_np.any():
        return None
    dim = tags_np.ndim
    lo, hi = [], []
    for d in range(dim):
        axes = tuple(e for e in range(dim) if e != d)
        proj = tags_np.any(axis=axes)
        idx = np.nonzero(proj)[0]
        a = max(0, int(idx[0]) - n_error_buf)
        b = min(tags_np.shape[d], int(idx[-1]) + 1 + n_error_buf)
        # align to blocking factor (in coarse cells)
        bf = max(1, blocking_factor // ratio)
        a = (a // bf) * bf
        b = -((-b) // bf) * bf
        b = min(b, tags_np.shape[d])
        a = min(a, b - 1)
        # enforce min patch size (grow by whole blocking units so the
        # alignment established above survives the expansion)
        while (b - a) * ratio < min_size:
            if a >= bf:
                a -= bf
            elif b <= tags_np.shape[d] - bf:
                b += bf
            elif a > 0:
                a -= 1
            elif b < tags_np.shape[d]:
                b += 1
            else:
                break
        lo.append(a * ratio)
        hi.append(b * ratio)
    return LevelSpec(
        lo=tuple(lo), ncell=tuple(h - l for l, h in zip(lo, hi)), ratio=ratio
    )


def regrid_fine_state(
    cfg: NSConfig,
    old_spec: Optional[LevelSpec],
    new_spec: LevelSpec,
    crse: NSState,
    fine_old: Optional[NSState],
) -> NSState:
    """Build the fine state on a new patch: interpolate from coarse, then
    copy the overlap from the previous fine level (init(old) semantics,
    NavierStokesBase.cpp:1713-1757)."""
    from iamr_tpu.amr.multilevel import init_fine_from_coarse

    new = init_fine_from_coarse(cfg, new_spec, crse)
    if fine_old is None or old_spec is None:
        return new
    # overlap in fine index space
    r = new_spec.ratio
    lo = [max(old_spec.lo[d], new_spec.lo[d]) for d in range(cfg.dim)]
    hi = [
        min(old_spec.lo[d] + old_spec.ncell[d], new_spec.lo[d] + new_spec.ncell[d])
        for d in range(cfg.dim)
    ]
    if any(h <= l for l, h in zip(lo, hi)):
        return new
    src = tuple(slice(lo[d] - old_spec.lo[d], hi[d] - old_spec.lo[d]) for d in range(cfg.dim))
    dst = tuple(slice(lo[d] - new_spec.lo[d], hi[d] - new_spec.lo[d]) for d in range(cfg.dim))

    def paste(new_a, old_a, ncomp_axis=False):
        if ncomp_axis:
            return new_a.at[(slice(None),) + dst].set(old_a[(slice(None),) + src])
        return new_a.at[dst].set(old_a[src])

    # node overlap for p
    src_n = tuple(slice(s.start, s.stop + 1) for s in src)
    dst_n = tuple(slice(s.start, s.stop + 1) for s in dst)
    return new._replace(
        vel=paste(new.vel, fine_old.vel, True),
        rho=paste(new.rho, fine_old.rho),
        trac=paste(new.trac, fine_old.trac, True),
        temp=paste(new.temp, fine_old.temp),
        gradp=paste(new.gradp, fine_old.gradp, True),
        p=new.p.at[dst_n].set(fine_old.p[src_n]),
        time=fine_old.time,
        dt=fine_old.dt,
    )


def cluster_to_patches(
    tags_np,
    ratio: int,
    n_error_buf: int = 1,
    blocking_factor: int = 4,
    min_size: int = 8,
    max_boxes: int = 8,
    min_eff: float = 0.7,
):
    """Berger-Rigoutsos clustering of tagged coarse cells into MULTIPLE fine
    patches (the reference's regrid box generation; native C++ BR with the
    bounding-box fallback). Returns a list of LevelSpec (empty if no tags)."""
    import numpy as np

    if not tags_np.any():
        return []
    from iamr_tpu import native

    if not native.available():
        s = cluster_to_patch(
            tags_np, ratio, n_error_buf, blocking_factor, min_size
        )
        return [s] if s is not None else []

    # buffer the tags first (n_error_buf), then cluster; the dilation must
    # NOT wrap across the domain (a tag at index 0 would seed a spurious
    # patch at the opposite face)
    t = tags_np.astype(bool)

    def _shift(arr, d, off):
        out = np.zeros_like(arr)
        src = [slice(None)] * arr.ndim
        dst = [slice(None)] * arr.ndim
        if off > 0:
            src[d] = slice(None, -off)
            dst[d] = slice(off, None)
        else:
            src[d] = slice(-off, None)
            dst[d] = slice(None, off)
        out[tuple(dst)] = arr[tuple(src)]
        return out

    for d in range(t.ndim):
        for _ in range(n_error_buf):
            t = t | _shift(t, d, 1) | _shift(t, d, -1)
    boxes = native.berger_rigoutsos(
        t, min_width=max(2, min_size // (2 * ratio)), min_eff=min_eff,
        max_boxes=max_boxes,
    )
    dim = tags_np.ndim
    specs = []
    bf = max(1, blocking_factor // ratio)
    for lo, hi in boxes:
        a, b = [], []
        for d in range(dim):
            lo_d = (lo[d] // bf) * bf
            hi_d = -((-(hi[d] + 1)) // bf) * bf
            hi_d = min(hi_d, tags_np.shape[d])
            lo_d = min(lo_d, hi_d - 1)
            while (hi_d - lo_d) * ratio < min_size:
                if lo_d >= bf:
                    lo_d -= bf
                elif hi_d <= tags_np.shape[d] - bf:
                    hi_d += bf
                elif lo_d > 0:
                    lo_d -= 1
                elif hi_d < tags_np.shape[d]:
                    hi_d += 1
                else:
                    break
            a.append(lo_d * ratio)
            b.append(hi_d * ratio)
        specs.append(
            LevelSpec(
                lo=tuple(a), ncell=tuple(bb - aa for aa, bb in zip(a, b)),
                ratio=ratio,
            )
        )
    # merge fully-contained duplicates
    uniq = []
    for s in specs:
        if s not in uniq:
            uniq.append(s)
    return coalesce_specs(uniq)


def coalesce_specs(specs):
    """Merge boxes whose union is a rectangle into one box (greedy, to a
    fixpoint).

    This is the level-wide-solve answer for dense arrays: the reference
    splits levels into max_grid_size boxes for MPI distribution and then runs MLMG
    level-wide across the BoxArray (SURVEY.md section 2.3.1); dense device
    arrays want the OPPOSITE — one big box wherever the union allows it, so
    every elliptic solve on the merged patch IS level-wide (no fine-fine
    Dirichlet seams). Only genuinely non-rectangular unions keep multiple
    boxes (their seams stay at truncation size, tests/test_multipatch)."""
    out = list(specs)
    merged = True
    while merged and len(out) > 1:
        merged = False
        for i in range(len(out)):
            for j in range(i + 1, len(out)):
                a, b = out[i], out[j]
                if a.ratio != b.ratio:
                    continue
                dim = a.dim
                diff = [
                    d for d in range(dim)
                    if not (a.lo[d] == b.lo[d] and a.ncell[d] == b.ncell[d])
                ]
                if len(diff) != 1:
                    continue
                d = diff[0]
                lo_a, hi_a = a.lo[d], a.lo[d] + a.ncell[d]
                lo_b, hi_b = b.lo[d], b.lo[d] + b.ncell[d]
                if hi_a == lo_b or hi_b == lo_a:
                    lo = min(lo_a, lo_b)
                    n = max(hi_a, hi_b) - lo
                    nlo = list(a.lo)
                    nn = list(a.ncell)
                    nlo[d] = lo
                    nn[d] = n
                    out[i] = LevelSpec(
                        lo=tuple(nlo), ncell=tuple(nn), ratio=a.ratio
                    )
                    out.pop(j)
                    merged = True
                    break
            if merged:
                break
    return out


def regrid_hierarchy(cfg, cfgs, specs, states, error_tags, boxlists=None):
    """Re-tag and re-nest an arbitrary-depth hierarchy (Amr::regrid for
    lbase=0: every level above the base is rebuilt from its parent's error
    tags, finest-first data transfer with overlap copy).

    specs[k] nests level k+1 inside level k, lo/ncell in level-(k+1)
    coordinates relative to the PARENT PATCH. Old child data transfers by
    expressing old and new child boxes in one absolute frame and copying
    the intersection (regrid_fine_state with the old spec rebased into the
    new parent's frame).

    Dynamic MULTI-BOX levels (the reference's BoxArray-of-many-grids
    regrid, Docs/Software.rst:356-401): each level's tags cluster with
    native Berger-Rigoutsos into possibly-many boxes (cluster_to_patches);
    a level with >1 box is carried as its bounding-box spec plus the TRUE
    box list (advance_subtree union-level semantics). A deeper level that
    would not nest inside the union's true boxes collapses its parent back
    to the single bbox patch (proper-nesting guarantee).

    Returns (new_specs, new_states, new_boxlists); new_boxlists[k] is None
    for single-box levels."""
    import numpy as _np

    from iamr_tpu.amr.hierarchy import LevelSpec
    from iamr_tpu.amr.multilevel import make_fine_config

    dim = cfg.dim
    r = cfg.ref_ratio
    # absolute patch origins, per level, in that level's own index space
    abs_old = [(0,) * dim]
    for sp in specs:
        abs_old.append(tuple(
            r * a + l for a, l in zip(abs_old[-1], sp.lo)
        ))

    new_specs = []
    new_states = [states[0]]
    new_cfgs = [cfg]
    new_boxlists = []
    abs_new = [(0,) * dim]
    for k in range(len(specs)):
        parent_cfg = new_cfgs[k]
        tags = _np.asarray(
            tag_cells(cfgs[k], states[k], error_tags, level=k)
        )
        boxes = cluster_to_patches(tags, r)
        if not boxes:
            # nothing tagged: keep the old patch shape (and box list)
            boxes_abs = []
            old_bl = boxlists[k] if boxlists is not None else None
            for b in (old_bl if old_bl else (specs[k],)):
                boxes_abs.append((
                    tuple(r * a + l for a, l in zip(abs_old[k], b.lo)),
                    b.ncell,
                ))
        else:
            # cluster lo is relative to the OLD level-k patch
            boxes_abs = [
                (tuple(r * a + l for a, l in zip(abs_old[k], b.lo)), b.ncell)
                for b in boxes
            ]
        # union bounding box in absolute child-level coordinates
        bb_lo = tuple(
            min(b[0][d] for b in boxes_abs) for d in range(dim)
        )
        bb_hi = tuple(
            max(b[0][d] + b[1][d] for b in boxes_abs) for d in range(dim)
        )
        s = LevelSpec(
            lo=bb_lo, ncell=tuple(h - l for l, h in zip(bb_lo, bb_hi)),
            ratio=r,
        )
        # rebase the bbox into the NEW parent's frame and clip inside it
        parent_n = parent_cfg.geom.ncell
        ncell = tuple(
            min(s.ncell[d], r * parent_n[d]) for d in range(dim)
        )
        lo_rel = []
        for d in range(dim):
            v = s.lo[d] - r * abs_new[k][d]
            v = max(0, min(v, r * parent_n[d] - ncell[d]))
            lo_rel.append((v // r) * r)  # keep coarse-cell alignment
        new_spec = LevelSpec(lo=tuple(lo_rel), ncell=ncell, ratio=r)
        if len(boxes_abs) > 1:
            # true boxes in the same (parent-patch-relative) frame as the
            # spec, clipped into the parent
            bl = []
            for (alo, an) in boxes_abs:
                blo = []
                bn = list(an)
                for d in range(dim):
                    v = alo[d] - r * abs_new[k][d]
                    bn[d] = min(bn[d], r * parent_n[d])
                    v = max(0, min(v, r * parent_n[d] - bn[d]))
                    blo.append((v // r) * r)
                bl.append(LevelSpec(lo=tuple(blo), ncell=tuple(bn), ratio=r))
            new_boxlists.append(tuple(bl))
        else:
            new_boxlists.append(None)
        # old child box in the new parent's frame (same child-level space)
        old_in_new = LevelSpec(
            lo=tuple(
                abs_old[k + 1][d] - r * abs_new[k][d] for d in range(dim)
            ),
            ncell=specs[k].ncell,
            ratio=r,
        )
        new_child = regrid_fine_state(
            parent_cfg, old_in_new, new_spec, new_states[k], states[k + 1]
        )
        new_specs.append(new_spec)
        new_states.append(new_child)
        new_cfgs.append(make_fine_config(parent_cfg, new_spec))
        abs_new.append(tuple(
            r * a + l for a, l in zip(abs_new[k], new_spec.lo)
        ))
    # proper nesting: a child patch must sit inside its parent's TRUE
    # boxes; otherwise the parent collapses to the single bbox patch
    for k in range(len(new_specs) - 1):
        bl = new_boxlists[k]
        if bl is None:
            continue
        child = new_specs[k + 1]
        # child in level-(k+1) cells, relative to the bbox origin
        c_lo = tuple(child.lo[d] // r for d in range(dim))
        c_hi = tuple(c_lo[d] + child.ncell[d] // r for d in range(dim))
        shape = tuple(new_specs[k].ncell)
        cov = _np.zeros(shape, bool)
        for b in bl:
            sl = tuple(
                slice(b.lo[d] - new_specs[k].lo[d],
                      b.lo[d] - new_specs[k].lo[d] + b.ncell[d])
                for d in range(dim)
            )
            cov[sl] = True
        child_sl = tuple(slice(c_lo[d], c_hi[d]) for d in range(dim))
        if not bool(cov[child_sl].all()):
            new_boxlists[k] = None
    return new_specs, tuple(new_states), new_boxlists


def apply_outflow_tag_policy(
    cfg, tags_np: np.ndarray, do_refine: bool = False,
    do_derefine: bool = True, nbuf: int = 1,
):
    """manual_tags_placement (NavierStokesBase.cpp:2112-2211): at every
    OUTFLOW face either (do_refine_outflow) tag the whole boundary strip
    when any tags sit within one cell of it, or (do_derefine_outflow, the
    default) CLEAR tags within nbuf cells of the face so the fine level
    stays off the outflow boundary. Host-side on the coarse tag array."""
    from iamr_tpu.core.bc import PhysBC

    out = np.array(tags_np)
    dim = out.ndim
    for d in range(dim):
        for side in (0, 1):
            kind = cfg.dom.phys_lo[d] if side == 0 else cfg.dom.phys_hi[d]
            if kind != PhysBC.Outflow:
                continue
            strip = [slice(None)] * dim
            strip[d] = slice(0, nbuf) if side == 0 else slice(-nbuf, None)
            if do_refine and not do_derefine:
                near = [slice(None)] * dim
                near[d] = slice(0, nbuf + 1) if side == 0 else slice(
                    -(nbuf + 1), None
                )
                if out[tuple(near)].any():
                    out[tuple(strip)] = True
            elif do_derefine:
                out[tuple(strip)] = False
    return out
