"""AMR level hierarchy: patch specs, coarse<->fine transfer operators.

JAX replacement for the amrex AmrCore machinery the reference builds
on (SURVEY.md section 2.2): FillPatch coarse->fine interpolation
(cell_cons_interp semantics), avgDown restriction
(NavierStokesBase.cpp:4125-4199), and reflux scatter
(NavierStokes.cpp:1735-1838) — all as dense-array ops on static rectangular
patches (a fine level is one dense array over its bounding box; unions of
boxes become masks in a later round).

Index conventions: a LevelSpec gives the fine patch's lo corner and size in
the FINE index space; the covered coarse region is [lo/r, (lo+n)/r).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import jax.numpy as jnp

from iamr_tpu.core.geometry import Geometry
from iamr_tpu.ops.stencil import sl


@dataclasses.dataclass(frozen=True)
class LevelSpec:
    """A fine level patch. lo/ncell in fine-level index units; ratio is the
    refinement ratio to the parent level."""

    lo: Tuple[int, ...]
    ncell: Tuple[int, ...]
    ratio: int = 2

    def __post_init__(self):
        for d in range(len(self.lo)):
            assert self.lo[d] % self.ratio == 0, "patch must align to coarse cells"
            assert self.ncell[d] % self.ratio == 0

    @property
    def dim(self):
        return len(self.lo)

    @property
    def crse_lo(self):
        return tuple(l // self.ratio for l in self.lo)

    @property
    def crse_ncell(self):
        return tuple(n // self.ratio for n in self.ncell)

    def fine_geom(self, crse_geom: Geometry) -> Geometry:
        dxc = crse_geom.dx
        dxf = tuple(h / self.ratio for h in dxc)
        lo = tuple(
            crse_geom.prob_lo[d] + self.lo[d] * dxf[d] for d in range(self.dim)
        )
        hi = tuple(lo[d] + self.ncell[d] * dxf[d] for d in range(self.dim))
        # periodic only if the patch spans the whole domain in that dim
        per = tuple(
            crse_geom.periodic[d]
            and self.lo[d] == 0
            and self.ncell[d] == crse_geom.ncell[d] * self.ratio
            for d in range(self.dim)
        )
        return Geometry(
            ncell=self.ncell, prob_lo=lo, prob_hi=hi, periodic=per,
            coord_sys=crse_geom.coord_sys,
        )

    def touches_domain(self, crse_geom: Geometry, d: int, side: int) -> bool:
        """Does the patch face (d, side) coincide with the physical domain
        boundary (-> physical BCs apply there instead of C-F interpolation)?"""
        if side == 0:
            return self.lo[d] == 0
        return self.lo[d] + self.ncell[d] == crse_geom.ncell[d] * self.ratio


def _mc_slope(q, d):
    """Monotonized-central limited slope per coarse cell (interior; one-sided
    zero at array ends)."""
    m = q.shape[d]
    c = sl(q, d, 1, m - 1)
    lo = sl(q, d, 0, m - 2)
    hi = sl(q, d, 2, m)
    dc = 0.5 * (hi - lo)
    dl = 2.0 * (c - lo)
    dr = 2.0 * (hi - c)
    lim = jnp.minimum(jnp.abs(dl), jnp.abs(dr))
    lim = jnp.where(dl * dr > 0.0, lim, 0.0)
    s = jnp.sign(dc) * jnp.minimum(jnp.abs(dc), lim)
    z = jnp.zeros_like(sl(q, d, 0, 1))
    return jnp.concatenate([z, s, z], axis=d)


def prolong_cell(crse, ratio: int, limited: bool = True):
    """Conservative linear interpolation of a coarse cell array to fine cells
    (cell_cons_interp semantics): fine = crse + sum_d slope_d * offset_d with
    MC-limited slopes; exactly conservative (offsets average to zero)."""
    dim = crse.ndim
    out = crse
    for d in range(dim):
        out = jnp.repeat(out, ratio, axis=d)
    if limited:
        for d in range(dim):
            s = _mc_slope(crse, d)
            for e in range(dim):
                s = jnp.repeat(s, ratio, axis=e)
            # fine-cell offset within its coarse cell, in coarse-cell units
            n_f = out.shape[d]
            pos = (jnp.arange(n_f) % ratio).astype(out.dtype)
            off = (pos + 0.5) / ratio - 0.5
            shape = [1] * dim
            shape[d] = n_f
            out = out + s * off.reshape(shape)
    return out


def restrict_cell(fine, ratio: int):
    """avgDown: mean over ratio^dim children."""
    out = fine
    for d in range(out.ndim):
        m = out.shape[d] // ratio
        idx0 = [slice(None)] * out.ndim
        acc = None
        for k in range(ratio):
            idx = [slice(None)] * out.ndim
            idx[d] = slice(k, k + ratio * m, ratio)
            take = out[tuple(idx)]
            acc = take if acc is None else acc + take
        out = acc / ratio
    return out


def restrict_node(fine, ratio: int):
    """Node restriction: injection at coincident nodes (avgDown for the
    node-centered pressure, NavierStokesBase avgDown of Press_Type)."""
    idx = tuple(slice(0, None, ratio) for _ in range(fine.ndim))
    return fine[idx]


def crse_region(spec: LevelSpec):
    """Slice tuple of the coarse region covered by the fine patch."""
    return tuple(
        slice(spec.crse_lo[d], spec.crse_lo[d] + spec.crse_ncell[d])
        for d in range(spec.dim)
    )


def avg_down(crse, fine, spec: LevelSpec):
    """Replace the covered coarse region with restricted fine data."""
    return crse.at[crse_region(spec)].set(restrict_cell(fine, spec.ratio))


def avg_down_node(crse_p, fine_p, spec: LevelSpec):
    reg = tuple(
        slice(spec.crse_lo[d], spec.crse_lo[d] + spec.crse_ncell[d] + 1)
        for d in range(spec.dim)
    )
    return crse_p.at[reg].set(restrict_node(fine_p, spec.ratio))


def fill_patch_from_coarse(fine, crse, spec: LevelSpec, ng: int):
    """Grow the fine patch by ng ghosts filled from the coarse level.

    Builds the prolonged coarse field over the grown patch box and pastes
    the fine interior on top (FillPatchTwoLevels semantics for interior
    C-F boundaries; physical-domain sides must be overwritten by the
    caller's BC fill afterwards).

    Requires ng <= ratio * (coarse cells beyond the patch): the coarse array
    must cover the grown region; out-of-domain coarse cells are edge-padded
    first (their values only matter where physical BCs will overwrite).
    """
    dim = fine.ndim
    r = spec.ratio
    ngc = (ng + r - 1) // r  # coarse ghost cells needed
    # coarse window around the covered region, clamped to the coarse domain
    starts, pads_lo, sizes = [], [], []
    for d in range(dim):
        lo = spec.crse_lo[d] - ngc
        hi = spec.crse_lo[d] + spec.crse_ncell[d] + ngc
        clo = max(lo, 0)
        chi = min(hi, crse.shape[d])
        starts.append(clo)
        pads_lo.append(clo - lo)
        sizes.append(chi - clo)
    win = crse[
        tuple(slice(starts[d], starts[d] + sizes[d]) for d in range(dim))
    ]
    # edge-pad the window where it left the coarse array
    pad_width = []
    for d in range(dim):
        hi_pad = (2 * ngc + spec.crse_ncell[d]) - pads_lo[d] - sizes[d]
        pad_width.append((pads_lo[d], hi_pad))
    win = jnp.pad(win, pad_width, mode="edge")
    f_bg = prolong_cell(win, r)
    # cut to exactly ng ghosts
    cut = ngc * r - ng
    if cut > 0:
        f_bg = f_bg[tuple(slice(cut, f_bg.shape[d] - cut) for d in range(dim))]
    # paste fine interior
    return f_bg.at[tuple(slice(ng, ng + fine.shape[d]) for d in range(dim))].set(
        fine
    )


def reflux_correct(
    crse,
    crse_flux,
    fine_flux,
    spec: LevelSpec,
    dt_over_dx: Sequence,
):
    """Flux-register correction of uncovered coarse cells at the C-F boundary.

    For each face dim d and side: the coarse cell just OUTSIDE the patch
    (uncovered) used crse_flux through the interface; the fine level moved
    sum(fine fluxes)/r^(dim-1) through it. Correct:
        crse_out += +/- dt/dx * (favg - fcrse)
    (sign: lo-side outside cell's hi-face is the interface -> its divergence
    contribution was +f_hi/dx... corrected by replacing fcrse with favg).

    crse_flux[d]: coarse face array ((n_d+1) in d); fine_flux[d]: fine face
    array. Non-subcycled (same dt both levels).
    """
    dim = crse.ndim
    r = spec.ratio
    out = crse
    for d in range(dim):
        # average fine interface fluxes to coarse faces (transverse mean)
        ff = fine_flux[d]
        # take fine faces at the patch boundary: index 0 and -1 along d
        for side in (0, 1):
            f_face = sl(ff, d, 0, 1) if side == 0 else sl(ff, d, -1, None)
            # transverse restriction: mean over r cells
            f_red = f_face
            for e in range(dim):
                if e == d:
                    continue
                m = f_red.shape[e] // r
                acc = None
                for k in range(r):
                    idx = [slice(None)] * dim
                    idx[e] = slice(k, k + r * m, r)
                    t = f_red[tuple(idx)]
                    acc = t if acc is None else acc + t
                f_red = acc / r
            # coarse face index at the interface
            cf = spec.crse_lo[d] if side == 0 else spec.crse_lo[d] + spec.crse_ncell[d]
            if cf <= 0 or cf >= crse.shape[d]:
                continue  # interface on the domain boundary: no outside cell
            idx_cf = [
                slice(spec.crse_lo[e], spec.crse_lo[e] + spec.crse_ncell[e])
                for e in range(dim)
            ]
            idx_cf[d] = slice(cf, cf + 1)
            fc = crse_flux[d][tuple(idx_cf)]
            delta = jnp.squeeze(f_red, axis=d) - jnp.squeeze(fc, axis=d)
            # outside coarse cell: cf-1 (lo side) had the interface as its
            # HI face (flux enters with -f/dx in div -> update S -= dt*div:
            # S += dt/dx * delta); cf (hi side) had it as its LO face
            # lo side: outside cell cf-1 has the interface as its HI face;
            # S -= dt*(F_hi - F_lo)/dx, so replacing fc by favg gives
            # dS = -dt/dx * delta. hi side: interface is the LO face: +.
            cell = cf - 1 if side == 0 else cf
            idx_cell = [
                slice(spec.crse_lo[e], spec.crse_lo[e] + spec.crse_ncell[e])
                for e in range(dim)
            ]
            idx_cell[d] = slice(cell, cell + 1)
            sign = -1.0 if side == 0 else 1.0
            cur = out[tuple(idx_cell)]
            out = out.at[tuple(idx_cell)].set(
                cur + sign * dt_over_dx[d] * jnp.expand_dims(delta, axis=d)
            )
    return out


def read_fixed_grids(path: str, dim: int):
    """Parse an AMReX fixed-grids file (amr.regrid_file; reference
    Docs/RunningProblems.rst and Tutorials/Particles/fixed_grids_ml):

        <n refined levels>
        <ngrids at level 1>
        ((lo...) (hi...) (type...))   # one per grid, hi INCLUSIVE,
        <ngrids at level 2>           # indices in that level's own space
        ...

    Returns [level][grid] -> (lo tuple, hi_exclusive tuple)."""
    import re

    with open(path) as f:
        txt = f.read()
    toks = txt.split("\n")
    nums = []
    boxes = []
    # stream-parse: bare integers are counts, "((..)..)" lines are boxes
    items = []
    for line in txt.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("(("):
            groups = re.findall(r"\(([-\d,\s]+)\)", line)
            vals = [
                tuple(int(x) for x in g.replace(" ", ",").split(",") if x)
                for g in groups
            ]
            items.append(("box", vals))
        else:
            items.append(("count", int(line.split()[0])))
    assert items and items[0][0] == "count"
    nlev = items[0][1]
    out = []
    i = 1
    for _ in range(nlev):
        assert items[i][0] == "count"
        ng = items[i][1]
        i += 1
        grids = []
        for _ in range(ng):
            kind, vals = items[i]
            assert kind == "box"
            lo, hi = vals[0][:dim], vals[1][:dim]
            grids.append((tuple(lo), tuple(h + 1 for h in hi)))
            i += 1
        out.append(grids)
    return out
