"""Congruent box-batch execution for multi-box AMR levels.

The reference's scaling model is many small boxes per level (amrex
BoxArray/DistributionMapping, Docs Software.rst:356-401) distributed over
ranks. The JAX equivalent built here (SURVEY.md section 7.1):
a fine level whose boxes are CONGRUENT (all the same shape — the
max_grid_size == blocking_factor gridding) executes as ONE batched array
`[nbox, ...]`:

  * hyperbolic phases (Godunov extrap + advection, updates, forcing) are
    `jax.vmap`-ed over the box axis — FLOPs and memory scale with
    sum(box volumes), not the bounding-box volume, and program size is
    independent of nbox (one traced program + a batch dim);
  * ghost cells are filled by ONE precomputed flat gather per fill:
    sibling-covered ghosts read the batch itself, the rest interpolate
    from gathered per-box coarse windows (FillPatch semantics), and
    physical domain sides apply the BC tables masked per box;
  * the level-wide elliptic couplings (MAC projection, CN diffusion,
    nodal projection — reference MLMG solves a level across its whole
    BoxArray) scatter the batch into the union bounding box and run the
    existing masked union solves (ops/mg.py union_dirichlet_coeffs),
    which touch only a handful of bbox-sized scratch arrays;
  * the box axis shards over a device mesh (jax.sharding) — the batched
    gathers become the halo exchange.

Hole cells (bbox minus the union) carry coarse-interpolated data exactly
where the union solves need Dirichlet values; the batch itself never
materializes them.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from iamr_tpu.amr.hierarchy import LevelSpec
from iamr_tpu.amr.multipatch import union_bbox_spec
from iamr_tpu.core.bc import BCRec, MathBC
from iamr_tpu.core.fill import _ghost_block
from iamr_tpu.ns.state import NSConfig, NSState


def congruent(specs: Sequence[LevelSpec]) -> bool:
    """All boxes the same shape (the box-batch eligibility condition)."""
    return len(specs) >= 1 and all(
        sp.ncell == specs[0].ncell and sp.ratio == specs[0].ratio
        for sp in specs
    )


def congruent_chop(boxes, box_size: Sequence[int]):
    """Re-chop arbitrary (lo, hi_exclusive) boxes onto a fixed box_size
    lattice: every occupied lattice tile becomes a box (the
    max_grid_size == blocking_factor gridding the reference recommends for
    uniform grids, Docs RunningProblems.rst:352-427). Input/output coords
    are in the same (fine) index space; tiles are clipped to nothing —
    callers pass box_size dividing the domain."""
    tiles = set()
    for lo, hi in boxes:
        dim = len(lo)
        ranges = [
            range(lo[d] // box_size[d], (hi[d] + box_size[d] - 1) // box_size[d])
            for d in range(dim)
        ]
        import itertools

        for t in itertools.product(*ranges):
            tiles.add(t)
    out = []
    for t in sorted(tiles):
        lo = tuple(t[d] * box_size[d] for d in range(len(t)))
        hi = tuple(lo[d] + box_size[d] for d in range(len(t)))
        out.append((lo, hi))
    return out


def grow_umac_normal_union(umac, periodic: Sequence[bool]):
    """MAC components grown by one face on each side of their OWN dim,
    reproducing exactly the union advance's d(umac)/dx ghost-row rule
    (ops/godunov.py compute_edge_states): periodic dims wrap the true
    faces; non-periodic sides linearly extrapolate so the per-box ghost
    dudx equals the union's edge-copied dudx:
    (u0 - u_pad)/dx == (u1 - u0)/dx  =>  u_pad = 2 u0 - u1."""

    def _take(u, d, j):
        return jnp.take(u, jnp.asarray([j]), axis=d)

    out = []
    for d, u in enumerate(umac):
        n = u.shape[d]
        if periodic[d]:
            lo = _take(u, d, n - 2)
            hi = _take(u, d, 1)
        else:
            lo = 2.0 * _take(u, d, 0) - _take(u, d, 1)
            hi = 2.0 * _take(u, d, n - 1) - _take(u, d, n - 2)
        out.append(jnp.concatenate([lo, u, hi], axis=d))
    return tuple(out)


class UnionBoxExec:
    """Executes the hyperbolic phases (Godunov extrap + advection) of a
    union-bbox advance per CONGRUENT box instead of over the whole bounding
    box: FLOPs scale with sum(box volumes), program size is independent of
    nbox (one gather -> one vmapped kernel -> one scatter), and the results
    are bitwise those of the bbox-wide computation because every per-box
    window carries the identical bbox data (stencil support ng=3 is inside
    the window).

    The reference's execution model is exactly this: amrex iterates
    Godunov/HydroUtils kernels box-by-box over the level's BoxArray
    (MFIter; Docs Software.rst:356-401) while MLMG couples the level
    globally — here the elliptic solves stay on the masked union
    (ops/mg.py interior_mask), as advance() already does.

    Boxes are grouped by their domain-touch pattern so each group's vmapped
    extrap gets the right static BCRec (physical sides on touching boxes,
    int_dir elsewhere — the same masking CoarseFineBCProvider applies to
    C-F sides). advect_field takes no BCRec, so advection runs as ONE
    all-box vmap.
    """

    def __init__(self, crse_geom, specs: Sequence[LevelSpec],
                 bbox: Optional[LevelSpec] = None):
        assert congruent(specs), "box batch requires congruent boxes"
        self.specs = tuple(specs)
        self.nbox = len(specs)
        self.dim = specs[0].dim
        self.r = specs[0].ratio
        self.bshape = tuple(specs[0].ncell)
        self.bbox = bbox if bbox is not None else union_bbox_spec(specs)
        self.dom_ncell = tuple(
            crse_geom.ncell[d] * self.r for d in range(self.dim)
        )
        self.per_crse = tuple(bool(p) for p in crse_geom.periodic)
        self._solvers: Dict = {}
        # route the union elliptic solves through the batched MG
        # (ops/mg_batch.py / ops/mg_nodal_batch.py); bitwise-parity tests
        # against the masked-union path switch this off
        self.solve_elliptic = True
        self.off = np.array(
            [[sp.lo[d] - self.bbox.lo[d] for d in range(self.dim)]
             for sp in specs], np.int32,
        )
        # group boxes by domain-touch pattern (static per group)
        groups: Dict[Tuple, List[int]] = {}
        for b, sp in enumerate(specs):
            pat = tuple(
                (sp.lo[d] == 0, sp.lo[d] + sp.ncell[d] == self.dom_ncell[d])
                for d in range(self.dim)
            )
            groups.setdefault(pat, []).append(b)
        self.groups = {k: tuple(v) for k, v in groups.items()}
        self._sel_cache: Dict = {}

    # -- window selectors ---------------------------------------------------

    def _sel(self, lengths: Tuple[int, ...], idxs: Tuple[int, ...]):
        """Advanced-index selector for per-box windows: window along d
        starts at off[b, d] in array coords for ANY ghost width (the array's
        ghost offset cancels the window's)."""
        key = (lengths, idxs)
        if key in self._sel_cache:
            return self._sel_cache[key]
        nb = len(idxs)
        sel = []
        for d in range(self.dim):
            i = self.off[list(idxs), d][:, None] + np.arange(
                lengths[d], dtype=np.int32
            )[None]
            sh = [nb] + [1] * self.dim
            sh[1 + d] = lengths[d]
            sel.append(jnp.asarray(i.reshape(sh)))
        sel = tuple(sel)
        self._sel_cache[key] = sel
        return sel

    def _lengths(self, ng=0, face_dim=None, gn=0, gt=0):
        return tuple(
            self.bshape[d]
            + (1 + 2 * gn if d == face_dim else 0)
            + (2 * ng if face_dim is None else 0)
            + (2 * gt if face_dim is not None and d != face_dim else 0)
            for d in range(self.dim)
        )

    def gather_cc(self, a, ng: int, idxs, lead: int = 0):
        """[lead..., bbox cells + 2ng] -> [nb, lead..., bshape + 2ng]."""
        sel = self._sel(self._lengths(ng=ng), idxs)
        out = a[(slice(None),) * lead + sel]
        return jnp.swapaxes(out, 0, 1) if lead else out

    def gather_face(self, u, fd: int, idxs, gn: int = 0, gt: int = 0):
        """Face-array windows (normal faces grown by gn, transverse cells
        by gt — matching the array's own ghosts)."""
        sel = self._sel(self._lengths(face_dim=fd, gn=gn, gt=gt), idxs)
        return u[sel]

    def scatter_cc(self, vals, idxs, target):
        sel = self._sel(self._lengths(), idxs)
        return target.at[sel].set(vals)

    def scatter_face(self, vals, fd: int, idxs, target):
        """Seam faces are written by both owners with bitwise-identical
        values (same window data, same arithmetic), so duplicate scatter
        indices are harmless."""
        sel = self._sel(self._lengths(face_dim=fd), idxs)
        return target.at[sel].set(vals)

    # -- batched phases -------------------------------------------------

    @staticmethod
    def _mask_rec(rec: BCRec, pat) -> BCRec:
        lo = tuple(
            rec.lo[d] if pat[d][0] else MathBC.int_dir for d in range(len(rec.lo))
        )
        hi = tuple(
            rec.hi[d] if pat[d][1] else MathBC.int_dir for d in range(len(rec.hi))
        )
        return BCRec(lo=lo, hi=hi)

    def extrap_batched(self, vel_g, force_g, dt, dx, recs_u, bl, bh,
                       scheme: str, use_forces_in_trans: bool):
        """Per-box Godunov ExtrapVelToFaces over the union arrays; returns
        bbox-shaped MAC faces (holes zero — the MAC projection's masked
        union solve overwrites/ignores them exactly as with the bbox-wide
        extrap)."""
        from iamr_tpu.ops.godunov import extrap_vel_to_faces

        dim = self.dim
        umac = [
            jnp.zeros(
                tuple(
                    self.bbox.ncell[e] + (1 if e == d else 0)
                    for e in range(dim)
                ),
                vel_g.dtype,
            )
            for d in range(dim)
        ]
        for pat, idxs in self.groups.items():
            vg = self.gather_cc(vel_g, 3, idxs, lead=1)
            fg = self.gather_cc(force_g, 1, idxs, lead=1)
            recs_b = [self._mask_rec(recs_u[c], pat) for c in range(dim)]

            def _one(v, f, _recs=recs_b):
                return extrap_vel_to_faces(
                    v, f, dt, dx, self.bshape, _recs, bl, bh,
                    use_forces_in_trans=use_forces_in_trans, scheme=scheme,
                )

            outs = jax.vmap(_one)(vg, fg)
            for d in range(dim):
                umac[d] = self.scatter_face(outs[d], d, idxs, umac[d])
        return tuple(umac)

    def advect_batched(self, s_g, umac, umac_g, umac_n, dt, dx,
                       iconserv: bool, s_cc=None, force_g=None,
                       scheme: str = "plm"):
        """Per-box advect_field over the union arrays. umac_n comes from
        grow_umac_normal_union so the conservative d(umac)/dx term matches
        the bbox-wide rule bitwise. Returns (bbox fluxes, bbox aofs)."""
        from iamr_tpu.ops.godunov import advect_field

        dim = self.dim
        idxs = tuple(range(self.nbox))
        sgb = self.gather_cc(s_g, 3, idxs)
        ub = tuple(self.gather_face(umac[d], d, idxs) for d in range(dim))
        ugb = tuple(
            self.gather_face(umac_g[d], d, idxs, gt=1) for d in range(dim)
        )
        unb = tuple(
            self.gather_face(umac_n[d], d, idxs, gn=1) for d in range(dim)
        )
        sccb = None if s_cc is None else self.gather_cc(s_cc, 0, idxs)
        fgb = None if force_g is None else self.gather_cc(force_g, 1, idxs)

        def _one(sg, u, ug, un, scc, fg):
            return advect_field(
                sg, u, ug, dt, dx, self.bshape, iconserv, s_cc=scc,
                force_g=fg, periodic=None, scheme=scheme, umac_gn=un,
            )

        in_axes = (0, 0, 0, 0, None if sccb is None else 0,
                   None if fgb is None else 0)
        fl, aofs = jax.vmap(_one, in_axes=in_axes)(
            sgb, ub, ugb, unb, sccb, fgb
        )
        fluxes = tuple(
            self.scatter_face(
                fl[d], d, idxs,
                jnp.zeros(
                    tuple(
                        self.bbox.ncell[e] + (1 if e == d else 0)
                        for e in range(dim)
                    ),
                    s_g.dtype,
                ),
            )
            for d in range(dim)
        )
        a_out = self.scatter_cc(
            aofs, idxs, jnp.zeros(tuple(self.bbox.ncell), s_g.dtype)
        )
        return fluxes, a_out


# ---------------------------------------------------------------------------
# Stage-B execution: the union advance's ELLIPTIC solves run on the batch
# ---------------------------------------------------------------------------
# The masked-union MG (ops/mg.py interior_mask, ops/mg_nodal.py) solves the
# right system but pays O(bbox) memory and FLOPs per V-cycle. These adapters
# gather the same system onto the congruent box batch, solve with the
# batched MG (ops/mg_batch.py, ops/mg_nodal_batch.py — every MG depth stays
# [nbox, ...]-sized, the reference's MLMG-over-BoxArray execution), and
# scatter the solution back into the bbox array with holes carrying the
# interior Dirichlet data, exactly mg_solve's union return convention.


def _bbox_solver_geometry(bexec: "UnionBoxExec"):
    """(periodic, touch) of the boxes within the BBOX index space."""
    dim = bexec.dim
    per = tuple(
        bexec.per_crse[d]
        and bexec.bbox.lo[d] == 0
        and bexec.bbox.ncell[d] == bexec.dom_ncell[d]
        for d in range(dim)
    )
    touch = np.zeros((bexec.nbox, dim, 2), bool)
    for b in range(bexec.nbox):
        for d in range(dim):
            touch[b, d, 0] = bexec.off[b, d] == 0
            touch[b, d, 1] = (
                bexec.off[b, d] + bexec.bshape[d] == bexec.bbox.ncell[d]
            )
    return per, touch


def _batch_bvals(bexec: "UnionBoxExec", bvals, idxs):
    """Per-box windows of bbox-boundary bval data (scalars pass through)."""
    if not bvals:
        return bvals
    out = {}
    for (d, side), v in bvals.items():
        va = jnp.asarray(v)
        if va.ndim == 0:
            out[(d, side)] = va
            continue
        # boundary-slab array over the transverse dims of the bbox (with
        # or without a kept singleton at d)
        if va.ndim == bexec.dim:
            va = jnp.squeeze(va, axis=d)
        sel = []
        tds = [e for e in range(bexec.dim) if e != d]
        for j, e in enumerate(tds):
            i = bexec.off[list(idxs), e][:, None] + np.arange(
                bexec.bshape[e], dtype=np.int32
            )[None]
            sh = [len(idxs)] + [1] * len(tds)
            sh[1 + j] = bexec.bshape[e]
            sel.append(jnp.asarray(i.reshape(sh)))
        vb = va[tuple(sel)]
        # the ghost slab in the padded batch spans bs+2 transversely; pad
        # with zeros — corner ghosts never enter the 7-point stencil of any
        # interior cell (mg._boundary_lift skips them too)
        vb = jnp.pad(vb, [(0, 0)] + [(1, 1)] * len(tds))
        out[(d, side)] = jnp.expand_dims(vb, axis=1 + d)
    return out


def _solve_cell_batched(
    bexec: "UnionBoxExec", rhs_u, alpha_u, beta_u, a, b, dx, bc, bvals,
    interior_vals, phi0=None, rtol=1e-11, atol=0.0, fixed_cycles=None,
):
    """Batched replacement for mg_solve(..., interior_mask, interior_vals)
    on a congruent union level. Returns (phi_bbox, res, iters) with hole
    cells = interior_vals (mg_solve's finalize convention)."""
    from iamr_tpu.ops.mg_batch import BatchPoisson

    dim = bexec.dim
    key = ("cell", tuple(bc.lo), tuple(bc.hi))
    if key not in bexec._solvers:
        per, touch = _bbox_solver_geometry(bexec)
        bexec._solvers[key] = BatchPoisson(
            bexec.off, bexec.bshape, tuple(bexec.bbox.ncell), per, bc, touch
        )
    bp = bexec._solvers[key]
    idxs = tuple(range(bexec.nbox))
    rhs_b = bexec.gather_cc(rhs_u, 0, idxs)
    alpha_b = bexec.gather_cc(alpha_u, 0, idxs)
    beta_b = tuple(bexec.gather_face(beta_u[d], d, idxs) for d in range(dim))
    # gather_cc(ng=1) expects an array WITH a 1-ghost ring (the offsets
    # cancel); interior_vals is plain bbox-shaped, so pad it first (edge
    # values beyond the bbox are never read: those ghosts are physical)
    iv_g = jnp.pad(interior_vals.astype(rhs_u.dtype),
                   [(1, 1)] * dim, mode="edge")
    cf = bexec.gather_cc(iv_g, 1, idxs)
    phi0_b = None if phi0 is None else bexec.gather_cc(phi0, 0, idxs)
    bv_b = _batch_bvals(bexec, bvals, idxs)
    phi_b, it, res = bp.solve(
        rhs_b, alpha_b, beta_b, a, b, dx, phi0=phi0_b, cf_ghosts=cf,
        bvals=bv_b, rtol=rtol, atol=atol, fixed_cycles=fixed_cycles,
    )
    out = bexec.scatter_cc(phi_b, idxs, interior_vals.astype(rhs_u.dtype))
    return out, res, it


def _gather_nodes_padded(bexec: "UnionBoxExec", a_nodes, idxs, pad: int):
    """Per-box node windows grown by `pad`, clamped at the bbox edge."""
    dim = bexec.dim
    sel = []
    for d in range(dim):
        nn = bexec.bbox.ncell[d] + 1
        i = bexec.off[list(idxs), d][:, None] + np.arange(
            -pad, bexec.bshape[d] + 1 + pad, dtype=np.int32
        )[None]
        i = np.clip(i, 0, nn - 1)
        sh = [len(idxs)] + [1] * dim
        sh[1 + d] = bexec.bshape[d] + 1 + 2 * pad
        sel.append(jnp.asarray(i.reshape(sh)))
    return a_nodes[tuple(sel)]


def _solve_nodal_batched(
    bexec: "UnionBoxExec", rhs_nodes, sigma_u, dx, bc, phi_bc=None,
    phi0=None, rtol=1e-11, atol=1e-16, fixed_cycles=None,
):
    """Batched replacement for nodal_solve(..., interior_mask=nodemask,
    phi_bc) on a congruent union level: bbox-boundary nodes and any node
    with an uncovered adjacent cell are Dirichlet-pinned to phi_bc
    (UnionBCProvider.nodemask semantics). Returns (phi_bbox, res, iters)
    with non-box nodes carrying phi_bc."""
    from iamr_tpu.ops.mg_nodal_batch import BatchNodal

    dim = bexec.dim
    key = ("nodal", tuple(bc.lo), tuple(bc.hi))
    if key not in bexec._solvers:
        per, touch = _bbox_solver_geometry(bexec)
        # the union nodemask pins every bbox-boundary node (mp padded 0)
        pin = np.zeros(
            (bexec.nbox,) + tuple(n + 1 for n in bexec.bshape), bool
        )
        for b in range(bexec.nbox):
            for d in range(dim):
                if touch[b, d, 0]:
                    idx = [slice(None)] * dim
                    idx[d] = slice(0, 1)
                    pin[(b,) + tuple(idx)] = True
                if touch[b, d, 1]:
                    idx = [slice(None)] * dim
                    idx[d] = slice(-1, None)
                    pin[(b,) + tuple(idx)] = True
        bexec._solvers[key] = BatchNodal(
            bexec.off, bexec.bshape, tuple(bexec.bbox.ncell), per, bc,
            extra_pin=pin,
        )
    bn = bexec._solvers[key]
    idxs = tuple(range(bexec.nbox))
    rhs_b = _gather_nodes_padded(bexec, rhs_nodes, idxs, 0)
    sigma_b = bexec.gather_cc(sigma_u, 0, idxs)
    g_pad = None
    bg = jnp.zeros(tuple(n + 1 for n in bexec.bbox.ncell), rhs_nodes.dtype)
    if phi_bc is not None:
        g_pad = _gather_nodes_padded(
            bexec, phi_bc.astype(rhs_nodes.dtype), idxs, 1
        )
        bg = phi_bc.astype(rhs_nodes.dtype)
    phi0_b = None if phi0 is None else _gather_nodes_padded(
        bexec, phi0, idxs, 0
    )
    phi_b, it, res = bn.solve(
        rhs_b, sigma_b, dx, phi0=phi0_b, g_pad=g_pad, rtol=rtol, atol=atol,
        fixed_cycles=fixed_cycles,
    )
    # scatter nodes (duplicated seam copies carry equal values)
    nsel = []
    for d in range(dim):
        i = bexec.off[list(idxs), d][:, None] + np.arange(
            bexec.bshape[d] + 1, dtype=np.int32
        )[None]
        sh = [len(idxs)] + [1] * dim
        sh[1 + d] = bexec.bshape[d] + 1
        nsel.append(jnp.asarray(i.reshape(sh)))
    out = bg.at[tuple(nsel)].set(phi_b)
    return out, res, it


UnionBoxExec.solve_cell = _solve_cell_batched
UnionBoxExec.solve_nodal = _solve_nodal_batched
