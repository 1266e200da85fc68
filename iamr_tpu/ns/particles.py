"""Passive tracer particles.

JAX equivalent of the reference's AmrTracerParticleContainer use
(NavierStokesBase.cpp:3754-4055): `AdvectWithUmac` (RK2 midpoint advection
with MAC-velocity interpolation, called from advance NavierStokes.cpp:672-677),
`Redistribute` (periodic wrapping / domain clamp), `Timestamp` output, ascii
init files (particles.particle_init_file), and particle_count derives.

Design: a fixed-size structure-of-arrays (positions (N, dim) + alive mask) —
static shapes for jit; no per-box bucketing is needed because a level is one
dense array (interpolation is a vectorized gather, not an MPI redistribute).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from iamr_tpu.core.geometry import Geometry


class Particles(NamedTuple):
    pos: jnp.ndarray    # (N, dim)
    alive: jnp.ndarray  # (N,) bool — False for slots that left the domain


def from_positions(pos, dtype=jnp.float64) -> Particles:
    pos = jnp.asarray(pos, dtype=dtype)
    return Particles(pos=pos, alive=jnp.ones(pos.shape[0], dtype=bool))


def read_ascii_init_file(path: str, dim: int) -> np.ndarray:
    """particles.particle_init_file format: first line = count, then one
    position per line (reference Exec/run_2d_particles/particle_file)."""
    with open(path) as f:
        toks = f.read().split()
    n = int(toks[0])
    vals = np.asarray([float(t) for t in toks[1 : 1 + n * dim]])
    return vals.reshape(n, dim)


def _interp_mac(umac, pos, geom: Geometry):
    """Interpolate MAC velocities to particle positions (linear per dim).

    Component d is face-centered in d (node coordinates) and cell-centered
    in the others; periodic dims wrap, non-periodic clamp to the domain.

    Under an active spatial mesh the interpolation runs SHARDED
    (_interp_mac_sharded): each device gathers only the stencil corners it
    owns and one psum of the (N, dim) particle velocities combines them —
    the MAC fields are never all-gathered (the Redistribute analogue of
    amrex's distributed AmrParticleContainer,
    NavierStokesBase.cpp:3866-3954).
    """
    from iamr_tpu.parallel.context import active

    pm = active()
    if pm is not None and pm.dim == geom.dim:
        return _interp_mac_sharded(umac, pos, geom, pm)
    dim = geom.dim
    dx = geom.dx
    out = []
    for d in range(dim):
        u = umac[d]
        # fractional index per axis
        idxs = []
        for e in range(dim):
            xe = (pos[:, e] - geom.prob_lo[e]) / dx[e]
            fe = xe if e == d else xe - 0.5  # face vs cell centering
            idxs.append(fe)
        # multilinear gather with wrap/clamp
        val = _multilinear(u, idxs, geom, face_dim=d)
        out.append(val)
    return jnp.stack(out, axis=-1)  # (N, dim)


def _multilinear(a, fidx: Sequence, geom: Geometry, face_dim: int):
    """One flat gather of all 2^dim corners per particle.

    A single jnp.take of (N * 2^dim) precomputed linear indices into the
    flattened array, in place of multi-dim fancy indexing or row gathers
    (its speed on the H100 is not measured)."""
    dim = a.ndim
    n = geom.ncell
    base = []
    frac = []
    for e in range(dim):
        f0 = jnp.floor(fidx[e])
        base.append(f0.astype(jnp.int32))
        frac.append(fidx[e] - f0)

    lins = []
    ws = []
    for corner in range(2**dim):
        w = 1.0
        lin = 0
        for e in range(dim):
            bit = (corner >> e) & 1
            ie = base[e] + bit
            we = frac[e] if bit else (1.0 - frac[e])
            size = a.shape[e]
            if geom.periodic[e]:
                if e == face_dim:
                    # face array carries the duplicated face (size n+1);
                    # wrap on the n real faces
                    ie = jnp.mod(ie, n[e])
                else:
                    ie = jnp.mod(ie, size)
            else:
                ie = jnp.clip(ie, 0, size - 1)
            lin = lin * size + ie
            w = w * we
        lins.append(lin)
        ws.append(w)
    vals = jnp.take(a.reshape(-1), jnp.stack(lins, -1).reshape(-1))
    return jnp.sum(vals.reshape(-1, 2**dim) * jnp.stack(ws, -1), -1)


def _interp_mac_sharded(umac, pos, geom: Geometry, pm):
    """Sharded MAC interpolation: positions are replicated (they are tiny),
    the fields stay spatially sharded. Every stencil corner is owned by
    exactly ONE device, so the combining psum adds one nonzero contribution
    to zeros — bitwise equal to the unsharded gather."""
    from jax.sharding import PartitionSpec as P

    dim = geom.dim
    dx = geom.dx
    n = geom.ncell
    names = pm.mesh.axis_names
    msh = pm.shape

    # pad every component to mesh-divisible extents (its own face dim has
    # n+1 entries); padding sits at the trailing shard and is never indexed
    padded = []
    locs = []
    for d in range(dim):
        u = umac[d]
        tgt = [(-(-u.shape[e] // msh[e])) * msh[e] for e in range(dim)]
        padded.append(
            jnp.pad(u, [(0, tgt[e] - u.shape[e]) for e in range(dim)])
        )
        locs.append(tuple(tgt[e] // msh[e] for e in range(dim)))

    def body(*args):
        us = args[:dim]
        p = args[dim]
        offs = [jax.lax.axis_index(names[e]) for e in range(dim)]
        out = []
        for d in range(dim):
            u_loc = us[d]
            loc = locs[d]
            base, frac = [], []
            for e in range(dim):
                xe = (p[:, e] - geom.prob_lo[e]) / dx[e]
                fe = xe if e == d else xe - 0.5
                f0 = jnp.floor(fe)
                base.append(f0.astype(jnp.int32))
                frac.append(fe - f0)
            prods = []
            for corner in range(2 ** dim):
                w = 1.0
                lin = 0
                ok = None
                for e in range(dim):
                    bit = (corner >> e) & 1
                    ie = base[e] + bit
                    we = frac[e] if bit else (1.0 - frac[e])
                    size = n[e] + (1 if e == d else 0)
                    if geom.periodic[e]:
                        ie = jnp.mod(ie, n[e])  # real faces/cells wrap
                    else:
                        ie = jnp.clip(ie, 0, size - 1)
                    il = ie - offs[e] * loc[e]
                    oke = (il >= 0) & (il < loc[e])
                    ok = oke if ok is None else ok & oke
                    lin = lin * loc[e] + jnp.clip(il, 0, loc[e] - 1)
                    w = w * we
                vals = jnp.take(u_loc.reshape(-1), lin)
                prods.append(jnp.where(ok, vals * w, 0.0))
            # psum BEFORE the corner reduction: each (particle, corner)
            # slot has exactly one nonzero contribution across devices, so
            # the psum is exact, and the final corner sum then runs in the
            # SAME reduction order as the unsharded gather -> bitwise equal
            stackp = jnp.stack(prods, axis=-1)
            for e in range(dim):
                stackp = jax.lax.psum(stackp, names[e])
            out.append(jnp.sum(stackp, axis=-1))
        return jnp.stack(out, axis=-1)

    spatial = P(*names)
    fn = jax.shard_map(
        body,
        mesh=pm.mesh,
        in_specs=tuple([spatial] * dim) + (P(),),
        out_specs=P(),
        check_vma=False,
    )
    return fn(*padded, pos)


def advect_with_umac(
    parts: Particles, umac, dt, geom: Geometry
) -> Particles:
    """RK2 midpoint advection (AdvectWithUmac semantics):
    x* = x + dt/2 u(x); x^{n+1} = x + dt u(x*), then redistribute."""
    u1 = _interp_mac(umac, parts.pos, geom)
    mid = parts.pos + 0.5 * dt * u1
    mid = _wrap(mid, geom)
    u2 = _interp_mac(umac, mid, geom)
    new = parts.pos + dt * u2
    return redistribute(parts._replace(pos=new), geom)


def _wrap(pos, geom: Geometry):
    cols = []
    for e in range(geom.dim):
        x = pos[:, e]
        lo, hi = geom.prob_lo[e], geom.prob_hi[e]
        if geom.periodic[e]:
            x = lo + jnp.mod(x - lo, hi - lo)
        cols.append(x)
    return jnp.stack(cols, axis=-1)


def redistribute(parts: Particles, geom: Geometry) -> Particles:
    """Wrap periodic positions; deactivate particles leaving the domain
    through non-periodic boundaries (Redistribute semantics)."""
    pos = parts.pos
    alive = parts.alive
    cols = []
    for e in range(geom.dim):
        x = pos[:, e]
        lo, hi = geom.prob_lo[e], geom.prob_hi[e]
        if geom.periodic[e]:
            x = lo + jnp.mod(x - lo, hi - lo)
        else:
            alive = alive & (x >= lo) & (x <= hi)
        cols.append(x)
    return Particles(pos=jnp.stack(cols, axis=-1), alive=alive)


def particle_count(parts: Particles, geom: Geometry):
    """Cells' particle counts (ParticleDerive particle_count,
    NavierStokesBase.cpp:3956-4055)."""
    dim = geom.dim
    n = geom.ncell
    idx = []
    for e in range(dim):
        ie = jnp.floor(
            (parts.pos[:, e] - geom.prob_lo[e]) / geom.dx[e]
        ).astype(jnp.int32)
        idx.append(jnp.clip(ie, 0, n[e] - 1))
    flat = jnp.zeros(int(np.prod(n)), dtype=jnp.int32)
    lin = idx[0]
    for e in range(1, dim):
        lin = lin * n[e] + idx[e]
    flat = flat.at[lin].add(parts.alive.astype(jnp.int32))
    return flat.reshape(n)


def timestamp(parts: Particles, path: str, time: float):
    """Append particle positions to a timestamp file (Timestamp output)."""
    pos = np.asarray(parts.pos)
    alive = np.asarray(parts.alive)
    with open(path, "a") as f:
        for i in range(pos.shape[0]):
            if alive[i]:
                f.write(
                    f"{i} {time:.12e} " + " ".join(f"{x:.12e}" for x in pos[i]) + "\n"
                )


def _composite_mac_velocity(levels, pos):
    """Velocity at particle positions from the FINEST level containing
    each particle (AmrTracerParticleContainer semantics: particles live on
    the finest level whose grids contain them and advect with that level's
    umac; NavierStokesBase.cpp:3754-3954).

    levels: sequence of (umac_tuple, Geometry) coarse -> fine; finer
    geometries are patch boxes in absolute coordinates. A particle counts
    as "on" a finer level while it sits at least one cell inside the patch
    (the interpolation stencil then never needs patch ghosts)."""
    u = _interp_mac(levels[0][0], pos, levels[0][1])
    for umac_l, geom_l in levels[1:]:
        inside = None
        for e in range(geom_l.dim):
            lo = geom_l.prob_lo[e] + geom_l.dx[e]
            hi = geom_l.prob_hi[e] - geom_l.dx[e]
            m = (pos[:, e] >= lo) & (pos[:, e] <= hi)
            inside = m if inside is None else inside & m
        u_l = _interp_mac(umac_l, pos, geom_l)
        u = jnp.where(inside[:, None], u_l, u)
    return u


def advect_with_umac_levels(parts: Particles, levels, dt) -> Particles:
    """RK2 midpoint advection against a level hierarchy's MAC velocities
    (composite finest-containing-level selection per particle); fine
    umacs should be the subcycle time-averages. Redistributes against the
    level-0 (domain) geometry."""
    geom0 = levels[0][1]
    u1 = _composite_mac_velocity(levels, parts.pos)
    mid = _wrap(parts.pos + 0.5 * dt * u1, geom0)
    u2 = _composite_mac_velocity(levels, mid)
    new = parts.pos + dt * u2
    return redistribute(parts._replace(pos=new), geom0)


def write_ascii_particles(path: str, parts: Particles):
    """particles.particle_output_file: final particle positions in the
    ascii init-file format (count, then one position per line;
    NavierStokesBase particle_output_file intake)."""
    import numpy as _np

    pos = _np.asarray(parts.pos)
    alive = _np.asarray(parts.alive)
    pos = pos[alive]
    with open(path, "w") as f:
        f.write(f"{pos.shape[0]}\n")
        for row in pos:
            f.write(" ".join(f"{x:.16e}" for x in row) + "\n")
