"""Pencil-decomposed distributed FFT solves over a SpatialMesh.

The exact spectral solvers (solvers/spectral.py) replace multigrid on
all-periodic constant-coefficient problems; under spatial domain
decomposition a naive jnp.fft.fftn of an (x,y)-sharded array would make
GSPMD all-gather the whole level onto every chip. This module keeps the
transform distributed the classic pencil way (the JAX analogue of the
slab/pencil MPI FFTs the reference ecosystem uses for its HIT forcing
spectra, Tutorials/HIT/NS_getForce.cpp): inside one shard_map,

  * transform array dims last->first with local 1D FFTs;
  * before transforming a dim that is device-sharded, rotate it to a full
    dim with a tiled `all_to_all` over that mesh axis (split a full dim,
    concatenate the sharded one) — each chip then owns a full pencil of
    the dim being transformed;
  * apply the (locally assembled) operator symbol in k-space;
  * replay the rotations in reverse for the inverse transform.

Every collective is an all-to-all inside jit (NVLink joins every card
to every other, so no mesh axis is cheaper than another); no array is
ever replicated. Symbols are assembled per shard from 1D factor vectors sliced
at the shard's k-offset (`lax.axis_index`), so the k-space layout never
materializes globally either.

The solves are bit-compatible with solvers/spectral.py (same discrete
symbols); tests/test_parallel.py asserts sharded == unsharded parity.
"""

from __future__ import annotations

from functools import partial
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from iamr_tpu.parallel.mesh import SpatialMesh


def _plan(dim: int, owner0: Sequence[Optional[str]]):
    """Forward-transform plan: list of ("fft", d) / ("a2a", name, f, d) ops
    (a2a = split full dim f into |name| parts, concat onto sharded dim d),
    plus the final k-space owner of each dim."""
    owner = list(owner0)
    ops: List[Tuple] = []
    for d in reversed(range(dim)):
        if owner[d] is not None:
            full = [e for e in range(dim) if owner[e] is None and e != d]
            if not full:
                # every dim device-sharded: no pencil rotation possible
                raise ValueError("pencil plan needs at least one full dim")
            f = max(full)
            ops.append(("a2a", owner[d], f, d))
            owner[f] = owner[d]
            owner[d] = None
        ops.append(("fft", d))
    return ops, owner


def _owner0(shape, pmesh: SpatialMesh) -> Tuple[Optional[str], ...]:
    """Input sharding of a level array: dim k on mesh axis k when it
    divides (mirrors parallel.context.level_spec, without MIN_LOCAL —
    the FFT path has no per-level coarsening to protect)."""
    names = pmesh.mesh.axis_names
    out = []
    for k, n in enumerate(shape):
        if k < len(names):
            nd = pmesh.mesh.shape[names[k]]
            out.append(names[k] if (nd > 1 and n % nd == 0) else None)
        else:
            out.append(None)
    return tuple(out)


def pencil_eligible(shape, pmesh: Optional[SpatialMesh]) -> bool:
    """Host-side: can `shape` run the pencil plan on `pmesh` (every
    all_to_all divides evenly)?"""
    if pmesh is None:
        return False
    dim = len(shape)
    owner0 = _owner0(shape, pmesh)
    if all(o is None for o in owner0):
        # nothing shardable: the dense single-device path is strictly
        # simpler (and GSPMD replicates either way)
        return False
    if all(o is not None for o in owner0):
        # every dim sharded (a fully-decomposed mesh): no full dim to
        # rotate pencils through -> fall back to MG
        return False
    sizes = {a: pmesh.mesh.shape[a] for a in pmesh.mesh.axis_names}
    local = [
        n // sizes[o] if o is not None else n for n, o in zip(shape, owner0)
    ]
    ops, _ = _plan(dim, owner0)
    for op in ops:
        if op[0] != "a2a":
            continue
        _, name, f, d = op
        s = sizes[name]
        if local[f] % s != 0:
            return False
        local[f] //= s
        local[d] *= s
    return True


def _slice_factor(vec, owner_name, local_n, dtype):
    """Local slice of a full-length per-dim factor vector at this shard's
    k-offset."""
    v = jnp.asarray(vec, dtype=dtype)
    if owner_name is None:
        return v
    off = jax.lax.axis_index(owner_name) * local_n
    return jax.lax.dynamic_slice(v, (off,), (local_n,))


def _local_zero_mask(owner_k, local_shape, dim):
    """Boolean of the local block marking the global (0,...,0) k-mode."""
    mask = None
    for d in range(dim):
        idx = jnp.arange(local_shape[d])
        if owner_k[d] is not None:
            idx = idx + jax.lax.axis_index(owner_k[d]) * local_shape[d]
        m = (idx == 0).reshape(
            tuple(local_shape[d] if e == d else 1 for e in range(dim))
        )
        mask = m if mask is None else jnp.logical_and(mask, m)
    return mask


def _fwd(v, ops):
    for op in ops:
        if op[0] == "fft":
            v = jnp.fft.fft(v, axis=op[1])
        else:
            _, name, f, d = op
            v = jax.lax.all_to_all(
                v, name, split_axis=f, concat_axis=d, tiled=True
            )
    return v


def _inv(v, ops):
    for op in reversed(ops):
        if op[0] == "fft":
            v = jnp.fft.ifft(v, axis=op[1])
        else:
            _, name, f, d = op
            v = jax.lax.all_to_all(
                v, name, split_axis=d, concat_axis=f, tiled=True
            )
    return v


def _stiff_vec(n, h):
    """Symbol of the assembled periodic 1D stiffness: (2-2cos k)/h^2
    (complex-fft frequency order)."""
    k = 2.0 * np.pi * np.fft.fftfreq(n)
    return (2.0 - 2.0 * np.cos(k)) / (h * h)


def _mass_vec(n):
    """Symbol of the assembled (h-normalized) 1D FEM mass: (4+2cos k)/6."""
    k = 2.0 * np.pi * np.fft.fftfreq(n)
    return (4.0 + 2.0 * np.cos(k)) / 6.0


def _shard_solve(rhs, pmesh, denom_fn, mean_free_flag):
    """Common driver: forward pencil FFT, divide by the locally assembled
    denominator, zero the nullspace mode per `mean_free_flag` (a traced
    boolean — True drops the zero mode), inverse transform."""
    dim = rhs.ndim
    shape = rhs.shape
    owner0 = _owner0(shape, pmesh)
    ops, owner_k = _plan(dim, owner0)
    rdtype = rhs.dtype
    cdtype = jnp.complex128 if rdtype == jnp.float64 else jnp.complex64

    sizes = {a: pmesh.mesh.shape[a] for a in pmesh.mesh.axis_names}

    def body(local, mf):
        v = _fwd(local.astype(cdtype), ops)
        kshape = v.shape
        denom = denom_fn(owner_k, kshape, rdtype)
        zero = _local_zero_mask(owner_k, kshape, dim)
        denom = jnp.where(zero & (jnp.abs(denom) == 0.0),
                          jnp.asarray(1.0, rdtype), denom)
        v = v / denom
        v = jnp.where(zero & mf, jnp.asarray(0.0, cdtype), v)
        return jnp.real(_inv(v, ops)).astype(rdtype)

    fn = jax.shard_map(
        body,
        mesh=pmesh.mesh,
        in_specs=(P(*owner0), P()),
        out_specs=P(*owner0),
    )
    return fn(rhs, jnp.asarray(mean_free_flag))


def solve_cell_helmholtz_pencil(rhs, a_alpha0, b_beta0, dx, pmesh):
    """Distributed twin of spectral.solve_cell_helmholtz: exact inverse of
    (a_alpha0 - b_beta0*lap7) on the all-periodic cell grid, sharded."""
    shape = rhs.shape
    dim = rhs.ndim
    stiff = [_stiff_vec(shape[d], dx[d]) for d in range(dim)]
    aa = jnp.asarray(a_alpha0, rhs.dtype)
    bb = jnp.asarray(b_beta0, rhs.dtype)

    def denom_fn(owner_k, kshape, rdtype):
        sym = None
        for d in range(dim):
            f = _slice_factor(stiff[d], owner_k[d], kshape[d], rdtype)
            f = f.reshape(
                tuple(kshape[d] if e == d else 1 for e in range(dim))
            )
            sym = f if sym is None else sym + f
        return aa + bb * sym

    return _shard_solve(rhs, pmesh, denom_fn, mean_free_flag=(aa <= 0.0))


def solve_nodal_poisson_pencil(rhs_inner, sigma0, dx, pmesh):
    """Distributed twin of spectral.solve_nodal_poisson on the n^d INNER
    node lattice (caller strips/wraps the duplicated periodic slice)."""
    shape = rhs_inner.shape
    dim = rhs_inner.ndim
    stiff = [_stiff_vec(shape[d], dx[d]) for d in range(dim)]
    mass = [_mass_vec(shape[d]) for d in range(dim)]
    sg = jnp.asarray(sigma0, rhs_inner.dtype)

    def denom_fn(owner_k, kshape, rdtype):
        fs = [
            _slice_factor(stiff[d], owner_k[d], kshape[d], rdtype)
            for d in range(dim)
        ]
        fm = [
            _slice_factor(mass[d], owner_k[d], kshape[d], rdtype)
            for d in range(dim)
        ]

        def rs(v, d):
            return v.reshape(
                tuple(kshape[d] if e == d else 1 for e in range(dim))
            )

        sym = None
        for d in range(dim):
            term = rs(fs[d], d)
            for e in range(dim):
                if e != d:
                    term = term * rs(fm[e], e)
            sym = term if sym is None else sym + term
        return sg * sym

    # apply_nodal = -(assembled operator): negate rhs like the dense twin
    return _shard_solve(-rhs_inner, pmesh, denom_fn, mean_free_flag=True)
