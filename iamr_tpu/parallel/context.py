"""Active-mesh context: sharding annotations inside the solver programs.

The step functions are written as plain dense-array programs; when a
SpatialMesh context is active (`with use_mesh(pmesh): step(...)` around
trace time), solver internals call `constrain(x)` at layout-critical points
— most importantly per multigrid level — and XLA's SPMD partitioner
propagates the rest.

The coarse-multigrid policy lives here (the JAX analogue of AMReX MLMG
agglomeration/consolidation, reference Source/Diffusion.cpp:319-336 and
SURVEY.md section 5.7): a spatial dim stays sharded while every device
keeps at least MIN_LOCAL cells of it and the extent divides the mesh axis;
below that the level is replicated, so coarse V-cycle levels run redundantly
on every device instead of ping-ponging tiny halos between devices. Fine levels
carry the work; replicating <= (2*MIN_LOCAL)^dim cells is cheaper than the
latency-bound alternative.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Optional

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from iamr_tpu.parallel.mesh import SpatialMesh

_ACTIVE: Optional[SpatialMesh] = None

# smallest per-device extent (in cells) worth keeping sharded inside MG
MIN_LOCAL = 8


def active() -> Optional[SpatialMesh]:
    return _ACTIVE


@contextmanager
def use_mesh(pmesh: SpatialMesh):
    """Activate a spatial mesh for programs traced inside the block."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = pmesh
    try:
        yield pmesh
    finally:
        _ACTIVE = prev


def level_spec(shape, pmesh: SpatialMesh, n_leading: int = 0) -> P:
    """PartitionSpec for a level array of (global) spatial `shape`.

    Dim k is sharded on mesh axis k iff the mesh axis has >1 devices, the
    extent divides evenly, and the per-device extent is >= MIN_LOCAL.
    Non-dividing extents (node arrays, n+1) stay unannotated along that dim
    and GSPMD chooses their layout.
    """
    names = pmesh.mesh.axis_names
    spatial = []
    for k, n in enumerate(shape):
        if k >= len(names):
            spatial.append(None)
            continue
        nd = pmesh.mesh.shape[names[k]]
        if nd > 1 and n % nd == 0 and n // nd >= MIN_LOCAL:
            spatial.append(names[k])
        else:
            spatial.append(None)
    return P(*((None,) * n_leading + tuple(spatial)))


def constrain(x, n_leading: int = 0):
    """Annotate a level array with its mesh layout (no-op without a mesh).

    n_leading: leading component axes (never sharded). Scalars pass through.
    """
    pmesh = _ACTIVE
    if pmesh is None or not hasattr(x, "ndim"):
        return x
    ns = x.ndim - n_leading
    if ns <= 0:
        return x
    spec = level_spec(x.shape[n_leading:], pmesh, n_leading)
    return jax.lax.with_sharding_constraint(x, NamedSharding(pmesh.mesh, spec))


def constrain_tuple(xs, n_leading: int = 0):
    return tuple(constrain(x, n_leading) for x in xs)
