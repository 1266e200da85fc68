"""Spatial device meshes and sharding specs for level arrays.

The framework's primary parallel axis is spatial domain decomposition
(SURVEY.md section 2.3.1; the reference distributes its BoxArray over MPI
ranks via DistributionMapping and communicates through ParallelDescriptor /
FillBoundary, Source/NavierStokesBase.cpp:1452). The JAX equivalent:
shard each dense level array over a `jax.sharding.Mesh` whose axes are the
spatial dimensions, annotate programs with `with_sharding_constraint`, and
let XLA compile the ghost fills / stencils / multigrid transfers into
collectives (collective-permute halo exchanges, all-reduce reductions).

Centering conventions: cell arrays are (nx, ny[, nz]); face/node arrays are
+1 along one/all dims; vector fields carry a leading component axis that is
never sharded. All of these map onto the same spatial mesh axes — XLA pads
the odd +1 element onto the last shard.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

AXIS_NAMES = ("x", "y", "z")


def _factor(n: int, dim: int) -> Tuple[int, ...]:
    """Factor n devices into `dim` mesh axes, most-square-first.

    Later spatial dims get the larger factors (the z/last dim is usually
    the contiguous-lane dim; keeping x smallest keeps halo slabs thick).
    """
    dims = [1] * dim
    rem = n
    # peel prime factors largest-axis-last
    f = 2
    factors = []
    while rem > 1:
        while rem % f == 0:
            factors.append(f)
            rem //= f
        f += 1
    for p in sorted(factors, reverse=True):
        # assign to the currently-smallest axis (ties -> later dim)
        i = int(np.argmin(dims[::-1]))
        dims[dim - 1 - i] *= p
    return tuple(dims)


@dataclasses.dataclass(frozen=True)
class SpatialMesh:
    """A spatial domain-decomposition mesh.

    mesh: the jax Mesh; axis k named AXIS_NAMES[k] decomposes spatial dim k.
    Axes of extent 1 are kept (they shard nothing but keep specs uniform).
    """

    mesh: Mesh

    @classmethod
    def create(
        cls,
        n_devices: Optional[int] = None,
        dim: int = 3,
        devices: Optional[Sequence] = None,
        shape: Optional[Tuple[int, ...]] = None,
    ) -> "SpatialMesh":
        if devices is None:
            devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
        n = len(devices)
        if shape is None:
            # decompose over the first dim-1 spatial dims by default: the
            # last dim is the XLA minor (lane) dim, keep it contiguous
            ndecomp = max(1, dim - 1)
            shape = _factor(n, ndecomp) + (1,) * (dim - ndecomp)
        assert len(shape) == dim and int(np.prod(shape)) == n
        mesh = Mesh(np.asarray(devices).reshape(shape), AXIS_NAMES[:dim])
        return cls(mesh=mesh)

    @property
    def dim(self) -> int:
        return len(self.mesh.axis_names)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.mesh.shape[a] for a in self.mesh.axis_names)

    def spec(self, n_leading: int = 0, spatial: Optional[Sequence[Optional[str]]] = None) -> P:
        """PartitionSpec: n_leading unsharded axes then the spatial axes."""
        if spatial is None:
            spatial = self.mesh.axis_names
        return P(*((None,) * n_leading + tuple(spatial)))

    def sharding(self, n_leading: int = 0, spatial=None) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec(n_leading, spatial))

    def replicated(self) -> NamedSharding:
        return NamedSharding(self.mesh, P())


def shard_state(state, pmesh: SpatialMesh):
    """device_put an NSState (or any pytree of level arrays) onto the mesh.

    Arrays whose trailing ndim >= mesh dim are sharded over their trailing
    `dim` spatial axes (leading axes = components); a spatial dim whose
    extent does not divide its mesh axis (node arrays, n+1) is left
    unsharded at input — GSPMD re-lays it out inside the program.
    Scalars replicate.
    """
    dim = pmesh.dim
    names = pmesh.mesh.axis_names

    def put(a):
        if not hasattr(a, "ndim") or a.ndim < dim:
            return jax.device_put(a, pmesh.replicated())
        nl = a.ndim - dim
        spatial = tuple(
            names[k]
            if a.shape[nl + k] % pmesh.mesh.shape[names[k]] == 0
            else None
            for k in range(dim)
        )
        return jax.device_put(a, pmesh.sharding(n_leading=nl, spatial=spatial))

    return jax.tree_util.tree_map(put, state)
