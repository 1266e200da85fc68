"""Multi-chip spatial parallelism (the ParallelDescriptor/DistributionMapping
replacement; SURVEY.md sections 2.3 and 5.8).

Design: shard dense level arrays over a spatial `jax.sharding.Mesh`
(`SpatialMesh`), activate the mesh with `use_mesh` around jit tracing, and
the solver internals annotate per-MG-level layouts via `constrain` — fine
levels stay sharded (halo exchanges are collective-permutes),
coarse levels replicate (the agglomeration analogue). Global reductions
(dt CFL min, residual norms, conservation sums — reference
NavierStokesBase.cpp:1452) are plain jnp reductions that XLA lowers to
all-reduces; there are no host round-trips inside the step.

Usage:
    pmesh = SpatialMesh.create(n_devices, dim=3)
    state = shard_state(state, pmesh)
    with use_mesh(pmesh):
        step = jax.jit(lambda s: advance(s, cfg))
        state = step(state)   # first call traces with annotations baked in
"""

from iamr_tpu.parallel.mesh import SpatialMesh, shard_state
from iamr_tpu.parallel.context import active, constrain, constrain_tuple, use_mesh

__all__ = [
    "SpatialMesh",
    "shard_state",
    "active",
    "constrain",
    "constrain_tuple",
    "use_mesh",
]
