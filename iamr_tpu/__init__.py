"""iamr_tpu — an adaptive-mesh incompressible Navier-Stokes framework in JAX.

A from-scratch JAX/XLA implementation of the capabilities of
AMReX-Fluids/IAMR (variable-density projection-method solver): Godunov
advection, Crank-Nicolson diffusion, MAC + nodal approximate projections with
a geometric-multigrid engine, multilevel AMR with refluxing and sync
projection, embedded boundaries, tracer particles, and IAMR-compatible
inputs files / plotfiles.

Design (not a port):
  * Each AMR level is a dense global array per centering, sharded over a
    ``jax.sharding.Mesh``; ghost exchange is XLA halo collectives, not MPI.
  * The timestep is a single jit-compiled functional program; regrids
    recompile out-of-band.
  * Multigrid smoothers and stencils are plain jax.numpy/lax, fused by
    XLA.
"""

__version__ = "0.1.0"

from iamr_tpu.config.parmparse import ParmParse
