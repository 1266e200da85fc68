"""Low-level stencil helpers over dense level arrays.

Conventions:
  * cell arrays: shape (nx, ny[, nz])
  * face arrays for dim d: shape +1 in dim d (MAC staggering)
  * node arrays: shape +1 in every dim
All helpers are jit-safe and dimension-generic.
"""

from __future__ import annotations

import jax.numpy as jnp


def sl(a, d: int, start, stop):
    """Slice axis d with [start:stop] (None allowed)."""
    idx = [slice(None)] * a.ndim
    idx[d] = slice(start, stop)
    return a[tuple(idx)]


def diff(a, d: int):
    """Forward difference along d: out has one fewer entry in d."""
    return sl(a, d, 1, None) - sl(a, d, None, -1)


def avg2(a, d: int):
    """Average of adjacent entries along d: out has one fewer entry in d."""
    return 0.5 * (sl(a, d, 1, None) + sl(a, d, None, -1))


def mac_div(umac, dx):
    """Divergence of a MAC (face-centered) vector field at cell centers.

    umac: tuple of face arrays; returns cell array sum_d (u_hi - u_lo)/dx_d.
    """
    out = 0.0
    for d, u in enumerate(umac):
        out = out + diff(u, d) / dx[d]
    return out


def cell_to_face(a, d: int, bc_wrap: bool = False):
    """Arithmetic average of a cell array to interior faces of dim d.

    Returns shape +1 in d when bc_wrap (periodic: face 0 == face n), else the
    caller must supply boundary faces; here we one-sided-copy edge cells to
    the domain faces (used for face coefficients beta=1/rho where boundary
    faces only matter via the BC masks).
    """
    inner = avg2(a, d)
    if bc_wrap:
        wrap = 0.5 * (sl(a, d, 0, 1) + sl(a, d, -1, None))
        return jnp.concatenate([wrap, inner, wrap], axis=d)
    lo = sl(a, d, 0, 1)
    hi = sl(a, d, -1, None)
    return jnp.concatenate([lo, inner, hi], axis=d)


def checkerboard(shape, parity: int, dtype):
    """Mask of cells with (i+j+k) % 2 == parity (built from >=2D iotas)."""
    import jax

    total = None
    for d in range(len(shape)):
        it = jax.lax.broadcasted_iota(jnp.int32, shape, d)
        total = it if total is None else total + it
    return (total % 2 == parity).astype(dtype)
