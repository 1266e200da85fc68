"""LES subgrid closures: Smagorinsky and Sigma eddy viscosity.

JAX equivalent of reference Source/NS_LES.cpp:114-240 (params
ns.do_LES / ns.LES_model / ns.smago_Cs_cst=0.18 / ns.sigma_Cs_cst=1.5,
NavierStokesBase.cpp:142-146,481-485). The eddy viscosity is added to the
molecular face viscosity in the CN solves and explicit viscous terms
(getViscosity hook, NavierStokes.cpp:2139-2152).

Smagorinsky: mu_t = (Cs dx)^2 sqrt(2 S_ij S_ij)
Sigma (3D, Nicoud et al. 2011): mu_t = (Cs dx)^2 *
    sigma3 (sigma1 - sigma2)(sigma2 - sigma3) / sigma1^2
with sigma_i the singular values of grad(u).
(The reference computes mu_t without a density factor; same here.)
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from iamr_tpu.ops.stencil import avg2, sl


def _cc_gradients(cfg, bcp, vel):
    """grad(u): G[c][d] = du_c/dx_d at cells, via 1-ghost central diffs."""
    dim = cfg.dim
    dx = cfg.geom.dx
    G = [[None] * dim for _ in range(dim)]
    vel_g = bcp.fill_vel(vel, 1)
    for c in range(dim):
        g = vel_g[c]
        for d in range(dim):
            hi = sl(g, d, 2, None)
            lo = sl(g, d, 0, -2)
            ctr = (hi - lo) / (2.0 * dx[d])
            idx = tuple(
                slice(None) if e == d else slice(1, -1) for e in range(dim)
            )
            G[c][d] = ctr[idx]
    return G


def mut_smagorinsky(cfg, bcp, vel, cs: float):
    dim = cfg.dim
    G = _cc_gradients(cfg, bcp, vel)
    smag = 0.0
    for i in range(dim):
        for j in range(dim):
            sij = 0.5 * (G[i][j] + G[j][i])
            smag = smag + 2.0 * sij * sij
    delta = min(cfg.geom.dx)
    return (cs * delta) ** 2 * jnp.sqrt(smag)


def mut_sigma(cfg, bcp, vel, cs: float):
    assert cfg.dim == 3, "Sigma model is 3D-only (reference NS_LES.cpp abort)"
    G = _cc_gradients(cfg, bcp, vel)
    # g: (*n, 3, 3)
    g = jnp.stack(
        [jnp.stack([G[i][j] for j in range(3)], axis=-1) for i in range(3)],
        axis=-2,
    )
    # singular values via eigvals of g^T g (symmetric PSD, 3x3)
    gtg = jnp.einsum("...ki,...kj->...ij", g, g,
                     precision=lax.Precision.HIGHEST)
    ev = jnp.linalg.eigvalsh(gtg)  # ascending
    ev = jnp.maximum(ev, 0.0)
    s1 = jnp.sqrt(ev[..., 2])
    s2 = jnp.sqrt(ev[..., 1])
    s3 = jnp.sqrt(ev[..., 0])
    delta = min(cfg.geom.dx)
    d_sigma = s3 * (s1 - s2) * (s2 - s3) / jnp.maximum(s1 * s1, 1e-30)
    return (cs * delta) ** 2 * d_sigma


def eddy_viscosity_faces(cfg, bcp, vel):
    """mu_t on faces (arithmetic cell->face average), per the configured
    LES model; zeros when LES is off."""
    if not cfg.do_les:
        return None
    if cfg.les_model.lower() == "sigma":
        mut = mut_sigma(cfg, bcp, vel, cfg.sigma_cs)
    else:
        mut = mut_smagorinsky(cfg, bcp, vel, cfg.smago_cs)
    dim = cfg.dim
    out = []
    for d in range(dim):
        inner = avg2(mut, d)
        lo = sl(mut, d, 0, 1)
        hi = sl(mut, d, -1, None)
        out.append(jnp.concatenate([lo, inner, hi], axis=d))
    return tuple(out)


def tensor_cross_terms(cfg, bcp, vel, mu_f):
    """Explicit tensor-viscosity cross terms: T_i = sum_j d_j(mu d_i u_j).

    Together with the componentwise implicit div(mu grad u_i) this is the
    full incompressible stress divergence d_j(mu (d_j u_i + d_i u_j)) of
    the reference's MLTensorOp (Diffusion.cpp:650-958); the cross part is
    treated explicitly (it vanishes identically for constant mu and
    div-free U, so it only matters for LES / variable viscosity).

    mu_f: face viscosities per dim. Returns (dim, *n) cell array.
    """
    from iamr_tpu.ops.stencil import cell_to_face, diff

    dim = cfg.dim
    dx = cfg.geom.dx
    G = _cc_gradients(cfg, bcp, vel)  # G[c][d] = d u_c / d x_d at cells
    out = []
    for i in range(dim):
        acc = None
        for j in range(dim):
            # mu * (d_i u_j) on j-faces, then d/dx_j back to cells
            g_face = cell_to_face(G[j][i], j, bc_wrap=cfg.geom.periodic[j])
            flux = mu_f[j] * g_face
            t = diff(flux, j) / dx[j]
            acc = t if acc is None else acc + t
        out.append(acc)
    return jnp.stack(out)


def tensor_cross_fluxes(cfg, bcp, vel, mu_f):
    """Transpose-part viscous face fluxes: out[i][j] = -mu_f[j]*(d_i u_j)
    on j-faces — the cross half of the full tensor stress flux
    mu (grad u + grad u^T) that the reference registers from its tensor
    solve (computeExtensiveFluxes, Diffusion.cpp:1463-1539). Sign matches
    ops/mg.get_fluxes (-b*beta*grad), so these ADD to the componentwise
    register fluxes to make LES / variable-viscosity C-F refluxing exact.
    """
    from iamr_tpu.ops.stencil import cell_to_face

    dim = cfg.dim
    G = _cc_gradients(cfg, bcp, vel)
    return [
        tuple(
            -mu_f[j]
            * cell_to_face(G[j][i], j, bc_wrap=cfg.geom.periodic[j])
            for j in range(dim)
        )
        for i in range(dim)
    ]
