"""Nodal approximate projection (the Projection engine, single level).

JAX equivalent of reference Source/Projection.cpp level_project
(Projection.cpp:166-449, proj_2 form) + initialVelocityProject (615-840),
over the FEM nodal multigrid (iamr_tpu.ops.mg_nodal), replacing
MLNodeLaplacian + Hydro::NodalProjector (Projection.cpp:2385-2567).

level_project semantics:
    Vs = U*/dt + Gp^{n-1/2}/rho_half          (scale, Projection.cpp:272-301)
    solve  L(phi) = D(Vs)                      (sigma = 1/rho_half)
    U^{n+1} = (Vs - sigma G(phi)) * dt
    p^{n+1/2} = phi;  Gp = G(phi)

sigma = 1/rho, zero outside the domain (scaleVar, Projection.cpp:1238-1466);
outflow faces carry phi = 0 Dirichlet nodes. Default tolerances rtol 1e-12 /
atol 1e-16 (Projection.cpp:18-20).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax.numpy as jnp

from iamr_tpu.core.bc import DomainBC, PhysBC
from iamr_tpu.ops import mg_nodal
from iamr_tpu.ops.mg_nodal import (
    N_DIRICHLET,
    N_NEUMANN,
    N_PERIODIC,
    NodalBC,
    div_cell_to_node,
    grad_node_to_cell,
    nodal_solve,
)


def nodal_bc(dom: DomainBC) -> NodalBC:
    def kind(p: PhysBC):
        if p == PhysBC.Interior:
            return N_PERIODIC
        if p == PhysBC.Outflow:
            return N_DIRICHLET
        return N_NEUMANN

    return NodalBC(
        lo=tuple(kind(p) for p in dom.phys_lo),
        hi=tuple(kind(p) for p in dom.phys_hi),
    )


def level_project(
    vel_star,
    rho_half,
    p_old,
    gradp_old,
    dt,
    dom: DomainBC,
    dx: Sequence[float],
    rtol: float = 1e-12,
    atol: float = 1e-16,
    fixed_cycles: Optional[int] = None,
    bc: Optional[NodalBC] = None,
    phi_bc=None,
    divu_src=None,
    eb=None,
    rz=None,
    union=None,
    spectral_sigma0=None,
    boxes=None,
):
    """Approximate nodal projection of the provisional velocity.

    spectral_sigma0: scalar 1/rho_half of an all-periodic uniform-density
    run — the FEM nodal solve runs in Fourier space (solvers.spectral),
    exact for the same 27-point discrete operator. Caller guarantees
    eligibility; ignored for EB/RZ/union projections.

    union: optional (cellmask, nodemask) for the level-wide multi-box
    projection — the nodal solve runs on the box union with hole elements
    removed (sigma masked) and non-interior nodes constrained to phi_bc's
    coarse-interpolated values. Not supported together with eb or rz.

    vel_star: (dim, *n) un-projected new-time velocity (updated with -Gp
    forcing); returns (vel_new, p_new, gradp_new, stats). bc/phi_bc override
    the domain BCs with coarse-fine Dirichlet values on fine levels
    (reference doMLMGNodalProjection coarse-fine handling). divu_src: cell
    field S with div(U^{n+1}) = S (thermal divergence; subtracted from the
    rhs as S/dt averaged to nodes).

    eb: optional EBData; the FEM nodal operator and the divergence are
    volume-fraction weighted (MLNodeLaplacian EB semantics) and covered
    cells are masked out of the corrected velocity/Gp.
    """
    dim = rho_half.ndim
    if bc is None:
        bc = nodal_bc(dom)
    sigma = 1.0 / rho_half

    vs = tuple(
        vel_star[d] / dt + gradp_old[d] * sigma for d in range(dim)
    )
    # prescribed inflow normal velocity enters the divergence, scaled like
    # vs (U/dt form); see div_cell_to_node inflow_vals
    inflow_vals = {
        (d, s): dom.value(d, s, d) / dt
        for d in range(dim)
        for s, p in ((0, dom.phys_lo[d]), (1, dom.phys_hi[d]))
        if p == PhysBC.Inflow
    }
    if eb is not None:
        sigma_op = sigma * eb.vfrac
        rhs = div_cell_to_node(
            tuple(eb.vfrac * v for v in vs), dx, bc, inflow_vals
        )
    elif rz is not None:
        # RZ: sigma and U are multiplied by the cell radius (scaleVar
        # radMultScal, Projection.cpp:1238-1505); the correction stays
        # unscaled (rescaleVar inverts)
        r_cell = rz[0]
        sigma_op = sigma * r_cell
        rhs = div_cell_to_node(tuple(r_cell * v for v in vs), dx, bc, inflow_vals)
    else:
        sigma_op = sigma
        rhs = div_cell_to_node(vs, dx, bc, inflow_vals)
    nodemask = None
    if union is not None:
        cellmask, nodemask = union
        sigma_op = sigma_op * cellmask
    if divu_src is not None:
        from iamr_tpu.ops.mg_nodal import avg_cell_to_node

        src = divu_src
        if eb is not None:
            src = eb.vfrac * src
        elif rz is not None:
            src = rz[0] * src
        rhs = rhs - avg_cell_to_node(src, bc) / dt
    # warm start from the previous half-time pressure: p^{n-1/2} solves the
    # same equation one step earlier, so the initial residual is already
    # O(dt) small — in fixed-cycle (benchmark) mode this buys roughly one
    # V-cycle of accuracy for free
    phi0 = p_old if p_old.shape == tuple(rhs.shape) else None
    if phi0 is not None and phi_bc is not None:
        # phi_bc lifting assumes the lifted part starts homogeneous
        phi0 = None
    if phi0 is not None and eb is not None:
        # EB: covered nodes (sigma = 0 all around -> zero diagonal) are
        # never touched by the masked smoother, so a warm start would
        # freeze p_old's covered values into grad(phi) next to the body
        phi0 = None
    if (
        spectral_sigma0 is not None
        and eb is None
        and rz is None
        and union is None
        and phi_bc is None
    ):
        from iamr_tpu.solvers.spectral import solve_nodal_poisson

        phi = solve_nodal_poisson(rhs, spectral_sigma0, dx)
        res, it = jnp.zeros((), rho_half.dtype), 0
    elif boxes is not None and union is not None:
        # congruent multi-box union: batched nodal MG (ops/mg_nodal_batch)
        # — same pinned system as the masked bbox solve, batch-sized
        phi, res, it = boxes.solve_nodal(
            rhs, sigma_op, dx, bc, phi_bc=phi_bc, phi0=phi0, rtol=rtol,
            atol=atol, fixed_cycles=fixed_cycles,
        )
    else:
        phi, res, it = nodal_solve(
            rhs, sigma_op, dx, bc, rtol=rtol, atol=atol,
            fixed_cycles=fixed_cycles,
            phi_bc=phi_bc, phi0=phi0, interior_mask=nodemask,
        )
    gphi = grad_node_to_cell(phi, dx)
    if eb is not None:
        vel_new = jnp.stack(
            [eb.fluid * (vs[d] - sigma * gphi[d]) * dt for d in range(dim)]
        )
        gradp_new = jnp.stack([eb.fluid * g for g in gphi])
    else:
        vel_new = jnp.stack(
            [(vs[d] - sigma * gphi[d]) * dt for d in range(dim)]
        )
        gradp_new = jnp.stack(list(gphi))
    return vel_new, phi, gradp_new, (res, it)


def initial_velocity_project(
    vel,
    rho,
    dom: DomainBC,
    dx: Sequence[float],
    divu_src=None,
    rtol: float = 1e-12,
    atol: float = 1e-16,
    fixed_cycles: Optional[int] = None,
    eb=None,
    rz=None,
):
    """Make the initial velocity divergence-free (initialVelocityProject,
    Projection.cpp:615-840): solve L(phi)=D(U), U <- U - sigma G(phi); the
    initial pressure stays zero (pressure comes from init_iter pressure
    iterations, NavierStokes.cpp:1305-1432)."""
    dim = rho.ndim
    bc = nodal_bc(dom)
    sigma = 1.0 / rho
    u = tuple(vel[d] for d in range(dim))
    inflow_vals = {
        (d, s): dom.value(d, s, d)
        for d in range(dim)
        for s, p in ((0, dom.phys_lo[d]), (1, dom.phys_hi[d]))
        if p == PhysBC.Inflow
    }
    if eb is not None:
        sigma_op = sigma * eb.vfrac
        rhs = div_cell_to_node(
            tuple(eb.vfrac * ud for ud in u), dx, bc, inflow_vals
        )
    elif rz is not None:
        sigma_op = sigma * rz[0]
        rhs = div_cell_to_node(tuple(rz[0] * ud for ud in u), dx, bc, inflow_vals)
    else:
        sigma_op = sigma
        rhs = div_cell_to_node(u, dx, bc, inflow_vals)
    if divu_src is not None:
        rhs = rhs - divu_src
    phi, res, it = nodal_solve(
        rhs, sigma_op, dx, bc, rtol=rtol, atol=atol, fixed_cycles=fixed_cycles
    )
    gphi = grad_node_to_cell(phi, dx)
    vel_new = jnp.stack([u[d] - sigma * gphi[d] for d in range(dim)])
    if eb is not None:
        vel_new = vel_new * eb.fluid
    return vel_new, (res, it)


def initial_pressure_project(
    rho,
    gravity: float,
    dom: DomainBC,
    dx: Sequence[float],
    geom=None,
    rtol: float = 1e-12,
    atol: float = 1e-16,
    fixed_cycles: Optional[int] = None,
    eb=None,
):
    """Hydrostatic initial pressure for gravity runs
    (Projection::initialPressureProject, Projection.cpp:841-969): project
    the pure body-force field V = (0,...,0,g) with sigma = 1/rho; the
    resulting phi is the hydrostatic pressure (rho-weighted, so variable-
    density columns get the correct discrete balance) and Gp its nodal
    gradient. Returns (p, gradp)."""
    dim = rho.ndim
    bc = nodal_bc(dom)
    sigma = 1.0 / rho
    g = jnp.full_like(rho, gravity)
    u = tuple(
        g if d == dim - 1 else jnp.zeros_like(rho) for d in range(dim)
    )
    phi_bc = None
    if geom is not None:
        phi_bc = hydrostatic_phi_bc(geom, dom, rho, gravity)
    if eb is not None:
        sigma_op = sigma * eb.vfrac
        rhs = div_cell_to_node(tuple(eb.vfrac * ud for ud in u), dx, bc)
    else:
        sigma_op = sigma
        rhs = div_cell_to_node(u, dx, bc)
    phi, res, it = nodal_solve(
        rhs, sigma_op, dx, bc, rtol=rtol, atol=atol,
        fixed_cycles=fixed_cycles, phi_bc=phi_bc,
    )
    gphi = grad_node_to_cell(phi, dx)
    return phi, jnp.stack(gphi)


def hydrostatic_phi_bc(geom, dom: DomainBC, rho, gravity: float):
    """Outflow Dirichlet phi strip with hydrostatic weighting
    (Projection::set_outflow_bcs + computeRhoG, Projection.cpp:1721-2060).

    Mechanism (reference semantics): phi = 0 on a TOP outflow face (IAMR's
    gravity definition makes the hydrostatic pressure vanish there); a
    LATERAL outflow face gets phi integrated downward from the top,
    phi_k = sum_{rows above} -gravity * rhoExt * dh with
    rhoExt = 0.5*(3 rho1 - rho2) extrapolated to the face
    (computeRhoG add_rhog); BOTTOM outflow + gravity aborts like the
    reference (Projection.cpp:1944-1958).

    Returns a node array (phi Dirichlet values; zero off outflow faces) or
    None when no outflow face needs values.
    """
    import numpy as np

    dim = rho.ndim
    g = float(gravity)
    if abs(g) < 1e-4:
        return None
    zdim = dim - 1
    n = rho.shape
    out = None
    for d in range(dim):
        for side in (0, 1):
            p = dom.phys_lo[d] if side == 0 else dom.phys_hi[d]
            if p != PhysBC.Outflow:
                continue
            if d == zdim:
                if side == 1:
                    continue  # top outflow: phi = 0, already the default
                raise NotImplementedError(
                    "outflow at the bottom with gravity != 0 (the reference "
                    "aborts here too, Projection.cpp:1944-1958)"
                )
            if out is None:
                out = jnp.zeros(tuple(s + 1 for s in n), dtype=rho.dtype)
            # density extrapolated to the outflow face, per cell row
            bidx = [slice(None)] * dim
            bidx[d] = slice(0, 1) if side == 0 else slice(-1, None)
            nidx = [slice(None)] * dim
            nidx[d] = slice(1, 2) if side == 0 else slice(-2, -1)
            rho1 = rho[tuple(bidx)]
            rho2 = rho[tuple(nidx)]
            rho_ext = 0.5 * (3.0 * rho1 - rho2)  # (1 in d, *n others)
            rho_ext = jnp.squeeze(rho_ext, axis=d)
            # cumulative -g*rho*dh from the top (cells -> nodes along zdim');
            # after squeezing d, the vertical axis index shifts
            zax = zdim - (1 if d < zdim else 0)
            dh = geom.dx[zdim]
            # node k (from bottom): phi = sum over cell rows j >= k of the
            # running rhog recurrence; build by reversed cumsum of the
            # reversed running-sum -- equivalent closed form:
            # rhog_j (row j from top, 1-based) = -g*dh*sum_{top rows >= j}
            # phi at node below row j = sum of rhog over rows above
            w = -g * dh * rho_ext
            # phi per row = running rhog from the top (computeRhoG: each
            # row's phi is the accumulated -g*rhoExt*dh of the rows above)
            rhog = jnp.cumsum(jnp.flip(w, axis=zax), axis=zax)
            phi_rows = jnp.flip(rhog, axis=zax)
            # node values along z: node at top = 0, node below row j carries
            # phi_rows[j]; nodes transverse: average adjacent rows
            zeros = jnp.take(phi_rows * 0.0, jnp.asarray([0]), axis=zax)
            phi_nodes_z = jnp.concatenate([phi_rows, zeros], axis=zax)
            # other transverse dims of the strip: cell -> node averaging
            for e in range(dim):
                if e == d:
                    continue
                ax = e - (1 if d < e else 0)
                if ax == zax:
                    continue
                lo_p = jnp.take(phi_nodes_z, jnp.asarray([0]), axis=ax)
                hi_p = jnp.take(phi_nodes_z, jnp.asarray([-1]), axis=ax)
                inner = 0.5 * (
                    jnp.take(
                        phi_nodes_z,
                        jnp.arange(phi_nodes_z.shape[ax] - 1), axis=ax,
                    )
                    + jnp.take(
                        phi_nodes_z,
                        jnp.arange(1, phi_nodes_z.shape[ax]), axis=ax,
                    )
                )
                phi_nodes_z = jnp.concatenate([lo_p, inner, hi_p], axis=ax)
            sidx = [slice(None)] * dim
            sidx[d] = slice(0, 1) if side == 0 else slice(-1, None)
            out = out.at[tuple(sidx)].set(jnp.expand_dims(phi_nodes_z, axis=d))
    return out
