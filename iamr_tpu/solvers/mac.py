"""MAC projection: make the face (MAC) velocities satisfy the divergence
constraint before advection.

JAX equivalent of reference Source/MacProj.cpp:225-352 (mac_project)
+ the Hydro::MacProjector wrapper (MacProj.cpp:1084-1184). Solves

    div( (1/rho)_faces grad phi ) = div(u_mac) - S

then corrects u_mac <- u_mac - (1/rho) grad phi, so div(u_mac) = S
(S = divu source, zero unless do_temp). Face coefficients are
arithmetically averaged 1/rho (average_cellcenter_to_face semantics,
MacProj.cpp:1098-1128).

BC kinds: periodic; walls/inflow/symmetry -> Neumann (no correction through
the boundary; boundary face velocities are BC-pinned upstream); outflow ->
Dirichlet phi = 0 (MacProj.cpp set_outflow_bcs).
Default tolerances rtol 1e-12, atol 1e-16 (MacProj.cpp:49-51).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax.numpy as jnp

from iamr_tpu.core.bc import DomainBC, PhysBC
from iamr_tpu.ops import mg
from iamr_tpu.ops.mg import DIRICHLET, NEUMANN, PERIODIC, PoissonBC
from iamr_tpu.ops.stencil import cell_to_face, mac_div


def mac_poisson_bc(dom: DomainBC) -> PoissonBC:
    """Physical BC -> MAC Poisson BC. Outflow faces carry homogeneous
    Dirichlet phi — exactly the reference's MAC-side outflow treatment
    (MacProj::set_outflow_bcs zeroes the phi strip just outside every
    outflow face, Source/MacProj.cpp:849-940)."""
    def kind(p: PhysBC):
        if p == PhysBC.Interior:
            return PERIODIC
        if p == PhysBC.Outflow:
            return DIRICHLET
        return NEUMANN

    return PoissonBC(
        lo=tuple(kind(p) for p in dom.phys_lo),
        hi=tuple(kind(p) for p in dom.phys_hi),
    )


def beta_from_rho(rho, dom: DomainBC):
    """(1/rho) averaged to faces; periodic dims wrap."""
    dim = rho.ndim
    inv = 1.0 / rho
    return tuple(
        cell_to_face(inv, d, bc_wrap=dom.is_periodic(d)) for d in range(dim)
    )


def mac_project(
    umac,
    rho,
    dom: DomainBC,
    dx: Sequence[float],
    divu_src=None,
    phi0=None,
    rtol: float = 1e-12,
    atol: float = 1e-16,
    fixed_cycles: Optional[int] = None,
    bc: Optional[PoissonBC] = None,
    bvals=None,
    eb=None,
    rz=None,
    interior_mask=None,
    interior_vals=None,
    spectral_beta0=None,
    boxes=None,
):
    """Project the MAC velocities. Returns (umac_corrected, phi, stats).

    boxes: optional amr.boxbatch.UnionBoxExec — a congruent multi-box union
    solve then runs on the box batch (ops/mg_batch.py; every MG depth stays
    batch-sized) instead of the masked bbox MG; same system, same return
    convention.

    spectral_beta0: scalar 1/rho of an all-periodic uniform-density run —
    the Poisson solve runs in Fourier space (solvers.spectral), exact for
    the same 7-point discrete operator. Caller guarantees eligibility
    (spectral_eligible); ignored for EB/RZ/union solves.

    interior_mask/interior_vals: level-wide multi-box solve (mg_solve
    union path) — mask 1 on union cells, coarse-interpolated mac_phi on
    holes. Not supported together with eb or rz.

    bc/bvals override the domain-derived BCs (fine levels pass Dirichlet
    coarse-fine values from the parent's mac_phi).

    eb: optional EBData; the solve becomes the volume-weighted EB operator
    (MLEBABecLap semantics — face coefficients scaled by area fractions,
    covered cells pinned through the identity), so the corrected velocities
    satisfy the CUT-CELL divergence sum_d d(afrac u)/dx = vfrac * S."""
    dim = rho.ndim
    if bc is None:
        bc = mac_poisson_bc(dom)
    beta = beta_from_rho(rho, dom)

    if eb is not None:
        import jax.numpy as _jnp

        beta_op = tuple(b * af for b, af in zip(beta, eb.afrac))
        div = mac_div(tuple(af * u for af, u in zip(eb.afrac, umac)), dx)
        if divu_src is not None:
            div = div - eb.vfrac * divu_src
        phi, res, it = mg.mg_solve(
            -div, eb.covered, beta_op, 1.0, 1.0, dx, bc,
            phi0=phi0, bvals=bvals, rtol=rtol, atol=atol,
            fixed_cycles=fixed_cycles,
        )
        corr = mg.get_fluxes(phi, beta, 1.0, dx, bc, bvals=bvals)
        umac_new = []
        for d in range(dim):
            u = (umac[d] + corr[d]) * (eb.afrac[d] > 0.0)
            if bc.lo[d] == NEUMANN:
                u = u.at[_face_idx(u, d, 0)].set(umac[d][_face_idx(umac[d], d, 0)])
            if bc.hi[d] == NEUMANN:
                u = u.at[_face_idx(u, d, -1)].set(umac[d][_face_idx(umac[d], d, -1)])
            umac_new.append(u)
        return tuple(umac_new), phi, (res, it)

    if rz is not None:
        # RZ: multiply sigma and U by radius (Projection.cpp scaleVar
        # radMult semantics): solve d(r b phi_r)/dr + d(r b phi_z)/dz =
        # d(r u_r)/dr + d(r u_z)/dz, then correct u -= b grad phi
        import jax.numpy as _jnp

        r_cell, r_face = rz
        beta_op = (r_face * beta[0], r_cell * beta[1])
        div = mac_div((r_face * umac[0], r_cell * umac[1]), dx)
        if divu_src is not None:
            div = div - r_cell * divu_src
        phi, res, it = mg.mg_solve(
            -div, _jnp.zeros_like(rho), beta_op, 0.0, 1.0, dx, bc,
            phi0=phi0, bvals=bvals, rtol=rtol, atol=atol,
            fixed_cycles=fixed_cycles,
        )
        corr = mg.get_fluxes(phi, beta, 1.0, dx, bc, bvals=bvals)
        umac_new = []
        for d in range(dim):
            u = umac[d] + corr[d]
            if bc.lo[d] == NEUMANN:
                u = u.at[_face_idx(u, d, 0)].set(umac[d][_face_idx(umac[d], d, 0)])
            if bc.hi[d] == NEUMANN:
                u = u.at[_face_idx(u, d, -1)].set(umac[d][_face_idx(umac[d], d, -1)])
            umac_new.append(u)
        return tuple(umac_new), phi, (res, it)

    div = mac_div(umac, dx)
    if divu_src is not None:
        div = div - divu_src

    if spectral_beta0 is not None and interior_mask is None:
        from iamr_tpu.solvers.spectral import solve_cell_helmholtz

        phi = solve_cell_helmholtz(-div, 0.0, spectral_beta0, dx)
        corr = mg.get_fluxes(phi, beta, 1.0, dx, bc, bvals=bvals)
        umac_new = tuple(umac[d] + corr[d] for d in range(dim))
        return umac_new, phi, (jnp.zeros((), rho.dtype), 0)

    # mg operator is (a*alpha - b*div beta grad); with a=0, b=1 it is
    # -div(beta grad). Solve -div(beta grad phi) = -div  <=>  L phi = div.
    if boxes is not None and interior_mask is not None:
        phi, res, it = boxes.solve_cell(
            -div, jnp.zeros_like(rho), beta, 0.0, 1.0, dx, bc, bvals,
            interior_vals, phi0=phi0, rtol=rtol, atol=atol,
            fixed_cycles=fixed_cycles,
        )
    else:
        phi, res, it = mg.mg_solve(
            -div,
            jnp.zeros_like(rho),
            beta,
            0.0,
            1.0,
            dx,
            bc,
            phi0=phi0,
            bvals=bvals,
            rtol=rtol,
            atol=atol,
            fixed_cycles=fixed_cycles,
            interior_mask=interior_mask,
            interior_vals=interior_vals,
        )
    # correction fluxes: get_fluxes returns -b*beta*grad(phi) = -beta grad phi
    corr = mg.get_fluxes(phi, beta, 1.0, dx, bc, bvals=bvals)
    umac_new = []
    for d in range(dim):
        u = umac[d] + corr[d]
        # no correction through non-periodic, non-outflow boundaries
        if bc.lo[d] == NEUMANN:
            u = u.at[_face_idx(u, d, 0)].set(umac[d][_face_idx(umac[d], d, 0)])
        if bc.hi[d] == NEUMANN:
            u = u.at[_face_idx(u, d, -1)].set(umac[d][_face_idx(umac[d], d, -1)])
        umac_new.append(u)
    return tuple(umac_new), phi, (res, it)


def _face_idx(a, d, pos):
    idx = [slice(None)] * a.ndim
    idx[d] = slice(0, 1) if pos == 0 else slice(-1, None)
    return tuple(idx)
