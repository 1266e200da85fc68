"""Spectral (FFT) solver fast path: exactness against the SAME discrete
operators the multigrid solves, and step-level agreement with the MG path
on an all-periodic uniform-density run (solvers/spectral.py; the JAX
analogue of AMReX's FFT Poisson solvers)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from iamr_tpu.solvers.spectral import (
    solve_cell_helmholtz,
    solve_nodal_poisson,
    spectral_eligible,
)


def test_cell_poisson_exact_2d_3d():
    """a=0 Poisson: apply_op(phi) reproduces the (mean-free) rhs to
    roundoff — the FFT inverse IS the 7-point operator's inverse."""
    from iamr_tpu.ops import mg
    from iamr_tpu.ops.mg import PERIODIC, PoissonBC

    for shape in ((32, 24), (16, 12, 20)):
        dim = len(shape)
        dx = tuple(1.0 / s for s in shape)
        rng = np.random.RandomState(3)
        rhs = jnp.asarray(rng.randn(*shape))
        rhs = rhs - jnp.mean(rhs)
        beta0 = 0.37
        phi = solve_cell_helmholtz(rhs, 0.0, beta0, dx)
        bc = PoissonBC((PERIODIC,) * dim, (PERIODIC,) * dim)
        beta = tuple(
            beta0 * jnp.ones(
                tuple(s + (1 if d == e else 0) for e, s in enumerate(shape))
            )
            for d in range(dim)
        )
        alpha = jnp.zeros(shape)
        phig = mg._pad_phi(phi, bc)
        out = mg.apply_op(phig, alpha, beta, 0.0, 1.0, dx, shape)
        assert float(jnp.max(jnp.abs(out - rhs))) < 1e-11 * float(
            jnp.max(jnp.abs(rhs))
        )
        assert abs(float(jnp.mean(phi))) < 1e-12


def test_cell_helmholtz_exact():
    """(a*alpha - b*lap) solve with nonzero alpha (the CN operator)."""
    from iamr_tpu.ops import mg
    from iamr_tpu.ops.mg import PERIODIC, PoissonBC

    shape = (24, 16, 16)
    dx = tuple(1.0 / s for s in shape)
    rng = np.random.RandomState(4)
    rhs = jnp.asarray(rng.randn(*shape))
    alpha0, beta0 = 200.0, 1e-3
    phi = solve_cell_helmholtz(rhs, alpha0, beta0, dx)
    bc = PoissonBC((PERIODIC,) * 3, (PERIODIC,) * 3)
    beta = tuple(
        beta0 * jnp.ones(
            tuple(s + (1 if d == e else 0) for e, s in enumerate(shape))
        )
        for d in range(3)
    )
    alpha = alpha0 * jnp.ones(shape)
    out = mg.apply_op(mg._pad_phi(phi, bc), alpha, beta, 1.0, 1.0, dx, shape)
    assert float(jnp.max(jnp.abs(out - rhs))) < 1e-11 * float(
        jnp.max(jnp.abs(rhs))
    )


def test_nodal_poisson_exact():
    """apply_nodal(phi, sigma0) reproduces the nodal rhs to roundoff on the
    periodic node lattice (2D + 3D)."""
    from iamr_tpu.ops.mg_nodal import (
        N_PERIODIC,
        NodalBC,
        apply_nodal,
    )

    for shape in ((24, 16), (12, 16, 8)):
        dim = len(shape)
        dx = tuple(1.0 / s for s in shape)
        rng = np.random.RandomState(5)
        inner = rng.randn(*shape)
        inner -= inner.mean()
        # wrapped (n+1)^d node array
        rhs = np.zeros(tuple(s + 1 for s in shape))
        rhs[tuple(slice(0, -1) for _ in range(dim))] = inner
        for d in range(dim):
            src = [slice(None)] * dim
            dst = [slice(None)] * dim
            src[d] = slice(0, 1)
            dst[d] = slice(-1, None)
            rhs[tuple(dst)] = rhs[tuple(src)]
        rhs = jnp.asarray(rhs)
        sigma0 = 2.5
        phi = solve_nodal_poisson(rhs, sigma0, dx)
        bc = NodalBC((N_PERIODIC,) * dim, (N_PERIODIC,) * dim)
        sigma = sigma0 * jnp.ones(shape)
        out = apply_nodal(phi, sigma, dx, bc)
        # wrapped nodes duplicate; compare on the full lattice
        assert float(jnp.max(jnp.abs(out - rhs))) < 1e-10 * float(
            jnp.max(jnp.abs(rhs))
        ), shape


def test_step_spectral_matches_mg():
    """Full advance with spectral solvers vs tolerance-driven MG on a 3D
    periodic Taylor-Green-like run: identical systems solved two ways."""
    from iamr_tpu.config.parmparse import ParmParse
    from iamr_tpu.ns.advance import make_step
    from iamr_tpu.ns.driver import initialize
    from iamr_tpu.ns.state import config_from_inputs

    pp = ParmParse.from_string(
        """
        max_step = 3
        amr.n_cell = 16 16 16
        ns.cfl = 0.5
        ns.init_shrink = 1.0
        ns.init_iter = 0
        ns.vel_visc_coef = 1e-3
        ns.scal_diff_coefs = 0.01
        geometry.prob_lo = 0. 0. 0.
        geometry.prob_hi = 1. 1. 1.
        geometry.is_periodic = 1 1 1
        ns.lo_bc = 0 0 0
        ns.hi_bc = 0 0 0
        prob.probtype = 11
        prob.velocity_factor = 1.0
        """
    )
    cfg = config_from_inputs(pp)
    state0 = initialize(cfg)
    assert spectral_eligible(cfg, np.asarray(state0.rho))

    step_mg = make_step(cfg, spectral=False)
    step_sp = make_step(cfg, spectral=True)
    s_mg, s_sp = state0, state0
    for _ in range(3):
        s_mg = step_mg(s_mg)
        s_sp = step_sp(s_sp)
    scale = float(jnp.max(jnp.abs(s_mg.vel)))
    dv = float(jnp.max(jnp.abs(s_mg.vel - s_sp.vel)))
    dr = float(jnp.max(jnp.abs(s_mg.rho - s_sp.rho)))
    dt_ = float(jnp.max(jnp.abs(s_mg.trac - s_sp.trac)))
    # MG solves to rtol 1e-12; spectral is exact — agreement at solver tol
    # (the round-4 ε-blend that amplified the solver difference to 3e-5
    # was reverted; thresholded upwind restores solver-tolerance parity)
    assert dv < 1e-8 * scale, dv
    assert dr < 1e-8, dr
    assert dt_ < 1e-8, dt_
    # spectral projection leaves no more divergence than the MG one
    from iamr_tpu.ops.mg_nodal import NodalBC, N_PERIODIC, div_cell_to_node

    bc = NodalBC((N_PERIODIC,) * 3, (N_PERIODIC,) * 3)
    div_sp = float(jnp.max(jnp.abs(div_cell_to_node(
        tuple(s_sp.vel[d] for d in range(3)), cfg.geom.dx, bc
    ))))
    div_mg = float(jnp.max(jnp.abs(div_cell_to_node(
        tuple(s_mg.vel[d] for d in range(3)), cfg.geom.dx, bc
    ))))
    assert div_sp <= max(div_mg * 2.0, 1e-10), (div_sp, div_mg)


def test_spectral_eligibility_gates():
    from iamr_tpu.config.parmparse import ParmParse
    from iamr_tpu.ns.state import config_from_inputs

    base = """
        amr.n_cell = 8 8
        geometry.prob_lo = 0. 0.
        geometry.prob_hi = 1. 1.
        {bcs}
        prob.probtype = 11
        {extra}
    """
    per = "geometry.is_periodic = 1 1\nns.lo_bc = 0 0\nns.hi_bc = 0 0"
    wall = "geometry.is_periodic = 0 0\nns.lo_bc = 5 5\nns.hi_bc = 5 5"

    cfg = config_from_inputs(ParmParse.from_string(
        base.format(bcs=per, extra="")))
    rho_u = np.ones((8, 8))
    rho_v = np.ones((8, 8))
    rho_v[3, 3] = 2.0
    assert spectral_eligible(cfg, rho_u)
    assert not spectral_eligible(cfg, rho_v)          # non-uniform rho
    assert not spectral_eligible(cfg, None)           # auto needs rho

    cfg_w = config_from_inputs(ParmParse.from_string(
        base.format(bcs=wall, extra="")))
    assert not spectral_eligible(cfg_w, rho_u)        # walls

    cfg_off = config_from_inputs(ParmParse.from_string(
        base.format(bcs=per, extra="ns.fft_solve = 0")))
    assert not spectral_eligible(cfg_off, rho_u)      # forced off

    cfg_on = config_from_inputs(ParmParse.from_string(
        base.format(bcs=per, extra="ns.fft_solve = 1")))
    assert spectral_eligible(cfg_on, None)            # forced on
