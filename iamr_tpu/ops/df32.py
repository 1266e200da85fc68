"""Double-float32 (df32) error-free-transformation arithmetic and the fused
high-precision stencil residuals built on it.

Why this exists: the mixed-precision multigrid path (f32 V-cycles + f64
outer residual/correction — iterative refinement to reference tolerances,
see ops/mg.py:mg_solve / ops/mg_nodal.py:nodal_solve) needs an f64-grade
residual, and on hardware whose f64 rate is low that residual dominates
the solve. A residual computed in *compensated f32* arithmetic —
Dekker/Knuth error-free transformations, fused by XLA into one f32
elementwise loop — reaches ~1e-13 relative accuracy (vs the
~4e-4 cancellation floor of a plain f32 apply) at f32 speed, which is what
the rtol<=1e-11 reference tolerances need (Source/Projection.cpp:18-20,
Source/MacProj.cpp:49-51).

The EFT identities (TwoSum, split/TwoProd) are exact in IEEE
round-to-nearest arithmetic, but XLA is NOT contractually bound to
preserve them: (a) mul+add->FMA contraction breaks Dekker's
multiplicative split (fixed here by bit-mask splitting — integer ops are
rewrite-proof), and (b) in LARGE compiled programs (a multigrid solver
loop body) whole-module optimization has been observed to degrade the
compensation to ~1e-8 relative even though every isolated context (eager,
standalone jit, bare while_loop) evaluates exactly — and
lax.optimization_barrier does NOT survive XLA:CPU's pipeline, so it
cannot fence this. Callers must therefore treat these residuals as
"accurate in practice, not guaranteed": the mixed-precision solvers use
them only for the early cheap cycles and always drive the final approach
to tolerance (and all reported residuals) with the true f64 residual
(ops/mg.py, ops/mg_nodal.py two-phase loops).

All functions take/return f32 arrays and run in non-x64 processes; the
residual entry points take f64 and split/recombine at the edges (x64
processes only). All are plain XLA fusions.

References (public algorithms): Dekker 1971 (splitting / exact products),
Knuth TAOCP v2 (TwoSum), Hida-Li-Bailey double-double arithmetic.
"""

from __future__ import annotations

import itertools
from typing import Sequence, Tuple

import jax.numpy as jnp
import numpy as np

def two_sum(a, b):
    """s + e == a + b exactly; s = fl(a+b)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a, b):
    """s + e == a + b exactly, REQUIRES |a| >= |b| (or a == 0)."""
    s = a + b
    e = b - (s - a)
    return s, e


def split(a):
    """Veltkamp-style split: a == hi + lo with hi, lo each <=12-bit-mantissa
    f32, so products of hi/lo parts are EXACT in f32.

    Implemented by masking the low 12 mantissa bits (truncation) instead of
    Dekker's `c = 4097*a; hi = c - (c - a)`: XLA contracts that `c - a`
    into fma(4097, a, -a) = 4096*a exactly, which silently destroys the
    split (observed: the compiled-in-context residual lost ~7 digits while
    the standalone jit of the same code was exact). Integer bit ops cannot
    be contracted or reassociated, so this form is rewrite-proof."""
    import jax.lax as lax

    ai = lax.bitcast_convert_type(a, jnp.uint32)
    hi = lax.bitcast_convert_type(ai & np.uint32(0xFFFFF000), jnp.float32)
    return hi, a - hi


def _split_const(v: np.float32):
    """Static (numpy) counterpart of split() for compile-time constants."""
    hi = np.uint32(np.float32(v).view(np.uint32) & np.uint32(0xFFFFF000)).view(
        np.float32
    )
    return np.float32(hi), np.float32(np.float32(v) - hi)


def two_prod(a, b):
    """p + e == a * b exactly (f32 inputs)."""
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def two_prod_presplit(a, ah, al, b, bh, bl):
    """TwoProd where both operands arrive pre-split (reused across taps)."""
    p = a * b
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def df_add(xh, xl, yh, yl):
    """(xh,xl) + (yh,yl) -> df32 pair (Knuth sloppy add, ~eps^2 accurate)."""
    s, e = two_sum(xh, yh)
    e = e + (xl + yl)
    return fast_two_sum(s, e)


def df_add_prod(xh, xl, p, e):
    """df32 accumulate of an EFT product (p, e)."""
    s, err = two_sum(xh, p)
    err = err + (xl + e)
    return fast_two_sum(s, err)


def df_const(v: float) -> Tuple[np.float32, np.float32]:
    """Split a python/f64 scalar into an f32 pair (vh + vl ~ v to ~1e-14)."""
    vh = np.float32(v)
    vl = np.float32(v - float(vh))
    return vh, vl


def split_f64(x):
    """f64 array -> (hi, lo) f32 pair with hi + lo == x to f32-pair precision.

    The pair passes through an optimization_barrier: when x is a compile-time
    constant (e.g. sigma/rhs captured by a lax.while_loop body), XLA's
    simplifier otherwise rewrites the downstream compensated chains around
    the folded constants and silently drops the lo-order terms (observed:
    ~4e-8 relative residual error with constants vs 2e-14 with parameters).
    The barrier makes the pair opaque to such rewrites at zero runtime cost."""
    import jax.lax as lax

    # input barrier: when x is produced by an f32->f64 chain in the same
    # program (e.g. phi += mask * vcycle32(r).astype(f64)), XLA may split
    # the producer into the two convert consumers with different precision
    # demotion, making hi/lo inconsistent (hi + lo != x)
    x = lax.optimization_barrier(x)
    hi = x.astype(jnp.float32)
    lo = (x - hi.astype(x.dtype)).astype(jnp.float32)
    return lax.optimization_barrier((hi, lo))


def join_f64(hi, lo):
    return hi.astype(jnp.float64) + lo.astype(jnp.float64)


def _df_scale(xh, xl, ch, cl):
    """(xh,xl) * static-or-scalar df constant (ch,cl) -> df pair."""
    p, e = two_prod(xh, ch)
    e = e + (xh * cl + xl * ch)
    return fast_two_sum(p, e)


def _df_mul(xh, xl, yh, yl):
    """df32 x df32 product (eps^2 cross term dropped)."""
    p, e = two_prod(xh, yh)
    e = e + (xh * yl + xl * yh)
    return fast_two_sum(p, e)


def _pad_pair_cell(ph, pl, bc):
    """Ghost fill of a df32 cell-field pair per ops/mg._pad_phi semantics
    (periodic wrap / Neumann copy / homogeneous Dirichlet 3-point ghost
    g = -2 c0 + c1/3), with the 1/3 product kept df-accurate."""
    third_h, third_l = df_const(1.0 / 3.0)
    dim = ph.ndim
    for d in range(dim):
        n = ph.shape[d]

        def take(a, i0, i1):
            idx = [slice(None)] * a.ndim
            idx[d] = slice(i0, i1)
            return a[tuple(idx)]

        from iamr_tpu.ops.mg import DIRICHLET, PERIODIC

        if bc.lo[d] == PERIODIC:
            loh, lol = take(ph, n - 1, n), take(pl, n - 1, n)
            hih, hil = take(ph, 0, 1), take(pl, 0, 1)
        else:
            def ghost(c0h, c0l, c1h, c1l, kind):
                if kind != DIRICHLET:  # NEUMANN copy
                    return c0h, c0l
                th, tl = _df_mul(c1h, c1l, third_h + jnp.zeros_like(c1h),
                                 third_l + jnp.zeros_like(c1h))
                return df_add(-2.0 * c0h, -2.0 * c0l, th, tl)

            loh, lol = ghost(take(ph, 0, 1), take(pl, 0, 1),
                             take(ph, 1, 2), take(pl, 1, 2), bc.lo[d])
            hih, hil = ghost(take(ph, n - 1, n), take(pl, n - 1, n),
                             take(ph, n - 2, n - 1), take(pl, n - 2, n - 1),
                             bc.hi[d])
        ph = jnp.concatenate([loh, ph, hih], axis=d)
        pl = jnp.concatenate([lol, pl, hil], axis=d)
    return ph, pl


def residual_cell_df(phi, rhs, alpha, beta, a, b, dx: Sequence[float], bc):
    """rhs - (a*alpha - b*div(beta grad)) phi for the cell ABecLaplacian,
    f64 in/out, fused compensated f32 (see module docstring; mirrors
    ops/mg.apply_op + _pad_phi term by term).

    b may be a traced f64 scalar (theta*dt in the CN solves)."""
    from iamr_tpu.ops.stencil import sl

    dim = phi.ndim
    shape = tuple(phi.shape)
    ph, pl = split_f64(phi)
    rh, rl = split_f64(rhs)
    ah, al = split_f64(alpha)
    pgh, pgl = _pad_pair_cell(ph, pl, bc)

    # accumulate r = rhs - a*alpha*c - sum_d [bh*hi + bl*lo - (bh+bl)*c]
    # (sign: apply = a*alpha*c - b*lap with lap = (bh(hi-c) - bl(c-lo))/dx^2)
    ctr_h = pgh[tuple(slice(1, -1) for _ in range(dim))]
    ctr_l = pgl[tuple(slice(1, -1) for _ in range(dim))]

    acc_h, acc_l = rh, rl

    # center coefficient starts at -a*alpha (a is a static float)
    if a != 0.0:
        na = -float(a)
        cc_h, cc_l = _df_scale(ah, al, np.float32(na),
                               np.float32(na - float(np.float32(na))))
    else:
        cc_h = jnp.zeros(shape, jnp.float32)
        cc_l = jnp.zeros(shape, jnp.float32)

    # b / dx_d^2 as a df scalar per dim (b possibly traced)
    if isinstance(b, (int, float)):
        b_h = jnp.float32(b)
        b_l = jnp.float32(float(b) - float(np.float32(b)))
    else:
        b64 = jnp.asarray(b, jnp.float64)
        b_h = b64.astype(jnp.float32)
        b_l = (b64 - b_h.astype(jnp.float64)).astype(jnp.float32)

    for d in range(dim):
        invdx2_h, invdx2_l = df_const(1.0 / (float(dx[d]) * float(dx[d])))
        s_h, s_l = _df_mul(b_h, b_l, invdx2_h, invdx2_l)
        bh64 = beta[d]
        bfh, bfl = split_f64(bh64)
        # face coefficient pairs bhat = beta_face * b/dx^2
        bl_fh, bl_fl = _df_mul(sl(bfh, d, 0, -1), sl(bfl, d, 0, -1),
                               s_h, s_l)
        bh_fh, bh_fl = _df_mul(sl(bfh, d, 1, None), sl(bfl, d, 1, None),
                               s_h, s_l)
        idx_lo = [slice(1, -1)] * dim
        idx_hi = [slice(1, -1)] * dim
        idx_lo[d] = slice(0, -2)
        idx_hi[d] = slice(2, None)
        lo_h, lo_l = pgh[tuple(idx_lo)], pgl[tuple(idx_lo)]
        hi_h, hi_l = pgh[tuple(idx_hi)], pgl[tuple(idx_hi)]
        # + bhat_hi * hi + bhat_lo * lo into the residual accumulator
        th, tl = _df_mul(bh_fh, bh_fl, hi_h, hi_l)
        acc_h, acc_l = df_add(acc_h, acc_l, th, tl)
        th, tl = _df_mul(bl_fh, bl_fl, lo_h, lo_l)
        acc_h, acc_l = df_add(acc_h, acc_l, th, tl)
        # center coefficient -= (bhat_hi + bhat_lo)... sign: contributes
        # -(bh+bl)*c inside the bracket, bracket subtracted -> center adds
        # -(a*alpha) + ... overall center coef cc = -(a*alpha + bh + bl)
        th, tl = df_add(bh_fh, bh_fl, bl_fh, bl_fl)
        cc_h, cc_l = df_add(cc_h, cc_l, -th, -tl)
    th, tl = _df_mul(cc_h, cc_l, ctr_h, ctr_l)
    acc_h, acc_l = df_add(acc_h, acc_l, th, tl)
    return acc_h.astype(phi.dtype) + acc_l.astype(phi.dtype)


def residual_nodal_df(phi, rhs, sigma, mask, dx: Sequence[float], bc):
    """mask * (rhs - L(phi)) for the FEM nodal Laplacian, f64 in/out, all
    arithmetic fused compensated f32 (see module docstring).

    Mirrors ops/mg_nodal.apply_nodal (same element-stiffness assembly,
    reference MLNodeLaplacian semantics) term by term:
        L(phi)_n = -(1/V) * sum_o [sum_combo sigma_c K(a,b)] * phi_{n+o}
    so  r = rhs + (1/V) * sum_o coef_o * phi_{n+o},
    with coef_o accumulated in df32 from pre-split sigma and statically
    split K entries, and the o-sum accumulated in df32 seeded with rhs*V.
    """
    ph, pl = split_f64(phi)
    sh, sl = split_f64(sigma)
    rh, rl = split_f64(rhs)
    oh, ol = residual_nodal_df_pair(ph, pl, rh, rl, sh, sl, mask, dx, bc)
    return oh.astype(phi.dtype) + ol.astype(phi.dtype)


def residual_nodal_df_pair(ph, pl, rh, rl, sh, sl, mask,
                           dx: Sequence[float], bc):
    """All-f32 pair core of residual_nodal_df: every operand arrives as a
    df32 (hi, lo) pair and the masked residual returns as one. This is the
    residual of the NON-x64 production solve (mg_nodal.nodal_solve_df),
    where no f64 exists in-process at all — the pairs are split host-side
    (numpy f64) or accumulated in df32 by the solver loop."""
    import jax.lax as lax

    from iamr_tpu.ops.mg_nodal import _fem_element_matrix, _pad_cells, _pad_nodes

    # the same rewrite fence split_f64 applies: without it, whole-module
    # XLA optimization reassociates the compensated chains around the pair
    # inputs (measured: the in-solve residual misreports 3.8e-11 while the
    # numpy-f64 truth is 3e-8 — the exact documented failure mode); the
    # barriers are free at runtime and restore the truth to ~1e-13
    ph, pl = lax.optimization_barrier((ph, pl))
    rh, rl = lax.optimization_barrier((rh, rl))
    sh, sl = lax.optimization_barrier((sh, sl))

    dim = ph.ndim
    vol = 1.0
    for h in dx:
        vol *= float(h)
    K = _fem_element_matrix(dx)

    # pad once; splits of the padded arrays are reused by every tap
    php = _pad_nodes(ph, bc)
    plp = _pad_nodes(pl, bc)
    shp = _pad_cells(sh, bc, dim)
    slp = _pad_cells(sl, bc, dim)
    ph1, ph2 = split(php)
    sh1, sh2 = split(shp)

    nshape = tuple(s + 1 for s in sh.shape)

    # seed the accumulator with rhs * V (df32 x static-df product) so the
    # final division by V returns the residual directly
    vh, vl = df_const(vol)
    acc_h, acc_l = two_prod(rh, jnp.float32(vh))
    acc_l = acc_l + (rh * vl + rl * vh)
    acc_h, acc_l = fast_two_sum(acc_h, acc_l)

    def view(a, offs):
        return a[tuple(slice(offs[d], offs[d] + nshape[d]) for d in range(dim))]

    for o in itertools.product((-1, 0, 1), repeat=dim):
        offs_p = tuple(1 + o[d] for d in range(dim))
        po = view(php, offs_p)
        po1 = view(ph1, offs_p)
        po2 = view(ph2, offs_p)
        pol = view(plp, offs_p)

        # coef_o = sum over admissible (t, a, b) of sigma[cell t] * K[a, b]
        choices = []
        for d in range(dim):
            if o[d] == -1:
                choices.append([(0, 1, 0)])
            elif o[d] == 1:
                choices.append([(1, 0, 1)])
            else:
                choices.append([(0, 1, 1), (1, 0, 0)])
        ch = None
        for combo in itertools.product(*choices):
            t = tuple(c[0] for c in combo)
            a = tuple(c[1] for c in combo)
            b = tuple(c[2] for c in combo)
            offs_s = tuple(t[d] for d in range(dim))
            sg = view(shp, offs_s)
            sg1 = view(sh1, offs_s)
            sg2 = view(sh2, offs_s)
            sgl = view(slp, offs_s)
            kh, klo = df_const(K[(a, b)])
            kh1, kh2 = _split_const(kh)
            p = sg * kh
            e = ((sg1 * kh1 - p) + sg1 * kh2 + sg2 * kh1) + sg2 * kh2
            e = e + (sg * klo + sgl * kh)
            if ch is None:
                ch, cl = fast_two_sum(p, e)
            else:
                ch, cl = df_add_prod(ch, cl, p, e)
        # term = coef_o (x) phi_o, df32 x df32 (drop the eps^2 cross term)
        ch1, ch2 = split(ch)
        tp = ch * po
        te = ((ch1 * po1 - tp) + ch1 * po2 + ch2 * po1) + ch2 * po2
        te = te + (ch * pol + cl * po)
        acc_h, acc_l = df_add_prod(acc_h, acc_l, tp, te)

    # r = acc / V : multiply by the static df32 inverse volume
    ivh, ivl = df_const(1.0 / vol)
    ivh1, ivh2 = _split_const(ivh)
    a1, a2 = split(acc_h)
    p = acc_h * ivh
    e = ((a1 * ivh1 - p) + a1 * ivh2 + a2 * ivh1) + a2 * ivh2
    e = e + (acc_h * ivl + acc_l * ivh)
    out_h, out_l = fast_two_sum(p, e)
    if mask is not None:
        out_h = mask * out_h  # mask is 0/1: exact on both components
        out_l = mask * out_l
    return out_h, out_l
