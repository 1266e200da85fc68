"""Spectral turbulent forcing for HIT (homogeneous isotropic turbulence).

Re-implements the behavior of the reference HIT tutorial's forcing
(Tutorials/HIT/TurbulentForcing_def.H:22-230, NS_getForce.cpp:360-460):
low-wavenumber modes k with |k| <= nmodes/Lmin, each carrying random
temporal frequency/phase (xT = cos(omega t + psi)), random spatial phases,
and amplitudes from a k^-2 (spectrum_type=2) shell spectrum; the
divergence-free variant takes the curl of a vector potential
A_c = FA_c * prod_d sin(2 pi k_d x_d / L_d + phi_{c,d}).

Evaluation: every mode term is separable, so the per-cell sum
over modes becomes einsum contractions over the mode axis of per-dimension
1D trig tables — matmul work instead of the reference's per-cell mode
loops (which it had to subsample via ff_factor).

Mode phases use jax PRNG (turb.seed) rather than the reference's fixed
Mersenne stream — the forcing is statistically, not bitwise, equivalent.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import jax.numpy as jnp
from jax import lax

from iamr_tpu.core.geometry import Geometry


@dataclasses.dataclass(frozen=True)
class HITForcing:
    """Precomputed mode tables (host numpy; traced in as jit constants)."""

    k: np.ndarray          # (nm, 3) integer wavenumbers
    omega: np.ndarray      # (nm,) temporal frequency * 2pi
    psi: np.ndarray        # (nm,) temporal phase
    amp: np.ndarray        # (nm, 3) per-component amplitude (FA)
    phases: np.ndarray     # (nm, 3, 3) phi[c, d] potential phases (div-free)
    phases_simple: np.ndarray  # (nm, 3) FPX/FPY/FPZ (non-div-free path)
    L: Tuple[float, float, float]
    div_free: bool

    @classmethod
    def create(
        cls,
        geom: Geometry,
        nmodes: int = 4,
        div_free: bool = True,
        spectrum_type: int = 2,
        mode_start: int = 0,
        forcing_time_scale_min: float = 0.5,
        forcing_time_scale_max: float = 1.0,
        force_scale: float = 1.0,
        moderate_zero_modes: bool = True,
        seed: int = 111397,
    ) -> "HITForcing":
        assert geom.dim == 3, "HIT forcing is 3D-only (reference asserts too)"
        L = tuple(hi - lo for lo, hi in zip(geom.prob_lo, geom.prob_hi))
        Lmin = min(L)
        kappa_max = nmodes / Lmin + 1e-8
        steps = [int(Ld / Lmin + 0.5) for Ld in L]
        nmax = [nmodes * s for s in steps]

        rng = np.random.default_rng(seed)
        ks, omegas, psis, amps, phases, phases_s = [], [], [], [], [], []
        freq_min = 1.0 / forcing_time_scale_max
        freq_diff = 1.0 / forcing_time_scale_min - freq_min
        for kz in range(mode_start * steps[2], nmax[2] + 1, steps[2]):
            for ky in range(mode_start * steps[1], nmax[1] + 1, steps[1]):
                for kx in range(mode_start * steps[0], nmax[0] + 1, steps[0]):
                    kappa = np.sqrt(
                        (kx / L[0]) ** 2 + (ky / L[1]) ** 2 + (kz / L[2]) ** 2
                    )
                    if kappa > kappa_max or kappa < 1e-6:
                        continue
                    omegas.append((freq_min + freq_diff * rng.random()) * 2 * np.pi)
                    psis.append(rng.random() * 2 * np.pi)
                    phases_s.append(rng.random(3) * 2 * np.pi)
                    phases.append(rng.random((3, 3)) * 2 * np.pi)
                    # random unit-ish direction
                    theta = rng.random() * 2 * np.pi
                    phi = rng.random() * np.pi
                    p = np.array(
                        [
                            np.cos(theta) * np.sin(phi),
                            np.sin(theta) * np.sin(phi),
                            np.cos(phi),
                        ]
                    )
                    if spectrum_type == 1:
                        ekh = 1.0 / kappa
                    elif spectrum_type == 2:
                        ekh = 1.0 / (kappa * kappa)
                    else:
                        ekh = 1.0
                    if div_free:
                        ekh /= kappa
                    if moderate_zero_modes:
                        for kk in (kx, ky, kz):
                            if kk == 0:
                                ekh /= 2.0
                    amps.append(force_scale * p * ekh / (p @ p))
                    ks.append([kx, ky, kz])
        return cls(
            k=np.asarray(ks, dtype=np.float64),
            omega=np.asarray(omegas),
            psi=np.asarray(psis),
            amp=np.asarray(amps),
            phases=np.asarray(phases),
            phases_simple=np.asarray(phases_s),
            L=L,
            div_free=div_free,
        )

    def eval(self, geom: Geometry, time, dtype=jnp.float32):
        """Force field (3, nx, ny, nz) at `time` (traced)."""
        nm = self.k.shape[0]
        xs = [jnp.asarray(geom.cell_centers_1d(d), dtype=dtype) for d in range(3)]
        karg = [
            2.0 * np.pi * self.k[:, d] / self.L[d] for d in range(3)
        ]  # (nm,) per dim
        xT = jnp.cos(
            jnp.asarray(self.omega, dtype=dtype) * time
            + jnp.asarray(self.psi, dtype=dtype)
        )  # (nm,)

        def trig_table(c, d, kind):
            """sin/cos(2 pi k_d x_d / L_d + phi[c,d]) as (nm, n_d)."""
            phi = self.phases[:, c, d] if c >= 0 else self.phases_simple[:, d]
            arg = (
                jnp.asarray(karg[d], dtype=dtype)[:, None] * xs[d][None, :]
                + jnp.asarray(phi, dtype=dtype)[:, None]
            )
            return jnp.sin(arg) if kind == "s" else jnp.cos(arg)

        if self.div_free:
            # f = curl(A), A_c = amp_c prod_d sin(arg_{c,d});
            # dA_c/dd = amp_c * (2 pi k_d/L_d) cos in dim d, sin others.
            # Each curl component is dA(c1,d1) - dA(c2,d2): evaluate BOTH
            # terms in ONE einsum by concatenating their mode tables along
            # the mode axis (halves the reconstruction passes vs six
            # separate einsums).
            def dA_parts(c, d, sign):
                coef = (
                    sign
                    * xT
                    * jnp.asarray(self.amp[:, c], dtype=dtype)
                    * jnp.asarray(karg[d], dtype=dtype)
                )
                tabs = [
                    trig_table(c, e, "c" if e == d else "s") for e in range(3)
                ]
                return coef, tabs

            def curl_comp(t1, t2):
                (ca, ta), (cb, tb) = t1, t2
                coef = jnp.concatenate([ca, cb])
                tabs = [
                    jnp.concatenate([ta[e], tb[e]], axis=0) for e in range(3)
                ]
                return jnp.einsum(
                    "m,mi,mj,mk->ijk", coef, tabs[0], tabs[1], tabs[2],
                    precision=lax.Precision.HIGHEST,
                )

            fx = curl_comp(dA_parts(2, 1, 1.0), dA_parts(1, 2, -1.0))
            fy = curl_comp(dA_parts(0, 2, 1.0), dA_parts(2, 0, -1.0))
            fz = curl_comp(dA_parts(1, 0, 1.0), dA_parts(0, 1, -1.0))
        else:
            # f_c = amp_c * (cos in dim c, sin in others), phases FPX/FPY/FPZ
            def comp(c):
                coef = xT * jnp.asarray(self.amp[:, c], dtype=dtype)
                tabs = [
                    trig_table(-1, e, "c" if e == c else "s") for e in range(3)
                ]
                return jnp.einsum(
                    "m,mi,mj,mk->ijk", coef, tabs[0], tabs[1], tabs[2],
                    precision=lax.Precision.HIGHEST,
                )

            fx, fy, fz = comp(0), comp(1), comp(2)
        return jnp.stack([fx, fy, fz])


def init_hit_velocity(geom: Geometry, urms: float = 1.0, kpeak: float = 4.0, seed: int = 0):
    """Synthesize a solenoidal random initial velocity with a k^4 exp(-2k^2/kp^2)
    spectrum (the standard HIT spin-up IC; the reference reads an equivalent
    field from gen_hit_ic.py output via Utilities read_binary,
    Tutorials/HIT/prob_init.cpp:43-86)."""
    n = geom.ncell
    assert geom.dim == 3
    rng = np.random.default_rng(seed)
    kfreq = [np.fft.fftfreq(n[d], d=1.0 / n[d]) for d in range(3)]
    KX, KY, KZ = np.meshgrid(*kfreq, indexing="ij")
    K2 = KX**2 + KY**2 + KZ**2
    K = np.sqrt(np.maximum(K2, 1e-12))
    Ek = (K / kpeak) ** 4 * np.exp(-2.0 * (K / kpeak) ** 2)
    amp = np.sqrt(Ek / (4.0 * np.pi * np.maximum(K2, 1e-12)))
    u_hat = np.stack(
        [
            amp * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
            for _ in range(3)
        ]
    )
    # project to solenoidal: u -= k (k.u)/k^2
    kvec = np.stack([KX, KY, KZ])
    kdotu = np.sum(kvec * u_hat, axis=0)
    u_hat = u_hat - kvec * kdotu / np.maximum(K2, 1e-12)
    u_hat[:, 0, 0, 0] = 0.0
    # zero the Nyquist planes: taking the real part Hermitian-symmetrizes the
    # spectrum, and on |k| = n/2 planes the aliased partner is perpendicular
    # to a different k, which breaks solenoidality there
    for d in range(3):
        nyq = np.abs(kfreq[d]) == n[d] // 2
        sl_ = [slice(None)] * 4
        sl_[1 + d] = nyq
        u_hat[tuple(sl_)] = 0.0
    u = np.real(np.fft.ifftn(u_hat, axes=(1, 2, 3)))
    rms = np.sqrt(np.mean(np.sum(u**2, axis=0)) / 3.0)
    return u * (urms / max(rms, 1e-30))
