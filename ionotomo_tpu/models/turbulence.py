"""Turbulent ionosphere perturbations via spectral synthesis (device-side).

Reference capability (SURVEY.md §2 "Turbulence / frozen-flow simulation"):
synthetic turbulent log-n_e perturbations with a von Kármán/Kolmogorov-like
spectrum, realized by filtering white noise in Fourier space. Device form:
one forward/inverse 3D FFT pair under jit; realizations are
embarrassingly parallel via vmap over split PRNG keys (SURVEY.md §2.1 P3).
"""
from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np

from ..core.grids import Grid3D


def _wavenumbers(grid: Grid3D):
    """|k| magnitude lattice (rad/km) for the grid, rfft layout on last axis.

    Shapes come from static metadata; spacings stay traced so the same
    compiled program serves any grid placement.
    """
    nx, ny, nz = grid.shape
    kx = 2 * jnp.pi * jnp.asarray(np.fft.fftfreq(nx), jnp.float32) \
        / grid.spacing[0]
    ky = 2 * jnp.pi * jnp.asarray(np.fft.fftfreq(ny), jnp.float32) \
        / grid.spacing[1]
    kz = 2 * jnp.pi * jnp.asarray(np.fft.rfftfreq(nz), jnp.float32) \
        / grid.spacing[2]
    return jnp.sqrt(kx[:, None, None] ** 2 + ky[None, :, None] ** 2
                    + kz[None, None, :] ** 2)


def von_karman_amplitude(kmag, outer_scale_km=100.0, inner_scale_km=2.0,
                         exponent=-11.0 / 6.0):
    """sqrt of the von Kármán power spectrum with inner-scale rolloff.

    P(k) ∝ (k² + k0²)^(-11/6) · exp(-(k·l_i)²), k0 = 2π/L0.
    """
    k0 = 2 * jnp.pi / outer_scale_km
    li = inner_scale_km / (2 * jnp.pi)
    p = (kmag**2 + k0**2) ** exponent * jnp.exp(-(kmag * li) ** 2)
    return jnp.sqrt(p)


@jax.jit
def _synthesize(grid: Grid3D, key, outer_scale_km, inner_scale_km):
    nx, ny, nz = grid.shape
    kmag = _wavenumbers(grid)
    amp = von_karman_amplitude(kmag, outer_scale_km, inner_scale_km)
    amp = amp.at[0, 0, 0].set(0.0)  # zero-mean field
    white = jax.random.normal(key, (nx, ny, nz), jnp.float32)
    spec = jnp.fft.rfftn(white) * amp
    field = jnp.fft.irfftn(spec, s=(nx, ny, nz)).astype(jnp.float32)
    std = jnp.std(field) + 1e-20
    return field / std


def turbulent_log_perturbation(grid: Grid3D, amplitude=0.5,
                               outer_scale_km=100.0, inner_scale_km=2.0,
                               seed=0, key=None):
    """One realization of a zero-mean, unit-std-scaled log-n_e perturbation.

    Returns amplitude × (normalized von Kármán field) on ``grid``.
    """
    if key is None:
        key = jax.random.key(seed)
    return amplitude * _synthesize(grid, key, float(outer_scale_km),
                                   float(inner_scale_km))


def turbulent_realizations(grid: Grid3D, n, amplitude=0.5,
                           outer_scale_km=100.0, inner_scale_km=2.0, seed=0):
    """vmapped batch of n independent realizations, (n, *grid.shape)."""
    keys = jax.random.split(jax.random.key(seed), n)
    f = jax.vmap(lambda k: _synthesize(grid, k, float(outer_scale_km),
                                       float(inner_scale_km)))
    return amplitude * f(keys)


class FourierModes:
    """Analytic band-limited von Kármán realization as an explicit
    random-Fourier-mode sum (randomized spectral method):

        m_pert(x) = a · Σ_j cos(k_j · x + φ_j),   a = amplitude·√(2/K)

    with wavevector magnitudes drawn from the normalized radial spectral
    density p(k) ∝ k²·(k² + k0²)^{-11/6}·exp(−(k l_i/2π)²) truncated to
    [0, k_max] (inverse-CDF on a dense table), directions uniform on the
    sphere, phases uniform. As K→∞ this converges to a Gaussian field
    with the exact target spectrum; at K ~ hundreds it is a legitimate
    non-Gaussian turbulent world whose value AND gradient have closed
    forms everywhere — no grid, no interpolant.

    Purpose (bench/common.analytic_world): an honest data-generating
    world that is NOT the interpolation model of any solver — gridded
    truths secretly define "reality" as the generating interpolant,
    which hands that interpolant's operator a zero-model-error advantage
    (measured: config4 256³, DESIGN.md §14).
    """

    def __init__(self, n_modes, amplitude, outer_scale_km, kmax_rad_km,
                 inner_scale_km=2.0, seed=0):
        rng = np.random.default_rng(seed)
        k0 = 2 * np.pi / outer_scale_km
        li = inner_scale_km / (2 * np.pi)
        kt = np.linspace(0.0, kmax_rad_km, 4097)
        pdf = kt**2 * (kt**2 + k0**2) ** (-11.0 / 6.0) \
            * np.exp(-((kt * li) ** 2))
        cdf = np.cumsum(pdf)
        cdf = cdf / cdf[-1]
        kmag = np.interp(rng.uniform(size=n_modes), cdf, kt)
        u = rng.normal(size=(n_modes, 3))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        self.ks = jnp.asarray((kmag[:, None] * u), jnp.float32)
        self.phases = jnp.asarray(rng.uniform(0, 2 * np.pi, n_modes),
                                  jnp.float32)
        self.amp = jnp.float32(amplitude * np.sqrt(2.0 / n_modes))

    def shifted(self, dx) -> "FourierModes":
        """The world advected rigidly by ``dx`` (km) — EXACT frozen-flow
        evolution in closed form: cos(k·(x−dx)+φ) = cos(k·x+(φ−k·dx)),
        so translation is a phase shift, with no grid, no interpolation,
        and no periodic wrap. This is what makes the mode sum the honest
        data-generating world for time-evolving tomography: the filter's
        spectral ``advect_periodic`` (periodic BC, gridded) then carries
        its true model error instead of being the truth's own evolution
        operator (bench/config5.py analytic world)."""
        out = object.__new__(FourierModes)
        out.ks = self.ks
        out.phases = self.phases - self.ks @ jnp.asarray(dx, jnp.float32)
        out.amp = self.amp
        return out

    def value(self, pts: jax.Array) -> jax.Array:
        """m_pert at pts (N, 3) — lax.scan over modes, O(N) memory."""
        def body(acc, kp):
            k, ph = kp
            return acc + jnp.cos(pts @ k + ph), None
        acc0 = jnp.zeros(pts.shape[:1], jnp.float32)
        out, _ = jax.lax.scan(body, acc0, (self.ks, self.phases))
        return self.amp * out

    def value_and_grad(self, pts: jax.Array):
        """(m_pert (N,), ∇m_pert (N, 3)) in 1/km — exact."""
        def body(carry, kp):
            acc, g = carry
            k, ph = kp
            th = pts @ k + ph
            return (acc + jnp.cos(th), g - jnp.sin(th)[:, None] * k), None
        acc0 = jnp.zeros(pts.shape[:1], jnp.float32)
        g0 = jnp.zeros(pts.shape, jnp.float32)
        (v, g), _ = jax.lax.scan(body, (acc0, g0), (self.ks, self.phases))
        return self.amp * v, self.amp * g


def analytic_ne_fn(modes: FourierModes, background):
    """Closed-form turbulent-world evaluator for the callable tracer:
    n_e(x) = n_bg(x)·e^{m_pert(x)}, with the exact gradient
    ∇n_e = e^{m_pert}·(∇n_bg + n_bg·∇m_pert). ``background`` is a
    ``chapman.background_ne_fn`` evaluator."""
    def ne_and_grad(x):
        nb, gb = background(x)
        mp, gmp = modes.value_and_grad(x)
        e = jnp.exp(mp)
        return nb * e, e[:, None] * (gb + nb[:, None] * gmp)
    return ne_and_grad
