"""Model priors: smoothness operator + stationary GP covariance via FFT.

Reference parity (SURVEY.md §3.5 "Covariance / GP application"): the model
covariance C_m with a stationary kernel (σ_m, correlation length L), applied
spectrally in O(N log N) on the grid, plus its inverse contraction for the
MAP objective. On the device: jnp.fft 3D transforms, spectrum built once by
circulant embedding of the kernel on the (padded-by-construction) grid.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..core.grids import Grid3D


def laplacian(field: jax.Array, grid: Grid3D) -> jax.Array:
    """Second-difference Laplacian with replicated edges (1/km² units).

    The smoothness-prior operator L for config 3's ‖L m‖² regularisation.
    """
    out = jnp.zeros_like(field)
    for ax in range(3):
        up = jnp.roll(field, -1, axis=ax)
        dn = jnp.roll(field, 1, axis=ax)
        # replicate edges: roll wraps, overwrite wrapped slabs
        idx_first = [slice(None)] * 3
        idx_first[ax] = slice(0, 1)
        idx_last = [slice(None)] * 3
        idx_last[ax] = slice(-1, None)
        up = up.at[tuple(idx_last)].set(field[tuple(idx_last)])
        dn = dn.at[tuple(idx_first)].set(field[tuple(idx_first)])
        out = out + (up - 2.0 * field + dn) / (grid.spacing[ax] ** 2)
    return out


def _rfft_multiplicity(nx: int, ny: int, nz: int) -> np.ndarray:
    """Conjugate-pair multiplicity of the rfftn half-spectrum layout:
    interior kz planes stand for two full-FFT modes, the kz=0 (and, for
    even nz, Nyquist) planes for one. Shared by the marginal-variance
    normalisation in GPCovariance.create and fit_shell_spectrum."""
    w = np.full((nx, ny, nz // 2 + 1), 2.0, np.float32)
    w[:, :, 0] = 1.0
    if nz % 2 == 0:
        w[:, :, -1] = 1.0
    return w


def _kernel_values(r, kind: str, length_scale: float):
    """Stationary kernel k(r), r in km, unit variance."""
    x = r / length_scale
    if kind == "exponential":
        return np.exp(-x)
    if kind == "sqexp":
        return np.exp(-0.5 * x * x)
    if kind == "matern32":
        a = np.sqrt(3.0) * x
        return (1.0 + a) * np.exp(-a)
    if kind == "matern52":
        a = np.sqrt(5.0) * x
        return (1.0 + a + a * a / 3.0) * np.exp(-a)
    raise ValueError(f"unknown kernel kind: {kind}")


@dataclasses.dataclass(frozen=True)
class GPCovariance:
    """Stationary GP covariance operator on a Grid3D, applied spectrally.

    Built by circulant embedding: the kernel is evaluated on the periodic
    distance lattice of the grid and FFT'd; negative spectral leakage is
    clipped to keep the operator PSD. ``sqrt_spectrum`` enables exact
    sampling and C^{1/2} preconditioning.

    Reference twin: the `Covariance` class (SURVEY.md §2 "Prior covariance
    operator").
    """

    spectrum: jax.Array        # (nx, ny, nz//2+1) rfftn layout, PSD
    shape: tuple
    sigma: float
    length_scale: float        # scalar, or (Lx, Ly, Lz) tuple (anisotropic)
    kind: str

    @staticmethod
    def create(grid: Grid3D, sigma=1.0, length_scale=50.0,
               kind="exponential", inner_scale=2.0):
        """``length_scale`` may be a scalar (isotropic) or a 3-sequence
        (Lx, Ly, Lz) of per-axis correlation lengths [km] — anisotropic
        priors model e.g. background-profile errors (long horizontal, short
        vertical correlation; inversion/anchors.py) or field-aligned
        turbulence. The anisotropic kernel is the isotropic shape evaluated
        on the stretched distance sqrt(Σ (Δx_i/L_i)²)."""
        nx, ny, nz = grid.shape
        sp = np.asarray(jax.device_get(grid.spacing), np.float64)
        ls = np.asarray(length_scale, np.float64).reshape(-1)
        if ls.size not in (1, 3):
            raise ValueError(
                f"length_scale must be scalar or 3-sequence (Lx, Ly, Lz), "
                f"got {ls.size} values")
        ls_meta = (float(ls[0]) if ls.size == 1
                   else tuple(float(v) for v in ls))
        ls3 = np.full(3, ls[0]) if ls.size == 1 else ls
        if kind == "von_karman":
            # built directly in spectral space: the turbulence spectrum
            # itself (models.turbulence), normalised to marginal σ² —
            # the *matched* prior for frozen-flow turbulent ionospheres.
            # length_scale plays the outer scale L0.
            ax = [np.fft.fftfreq(nx, sp[0]), np.fft.fftfreq(ny, sp[1]),
                  np.fft.rfftfreq(nz, sp[2])]
            kmag = 2 * np.pi * np.sqrt(
                ax[0][:, None, None] ** 2 + ax[1][None, :, None] ** 2
                + ax[2][None, None, :] ** 2)
            li = inner_scale / (2 * np.pi)
            if np.all(ls3 == ls3[0]):
                k0 = 2 * np.pi / ls3[0]
                spec = (kmag**2 + k0**2) ** (-11.0 / 6.0) \
                    * np.exp(-((kmag * li) ** 2))
            else:
                # anisotropic outer scale on the stretched wavevector:
                # (Σ (k_i L_i)² + (2π)²)^{-11/6} ≡ the isotropic form
                # when L_i = L (overall L-power absorbed by the σ²
                # normalisation below); inner-scale dissipation stays
                # isotropic/physical.
                ks2 = (2 * np.pi) ** 2 * (
                    (ax[0][:, None, None] * ls3[0]) ** 2
                    + (ax[1][None, :, None] * ls3[1]) ** 2
                    + (ax[2][None, None, :] * ls3[2]) ** 2)
                spec = (ks2 + (2 * np.pi) ** 2) ** (-11.0 / 6.0) \
                    * np.exp(-((kmag * li) ** 2))
            spec[0, 0, 0] = 0.0  # zero-mean field
            # marginal variance: (1/N²)·Σ_full spec, rfft conjugate pairs
            # counted twice except the self-conjugate kz planes
            w = _rfft_multiplicity(nx, ny, nz)
            # Spectrum entries are DFT(kernel) values: the sampling/apply
            # convention (see sample()) implies marginal variance Σ_full S/N,
            # so scale so that Σ_full S = N σ².
            n_tot = float(nx * ny * nz)
            s_full = float((spec * w).sum())
            spec = spec * (sigma**2 * n_tot / max(s_full, 1e-300))
        else:
            # circulant embedding of a closed-form kernel on the periodic
            # (minimum-image) distance lattice
            ax = [np.minimum(np.arange(n), n - np.arange(n)) * sp[d]
                  for d, n in enumerate(grid.shape)]
            if np.all(ls3 == ls3[0]):
                r = np.sqrt(ax[0][:, None, None] ** 2
                            + ax[1][None, :, None] ** 2
                            + ax[2][None, None, :] ** 2)
                k = (sigma ** 2) * _kernel_values(r, kind, ls3[0])
            else:
                r = np.sqrt((ax[0][:, None, None] / ls3[0]) ** 2
                            + (ax[1][None, :, None] / ls3[1]) ** 2
                            + (ax[2][None, None, :] / ls3[2]) ** 2)
                k = (sigma ** 2) * _kernel_values(r, kind, 1.0)
            spec = np.fft.rfftn(k).real
            spec = np.maximum(spec, 0.0)  # PSD-ify
        return GPCovariance(spectrum=jnp.asarray(spec, jnp.float32),
                            shape=tuple(grid.shape), sigma=float(sigma),
                            length_scale=ls_meta, kind=kind)

    def apply(self, v: jax.Array) -> jax.Array:
        """C_m v — spectral multiply, O(N log N)."""
        spec = jnp.fft.rfftn(v) * self.spectrum
        return jnp.fft.irfftn(spec, s=self.shape).astype(v.dtype)

    def apply_sqrt(self, v: jax.Array) -> jax.Array:
        """C_m^{1/2} v — for sampling and symmetric preconditioning."""
        spec = jnp.fft.rfftn(v) * jnp.sqrt(self.spectrum)
        return jnp.fft.irfftn(spec, s=self.shape).astype(v.dtype)

    def apply_inv(self, v: jax.Array, floor_ratio=1e-6) -> jax.Array:
        """C_m^{-1} v with a spectral floor for numerical stability."""
        floor = floor_ratio * jnp.max(self.spectrum)
        spec = jnp.fft.rfftn(v) / jnp.maximum(self.spectrum, floor)
        return jnp.fft.irfftn(spec, s=self.shape).astype(v.dtype)

    def contract(self, v: jax.Array) -> jax.Array:
        """φᵀ C_m⁻¹ φ — the prior term of the MAP objective."""
        return jnp.vdot(v, self.apply_inv(v)).real

    def sample(self, key, n=None) -> jax.Array:
        """Draw sample(s) with covariance C_m (zero mean).

        y = F⁻¹(√S · Fw) for white w gives E[y yᵀ] = k(·) exactly under
        numpy FFT conventions (S = DFT(k), inverse carries the 1/N), so no
        extra normalisation is applied.
        """
        if n is None:
            w = jax.random.normal(key, self.shape, jnp.float32)
            return self.apply_sqrt(w)
        keys = jax.random.split(key, n)
        return jax.vmap(lambda k: self.sample(k))(keys)


jax.tree_util.register_dataclass(
    GPCovariance,
    data_fields=["spectrum"],
    meta_fields=["shape", "sigma", "length_scale", "kind"],
)


def fit_shell_spectrum(anomalies: jax.Array, grid: Grid3D,
                       n_bins: int = 48, ddof: int = 1) -> jax.Array:
    """Isotropic (shell-averaged) covariance spectrum from sample fields.

    ``anomalies``: (n, nx, ny, nz) zero-mean sample fields (e.g. ensemble
    deviations from their mean). Returns an rfftn-layout spectrum ``S``
    such that ``GPCovariance(spectrum=S, ...)`` is the best *stationary
    isotropic* approximation of the samples' covariance: the periodogram
    ``|F a|² / (n−ddof)·N`` is averaged over log-spaced shells of physical
    |k| (multiplicity-weighted for the rfft half-spectrum) and broadcast
    back per mode. Shell averaging pools thousands of modes per estimate,
    so even an 8-member ensemble yields a low-variance spectrum — this is
    the spectral answer to EnKF localization: instead of tapering noisy
    sample correlations in physical space, project the sample covariance
    onto the stationary-isotropic class where tiny ensembles are already
    statistically sufficient. Fully traced (spacing may be a tracer);
    only shapes and ``n_bins`` are static.
    """
    n = anomalies.shape[0]
    nx, ny, nz = anomalies.shape[1:]
    n_tot = nx * ny * nz
    f = jnp.fft.rfftn(anomalies, axes=(-3, -2, -1))
    p = jnp.sum(jnp.abs(f) ** 2, axis=0) / (max(n - ddof, 1) * n_tot)

    sp = grid.spacing
    def _freqs(nn, d):
        i = jnp.arange(nn)
        return jnp.where(i <= nn // 2, i, i - nn) / (nn * d)
    fx = _freqs(nx, sp[0])
    fy = _freqs(ny, sp[1])
    fz = jnp.arange(nz // 2 + 1) / (nz * sp[2])
    kmag = 2 * jnp.pi * jnp.sqrt(fx[:, None, None] ** 2
                                 + fy[None, :, None] ** 2
                                 + fz[None, None, :] ** 2)
    dims = jnp.asarray([nx, ny, nz], jnp.float32)
    kmin = 2 * jnp.pi * jnp.min(1.0 / (dims * sp))
    kmax = jnp.max(kmag)
    edges = jnp.exp(jnp.linspace(jnp.log(0.999 * kmin),
                                 jnp.log(1.001 * kmax), n_bins))
    bins = jnp.searchsorted(edges, kmag.ravel())  # 0 = DC only

    w = jnp.asarray(_rfft_multiplicity(nx, ny, nz)).ravel()
    num = jax.ops.segment_sum(p.ravel() * w, bins, num_segments=n_bins + 1)
    den = jax.ops.segment_sum(w, bins, num_segments=n_bins + 1)
    shell = num / jnp.maximum(den, 1e-30)
    s = shell[bins].reshape(kmag.shape)
    return s.at[0, 0, 0].set(0.0)
