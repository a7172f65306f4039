"""Frozen-flow advection (Taylor's hypothesis) — device-side spectral shift.

Reference capability (SURVEY.md §8): ``n_e(x, t+Δt) = n_e(x − v·Δt, t)`` +
process noise. Device form: a sub-voxel-exact translation as a Fourier
phase ramp (periodic boundary) — one FFT pair, no gather; this is both the
simulation's time evolution and the Kalman filter's transition operator.

Periodicity caveat: content advected past a face re-enters on the opposite
face. Grids are built with padding beyond the ray volume (SURVEY.md §2
"initial model"), so wrapped content stays outside the rays for the modest
shifts (v·Δt ≪ grid extent) of a 30-step observation window.
"""
from __future__ import annotations


import jax
import jax.numpy as jnp


@jax.jit
def advect_periodic(field, grid, shift_km):
    """Translate ``field`` by ``shift_km`` with spectral interpolation.

    ``shift_km`` shapes:
      (3,)   — rigid translation: sample the field at x − shift with
               periodic boundary (one 3-D FFT pair, no gather).
      (2,3)  — rigid + **vertical shear**: row 0 is the mid-grid shift,
               row 1 the horizontal shift *difference* reached at the
               grid's top/bottom faces — each z-slice translates by
               ``row0[:2] + ζ(z)·row1[:2]`` with ζ ∈ [−1, 1] the
               normalized height (linear-in-height drift: E- and
               F-region plasma move with different bulk velocities).
               Implemented as a per-slice 2-D phase ramp (one 2-D FFT
               pair over the stacked slices — same cost class as the
               rigid op), composed with row 0's rigid vertical shift.
               Row 1's vertical component must be 0 (a z-dependent
               vertical shift is not volume-preserving slice-wise).
    """
    nx, ny, nz = grid.shape
    shift = jnp.asarray(shift_km)
    if shift.ndim == 1:
        s = shift / grid.spacing  # voxels
        kx = jnp.fft.fftfreq(nx)[:, None, None]
        ky = jnp.fft.fftfreq(ny)[None, :, None]
        kz = jnp.fft.rfftfreq(nz)[None, None, :]
        phase = -2j * jnp.pi * (kx * s[0] + ky * s[1] + kz * s[2])
        spec = jnp.fft.rfftn(field) * jnp.exp(phase)
        return jnp.fft.irfftn(spec, s=(nx, ny, nz)).astype(field.dtype)

    # shear form: horizontal shift varies linearly over the z axis.
    # Full complex 2-D FFT + real part (the scipy fourier_shift
    # convention for the even-size Nyquist bin under fractional shifts).
    mean, shear = shift[0], shift[1]
    zeta = (2.0 * jnp.arange(nz) - (nz - 1)) / jnp.maximum(nz - 1, 1)
    sx = (mean[0] + zeta * shear[0]) / grid.spacing[0]   # (nz,) voxels
    sy = (mean[1] + zeta * shear[1]) / grid.spacing[1]
    kx = jnp.fft.fftfreq(nx)[:, None, None]
    ky = jnp.fft.fftfreq(ny)[None, :, None]
    phase = -2j * jnp.pi * (kx * sx[None, None, :]
                            + ky * sy[None, None, :])
    spec = jnp.fft.fft2(field, axes=(0, 1)) * jnp.exp(phase)
    out = jnp.fft.ifft2(spec, axes=(0, 1)).real
    # rigid vertical component from the mean row (row 1's v_z is ignored
    # by construction — the filters mask it to 0)
    kz = jnp.fft.rfftfreq(nz)[None, None, :]
    phase_z = -2j * jnp.pi * kz * (mean[2] / grid.spacing[2])
    spec_z = jnp.fft.rfft(out, axis=2) * jnp.exp(phase_z)
    return jnp.fft.irfft(spec_z, n=nz, axis=2).astype(field.dtype)


def estimate_wind(field_a, field_b, grid, dt_s, n_iters=200, lr=0.05,
                  v0=(0.0, 0.0, 0.0), horizontal_only=True):
    """Estimate the bulk wind between two snapshots (Taylor hypothesis).

    Minimises ‖advect(field_a, v·Δt) − field_b‖² over v by Adam — the
    spectral phase ramp is smooth in the shift, so the match is
    differentiable to sub-voxel accuracy. Fields should be zero-mean
    perturbations (subtract the background first). Returns v [km/s].

    ``horizontal_only`` (default) pins v_z = 0: ionospheric frozen flow is
    horizontal drift, and near-vertical ray geometry leaves the vertical
    shift of reconstructed snapshots essentially unconstrained (the
    unconstrained fit slides along the ray direction).
    """
    a = field_a - jnp.mean(field_a)
    b = field_b - jnp.mean(field_b)
    mask = jnp.asarray([1.0, 1.0, 0.0 if horizontal_only else 1.0])

    def loss(v):
        pred = advect_periodic(a, grid, (v * mask) * dt_s)
        return jnp.mean((pred - b) ** 2)

    grad = jax.value_and_grad(loss)

    def step(carry, _):
        v, m, s, t = carry
        val, g = grad(v)
        g = g * mask
        t = t + 1
        m = 0.9 * m + 0.1 * g
        s = 0.999 * s + 0.001 * g * g
        v = v - lr * (m / (1 - 0.9**t)) / (jnp.sqrt(s / (1 - 0.999**t))
                                           + 1e-12)
        return (v, m, s, t), val

    v0 = jnp.asarray(v0, jnp.float32)
    (v, *_), hist = jax.lax.scan(
        step, (v0, jnp.zeros(3), jnp.zeros(3), 0.0), None, length=n_iters)
    return v, hist


def frozen_flow_sequence(field0, grid, wind_kmps, dt_s, n_steps):
    """Stack of n_steps fields advected by t·v·Δt (lax.scan, device-resident)."""
    wind = jnp.asarray(wind_kmps, jnp.float32)

    def step(carry, _):
        t = carry
        out = advect_periodic(field0, grid, wind * (t * dt_s))
        return t + 1.0, out

    _, seq = jax.lax.scan(step, 0.0, None, length=n_steps)
    return seq
