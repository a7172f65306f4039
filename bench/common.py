"""Shared helpers for the five judged-config bench harnesses
(BASELINE.json .configs). Each configN.py prints one JSON line, naming
the GPU it ran on; run anywhere else, the harnesses refuse to measure."""
from __future__ import annotations

import json
import subprocess
import time

import numpy as np

NVIDIA_SMI = ["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"]


def card_lines() -> list:
    """The cards' names and power limits as nvidia-smi reports them (one
    line per card; the subprocess does not import JAX)."""
    out = subprocess.run(NVIDIA_SMI, capture_output=True, text=True,
                         check=True, timeout=60).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


def device_record() -> dict:
    """Platform, device kind and count as JAX reports them, and the
    cards' names and power limits. Raises SystemExit off the GPU: a
    number measured elsewhere is not a measurement of this system."""
    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(f"bench: needs a GPU; JAX found platform "
                         f"{devices[0].platform!r}")
    return dict(platform=devices[0].platform,
                device_kind=devices[0].device_kind,
                device_count=len(devices), cards=card_lines())


def setup() -> dict:
    """Call first in every harness: refuse to run off the GPU, then turn
    on the persistent compilation cache. Returns ``device_record()``."""
    from ionotomo_tpu.utils.compile_cache import enable_compile_cache
    rec = device_record()
    enable_compile_cache()
    return rec


def make_rays(n_ants, n_dirs, seed=0, spread_km=150.0, zen_max=0.6):
    """Antenna ENU positions + near-zenith unit directions (flat product)."""
    rng = np.random.default_rng(seed)
    ants = np.concatenate([rng.uniform(-spread_km, spread_km, (n_ants, 2)),
                           np.zeros((n_ants, 1))], -1).astype(np.float32)
    zen = rng.uniform(0.05, zen_max, n_dirs)
    az = rng.uniform(0, 2 * np.pi, n_dirs)
    dirs = np.stack([np.sin(zen) * np.sin(az), np.sin(zen) * np.cos(az),
                     np.cos(zen)], -1).astype(np.float32)
    return ants, dirs


def timed(fn, *args, reps=3):
    """Compile + steady-state timing; returns (result, seconds/rep)."""
    import jax
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return out, (time.perf_counter() - t0) / reps


def emit(config: str, metric: str, value: float, unit: str, **extra):
    rec = dict(config=config, metric=metric, value=float(value), unit=unit)
    rec.update(extra)
    rec.update(device_record())
    print(json.dumps(rec))
    return rec


def honest_truth(grid, m_prior, amplitude=0.3, outer_scale_km=120.0,
                 seed=7):
    """Truth field for inversion benches: prior + **von Kármán turbulence**
    — deliberately NOT a draw from any solver's assumed GP prior, so
    reconstruction error includes real prior misspecification
    (VERDICT r1 #4: no inverse crime)."""
    from ionotomo_tpu.models.turbulence import turbulent_log_perturbation
    return m_prior + turbulent_log_perturbation(
        grid, amplitude=amplitude, outer_scale_km=outer_scale_km, seed=seed)


def bent_dtec_data(m_true, grid, ants, dirs, frequency_hz=150e6,
                   n_steps=256, noise_frac=0.01, seed=0,
                   max_length_km=1000.0):
    """Observations via the **bent Fermat tracer** at 2× the production
    quadrature (n_steps=256 vs the solvers' ~129 samples), plus Gaussian
    noise — the forward model generating the data is NOT the operator the
    solvers invert (different physics: bending; different quadrature).
    Returns (d_obs (Na,Nd), noise_std scalar)."""
    import jax
    import jax.numpy as jnp
    from ionotomo_tpu.geometry import fermat, rays as rays_mod

    origins, dvecs = rays_mod.make_ray_batch(ants, dirs)
    _, tau = fermat.trace_rays(m_true, grid, origins, dvecs, frequency_hz,
                               max_length_km, n_steps=n_steps,
                               keep_path=False, method="leapfrog")
    nd = np.asarray(dirs).shape[0]
    tau = tau.reshape(-1, nd)
    d = tau - tau[0:1]
    noise = float(noise_frac * jnp.std(d))
    d = d + noise * jax.random.normal(jax.random.key(seed), d.shape)
    return d, np.float32(noise)


def covered_rmse(m, m_true, grid, rb, frac=0.05):
    """RMSE of (m − m_true) restricted to ray-covered voxels — unobserved
    voxels carry no information and would dilute the metric."""
    import jax.numpy as jnp
    from ionotomo_tpu.forward import tec as tec_mod
    cover = tec_mod.ray_coverage(grid, rb)
    mask = cover > frac * cover.max()
    e = jnp.where(mask, m - m_true, 0.0)
    return float(jnp.sqrt(jnp.sum(e * e) / jnp.maximum(mask.sum(), 1)))


def heldout_dtec_rms(m, grid, ants_h, dirs_h, d_heldout, n_samples=129,
                     interp="cubic"):
    """Generalisation on the observable: rms dTEC prediction error on rays
    never used in the solve (new antennas AND directions). dTEC tomography
    has a large null space (common-mode vertical profile) that model-space
    RMSE charges to the solver; held-out dTEC measures the skill that
    physically exists."""
    import jax.numpy as jnp
    from ionotomo_tpu.forward import tec as tec_mod
    from ionotomo_tpu.geometry import rays as rays_mod
    o, dv = rays_mod.make_ray_batch(ants_h, dirs_h)
    rb = rays_mod.sample_straight_rays(o, dv, n_samples=n_samples)
    nd = np.asarray(dirs_h).shape[0]
    g = tec_mod.dtec_paired(m, grid, rb, nd, 0, interp)
    return float(jnp.sqrt(jnp.mean((g - d_heldout) ** 2)))


def analytic_world(grid, amplitude=0.25, outer_scale_km=120.0,
                   n_modes=512, seed=11):
    """Analytic honest world: closed-form Chapman background × a
    band-limited von Kármán Fourier-mode sum (models.turbulence.
    FourierModes) — truth value and gradient exist everywhere in closed
    form, so NO solver's interpolation model defines reality.

    Why this exists (round-3 measurement, DESIGN.md §14): a truth held as
    grid samples makes "reality" the generating interpolant — the
    matching operator then carries zero model error by construction and
    every other C¹ model is charged its full inter-model gap (measured:
    1279 vs 1706 held-out at config-4 scale). Band-limiting at the solve
    grid's Nyquist keeps the world representable, so the comparison
    isolates model error the solvers can actually act on.

    Returns (m_true_grid — the truth's log-density SAMPLES on ``grid``
    (what the solvers' metrics compare against), ne_and_grad — the
    closed-form evaluator the bent tracer generates data through).
    """
    import jax.numpy as jnp
    from ionotomo_tpu import constants
    from ionotomo_tpu.models import chapman
    from ionotomo_tpu.models.turbulence import FourierModes, analytic_ne_fn

    kmax = float(np.pi / np.max(np.asarray(grid.spacing)))
    modes = FourierModes(n_modes, amplitude, outer_scale_km, kmax,
                         seed=seed)
    bg = chapman.background_ne_fn()
    m_ch = chapman.log_parametrize(chapman.chapman_field(grid))
    pts = grid.meshgrid().reshape(-1, 3)
    import jax
    pert = jax.jit(modes.value)(jnp.asarray(pts, jnp.float32))
    m_true = m_ch + pert.reshape(grid.shape)
    return m_true, analytic_ne_fn(modes, bg)


def bent_dtec_data_callable(ne_and_grad, ants, dirs, frequency_hz=150e6,
                            n_steps=256, noise_frac=0.01, seed=0,
                            max_length_km=1000.0):
    """Observations via the bent tracer through a CLOSED-FORM field
    (fermat.trace_rays_callable) at 2× the production step count, plus
    noise — the analytic-world twin of ``bent_dtec_data``."""
    import jax
    import jax.numpy as jnp
    from ionotomo_tpu.geometry import fermat, rays as rays_mod

    origins, dvecs = rays_mod.make_ray_batch(ants, dirs)
    f = jax.jit(lambda o, d: fermat.trace_rays_callable(
        ne_and_grad, o, d, frequency_hz, max_length_km, n_steps=n_steps,
        keep_path=False, method="leapfrog")[1])
    # chunk the ray axis: the mode-sum field costs ~n_modes
    # transcendental sweeps per integrator step, and 2048-ray chunks
    # bound each program's working set
    r = origins.shape[0]
    chunk = 2048
    pads = (-r) % chunk
    o_p = jnp.concatenate([origins, jnp.broadcast_to(origins[-1:],
                                                     (pads, 3))])
    d_p = jnp.concatenate([dvecs, jnp.broadcast_to(dvecs[-1:], (pads, 3))])
    tau = jnp.concatenate([f(o_p[i:i + chunk], d_p[i:i + chunk])
                           for i in range(0, r + pads, chunk)])[:r]
    nd = np.asarray(dirs).shape[0]
    tau = tau.reshape(-1, nd)
    d = tau - tau[0:1]
    noise = float(noise_frac * jnp.std(d))
    d = d + noise * jax.random.normal(jax.random.key(seed), d.shape)
    return d, noise
