"""Config 3b: the north-star literal — converge a 128³-voxel inversion
from 10k rays in <10 s (BASELINE.json north_star), on the honest world.

Honest setup (VERDICT r1 #4): von Kármán truth (never a draw from the
solver's prior), data from the bent Fermat tracer at 2× the production
quadrature + 1% noise, inversion with the production straight-ray
operator and a von Kármán GP prior at deliberately-off hyperparameters.

Operator quadrature: n_samples=65 (on the turbulent 128³ world the GN
held-out skill is unchanged vs 129 samples, 1342 vs 1336, at half the
samples; the GP prior absorbs the extra quadrature error, see
PRECISION.md). The parity is
resolution-dependent (~1 sample per voxel crossed): at 256³ the
65-sample operator fails, so config 4 keeps 129.
"""
import os

import jax
import jax.numpy as jnp

from bench.common import (setup, make_rays, timed, emit, honest_truth,
                          bent_dtec_data, bent_dtec_data_callable,
                          analytic_world, covered_rmse, heldout_dtec_rms)
from ionotomo_tpu.models import chapman
from ionotomo_tpu.geometry import rays as rays_mod
from ionotomo_tpu.inversion import solvers
from ionotomo_tpu.inversion.priors import GPCovariance


def main():
    setup()
    n_samples = int(os.environ.get("BENCH_N_SAMPLES", "65"))
    quadrature = os.environ.get("BENCH_QUADRATURE", "hermite")
    # zp field model: equal held-out skill to cubic (1628 vs 1631) on
    # the analytic world — DESIGN.md §14
    interp = os.environ.get("BENCH_INTERP", "zp")
    ants, dirs = make_rays(100, 100)  # 10k rays
    grid = chapman.grid_enclosing_rays(ants, dirs, shape=(128, 128, 128),
                                       h_min_km=0.0)
    m_prior = chapman.log_parametrize(chapman.chapman_field(grid))
    # round-3 default: analytic world (no interpolation model defines
    # reality — DESIGN.md §15); BENCH_WORLD=gridded restores the r2 setup
    world = os.environ.get("BENCH_WORLD", "analytic")
    if world == "analytic":
        m_true, ne_fn = analytic_world(grid, amplitude=0.3,
                                       outer_scale_km=120.0, seed=7)
    else:
        m_true = honest_truth(grid, m_prior, amplitude=0.3, seed=7)
        ne_fn = None
    cov = GPCovariance.create(grid, sigma=0.3, length_scale=80.0,
                              kind="von_karman")
    if ne_fn is not None:
        d_obs, noise = bent_dtec_data_callable(ne_fn, ants, dirs,
                                               frequency_hz=150e6,
                                               n_steps=256,
                                               noise_frac=0.01)
    else:
        d_obs, noise = bent_dtec_data(m_true, grid, ants, dirs,
                                      frequency_hz=150e6, n_steps=256,
                                      noise_frac=0.01)
    origins, dvecs = rays_mod.make_ray_batch(ants, dirs)
    rb = rays_mod.sample_straight_rays(origins, dvecs,
                                       n_samples=n_samples)
    ants_h, dirs_h = make_rays(20, 50, seed=99)
    if ne_fn is not None:
        d_h, _ = bent_dtec_data_callable(ne_fn, ants_h, dirs_h,
                                         frequency_hz=150e6, n_steps=256,
                                         noise_frac=0.0)
    else:
        d_h, _ = bent_dtec_data(m_true, grid, ants_h, dirs_h,
                                frequency_hz=150e6, n_steps=256,
                                noise_frac=0.0)

    gn_iters = 2
    cg_iters = int(os.environ.get("BENCH_CG_ITERS", "20"))
    # round-4 knob: BENCH_WARM=1 — warm-started GN continuation
    # (same-data Krylov carry, DESIGN.md §16), letting BENCH_CG_ITERS
    # drop at equal held-out skill. Defaults preserve the r3 row.
    warm = os.environ.get("BENCH_WARM", "") == "1"
    f = jax.jit(lambda d: solvers.map_gauss_newton(
        grid, rb, d, noise, m_prior, cov, num_directions=100,
        gn_iters=gn_iters, cg_iters=cg_iters, quadrature=quadrature,
        interp=interp, warm_start=warm))
    res, secs = timed(f, jnp.asarray(d_obs), reps=1)
    emit("config3b", "northstar_128_10k_seconds", secs, "s",
         under_10s=bool(secs < 10.0),
         cg_iters_per_sec=gn_iters * cg_iters / secs,
         n_samples=n_samples, quadrature=quadrature, interp=interp,
         warm_start=warm, cg_iters=cg_iters,
         covered_rmse_prior=covered_rmse(m_prior, m_true, grid, rb),
         covered_rmse_post=covered_rmse(res.m, m_true, grid, rb),
         heldout_dtec_rms_prior=heldout_dtec_rms(m_prior, grid, ants_h,
                                                 dirs_h, d_h,
                                                 interp=interp),
         heldout_dtec_rms_post=heldout_dtec_rms(res.m, grid, ants_h,
                                                dirs_h, d_h,
                                                interp=interp),
         world=world,
         data="bent-tracer 2x quadrature + 1% noise, von Karman truth "
              f"({world} world)")


if __name__ == "__main__":
    main()
