"""Config 3: single-snapshot inversion — ray–voxel Jacobian + LSQR/CG with
smoothness prior, 128³ grid, 5k rays (BASELINE.json configs[2]).

Metric: wall seconds to converge + inversion iterations/sec on the 128³
grid (the BASELINE.json metric definition).

Honest setup (VERDICT r1 #4 — no inverse crime): truth = Chapman prior +
von Kármán turbulence (not a draw from the solver's smoothness prior);
data synthesized by the bent Fermat tracer at 2× quadrature + noise; the
solve uses the production straight-ray Simpson operator, so reported RMSE
includes bending and quadrature model error.
"""
import os

import jax
import jax.numpy as jnp

from bench.common import (setup, make_rays, timed, emit, honest_truth,
                          bent_dtec_data, bent_dtec_data_callable,
                          analytic_world, covered_rmse,
                          heldout_dtec_rms)
from ionotomo_tpu.models import chapman
from ionotomo_tpu.geometry import rays as rays_mod
from ionotomo_tpu.inversion import solvers


def main():
    setup()
    ants, dirs = make_rays(50, 100)   # 5000 rays
    grid = chapman.grid_enclosing_rays(ants, dirs, shape=(128, 128, 128),
                                       h_min_km=0.0)
    m_prior = chapman.log_parametrize(chapman.chapman_field(grid))
    # round-3 default: analytic world (no interpolation model defines
    # reality — DESIGN.md §15); BENCH_WORLD=gridded restores the r2 setup
    world = os.environ.get("BENCH_WORLD", "analytic")
    if world == "analytic":
        m_true, ne_fn = analytic_world(grid, amplitude=0.3,
                                       outer_scale_km=120.0, seed=7)
        d_obs, noise = bent_dtec_data_callable(ne_fn, ants, dirs,
                                               frequency_hz=150e6,
                                               n_steps=256,
                                               noise_frac=0.01)
    else:
        m_true = honest_truth(grid, m_prior, amplitude=0.3, seed=7)
        ne_fn = None
        d_obs, noise = bent_dtec_data(m_true, grid, ants, dirs,
                                      frequency_hz=150e6, n_steps=256,
                                      noise_frac=0.01)
    origins, dvecs = rays_mod.make_ray_batch(ants, dirs)
    # round-3: Hermite operator at 97 samples — measured faster AND
    # better held-out than the r2 Simpson@129 for the weak-prior LSQR
    # (PRECISION.md; hermite@65 loses 11% skill, so LSQR keeps 97)
    n_samples = int(os.environ.get("BENCH_N_SAMPLES", "97"))
    quadrature = os.environ.get("BENCH_QUADRATURE", "hermite")
    # zp field model: equal held-out skill to cubic on the analytic
    # world at about half the solve time in an earlier round (DESIGN.md
    # §14); not yet measured on the H100
    interp = os.environ.get("BENCH_INTERP", "zp")
    rb = rays_mod.sample_straight_rays(origins, dvecs,
                                       n_samples=n_samples)
    ants_h, dirs_h = make_rays(20, 50, seed=99)   # held-out rays
    if ne_fn is not None:
        d_h, _ = bent_dtec_data_callable(ne_fn, ants_h, dirs_h,
                                         frequency_hz=150e6, n_steps=256,
                                         noise_frac=0.0)
    else:
        d_h, _ = bent_dtec_data(m_true, grid, ants_h, dirs_h,
                                frequency_hz=150e6, n_steps=256,
                                noise_frac=0.0)

    iters = 48
    f = jax.jit(lambda d: solvers.lsqr_smoothness(
        grid, rb, d, noise, m_prior, num_directions=100, damp=3e-3,
        smooth=0.2, max_iters=iters, quadrature=quadrature,
        interp=interp))
    res, secs = timed(f, jnp.asarray(d_obs), reps=1)
    err_pr = covered_rmse(m_prior, m_true, grid, rb)
    err_po = covered_rmse(res.m, m_true, grid, rb)
    ho_pr = heldout_dtec_rms(m_prior, grid, ants_h, dirs_h, d_h,
                             interp=interp)
    ho_po = heldout_dtec_rms(res.m, grid, ants_h, dirs_h, d_h,
                             interp=interp)
    emit("config3", "lsqr_seconds_to_solve", secs, "s",
         iters_per_sec=iters / secs, n_samples=n_samples,
         quadrature=quadrature, interp=interp, covered_rmse_prior=err_pr,
         covered_rmse_post=err_po,
         heldout_dtec_rms_prior=ho_pr, heldout_dtec_rms_post=ho_po,
         under_10s=bool(secs < 10.0), world=world,
         data="bent-tracer 2x quadrature + 1% noise, von Karman truth "
              f"({world} world)")


if __name__ == "__main__":
    main()
