"""Config 4: Bayesian MAP inversion with GP covariance prior on a 256³
grid, 10k rays, batched Krylov solves (BASELINE.json configs[3]).

Metric: wall seconds per Gauss-Newton solve and data-space CG
iterations/sec with the 256³ covariance operator in the loop.

Honest setup (VERDICT r1 #4): truth = prior + von Kármán turbulence while
the solver assumes a squared-exponential GP — the prior is misspecified,
as in reality; data from the bent tracer at 2× quadrature + noise; solve
with the production straight-ray operator.
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
from ionotomo_tpu.inversion.priors import GPCovariance


def main():
    setup()
    ants, dirs = make_rays(100, 100)  # 10k rays
    grid = chapman.grid_enclosing_rays(ants, dirs, shape=(256, 256, 256),
                                       h_min_km=0.0)
    m_prior = chapman.log_parametrize(chapman.chapman_field(grid))
    # round-3 default: ANALYTIC world (closed-form Chapman x Fourier-mode
    # von Karman, data traced through it exactly) — a gridded truth makes
    # "reality" the generating interpolant and hands that interpolant's
    # operator zero model error by construction (measured, DESIGN.md
    # sec. 14). BENCH_WORLD=gridded restores the r2 world.
    world = os.environ.get("BENCH_WORLD", "analytic")
    if world == "analytic":
        m_true, ne_fn = analytic_world(grid, amplitude=0.25,
                                       outer_scale_km=120.0, seed=11)
    else:
        m_true = honest_truth(grid, m_prior, amplitude=0.25, seed=11)
        ne_fn = None
    # physically-motivated prior family (von Kármán — what the ionosphere
    # actually does) with hyperparameters deliberately OFF the truth's
    # (L=80 vs 120 km, sigma=0.3 vs amplitude 0.25). sqexp leaves 3x more
    # held-out error on turbulent truth (its spectrum kills all sub-L
    # structure); see DESIGN.md.
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
    # round-3 default: Hermite (gradient-augmented) operator at 65
    # samples — held-out 1282 vs the r2 Simpson@129's 1359 at half the
    # samples (uniform weights kill Simpson's Nyquist comb; the endpoint
    # gradient correction is free — PRECISION.md round-3 study)
    n_samples = int(os.environ.get("BENCH_N_SAMPLES", "65"))
    quadrature = os.environ.get("BENCH_QUADRATURE", "hermite")
    # cubic stays the 256³ default: the zp field model loses held-out
    # skill 1891 vs 1435 — at 3-km voxels the truth's near-Nyquist power
    # is real signal that ZP's xy response attenuates (resolution-
    # dependent model choice — DESIGN.md §14). BENCH_INTERP=zp reports
    # the latency frontier.
    interp = os.environ.get("BENCH_INTERP", "cubic")
    # default from the round-3 frontier (not yet on the H100): progressive
    # fidelity — GN iter 1 entirely on the @33 bundle, iter 2 full @65 —
    # held-out 1286 vs 1281 full-fidelity (parity within run-to-run
    # noise). BENCH_INNER_SAMPLES=0 or BENCH_PROGRESSIVE=0 restores
    # single-fidelity; BENCH_PROGRESSIVE_MIXED=1 additionally runs iter
    # 2's solve on the coarse Jacobian (−3.3% skill).
    inner = int(os.environ.get("BENCH_INNER_SAMPLES", "33"))
    rb = rays_mod.sample_straight_rays(origins, dvecs,
                                       n_samples=n_samples)
    rb_inner = (rays_mod.sample_straight_rays(origins, dvecs,
                                              n_samples=inner)
                if inner else None)
    ants_h, dirs_h = make_rays(20, 50, seed=99)   # held-out rays
    if ne_fn is not None:
        d_h, _ = bent_dtec_data_callable(ne_fn, ants_h, dirs_h,
                                         frequency_hz=150e6, n_steps=256,
                                         noise_frac=0.0)
    else:
        d_h, _ = bent_dtec_data(m_true, grid, ants_h, dirs_h,
                                frequency_hz=150e6, n_steps=256,
                                noise_frac=0.0)

    gn_iters, cg_iters = 2, 20
    # round-4 default (DESIGN.md §16): warm_start — stage 2 CONTINUES
    # stage 1's whitened Krylov solution (u_final → u0, same data) at
    # cg2=10: held-out 1379 vs the r3 cold default's 1435 with half the
    # stage-2 iterations (warm continuation = legitimately deeper
    # fitting of the same data). BENCH_WARM=0 restores the r3 cold
    # schedule. BENCH_INTERP_INNER=zp (mixed field-model Jacobian) is
    # GATED OFF: the zp operator inside large 256³ CG programs was
    # non-reproducible on an earlier round's backend (DESIGN.md §17);
    # ROADMAP R1 asks the question again on the GPU.
    interp_inner = os.environ.get("BENCH_INTERP_INNER", "") or None
    warm = os.environ.get("BENCH_WARM", "1") == "1"
    cg2 = int(os.environ.get("BENCH_CG2", "10" if warm else str(cg_iters)))
    progressive = (os.environ.get("BENCH_PROGRESSIVE", "1") == "1"
                   and inner > 0)
    if progressive:
        # progressive fidelity: GN iter 1 entirely on the coarse bundle
        # (its linearisation error is corrected by iter 2's full-fidelity
        # re-linearisation), iter 2 full
        assert rb_inner is not None, "BENCH_PROGRESSIVE needs inner"

        def f(d):
            r1 = solvers.map_gauss_newton(
                grid, rb_inner, d, noise, m_prior, cov,
                num_directions=100, gn_iters=1, cg_iters=cg_iters,
                quadrature=quadrature, interp=interp,
                warm_start=warm, interp_inner=interp_inner)
            return solvers.map_gauss_newton(
                grid, rb, d, noise, m_prior, cov, num_directions=100,
                gn_iters=1, cg_iters=cg2, quadrature=quadrature,
                interp=interp, m0=r1.m,
                warm_start=warm, u0=(r1.u_final if warm else None),
                interp_inner=interp_inner,
                rays_inner=(rb_inner if os.environ.get(
                    "BENCH_PROGRESSIVE_MIXED", "") == "1" else None))
    else:
        f = jax.jit(lambda d: solvers.map_gauss_newton(
            grid, rb, d, noise, m_prior, cov, num_directions=100,
            gn_iters=gn_iters, cg_iters=cg_iters, quadrature=quadrature,
            interp=interp, rays_inner=rb_inner,
            warm_start=warm, interp_inner=interp_inner))
    res, secs = timed(f, jnp.asarray(d_obs), reps=1)
    err_pr = covered_rmse(m_prior, m_true, grid, rb)
    err_po = covered_rmse(res.m, m_true, grid, rb)
    ho_pr = heldout_dtec_rms(m_prior, grid, ants_h, dirs_h, d_h,
                             interp=interp)
    ho_po = heldout_dtec_rms(res.m, grid, ants_h, dirs_h, d_h,
                             interp=interp)
    emit("config4", "map_gn_seconds_to_solve", secs, "s",
         cg_iters_per_sec=gn_iters * cg_iters / secs,
         n_samples=n_samples, quadrature=quadrature, interp=interp,
         inner_samples=inner, progressive=progressive,
         interp_inner=interp_inner, warm_start=warm, cg2=cg2,
         covered_rmse_prior=err_pr, covered_rmse_post=err_po,
         heldout_dtec_rms_prior=ho_pr, heldout_dtec_rms_post=ho_po,
         world=world,
         data="bent-tracer 2x quadrature + 1% noise, von Karman truth "
              f"({world} world), von Karman prior at mismatched "
              "hyperparameters")


if __name__ == "__main__":
    main()
