"""Config 5: time-evolving tomography — Kalman-filtered frozen-flow
ionosphere, 30 timesteps × 10k rays end-to-end (BASELINE.json configs[4]).

Metric: end-to-end wall seconds for the 30-step filter and timesteps/sec.

Honest setup (VERDICT r1 #4): the true perturbation is von Kármán
turbulence advected by the wind; per-step data come from the bent Fermat
tracer through the true field at 2× quadrature + noise; the filter runs
the production straight-ray operator with a von Kármán GP covariance at
hyperparameters deliberately off the truth's.

Round-3 default world is ANALYTIC (BENCH_WORLD=gridded restores the r2
setup): truth = closed-form Chapman × Fourier-mode von Kármán whose
frozen-flow evolution is an exact phase shift (turbulence.FourierModes.
shifted) — previously the truth was advected by the filter's own
advect_periodic, handing the filter's evolution model zero model error
by construction (the time-domain analogue of the gridded-truth inverse
crime measured in DESIGN.md §14). The filter executes in production
form: chunked scans chained via advect_first/m_clim (the pipeline's
checkpoint granularity).
"""
import jax
import jax.numpy as jnp
import numpy as np
import time

from bench.common import (setup, make_rays, emit, honest_truth,
                          covered_rmse, bent_dtec_data, heldout_dtec_rms)
from ionotomo_tpu.models import chapman
from ionotomo_tpu.geometry import fermat, rays as rays_mod
from ionotomo_tpu.inversion.kalman import kalman_filter
from ionotomo_tpu.inversion.priors import GPCovariance
from ionotomo_tpu.models.frozen_flow import advect_periodic
from ionotomo_tpu.models.turbulence import FourierModes, analytic_ne_fn


def main(n_samples=65, cg_iters=10, inner_samples=33):
    import os
    setup()
    # zp field model: better held-out skill than cubic (836 vs 843) on
    # the analytic world at half its rows — DESIGN.md §14
    interp = os.environ.get("BENCH_INTERP", "zp")
    world = os.environ.get("BENCH_WORLD", "analytic")
    # sweep knobs (round 4): per-step CG depth and the mixed-fidelity
    # inner sample count (0 disables the inner bundle)
    cg_iters = int(os.environ.get("BENCH_CG", str(cg_iters)))
    inner_env = os.environ.get("BENCH_INNER_SAMPLES", "")
    if inner_env:
        inner_samples = int(inner_env) or None
    # inner_samples=33 (mixed-fidelity update, kalman_filter
    # rays_inner_seq) is the round-5 default, picked from a speed/skill
    # frontier of an earlier round (not yet on the H100): cg10/inner33
    # (held-out 861) dominated cg7/inner49 (992); cg10/inner49 (836) is
    # the +3%-skill option (BENCH_INNER_SAMPLES=49), cg15/inner49 (706)
    # the best-skill point.
    nt, chunk = 30, 6
    ants, dirs = make_rays(100, 100)  # 10k rays per step
    grid = chapman.grid_enclosing_rays(ants, dirs, shape=(128, 128, 128),
                                       h_min_km=0.0)
    m_bg = chapman.log_parametrize(chapman.chapman_field(grid))
    cov = GPCovariance.create(grid, sigma=0.3, length_scale=80.0,
                              kind="von_karman")  # family right (physics),
    # hyperparameters off the truth's (L=80 vs 120 km) — see config4
    wind = jnp.asarray([0.3, 0.1, 0.0])
    dt_s = 30.0
    origins, dvecs = rays_mod.make_ray_batch(ants, dirs)
    rb = rays_mod.sample_straight_rays(origins, dvecs,
                                       n_samples=n_samples)

    if world == "analytic":
        # Analytic honest world (round-3, DESIGN.md §14), now for the
        # TIME-EVOLVING config too: the truth is a closed-form Chapman ×
        # Fourier-mode von Kármán field whose frozen-flow evolution is
        # an EXACT phase shift (FourierModes.shifted) — no grid, no
        # interpolant, and crucially NOT the filter's own spectral
        # advect_periodic (periodic wrap + gridded), so both the field
        # model and the evolution model carry their true error.
        kmax = float(np.pi / np.max(np.asarray(grid.spacing)))
        modes = FourierModes(512, 0.25, 120.0, kmax, seed=13)
        bg = chapman.background_ne_fn()

        def tau_chunk(dx, o, d):
            ne = analytic_ne_fn(modes.shifted(dx), bg)
            return fermat.trace_rays_callable(
                ne, o, d, 150e6, 1000.0, n_steps=128, keep_path=False,
                method="leapfrog")[1]

        f_tau = jax.jit(tau_chunk)
        r, chunk_r = origins.shape[0], 2048

        def obs(t):
            dx = wind * (t * dt_s)
            tau = jnp.concatenate(
                [f_tau(dx, origins[i:i + chunk_r], dvecs[i:i + chunk_r])
                 for i in range(0, r, chunk_r)])
            return tau.reshape(-1, 100) - tau.reshape(-1, 100)[0:1]

        pts = grid.meshgrid().reshape(-1, 3)
        sample = jax.jit(lambda dx: modes.shifted(dx).value(
            jnp.asarray(pts, jnp.float32)).reshape(grid.shape))

        def truth_at(t):
            return m_bg + sample(wind * (t * dt_s))
    else:
        m_true0 = honest_truth(grid, m_bg, amplitude=0.25, seed=13)
        pert = m_true0 - m_bg

        # observations: bent tracer through the advected true field
        def obs(t):
            m_t = truth_at(t)
            _, tau = fermat.trace_rays(m_t, grid, origins, dvecs, 150e6,
                                       1000.0, n_steps=128,
                                       keep_path=False, method="leapfrog")
            return tau.reshape(-1, 100) - tau.reshape(-1, 100)[0:1]

        def truth_at(t):
            return m_bg + advect_periodic(pert, grid, wind * (t * dt_s))

    d_seq = jnp.stack([obs(t) for t in range(nt)])
    noise = jnp.float32(0.01 * float(jnp.std(d_seq)))
    d_seq = d_seq + noise * jax.random.normal(jax.random.key(0),
                                              d_seq.shape)
    def stack(b):
        return rays_mod.RayBundle(
            points=jnp.broadcast_to(b.points, (chunk,) + b.points.shape),
            ds=jnp.broadcast_to(b.ds, (chunk,) + b.ds.shape))

    rays_seq = stack(rb)
    inner_seq = None
    if inner_samples is not None:
        inner_seq = stack(rays_mod.sample_straight_rays(
            origins, dvecs, n_samples=inner_samples))

    def run_chunked(d):
        m_cur, pre, post, m_last = m_bg, [], [], None
        for c0 in range(0, nt, chunk):
            res = kalman_filter(
                grid, rays_seq, d[c0:c0 + chunk], noise, m_cur, cov, wind,
                dt_s, num_directions=100, cg_iters=cg_iters,
                advect_first=(c0 > 0), m_clim=m_bg,
                rays_inner_seq=inner_seq, interp=interp)
            m_cur = res.m_seq[-1]
            pre.append(res.residuals)
            post.append(res.post_residuals)
        jax.block_until_ready(m_cur)
        return m_cur, jnp.concatenate(pre), jnp.concatenate(post)

    m_f, pre, post = run_chunked(d_seq)          # compile
    t0 = time.perf_counter()
    m_f, pre, post = run_chunked(d_seq)
    secs = time.perf_counter() - t0

    m_true_f = truth_at(nt - 1)
    ants_h, dirs_h = make_rays(20, 50, seed=99)
    if world == "analytic":
        o_h, dv_h = rays_mod.make_ray_batch(ants_h, dirs_h)
        tau_h = f_tau(wind * ((nt - 1) * dt_s), o_h, dv_h)
        d_h = tau_h.reshape(-1, 50) - tau_h.reshape(-1, 50)[0:1]
    else:
        d_h, _ = bent_dtec_data(m_true_f, grid, ants_h, dirs_h,
                                frequency_hz=150e6, n_steps=128,
                                noise_frac=0.0)
    ho_pr = heldout_dtec_rms(m_bg, grid, ants_h, dirs_h, d_h, n_samples=65,
                             interp=interp)
    ho_po = heldout_dtec_rms(m_f, grid, ants_h, dirs_h, d_h, n_samples=65,
                             interp=interp)
    emit("config5", "kalman_30steps_seconds", secs, "s",
         timesteps_per_sec=nt / secs,
         mean_residual_reduction=float(
             (pre / jnp.maximum(post, 1e-9)).mean()),
         covered_rmse_prior=covered_rmse(m_bg, m_true_f, grid, rb),
         covered_rmse_post=covered_rmse(m_f, m_true_f, grid, rb),
         heldout_dtec_rms_prior=ho_pr, heldout_dtec_rms_post=ho_po,
         world=world,
         data=f"bent-tracer 2x quadrature + 1% noise, von Karman "
              f"truth ({world} world"
              f"{', exact frozen-flow phase-shift evolution' if world == 'analytic' else ''}), "
              f"chunked filter (5 chunks x 6 steps), "
              f"hermite@{n_samples}{f'/inner@{inner_samples}' if inner_samples else ''}, "
              f"interp={interp}, cg_iters={cg_iters}")


if __name__ == "__main__":
    main()
