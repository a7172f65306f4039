"""Run the engine's main path once on an NVIDIA GPU and check every answer.

    python chip_smoke.py [--seed N]          # phases 1-5 on one GPU
    python chip_smoke.py --four [--seed N]   # the four-GPU phase only

One process, phases in order, at the sizes the repository's own harnesses
use (bench.py, bench/config3-5.py, bench/serve_latency.py):

1. field models (cubic, zp, zpc) through their production row paths
   against the f64 oracles in ``reference_kernels/``;
2. the bent-ray tracer, 262,144 rays at leapfrog@64 through 128³ (zp and
   cubic), with 16 rays retraced at 60 MHz against the adaptive f64
   oracle;
3. snapshot MAP Gauss-Newton inversions through ``InversionPipeline`` at
   128³ and 256³ from 100 × 100 rays;
4. the Kalman (8 epochs) and ensemble Kalman (4 epochs, 8 members)
   filters through the pipeline, and ``OnlineKalman`` state_dict resume;
5. streaming epoch by epoch through ``OnlineKalman`` at the serving
   deployment size (62 antennas × 10 directions, 64³).

``--four`` runs only the sharded paths on four GPUs, each against the
same computation on one device: a MAP Gauss-Newton step on the ray mesh,
the member-parallel EnKF, and the 2×2 grid×ray halo-exchange trace.

Each phase prints one JSON line with its compile and steady seconds and
its gates (value beside bound). Any failure is fatal: the script exits
non-zero and never prints the last line, which on success is exactly
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Data comes from ``--seed``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

from bench.common import device_record


# --- plumbing ---------------------------------------------------------------

def contract_line(devices) -> str:
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def gate(value, op: str, bound: float) -> dict:
    """One checked quantity; NaN fails every comparison."""
    value = float(value)
    ok = {"<=": value <= bound, "<": value < bound,
          ">": value > bound}[op]
    return {"value": value, op: bound, "ok": bool(ok)}


def timed(fn, *args):
    """(result, first-call seconds, second-call seconds): the first call
    compiles; the second runs warm."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, first, time.perf_counter() - t0


def memory_sizes(compiled) -> dict:
    """``compiled.memory_analysis()`` as plain byte counts."""
    ma = compiled.memory_analysis()
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
    return {k: int(getattr(ma, k)) for k in keys if hasattr(ma, k)}


def peak_bytes():
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def bench_grid(n: int):
    """The tracer benchmark's box (bench.py): 800 × 800 × 1100 km."""
    from ionotomo_tpu.core.grids import Grid3D
    return Grid3D.from_bounds((-400.0, -400.0, 0.0), (400.0, 400.0, 1100.0),
                              (n, n, n))


def slant_rays(n_rays: int, rng, zen_max: float = 0.6):
    """bench.py's ray batch: origins within ±30 km, zenith ≤ ``zen_max``."""
    o = np.concatenate([rng.uniform(-30, 30, (n_rays, 2)),
                        np.zeros((n_rays, 1))], -1).astype(np.float32)
    zen = rng.uniform(0.05, zen_max, n_rays)
    az = rng.uniform(0, 2 * np.pi, n_rays)
    d = np.stack([np.sin(zen) * np.sin(az), np.sin(zen) * np.cos(az),
                  np.cos(zen)], -1).astype(np.float32)
    return o, d


def engine_config(n: int, workdir: str, name: str, **sections):
    from ionotomo_tpu.config import EngineConfig, GridConfig, RuntimeConfig
    rt = RuntimeConfig(
        checkpoint_dir=os.path.join(workdir, name, "ckpt"),
        metrics_path=os.path.join(workdir, name, "metrics.jsonl"))
    return EngineConfig(grid=GridConfig(shape=(n, n, n)), runtime=rt,
                        **sections)


def whitened_residual(pipe, m, t: int = 0) -> float:
    """‖(g(m) − d_t)/σ_t‖ with the pipeline's own operator and data."""
    from ionotomo_tpu.forward import tec as tec_mod
    rc = pipe.config.rays
    g = tec_mod.dtec_paired_q(m, pipe.grid, pipe.rays_for_time(t),
                              pipe.directions.shape[1], pipe.i0,
                              quadrature=rc.quadrature, interp=rc.interp)
    r = ((np.asarray(g) - np.asarray(pipe.d_obs[:, t, :]))
         / np.asarray(pipe.noise_std[:, t, :]))
    return float(np.sqrt(np.sum(r * r)))


def heldout_rms_fn(pipe, truth, t: int = 0):
    """dTEC rms on rays the solve never saw: every antenna towards the
    midpoints of consecutive observed directions, data from the truth
    field on its own grid (bench/common.heldout_dtec_rms)."""
    import jax.numpy as jnp
    from bench.common import heldout_dtec_rms
    from ionotomo_tpu.forward import tec as tec_mod
    from ionotomo_tpu.geometry import rays as rays_mod

    dirs = np.asarray(pipe.directions[t], np.float64)
    mid = dirs[:-1] + dirs[1:]
    mid = (mid / np.linalg.norm(mid, axis=-1, keepdims=True))[:50]
    mid = mid.astype(np.float32)
    ants = np.asarray(pipe.antennas, np.float32)
    o, dv = rays_mod.make_ray_batch(ants, mid)
    rb = rays_mod.sample_straight_rays(o, dv, n_samples=129)
    d_h = tec_mod.dtec_paired(jnp.asarray(truth["m"][t]), truth["grid"], rb,
                              mid.shape[0], pipe.i0)
    return lambda m: heldout_dtec_rms(m, pipe.grid, ants, mid, d_h,
                                      interp=pipe.config.rays.interp)


# --- phase 1: field models vs the f64 oracles ------------------------------

#: PRECISION.md's tricubic bounds (value ≤5e-6, gradient ≤5e-5 on
#: unit-scale fields), applied to every model relative to the field's
#: magnitude over each point's stencil, gradients in index units.
VALUE_BOUND, GRAD_BOUND = 5e-6, 5e-5


def phase_field_models(seed: int, n: int = 128, n_points: int = 4096):
    import jax
    import jax.numpy as jnp
    from bench.common import honest_truth
    from ionotomo_tpu.core import boxspline, tricubic, zpcubic
    from ionotomo_tpu.models import chapman
    from reference_kernels import boxspline_ref, tricubic_ref, zpcubic_ref

    grid = bench_grid(n)
    m = honest_truth(grid, chapman.log_parametrize(
        chapman.chapman_field(grid)), seed=seed + 7)
    rng = np.random.default_rng(seed)
    origin = np.asarray(grid.origin, np.float64)
    spacing = np.asarray(grid.spacing, np.float64)
    lo, hi = origin + 2 * spacing, np.asarray(grid.upper()) - 2 * spacing
    n_out = n_points // 4
    inside = rng.uniform(lo, hi, (n_points - n_out, 3))
    # a quarter of the points beyond one face of the grid
    span = hi - lo
    out = rng.uniform(lo, hi, (n_out, 3))
    axis = rng.integers(0, 3, n_out)
    beyond = rng.uniform(0.02, 0.2, n_out) * span[axis]
    side = rng.integers(0, 2, n_out).astype(bool)
    out[np.arange(n_out), axis] = np.where(
        side, np.asarray(grid.upper())[axis] + beyond,
        origin[axis] - beyond)
    pts = np.concatenate([inside, out]).astype(np.float32)
    is_in = np.arange(n_points) < n_points - n_out

    # The oracles evaluate at the index coordinates the f32 kernels
    # compute, so the comparison measures the contractions, not the f32
    # rounding of the query coordinates (which every f32 path shares).
    t32 = np.asarray(jax.jit(grid.world_to_index)(jnp.asarray(pts)),
                     np.float64)
    pts_ref = origin + t32 * spacing
    m_np = np.asarray(m)
    base = np.clip(np.floor(t32).astype(int), 0, n - 1)
    ax = [np.clip(base[:, a, None] + np.arange(-2, 3), 0, n - 1)
          for a in range(3)]
    block = m_np[ax[0][:, :, None, None], ax[1][:, None, :, None],
                 ax[2][:, None, None, :]]
    scale = np.maximum(1.0, np.abs(block).reshape(n_points, -1).max(1))

    models = (("cubic", tricubic, tricubic_ref, None),
              ("zp", boxspline, boxspline_ref, boxspline.prefilter),
              ("zpc", zpcubic, zpcubic_ref, zpcubic.prefilter))
    gates, times = {}, {}
    for name, mod, ref, prefilter in models:
        coef = m if prefilter is None else jax.jit(prefilter)(m)
        table = coef.reshape(n * n, n)
        f = jax.jit(lambda tb, p, mod=mod: (
            mod.interp_rows(tb, grid, p),
            mod.interp_rows_with_grad(tb, grid, p)))
        (v, (v2, g2)), first, steady = timed(f, table, jnp.asarray(pts))
        times[name] = dict(compile_s=first - steady, steady_s=steady)
        v, v2, g2 = np.asarray(v), np.asarray(v2), np.asarray(g2)
        # the zp-family oracles are defined on the interior only; outside
        # the grid those models are checked for finite clamped values
        sel = slice(None) if name == "cubic" else is_in
        rv, rg = ref.interp_grad_ref(np.asarray(coef, np.float64), origin,
                                     spacing, pts_ref[sel])
        err_v = max(np.abs(v[sel] - rv).max(), np.abs(v2[sel] - rv).max())
        err_g = np.abs(g2[sel] - rg) * spacing
        gates[f"{name}_value_err"] = gate(
            (np.abs(v[sel] - rv) / scale[sel]).max(), "<=", VALUE_BOUND)
        gates[f"{name}_value_with_grad_err"] = gate(
            (np.abs(v2[sel] - rv) / scale[sel]).max(), "<=", VALUE_BOUND)
        gates[f"{name}_grad_err"] = gate(
            (err_g.max(1) / scale[sel]).max(), "<=", GRAD_BOUND)
        gates[f"{name}_nonfinite"] = gate(
            (~np.isfinite(np.concatenate([v, v2, g2.ravel()]))).sum(),
            "<=", 0)
        times[name]["max_abs_value_err"] = float(err_v)
    return dict(phase="field_models", grid=n, points=n_points,
                points_outside=n_out, times=times, gates=gates)


# --- phase 2: bent-ray tracer -------------------------------------------

def phase_tracer(seed: int, n: int = 128, n_rays: int = 262144,
                 n_steps: int = 64, n_oracle: int = 16, reps: int = 3):
    import jax
    import jax.numpy as jnp
    from ionotomo_tpu.geometry import fermat
    from ionotomo_tpu.models import chapman
    from reference_kernels import fermat_ref

    grid = bench_grid(n)
    m = chapman.log_parametrize(chapman.chapman_field(grid))
    o, d = slant_rays(n_rays, np.random.default_rng(seed))
    o_j, d_j = jnp.asarray(o), jnp.asarray(d)
    rec = dict(phase="tracer", grid=n, rays=n_rays,
               integrator=f"leapfrog@{n_steps}", frequency_hz=150e6,
               max_length_km=1000.0, models={}, gates={})
    for interp in ("zp", "cubic"):
        f = jax.jit(lambda mm, oo, dd, interp=interp: fermat.trace_rays(
            mm, grid, oo, dd, 150e6, 1000.0, n_steps=n_steps,
            keep_path=False, method="leapfrog", interp=interp)[1])
        t0 = time.perf_counter()
        compiled = f.lower(m, o_j, d_j).compile()
        compile_s = time.perf_counter() - t0
        tec = jax.block_until_ready(compiled(m, o_j, d_j))
        t0 = time.perf_counter()
        for _ in range(reps):
            tec = compiled(m, o_j, d_j)
        jax.block_until_ready(tec)
        steady = (time.perf_counter() - t0) / reps
        rec["models"][interp] = dict(
            compile_s=compile_s, steady_s=steady,
            rays_per_s=n_rays / steady, memory=memory_sizes(compiled))
        rec["gates"][f"{interp}_nonfinite_tec"] = gate(
            (~np.isfinite(np.asarray(tec))).sum(), "<=", 0)

    # accuracy: the adaptive f64 oracle (tricubic field model) at 60 MHz,
    # PRECISION.md's bent-ray bounds (endpoint ≤5 m, TEC ≤1e-4 rel)
    k = n_oracle
    b, tec = fermat.trace_rays(m, grid, o_j[:k], d_j[:k], 60e6, 1000.0,
                               n_steps=n_steps, keep_path=False,
                               method="leapfrog", interp="cubic")
    ends, tec = np.asarray(b.points[:, -1]), np.asarray(tec)
    m64 = np.asarray(m, np.float64)
    end_err, tec_err = [], []
    for i in range(k):
        end_ref, tec_ref = fermat_ref.trace_ray_ref(
            m64, np.asarray(grid.origin), np.asarray(grid.spacing),
            o[i].astype(np.float64), d[i].astype(np.float64), 60e6, 1000.0,
            rtol=1e-9, atol=1e-11)
        end_err.append(np.linalg.norm(ends[i] - end_ref) * 1e3)   # m
        tec_err.append(abs(tec[i] - tec_ref) / tec_ref)
    rec["gates"]["cubic_60mhz_endpoint_m"] = gate(max(end_err), "<=", 5.0)
    rec["gates"]["cubic_60mhz_tec_rel"] = gate(max(tec_err), "<=", 1e-4)
    rec["peak_bytes_in_use"] = peak_bytes()
    return rec


# --- phase 3: snapshot inversions through the pipeline ---------------------

def phase_snapshot(seed: int, workdir: str, n: int = 128,
                   n_big: int = 256, n_ants: int = 100, n_dirs: int = 100):
    from ionotomo_tpu.data.synth import generate_example_datapack
    from ionotomo_tpu.inversion.pipeline import InversionPipeline

    dp, truth = generate_example_datapack(n_antennas=n_ants,
                                          n_directions=n_dirs,
                                          noise_tecu=1e-2, seed=seed)
    rec = dict(phase="snapshot", rays=n_ants * n_dirs, solves={},
               gates={})
    for size in (n, n_big):
        pipe = InversionPipeline(dp, engine_config(size, workdir,
                                                   f"snap{size}"))
        sol, first, steady = timed(lambda: pipe.run(resume=False))
        m = sol.m[0]
        res0 = whitened_residual(pipe, pipe.m_prior)
        res1 = whitened_residual(pipe, m)
        heldout = heldout_rms_fn(pipe, truth)
        ho0, ho1 = heldout(pipe.m_prior), heldout(m)
        sc = pipe.config.solver
        rec["solves"][size] = dict(
            compile_s=first - steady, steady_s=steady,
            solver=f"map_gauss_newton gn{sc.gn_iters} cg{sc.cg_iters}",
            residual_prior=res0, residual_post=res1,
            heldout_rms_prior=ho0, heldout_rms_post=ho1,
            peak_bytes_in_use=peak_bytes())
        rec["gates"][f"{size}_residual_reduction"] = gate(res0 / res1, ">",
                                                          1.0)
        rec["gates"][f"{size}_heldout_ratio"] = gate(ho1 / ho0, "<", 1.0)
        rec["gates"][f"{size}_nonfinite"] = gate(
            (~np.isfinite(m)).sum(), "<=", 0)
    return rec


# --- phase 4: time-evolving filters -------------------------------------

#: OnlineKalman resume vs an uninterrupted stream. Not bit-identical on
#: the GPU: its scatter-add is atomic and sums in a varying order, and
#: truncated CG amplifies the last-bit differences (test_multichip.py
#: holds reduction-order parity of 10-iteration solves to ~1e-3).
RESUME_BOUND = 1e-3


def phase_filters(seed: int, workdir: str, n: int = 128, n_ants: int = 100,
                  n_dirs: int = 100, kalman_epochs: int = 8,
                  enkf_epochs: int = 4, members: int = 8,
                  resume_epochs: int = 4):
    import jax.numpy as jnp
    from ionotomo_tpu.config import PriorConfig, RayConfig, SolverConfig
    from ionotomo_tpu.data.synth import generate_example_datapack
    from ionotomo_tpu.inversion.online import OnlineKalman
    from ionotomo_tpu.inversion.pipeline import InversionPipeline

    # config 5's judged settings (bench/config5.py)
    rays = RayConfig(n_samples=65, inner_samples=33, interp="zp")
    prior = PriorConfig(sigma=0.3, length_scale_km=80.0, kind="von_karman")
    rec = dict(phase="filters", grid=n, rays=n_ants * n_dirs, runs={},
               gates={})

    dp, _ = generate_example_datapack(n_antennas=n_ants, n_directions=n_dirs,
                                      n_times=kalman_epochs,
                                      noise_tecu=1e-2, seed=seed)
    cfg = engine_config(n, workdir, "kalman", rays=rays, prior=prior,
                        solver=SolverConfig(solver="kalman", cg_iters=10,
                                            kalman_chunk=kalman_epochs))
    pipe = InversionPipeline(dp, cfg)
    sol, first, steady = timed(lambda: pipe.run(resume=False))
    pre = sol.diagnostics["pre_residuals"]
    post = sol.diagnostics["post_residuals"]
    rec["runs"]["kalman"] = dict(epochs=kalman_epochs,
                                 compile_s=first - steady, steady_s=steady,
                                 peak_bytes_in_use=peak_bytes())
    rec["gates"]["kalman_nonfinite"] = gate((~np.isfinite(sol.m)).sum(),
                                            "<=", 0)
    rec["gates"]["kalman_mean_residual_reduction"] = gate(
        np.mean(pre / np.maximum(post, 1e-9)), ">", 1.0)

    dp_e, _ = generate_example_datapack(n_antennas=n_ants,
                                        n_directions=n_dirs,
                                        n_times=enkf_epochs,
                                        noise_tecu=1e-2, seed=seed + 1)
    cfg_e = engine_config(n, workdir, "enkf", rays=rays, prior=prior,
                          solver=SolverConfig(solver="enkf", cg_iters=10,
                                              enkf_members=members,
                                              kalman_chunk=enkf_epochs))
    pipe_e = InversionPipeline(dp_e, cfg_e)
    sol_e, first, steady = timed(lambda: pipe_e.run(resume=False))
    last = enkf_epochs - 1
    res0 = whitened_residual(pipe_e, pipe_e.m_prior, last)
    res1 = whitened_residual(pipe_e, jnp.asarray(sol_e.m[last]), last)
    rec["runs"]["enkf"] = dict(epochs=enkf_epochs, members=members,
                               compile_s=first - steady, steady_s=steady,
                               residual_prior=res0, residual_post=res1,
                               peak_bytes_in_use=peak_bytes())
    rec["gates"]["enkf_nonfinite"] = gate(
        (~np.isfinite(sol_e.m)).sum()
        + (~np.isfinite(sol_e.diagnostics["std_seq"])).sum(), "<=", 0)
    rec["gates"]["enkf_residual_reduction"] = gate(res0 / res1, ">", 1.0)

    # restart: stream half the epochs, persist state_dict, resume in a
    # fresh filter, and compare with the uninterrupted stream
    nd = pipe.directions.shape[1]
    dt_s = float(np.diff(dp.times).mean() * 86400.0)

    def new_filter():
        return OnlineKalman(pipe.grid, pipe.cov, pipe.m_prior,
                            (0.15, 0.05, 0.0), dt_s, nd, i0=pipe.i0,
                            cg_iters=10, interp="zp", inner_samples=33)

    def feed(f, epochs):
        for t in epochs:
            f.step(pipe.rays_for_time(t), jnp.asarray(pipe.d_obs[:, t, :]),
                   jnp.asarray(pipe.noise_std[:, t, :]))

    whole = new_filter()
    feed(whole, range(resume_epochs))
    half = new_filter()
    feed(half, range(resume_epochs // 2))
    resumed = new_filter()
    resumed.load_state(half.state_dict())
    feed(resumed, range(resume_epochs // 2, resume_epochs))
    scale = float(np.abs(np.asarray(whole.m) - np.asarray(pipe.m_prior)).max())
    diff = float(np.abs(np.asarray(whole.m) - np.asarray(resumed.m)).max())
    rec["runs"]["resume"] = dict(epochs=resume_epochs, max_abs_diff=diff,
                                 increment_scale=scale)
    rec["gates"]["resume_rel_diff"] = gate(diff / scale, "<=", RESUME_BOUND)
    return rec


# --- phase 5: streaming at the serving deployment size ---------------------

def phase_streaming(seed: int, n: int = 64, n_ants: int = 62,
                    n_dirs: int = 10, n_epochs: int = 6):
    """Epoch-by-epoch assimilation through ``inversion.online.
    OnlineKalman``, built the way ``serving.EpochService`` bootstraps it
    in bench/serve_latency.py's deployment. The service itself reads its
    epoch files with h5py, which the GPU host does not have (the
    optional ``io`` extra), so the epochs arrive here as arrays."""
    import jax.numpy as jnp
    from ionotomo_tpu.data.synth import generate_example_datapack
    from ionotomo_tpu.geometry import rays as rays_mod
    from ionotomo_tpu.inversion.online import OnlineKalman
    from ionotomo_tpu.inversion.priors import GPCovariance
    from ionotomo_tpu.models import chapman

    # the epochs' data is made up front: loading is set-up, not serving
    epochs = [generate_example_datapack(
        n_antennas=n_ants, n_directions=n_dirs, n_times=1,
        mjd0=58000.45 + i * 30.0 / 86400.0, seed=seed + 7,
        grid_shape=(48, 48, 48), n_samples=49)[0].to_device_arrays()
        for i in range(n_epochs)]
    grid = chapman.grid_enclosing_rays(
        epochs[0]["antennas_enu"], epochs[0]["directions_enu"].reshape(-1, 3),
        shape=(n, n, n), h_min_km=0.0)
    cov = GPCovariance.create(grid, sigma=0.3, length_scale=80.0,
                              kind="von_karman")
    m_prior = chapman.log_parametrize(chapman.chapman_field(grid))
    flt = OnlineKalman(grid, cov, m_prior, (0.15, 0.05, 0.0), dt_s=30.0,
                       num_directions=n_dirs, cg_iters=8,
                       quadrature="hermite", interp="zp", inner_samples=33)
    seconds, pre, post = [], [], []
    for dev in epochs:
        t0 = time.perf_counter()
        o, dv = rays_mod.make_ray_batch(dev["antennas_enu"],
                                        dev["directions_enu"][0])
        rb = rays_mod.sample_straight_rays(o, dv, n_samples=65)
        noise = np.where(dev["flags"], 1e6, dev["noise_std"])[:, 0, :]
        _, diag = flt.step(rb, jnp.asarray(dev["dtec"][:, 0, :]),
                           jnp.asarray(noise))
        seconds.append(time.perf_counter() - t0)
        pre.append(diag["pre_residual"])
        post.append(diag["post_residual"])
    pre, post = np.asarray(pre), np.asarray(post)
    steady = float(np.median(seconds[1:] or seconds))
    return dict(
        phase="streaming", grid=n, rays_per_epoch=n_ants * n_dirs,
        epochs=n_epochs, compile_s=seconds[0] - steady, steady_s=steady,
        seconds_per_epoch=seconds,
        gates=dict(
            nonfinite_state=gate((~np.isfinite(np.asarray(flt.m))).sum(),
                                 "<=", 0),
            mean_residual_reduction=gate(
                np.mean(pre / np.maximum(post, 1e-9)), ">", 1.0)))


# --- --four: the sharded paths against one device --------------------------

#: Sharded vs single-device parity bounds, as the largest field
#: difference over the largest field increment. No sharded run is
#: bit-identical to one device: shards sum their partial products in
#: another order, psum adds them, and GPU scatter-adds are atomic with a
#: varying order. Truncated CG amplifies these last-bit differences: on a
#: 4-device CPU mesh they grow from 1e-6 after one iteration to 1e-5 after
#: five, and to 1e-2 once a small system's Krylov space is exhausted. A
#: sharding defect (a shard's rays dropped or counted twice) moves the
#: increment by about 1/devices = 25%. MAP step: 1e-2. Member-parallel
#: EnKF: 2e-2, because the member-sharded and vmapped filters also run
#: different adjoint forms by design (DESIGN.md §18). Halo-exchange trace:
#: TEC to 3e-5 relative, no Krylov loop (test_grid_sharding.py).
FOUR_MAP_BOUND, FOUR_ENKF_BOUND, FOUR_TRACE_BOUND = 1e-2, 2e-2, 3e-5


def phase_four(seed: int, n: int = 128, n_ants: int = 100,
               n_dirs: int = 100, n_trace_rays: int = 4096,
               n_trace_steps: int = 64, members: int = 8, epochs: int = 2,
               cg_iters: int = 10, n_devices: int = 4):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from bench.common import honest_truth, make_rays
    from ionotomo_tpu import constants
    from ionotomo_tpu.forward import tec as tec_mod
    from ionotomo_tpu.geometry import fermat, rays as rays_mod
    from ionotomo_tpu.inversion import solvers
    from ionotomo_tpu.inversion.kalman import (ensemble_kalman_filter,
                                               initial_ensemble,
                                               member_parallel_enkf)
    from ionotomo_tpu.inversion.priors import GPCovariance
    from ionotomo_tpu.models import chapman
    from ionotomo_tpu.parallel import grid_sharding as gs
    from ionotomo_tpu.parallel import sharding as shard_mod

    devices = jax.devices()[:n_devices]
    if len(devices) < n_devices:
        raise SystemExit(f"phase four: needs {n_devices} devices, "
                         f"found {len(devices)}")
    rec = dict(phase="four", devices=n_devices, grid=n,
               rays=n_ants * n_dirs, checks={}, gates={})

    ants, dirs = make_rays(n_ants, n_dirs, seed=seed)
    grid = chapman.grid_enclosing_rays(ants, dirs, shape=(n, n, n),
                                       h_min_km=0.0)
    m_prior = chapman.log_parametrize(chapman.chapman_field(grid))
    m_true = honest_truth(grid, m_prior, amplitude=0.25, seed=seed + 11)
    origins, dvecs = rays_mod.make_ray_batch(ants, dirs)
    rb = rays_mod.sample_straight_rays(origins, dvecs, n_samples=65)
    d_obs = tec_mod.dtec_paired(m_true, grid, rb, n_dirs, 0)
    # 1e-2 TECU, the production-noise class (test_multichip.py)
    noise = jnp.float32(1e-2 * constants.TECU / constants.TEC_SCALE)
    cov = GPCovariance.create(grid, sigma=0.3, length_scale=80.0,
                              kind="von_karman")
    one = devices[0]

    def rel_diff(a, b, ref):
        a, b, ref = (np.asarray(x, np.float64) for x in (a, b, ref))
        return float(np.abs(a - b).max() / np.abs(b - ref).max())

    # 1. MAP Gauss-Newton step, rays sharded over the 1-D ray mesh
    kw = dict(num_directions=n_dirs, gn_iters=1, cg_iters=cg_iters)
    single = jax.device_put((rb, d_obs, m_prior), one)
    (res_1, first, steady) = timed(lambda: solvers.map_gauss_newton(
        grid, single[0], single[1], noise, single[2], cov, **kw))
    mesh = shard_mod.ray_mesh(devices)
    sh = shard_mod.ray_sharding(mesh)
    rb_s = rays_mod.RayBundle(points=jax.device_put(rb.points, sh),
                              ds=jax.device_put(rb.ds, sh))
    (m_r,) = shard_mod.replicate(mesh, m_prior)
    cov_r = GPCovariance(
        spectrum=jax.device_put(cov.spectrum, NamedSharding(mesh, P())),
        shape=cov.shape, sigma=cov.sigma, length_scale=cov.length_scale,
        kind=cov.kind)
    (res_4, first4, steady4) = timed(lambda: solvers.map_gauss_newton(
        grid, rb_s, jax.device_put(d_obs, NamedSharding(mesh, P())), noise,
        m_r, cov_r, **kw))
    rec["checks"]["map_step"] = dict(steady_s_1=steady, steady_s_4=steady4,
                                     compile_s_4=first4 - steady4)
    rec["gates"]["map_step_rel_diff"] = gate(
        rel_diff(res_4.m, res_1.m, m_prior), "<=", FOUR_MAP_BOUND)

    # 2. member-parallel EnKF against the unsharded filter
    rs = rays_mod.RayBundle(points=jnp.stack([rb.points] * epochs),
                            ds=jnp.stack([rb.ds] * epochs))
    d_seq = jnp.stack([d_obs] * epochs)
    key = jax.random.key(seed)
    ens0 = initial_ensemble(grid, cov, m_prior, key, members)
    kw_e = dict(num_directions=n_dirs, key=key, n_members=members,
                cg_iters=cg_iters, fade=0.9)
    base, _, steady1 = timed(lambda: ensemble_kalman_filter(
        grid, rs, d_seq, noise, m_prior, cov, (0.15, 0.05, 0.0), 30.0,
        ens0=ens0, **kw_e))
    mesh_m = shard_mod.member_mesh(devices)
    ens0_s = jax.device_put(ens0, shard_mod.member_sharding(mesh_m))
    shd, first4, steady4 = timed(lambda: member_parallel_enkf(
        mesh_m, grid, rs, d_seq, noise, m_prior, cov, (0.15, 0.05, 0.0),
        30.0, ens0=ens0_s, **kw_e))
    rec["checks"]["member_enkf"] = dict(members=members, epochs=epochs,
                                        steady_s_1=steady1,
                                        steady_s_4=steady4,
                                        compile_s_4=first4 - steady4)
    rec["gates"]["member_enkf_rel_diff"] = gate(
        rel_diff(shd.mean_seq, base.mean_seq,
                 jnp.broadcast_to(m_prior, base.mean_seq.shape)),
        "<=", FOUR_ENKF_BOUND)

    # 3. 2×2 grid×ray mesh: x-sharded field with halo exchange, rays
    #    sharded on the other axis, against the replicated trace
    o, d = slant_rays(n_trace_rays, np.random.default_rng(seed + 1))
    o, d = jnp.asarray(o), jnp.asarray(d)
    trace_kw = dict(n_steps=n_trace_steps, keep_path=False)
    _, tec_1 = fermat.trace_rays(m_true, grid, o, d, 150e6, 1000.0,
                                 method="leapfrog", **trace_kw)
    mesh2 = gs.grid_ray_mesh(2, n_devices // 2, devices=devices)
    f_sh = jax.device_put(m_true, NamedSharding(mesh2, P(gs.GRID_AXIS)))
    ray_sh = NamedSharding(mesh2, P(shard_mod.RAY_AXIS))
    (_, tec_4), first4, steady4 = timed(lambda: gs.trace_rays_sharded(
        mesh2, f_sh, grid, jax.device_put(o, ray_sh),
        jax.device_put(d, ray_sh), 150e6, 1000.0, rays_sharded=True,
        **trace_kw))
    tec_1, tec_4 = np.asarray(tec_1), np.asarray(tec_4)
    rec["checks"]["halo_trace"] = dict(rays=n_trace_rays,
                                       steady_s_4=steady4,
                                       compile_s_4=first4 - steady4)
    rec["gates"]["halo_trace_tec_rel_diff"] = gate(
        (np.abs(tec_4 - tec_1) / np.abs(tec_1)).max(), "<=",
        FOUR_TRACE_BOUND)
    return rec


# --- driver -------------------------------------------------------------

def emit(rec: dict, cards: list, kind: str) -> None:
    rec = dict(rec, device_kind=kind, cards=cards)
    print(json.dumps(rec), flush=True)
    failed = [k for k, g in rec["gates"].items() if not g["ok"]]
    if failed:
        raise SystemExit(f"chip_smoke: phase {rec['phase']} failed gates "
                         f"{failed}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--four", action="store_true",
                   help="run only the four-GPU sharded phase")
    args = p.parse_args(argv)

    rec = device_record()              # SystemExit off the GPU
    if args.four and rec["device_count"] < 4:
        raise SystemExit(f"chip_smoke --four: needs 4 GPUs; JAX found "
                         f"{rec['device_count']}")
    from ionotomo_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax
    devices = jax.devices()
    cards, kind = rec["cards"], rec["device_kind"]

    if args.four:
        emit(phase_four(args.seed), cards, kind)
    else:
        emit(phase_field_models(args.seed), cards, kind)
        emit(phase_tracer(args.seed), cards, kind)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
            emit(phase_snapshot(args.seed, work), cards, kind)
            emit(phase_filters(args.seed, work), cards, kind)
        emit(phase_streaming(args.seed), cards, kind)
    for line in cards:
        print(line)
    print(contract_line(devices), flush=True)


if __name__ == "__main__":
    sys.exit(main())
