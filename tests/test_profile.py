"""Parametric profile estimation (inversion/profile.py): recovering the
Chapman (N_peak, h_peak, H) from multi-elevation slant absolute TEC +
dTEC — the capability that closes dTEC's measured profile null space
(VERDICT r2 #3; DESIGN.md §8 null-result study)."""
import numpy as np
import jax
import jax.numpy as jnp

from ionotomo_tpu.forward import tec as tec_mod
from ionotomo_tpu.geometry import rays as rays_mod
from ionotomo_tpu.inversion import anchors as anch
from ionotomo_tpu.inversion.priors import GPCovariance
from ionotomo_tpu.inversion.profile import (ProfileParams,
                                            chapman_log_field,
                                            log_profile_rms,
                                            map_gauss_newton_profile)
from ionotomo_tpu.models import chapman


def wrong_profile_world(nx=28, seed=0, turb_amp=0.1):
    """Truth profile well off the prior guess (N_peak 1.6x, h_peak +30 km,
    H -10 km) + mild turbulence — the real-world case the round-2 study
    measured dTEC to be blind to."""
    rng = np.random.default_rng(seed)
    ants = np.concatenate([rng.uniform(-40, 40, (6, 2)),
                           np.zeros((6, 1))], -1)
    zen = rng.uniform(0.05, 0.45, 4)
    az = rng.uniform(0, 2 * np.pi, 4)
    dirs = np.stack([np.sin(zen) * np.sin(az), np.sin(zen) * np.cos(az),
                     np.cos(zen)], -1)
    grid = chapman.grid_enclosing_rays(ants, dirs, shape=(nx, nx, nx),
                                       h_min_km=0.0)
    theta_true = ProfileParams.create(n_peak=1.6e12, h_peak_km=380.0,
                                      scale_km=70.0)
    m_true = chapman_log_field(grid, theta_true)
    if turb_amp:
        from ionotomo_tpu.models.turbulence import turbulent_log_perturbation
        m_true = m_true + turbulent_log_perturbation(
            grid, amplitude=turb_amp, outer_scale_km=120.0, seed=seed)
    return grid, ants, dirs, theta_true, m_true


def slant_anchor_set(grid, m_true, noise_frac=0.005, seed=1):
    """Multi-elevation slant absolute-TEC observations: 3 receivers x
    5 elevations (15-75 deg) x alternating azimuths."""
    rng = np.random.default_rng(seed)
    rec = np.array([[-30.0, -20.0], [10.0, 30.0], [25.0, -15.0]])
    els = np.deg2rad([15.0, 25.0, 40.0, 60.0, 75.0])
    xy, az, el = [], [], []
    for r in rec:
        for j, e in enumerate(els):
            xy.append(r)
            el.append(e)
            az.append(rng.uniform(0, 2 * np.pi))
    bundle = anch.slant_bundle(grid, np.asarray(xy), np.asarray(az),
                               np.asarray(el), n_samples=65)
    v = tec_mod.tec(m_true, grid, bundle)
    noise = float(noise_frac * jnp.mean(v))
    v = v + noise * jax.random.normal(jax.random.key(seed), v.shape)
    return anch.TecAnchors(rays=bundle, values=v,
                           noise_std=jnp.float32(noise))


def test_profile_solve_recovers_peak_height_and_cuts_profile_rms():
    grid, ants, dirs, theta_true, m_true = wrong_profile_world()
    nd = dirs.shape[0]
    origins, dvecs = rays_mod.make_ray_batch(ants, dirs)
    rb = rays_mod.sample_straight_rays(origins, dvecs, n_samples=65)
    # dTEC data from the truth (simpson generator vs hermite operator —
    # no inverse crime in the quadrature either)
    d = tec_mod.dtec_paired(m_true, grid, rb, nd, 0)
    noise_d = 0.01 * float(jnp.std(d)) + 1e-3
    d = d + noise_d * jax.random.normal(jax.random.key(3), d.shape)
    anchors = slant_anchor_set(grid, m_true)

    theta0 = ProfileParams.create()          # the (wrong) prior guess
    cov = GPCovariance.create(grid, sigma=0.3, length_scale=80.0,
                              kind="exponential")
    res = map_gauss_newton_profile(
        grid, rb, d, noise_d, theta0, (0.7, 50.0, 30.0), cov,
        num_directions=nd, anchors=anchors, gn_iters=6, cg_iters=40)

    # --- the VERDICT "done" criteria -----------------------------------
    h_err = abs(float(res.theta.h_peak_km) - 380.0)
    assert h_err < 10.0, (float(res.theta.h_peak_km), h_err)
    # N_peak to ~15% (log-space error < 0.15)
    assert abs(float(res.theta.log_n_peak) - float(
        theta_true.log_n_peak)) < 0.15
    # horizontally-averaged log-profile rms: the component dTEC cannot
    # see. Compare against (a) the prior profile and (b) the fixed-
    # profile solve with the same anchors (sequential assimilation — the
    # shipped r2 design, which pins the column but not the shape).
    m_prior = chapman_log_field(grid, theta0)
    rms_prior = float(log_profile_rms(m_prior, m_true, grid))
    bg_cov = anch.background_covariance(grid)
    m_anch = anch.assimilate_anchors(grid, m_prior, bg_cov, anchors)
    from ionotomo_tpu.inversion.solvers import map_gauss_newton
    res_fixed = map_gauss_newton(grid, rb, d, noise_d, m_anch, cov,
                                 num_directions=nd, gn_iters=2,
                                 cg_iters=25)
    rms_fixed = float(log_profile_rms(res_fixed.m, m_true, grid))
    rms_param = float(log_profile_rms(res.m, m_true, grid))
    # measured: prior 0.587, fixed-profile anchored solve 0.586 (the r2
    # null result reproduced — anchors pin the column, not the shape),
    # parametric 0.337 (−43%)
    assert rms_param < 0.7 * rms_prior, (rms_param, rms_prior)
    assert rms_param < 0.7 * rms_fixed, (rms_param, rms_fixed)


def test_profile_solve_is_neutral_when_prior_profile_is_right():
    """With the truth profile AT the prior guess, the parametric solve
    must not wander off: θ stays near θ0 (the data give it no reason to
    move beyond noise)."""
    grid, ants, dirs, _, _ = wrong_profile_world(turb_amp=0.0)
    theta0 = ProfileParams.create()
    m_true = chapman_log_field(grid, theta0)
    nd = dirs.shape[0]
    origins, dvecs = rays_mod.make_ray_batch(ants, dirs)
    rb = rays_mod.sample_straight_rays(origins, dvecs, n_samples=65)
    d = tec_mod.dtec_paired(m_true, grid, rb, nd, 0)
    anchors = slant_anchor_set(grid, m_true, noise_frac=0.005, seed=5)
    cov = GPCovariance.create(grid, sigma=0.3, length_scale=80.0,
                              kind="exponential")
    res = map_gauss_newton_profile(
        grid, rb, d, 1.0, theta0, (0.7, 50.0, 30.0), cov,
        num_directions=nd, anchors=anchors, gn_iters=3, cg_iters=20)
    assert abs(float(res.theta.h_peak_km) - 350.0) < 8.0
    assert abs(float(res.theta.scale_km) - 80.0) < 8.0
    assert abs(float(res.theta.log_n_peak)
               - float(theta0.log_n_peak)) < 0.1


def test_chapman_log_field_matches_model_builder():
    """The differentiable profile field equals models.chapman's builder
    at the same parameters (single source of profile physics)."""
    from ionotomo_tpu.core.grids import Grid3D
    grid = Grid3D.from_bounds((-50, -50, 0.0), (50, 50, 1200.0),
                              (6, 6, 48))
    theta = ProfileParams.create(n_peak=8e11, h_peak_km=340.0,
                                 scale_km=65.0)
    got = np.asarray(chapman_log_field(grid, theta))
    want = np.asarray(chapman.log_parametrize(chapman.chapman_field(
        grid, n_peak=8e11, h_peak_km=340.0, scale_km=65.0)))
    # compare where the density is representable; in the deep-vacuum
    # bottomside the model builder's exp() underflows at slightly
    # different levels than the direct-log form — both are floored
    # near log(1e-30/K_NE) either way
    mask = want > -85.0
    np.testing.assert_allclose(got[mask], want[mask], rtol=0, atol=1e-4)
    assert got.min() >= np.log(1e-30 / 1e11) - 1e-3


def test_pipeline_estimate_profile_mode(tmp_path):
    """--estimate-profile through the pipeline: with the configured
    Chapman parameters deliberately wrong, the profile solve (timestep-0
    data + slant anchors) recovers the truth's parameters, installs the
    estimated profile as the run prior, and logs theta to metrics; the
    flag without anchors raises."""
    import dataclasses
    import json as _json
    import pytest
    from ionotomo_tpu.config import (EngineConfig, GridConfig,
                                     PhysicsConfig, PriorConfig,
                                     RayConfig, RuntimeConfig,
                                     SolverConfig)
    from ionotomo_tpu.data.synth import generate_example_datapack
    from ionotomo_tpu.inversion.pipeline import InversionPipeline

    # truth generated at the DEFAULT Chapman (1e12, 350, 80); the
    # pipeline is configured with a wrong guess (6e11, 310, 100)
    dp, truth = generate_example_datapack(
        n_antennas=6, n_directions=4, n_times=1,
        grid_shape=(20, 20, 20), turbulence_amp=0.1, seed=2,
        n_samples=33)
    cfg = EngineConfig(
        physics=PhysicsConfig(chapman_n_peak=6e11, chapman_h_peak_km=310.0,
                              chapman_scale_km=100.0),
        grid=GridConfig(shape=(20, 20, 20)),
        rays=RayConfig(n_samples=33),
        prior=PriorConfig(kind="sqexp", length_scale_km=90.0),
        solver=SolverConfig(solver="map_gauss_newton", gn_iters=2,
                            cg_iters=25, estimate_profile=True),
        runtime=RuntimeConfig(checkpoint_dir=str(tmp_path / "ck"),
                              metrics_path=str(tmp_path / "m.jsonl")))
    pipe = InversionPipeline(dp, cfg)

    with pytest.raises(ValueError, match="anchors"):
        pipe.run(resume=False)                  # flag without anchors

    m_true = jnp.asarray(truth["m"][0])
    anchors = slant_anchor_set(pipe.grid, m_true, noise_frac=0.005,
                               seed=9)
    sol = pipe.run(resume=False, anchors=anchors)
    recs = [_json.loads(l) for l in open(tmp_path / "m.jsonl")]
    est = next(r for r in recs if r.get("event") == "profile_estimated")
    assert abs(est["h_peak_km"] - 350.0) < 25.0, est
    # the synth truth applies the solar-zenith factor to N_peak: the
    # observable quantity is the EFFECTIVE peak density
    from ionotomo_tpu.geometry import frames
    cc = frames.solar_cos_zenith(float(dp.times.mean()),
                                 dp.array.enu_frame)
    n_eff = 1e12 * float(chapman.solar_zenith_factor(jnp.float32(cc)))
    assert 0.5 * n_eff < est["n_peak"] < 2.0 * n_eff, (est, n_eff)
    # the run prior was replaced by the estimated profile
    from ionotomo_tpu.inversion.profile import log_profile_rms
    wrong = chapman.log_parametrize(chapman.chapman_field(
        pipe.grid, n_peak=6e11, h_peak_km=310.0, scale_km=100.0))
    assert float(log_profile_rms(jnp.asarray(sol.m[0]), m_true,
                                 pipe.grid)) < 0.8 * float(
        log_profile_rms(wrong, m_true, pipe.grid))


def test_profile_solve_multi_layer_and_curved_builders():
    """Generalised field builders: (a) multi-layer — free F2 triple with
    tightly-priored E layer recovers the F2 peak from slant anchors;
    (b) curved-Earth single-layer builder round-trips against the model
    builder's curved field."""
    from ionotomo_tpu.inversion.profile import multi_chapman_log_field

    # (b) curved builder parity with models.chapman
    from ionotomo_tpu.core.grids import Grid3D
    g2 = Grid3D.from_bounds((-300, -300, 0.0), (300, 300, 1000.0),
                            (10, 10, 24))
    th = ProfileParams.create(n_peak=9e11, h_peak_km=355.0, scale_km=75.0)
    got = np.asarray(chapman_log_field(g2, th, curved=True))
    want = np.asarray(chapman.log_parametrize(chapman.chapman_field(
        g2, n_peak=9e11, h_peak_km=355.0, scale_km=75.0, curved=True)))
    mask = want > -85.0
    np.testing.assert_allclose(got[mask], want[mask], rtol=0, atol=1e-3)

    # (a) multi-layer recovery: E layer (known, tight prior) + F2 layer
    # (wrong guess, loose prior)
    rng = np.random.default_rng(0)
    ants = np.concatenate([rng.uniform(-40, 40, (6, 2)),
                           np.zeros((6, 1))], -1)
    zen = rng.uniform(0.05, 0.45, 4)
    az = rng.uniform(0, 2 * np.pi, 4)
    dirs = np.stack([np.sin(zen) * np.sin(az), np.sin(zen) * np.cos(az),
                     np.cos(zen)], -1)
    grid = chapman.grid_enclosing_rays(ants, dirs, shape=(24, 24, 24),
                                       h_min_km=0.0)
    t_true = jnp.asarray([np.log(1.2e11), 110.0, 10.0,     # E (known)
                          np.log(1.5e12), 385.0, 70.0],    # F2 (off)
                         jnp.float32)
    from ionotomo_tpu.models.turbulence import turbulent_log_perturbation
    m_true = multi_chapman_log_field(grid, t_true) \
        + turbulent_log_perturbation(grid, amplitude=0.1,
                                     outer_scale_km=120.0, seed=3)
    nd = dirs.shape[0]
    origins, dvecs = rays_mod.make_ray_batch(ants, dirs)
    rb = rays_mod.sample_straight_rays(origins, dvecs, n_samples=65)
    d = tec_mod.dtec_paired(m_true, grid, rb, nd, 0)
    noise_d = 0.01 * float(jnp.std(d)) + 1e-3
    d = d + noise_d * jax.random.normal(jax.random.key(7), d.shape)
    anchors = slant_anchor_set(grid, m_true, noise_frac=0.005, seed=11)

    t0 = jnp.asarray([np.log(1.2e11), 110.0, 10.0,
                      np.log(1.0e12), 350.0, 80.0], jnp.float32)
    sig = (0.05, 3.0, 2.0,           # E pinned by its prior
           0.7, 50.0, 30.0)          # F2 free
    cov = GPCovariance.create(grid, sigma=0.3, length_scale=80.0,
                              kind="exponential")
    builder = (lambda t: multi_chapman_log_field(grid, t))
    res = map_gauss_newton_profile(
        grid, rb, d, noise_d, t0, sig, cov, num_directions=nd,
        anchors=anchors, gn_iters=10, cg_iters=40,
        field_builder=builder)
    t_est = np.asarray(res.theta)
    # measured identifiability in the multi-layer + free-voxel-field
    # setting: h_peak to ~25 km (the delta-m field absorbs part of the
    # height shift; single-layer recovery is ~5 km) — assert a decisive
    # move toward the truth, N_peak and H essentially recovered, E
    # pinned by its prior
    assert t_est[4] > 355.0 and abs(t_est[4] - 385.0) < 30.0, t_est
    assert abs(t_est[3] - np.log(1.5e12)) < 0.1, t_est
    assert abs(t_est[5] - 70.0) < 5.0, t_est
    assert abs(t_est[1] - 110.0) < 6.0, t_est        # E stayed put


def test_pipeline_multilayer_estimate_profile(tmp_path):
    """apriori_model="multi_chapman" + estimate_profile through the
    pipeline: theta is the flat per-layer vector over DEFAULT_LAYERS with
    thickness-scaled priors; ionosonde probes make the F2 peak
    km-identifiable; the metrics event carries per-layer parameters; a
    plasmasphere tail is refused with a clear error."""
    import json as _json
    import pytest
    from ionotomo_tpu.config import (EngineConfig, GridConfig,
                                     PhysicsConfig, PriorConfig,
                                     RayConfig, RuntimeConfig,
                                     SolverConfig)
    from ionotomo_tpu.data.synth import generate_example_datapack
    from ionotomo_tpu.data.ionosonde import bottomside_probes
    from ionotomo_tpu.inversion.pipeline import InversionPipeline
    from ionotomo_tpu.inversion.profile import multi_chapman_log_field
    from ionotomo_tpu.models.turbulence import turbulent_log_perturbation

    dp, _ = generate_example_datapack(
        n_antennas=6, n_directions=4, n_times=1, grid_shape=(20, 20, 20),
        turbulence_amp=0.1, seed=6, n_samples=33)
    cfg = EngineConfig(
        physics=PhysicsConfig(apriori_model="multi_chapman"),
        grid=GridConfig(shape=(20, 20, 20)),
        rays=RayConfig(n_samples=33),
        prior=PriorConfig(kind="sqexp", length_scale_km=90.0),
        solver=SolverConfig(solver="map_gauss_newton", gn_iters=2,
                            cg_iters=25, estimate_profile=True),
        runtime=RuntimeConfig(checkpoint_dir=str(tmp_path / "ck"),
                              metrics_path=str(tmp_path / "m.jsonl")))
    # replace the synth single-Chapman observations with a multi-layer
    # truth (E/F1 at the climatology, F2 well off: 1.5e12 / 385 / 70 vs
    # the DEFAULT_LAYERS guess 1e12 / 350 / 80) on the pipeline's own
    # grid, which depends only on geometry + config
    grid = InversionPipeline(dp, cfg).grid
    t_true = jnp.asarray([np.log(1.2e11), 110.0, 10.0,
                          np.log(2.5e11), 180.0, 40.0,
                          np.log(1.5e12), 385.0, 70.0], jnp.float32)
    m_true = multi_chapman_log_field(grid, t_true) \
        + turbulent_log_perturbation(grid, amplitude=0.1,
                                     outer_scale_km=120.0, seed=8)
    dirs_enu = dp.directions_enu()
    origins, dvecs = rays_mod.make_ray_batch(dp.array.enu, dirs_enu[0])
    rb = rays_mod.sample_straight_rays(origins, dvecs, n_samples=33)
    g = tec_mod.dtec_paired(m_true, grid, rb, num_directions=4, i0=0)
    dp.dtec = np.asarray(g)[:, None, :] + np.random.default_rng(9).normal(
        scale=dp.noise_std, size=dp.shape)

    pipe = InversionPipeline(dp, cfg)
    anchors = slant_anchor_set(pipe.grid, m_true, noise_frac=0.005,
                               seed=13)
    probes = bottomside_probes(m_true, pipe.grid,
                               [[-25.0, 15.0], [20.0, -20.0]],
                               n_per_station=12, noise_log=0.05, seed=5)
    sol = pipe.run(resume=False, anchors=anchors, probes=probes)
    recs = [_json.loads(l) for l in open(tmp_path / "m.jsonl")]
    est = next(r for r in recs if r.get("event") == "profile_estimated")
    layers = est["layers"]
    assert len(layers) == 3
    # F2 recovered to a few km (probe-rows regime); E pinned by its
    # thickness-scaled prior
    assert abs(layers[2]["h_peak_km"] - 385.0) < 8.0, layers
    assert 1.1e12 < layers[2]["n_peak"] < 2.0e12, layers
    assert abs(layers[0]["h_peak_km"] - 110.0) < 3.0, layers
    # the estimated multi-layer profile became the run prior
    assert float(log_profile_rms(pipe.m_prior, m_true, pipe.grid)) < 0.25

    # the time-varying climatology path rebuilds per-epoch targets from
    # the ESTIMATED builder; at the estimation epoch (timestep 0) the
    # solar offset is exactly zero, so the target equals the run prior
    import dataclasses
    pipe.config = dataclasses.replace(
        pipe.config, physics=dataclasses.replace(
            pipe.config.physics, time_varying_clim=True))
    seq = pipe._clim_seq(0, 1)
    np.testing.assert_allclose(np.asarray(seq[0]),
                               np.asarray(pipe.m_prior), atol=1e-6)

    cfg_ps = EngineConfig(
        physics=PhysicsConfig(apriori_model="multi_chapman",
                              plasmasphere_n0=1e10),
        grid=cfg.grid, rays=cfg.rays, prior=cfg.prior, solver=cfg.solver,
        runtime=cfg.runtime)
    with pytest.raises(ValueError, match="plasmasphere"):
        InversionPipeline(dp, cfg_ps).run(resume=False, anchors=anchors)
