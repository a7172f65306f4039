"""Ionosonde point-density probes (data/ionosonde.py): the direct
profile-shape observation channel. Measured context: dTEC is blind to the
horizontally-uniform profile (r2 null study), slant anchors identify the
multi-layer F2 peak height only to ~25 km with a free voxel field
(test_profile.py); probe rows observe n_e(h) itself and close that gap
(measured here: <2 km with two sounder stations)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ionotomo_tpu.core.grids import Grid3D
from ionotomo_tpu.data import ionosonde as iono
from ionotomo_tpu.forward.tec import log_ne_at
from ionotomo_tpu.inversion import anchors as anch
from ionotomo_tpu.inversion.priors import GPCovariance
from ionotomo_tpu.inversion.profile import (ProfileParams,
                                            chapman_log_field,
                                            log_profile_rms,
                                            map_gauss_newton_profile,
                                            multi_chapman_log_field)
from ionotomo_tpu.models import chapman


def _world(nx=16, nz=24):
    grid = Grid3D.from_bounds((-60, -60, 0.0), (60, 60, 1000.0),
                              (nx, nx, nz))
    theta_true = ProfileParams.create(n_peak=1.4e12, h_peak_km=370.0,
                                      scale_km=70.0)
    return grid, theta_true, chapman_log_field(grid, theta_true)


def test_probe_forward_npz_roundtrip_and_validation(tmp_path):
    grid, _, m_true = _world()
    # zero-noise bottomside probes reproduce the truth's log density and
    # stay below each column's peak (the sounder's physical range)
    p = iono.bottomside_probes(m_true, grid, [[-20.0, 10.0], [15.0, -25.0]],
                               n_per_station=8, noise_log=1e-6, seed=0)
    got = log_ne_at(m_true, grid, p.points)
    np.testing.assert_allclose(np.asarray(got), np.asarray(p.values),
                               atol=1e-4)
    assert p.points.shape == (16, 3)
    assert float(p.points[:, 2].max()) <= 370.0 + 2 * float(
        grid.spacing[2])
    # densities at the sampled points are above the sounder floor
    assert float(p.values.min()) >= np.log(
        iono.MIN_SOUNDER_NE / 1e11) - 0.2

    # npz round trip is exact (within f32<->f64 log/exp)
    iono.probes_to_npz(tmp_path / "p.npz", p)
    p2 = iono.probes_from_npz(grid, tmp_path / "p.npz")
    np.testing.assert_allclose(np.asarray(p2.values), np.asarray(p.values),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(p2.points), np.asarray(p.points))

    # validation: out-of-grid points and non-positive densities refused
    with pytest.raises(ValueError, match="outside the grid"):
        iono.probes_from_arrays(grid, [[500.0, 0.0, 300.0]], [1e11], 0.05)
    with pytest.raises(ValueError, match="positive"):
        iono.probes_from_arrays(grid, [[0.0, 0.0, 300.0]], [-1e11], 0.05)
    with pytest.raises(ValueError, match="points_enu"):
        iono.probes_from_arrays(grid, [[0.0, 0.0, 300.0]], [1e11, 2e11],
                                0.05)


def test_sequential_probe_assimilation_cuts_profile_rms():
    """assimilate_probes through the default short-vertical-scale
    background covariance cuts the horizontally-averaged log-profile rms
    ~3x on a wrong-profile world (measured 0.77 -> 0.23); through the
    anchor-default 150 km vertical scale it would WORSEN it (0.86) —
    the covariance choice is load-bearing and encoded as the default."""
    grid, _, m_true = _world()
    m_prior = chapman_log_field(grid, ProfileParams.create())
    p = iono.bottomside_probes(
        m_true, grid, [[-20.0, 10.0], [15.0, -25.0], [30.0, 30.0]],
        n_per_station=10, noise_log=0.05, seed=1)
    rms0 = float(log_profile_rms(m_prior, m_true, grid))
    m_upd = anch.assimilate_probes(grid, m_prior, p)
    rms1 = float(log_profile_rms(m_upd, m_true, grid))
    assert rms1 < 0.45 * rms0, (rms0, rms1)
    # the measured failure mode: long vertical correlation bleeds the
    # bottomside correction into the topside
    m_bad = anch.assimilate_probes(
        grid, m_prior, p, cov=anch.background_covariance(grid))
    assert float(log_profile_rms(m_bad, m_true, grid)) > rms1


def test_multilayer_profile_solve_with_probes_tightens_h_peak():
    """The round-3 measured gap: multi-layer F2 h_peak identifiability is
    ~25 km from dTEC + slant anchors with a free voxel field
    (test_profile.py::test_profile_solve_multi_layer_and_curved_builders).
    Two ionosonde stations' bottomside soundings tighten it to ~1 km
    (measured 0.7 km), with log N_peak and H essentially exact."""
    import sys
    import os
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_profile import slant_anchor_set
    from ionotomo_tpu.forward import tec as tec_mod
    from ionotomo_tpu.geometry import rays as rays_mod
    from ionotomo_tpu.models.turbulence import turbulent_log_perturbation

    rng = np.random.default_rng(0)
    ants = np.concatenate([rng.uniform(-40, 40, (6, 2)),
                           np.zeros((6, 1))], -1)
    zen = rng.uniform(0.05, 0.45, 4)
    az = rng.uniform(0, 2 * np.pi, 4)
    dirs = np.stack([np.sin(zen) * np.sin(az), np.sin(zen) * np.cos(az),
                     np.cos(zen)], -1)
    grid = chapman.grid_enclosing_rays(ants, dirs, shape=(24, 24, 24),
                                       h_min_km=0.0)
    t_true = jnp.asarray([np.log(1.2e11), 110.0, 10.0,      # E (known)
                          np.log(1.5e12), 385.0, 70.0],     # F2 (off)
                         jnp.float32)
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
    probes = iono.bottomside_probes(m_true, grid,
                                    [[-25.0, 15.0], [20.0, -20.0]],
                                    n_per_station=12, noise_log=0.05,
                                    seed=5)

    t0 = jnp.asarray([np.log(1.2e11), 110.0, 10.0,
                      np.log(1.0e12), 350.0, 80.0], jnp.float32)
    sig = (0.05, 3.0, 2.0, 0.7, 50.0, 30.0)
    cov = GPCovariance.create(grid, sigma=0.3, length_scale=80.0,
                              kind="exponential")
    res = map_gauss_newton_profile(
        grid, rb, d, noise_d, t0, sig, cov, num_directions=nd,
        anchors=anchors, gn_iters=10, cg_iters=40,
        field_builder=(lambda t: multi_chapman_log_field(grid, t)),
        probes=probes)
    t_est = np.asarray(res.theta)
    # measured: 0.7 km h_peak error (vs 26.8 km without probes)
    assert abs(t_est[4] - 385.0) < 5.0, t_est
    assert abs(t_est[3] - np.log(1.5e12)) < 0.05, t_est
    assert abs(t_est[5] - 70.0) < 3.0, t_est
    assert abs(t_est[1] - 110.0) < 5.0, t_est       # E stayed put


def test_pipeline_sequential_probes_and_cli(tmp_path):
    """Pipeline + CLI integration: run(probes=...) assimilates into the
    prior mean and logs the metrics event; `invert --ionosonde` round-
    trips the npz format end-to-end."""
    import json
    import subprocess
    import sys
    import os
    from ionotomo_tpu.config import (EngineConfig, GridConfig,
                                     PhysicsConfig, PriorConfig,
                                     RayConfig, RuntimeConfig,
                                     SolverConfig)
    from ionotomo_tpu.data.synth import generate_example_datapack
    from ionotomo_tpu.inversion.pipeline import InversionPipeline

    dp, truth = generate_example_datapack(
        n_antennas=6, n_directions=4, n_times=1, grid_shape=(18, 18, 18),
        turbulence_amp=0.1, seed=4, n_samples=33)
    # configured profile deliberately wrong (truth: 1e12 / 350 / 80)
    cfg = EngineConfig(
        physics=PhysicsConfig(chapman_n_peak=5e11,
                              chapman_h_peak_km=310.0,
                              chapman_scale_km=100.0),
        grid=GridConfig(shape=(18, 18, 18)),
        rays=RayConfig(n_samples=33),
        prior=PriorConfig(kind="sqexp", length_scale_km=90.0),
        solver=SolverConfig(solver="map_gauss_newton", gn_iters=1,
                            cg_iters=15),
        runtime=RuntimeConfig(checkpoint_dir=str(tmp_path / "ck"),
                              metrics_path=str(tmp_path / "m.jsonl")))
    pipe = InversionPipeline(dp, cfg)
    m_true = jnp.asarray(truth["m"][0])
    probes = iono.bottomside_probes(m_true, pipe.grid,
                                    [[-15.0, 10.0], [20.0, -10.0]],
                                    n_per_station=10, noise_log=0.05,
                                    seed=2)
    rms_wrong = float(log_profile_rms(pipe.m_prior, m_true, pipe.grid))
    pipe.run(resume=False, probes=probes)
    recs = [json.loads(l) for l in open(tmp_path / "m.jsonl")]
    ev = next(r for r in recs if r.get("event") == "ionosonde_probes")
    assert ev["n"] == int(probes.values.shape[0])
    rms_after = float(log_profile_rms(pipe.m_prior, m_true, pipe.grid))
    assert rms_after < 0.6 * rms_wrong, (rms_wrong, rms_after)

    # CLI: write the npz, save the datapack, invert --ionosonde
    obs = tmp_path / "obs.h5"
    dp.save(obs)
    iono.probes_to_npz(tmp_path / "probes.npz", probes)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-m", "ionotomo_tpu", "invert", str(obs),
         "--out", str(tmp_path / "sol.h5"), "--grid", "18",
         "--samples", "17", "--cg-iters", "8", "--gn-iters", "1",
         "--ionosonde", str(tmp_path / "probes.npz"),
         "--checkpoint-dir", str(tmp_path / "ck2"),
         "--metrics", str(tmp_path / "m2.jsonl")],
        capture_output=True, text=True, cwd=repo, env=env)
    assert r.returncode == 0, r.stderr[-800:]
    recs2 = [json.loads(l) for l in open(tmp_path / "m2.jsonl")]
    assert any(x.get("event") == "ionosonde_probes" for x in recs2)
