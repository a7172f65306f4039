"""Ionosonde probes: the direct profile-shape observation channel.

`examples/profile_estimation.py` shows slant-TEC anchors making the
single-layer Chapman parameters observable. For a realistic MULTI-layer
ionosphere (E/F1/F2 stack) the engine's measured identifiability from
TEC-derived data alone is ~25 km on the F2 peak height — the free voxel
field absorbs part of the height shift. The instrument that closes this
is the ionosonde: bottomside n_e(h) soundings are point log-density
observations, *exactly linear* in the engine's log-field unknown
(`data/ionosonde.py`), and they observe the profile itself rather than
any integral of it.

Workflow:
1. synthesise a multi-layer world whose F2 layer is well off the
   climatology (1.5e12 / 385 km / 70 km vs the E/F1/F2 default
   1e12 / 350 / 80) + turbulence;
2. observe it with dTEC rays, 15 slant anchors, and TWO ionosonde
   stations' bottomside soundings (`ionosonde.bottomside_probes` — the
   sounder sees from its reflection floor up to each column's peak);
3. (a) sequentially assimilate the probes into a wrong prior
   (`anchors.assimilate_probes` — note the short-vertical-scale
   background covariance, the measured load-bearing choice), and
   (b) run the joint multi-layer (θ, δm) profile solve with probe rows.

Run: python examples/ionosonde_probes.py    (CPU ok; GPU if attached)
CLI equivalent:
    python -m ionotomo_tpu invert obs.h5 --estimate-profile \
        --apriori-model multi_chapman --vtec-anchors anchors.npz \
        --ionosonde probes.npz ...
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import jax
import jax.numpy as jnp

from ionotomo_tpu.data.ionosonde import bottomside_probes, probes_to_npz
from ionotomo_tpu.forward import tec as tec_mod
from ionotomo_tpu.geometry import rays as rays_mod
from ionotomo_tpu.inversion import anchors as anch
from ionotomo_tpu.inversion.priors import GPCovariance
from ionotomo_tpu.inversion.profile import (log_profile_rms,
                                            map_gauss_newton_profile,
                                            multi_chapman_log_field)
from ionotomo_tpu.models import chapman
from ionotomo_tpu.models.turbulence import turbulent_log_perturbation


def main():
    rng = np.random.default_rng(0)
    # --- multi-layer world: F2 well off the climatology ---------------
    ants = np.concatenate([rng.uniform(-40, 40, (8, 2)),
                           np.zeros((8, 1))], -1)
    zen = rng.uniform(0.05, 0.45, 5)
    az = rng.uniform(0, 2 * np.pi, 5)
    dirs = np.stack([np.sin(zen) * np.sin(az), np.sin(zen) * np.cos(az),
                     np.cos(zen)], -1)
    grid = chapman.grid_enclosing_rays(ants, dirs, shape=(28, 28, 28),
                                       h_min_km=0.0)
    t_true = jnp.asarray([np.log(1.2e11), 110.0, 10.0,      # E
                          np.log(2.5e11), 180.0, 40.0,      # F1
                          np.log(1.5e12), 385.0, 70.0],     # F2 (off)
                         jnp.float32)
    m_true = multi_chapman_log_field(grid, t_true) \
        + turbulent_log_perturbation(grid, amplitude=0.1,
                                     outer_scale_km=120.0, seed=4)

    # --- observations: dTEC + slant anchors + 2 sounder stations ------
    nd = dirs.shape[0]
    origins, dvecs = rays_mod.make_ray_batch(ants, dirs)
    rb = rays_mod.sample_straight_rays(origins, dvecs, n_samples=65)
    d = tec_mod.dtec_paired(m_true, grid, rb, nd, 0)
    noise_d = 0.01 * float(jnp.std(d)) + 1e-3
    d = d + noise_d * jax.random.normal(jax.random.key(1), d.shape)

    rec = np.array([[-25.0, -15.0], [5.0, 25.0], [20.0, -20.0]])
    els = np.deg2rad([15.0, 25.0, 40.0, 60.0, 75.0])
    xy = np.repeat(rec, len(els), axis=0)
    el = np.tile(els, len(rec))
    bundle = anch.slant_bundle(grid, xy,
                               rng.uniform(0, 2 * np.pi, xy.shape[0]),
                               el, n_samples=65)
    v = tec_mod.tec(m_true, grid, bundle)
    noise_a = 0.005 * float(jnp.mean(v))
    anchors = anch.TecAnchors(
        rays=bundle,
        values=v + noise_a * jax.random.normal(jax.random.key(2), v.shape),
        noise_std=jnp.float32(noise_a))

    probes = bottomside_probes(m_true, grid,
                               [[-25.0, 15.0], [20.0, -20.0]],
                               n_per_station=12, noise_log=0.05, seed=5)
    print(f"{probes.values.shape[0]} probe rows from 2 sounder stations "
          f"(bottomside, z {float(probes.points[:, 2].min()):.0f}–"
          f"{float(probes.points[:, 2].max()):.0f} km)")
    probes_to_npz("/tmp/probes.npz", probes)   # the CLI interchange file

    # --- (a) sequential assimilation into a wrong prior mean ----------
    t0 = jnp.asarray([np.log(1.2e11), 110.0, 10.0,
                      np.log(2.5e11), 180.0, 40.0,
                      np.log(1.0e12), 350.0, 80.0], jnp.float32)
    m_prior = multi_chapman_log_field(grid, t0)
    m_upd = anch.assimilate_probes(grid, m_prior, probes)
    print("\nhorizontally-averaged log-profile rms vs truth:")
    print(f"  climatological prior:             "
          f"{float(log_profile_rms(m_prior, m_true, grid)):.3f}")
    print(f"  after probe assimilation:         "
          f"{float(log_profile_rms(m_upd, m_true, grid)):.3f}")

    # --- (b) joint multi-layer profile solve with probe rows ----------
    sig = (0.05, 3.0, 2.0,          # E pinned (photochemical, known)
           0.1, 6.0, 4.0,           # F1 nearly pinned
           0.7, 50.0, 30.0)         # F2 free
    cov = GPCovariance.create(grid, sigma=0.3, length_scale=80.0,
                              kind="exponential")
    res = map_gauss_newton_profile(
        grid, rb, d, noise_d, t0, sig, cov, num_directions=nd,
        anchors=anchors, gn_iters=8, cg_iters=40,
        field_builder=(lambda t: multi_chapman_log_field(grid, t)),
        probes=probes)
    t_est = np.asarray(res.theta)
    print("\nF2 layer:            N_peak        h_peak     H")
    print(f"  truth:          {1.5e12:10.3e}   {385.0:6.1f}  {70.0:5.1f}")
    print(f"  guess:          {1.0e12:10.3e}   {350.0:6.1f}  {80.0:5.1f}")
    print(f"  estimated:      {float(np.exp(t_est[6])):10.3e}   "
          f"{t_est[7]:6.1f}  {t_est[8]:5.1f}")
    print(f"\njoint-solve log-profile rms:        "
          f"{float(log_profile_rms(res.m, m_true, grid)):.3f}")
    print("(without probe rows the measured F2 h_peak identifiability "
          "is ~25 km; with two stations it is ~1 km)")


if __name__ == "__main__":
    main()
