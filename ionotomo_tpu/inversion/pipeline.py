"""End-to-end inversion pipeline (reference: inversion_pipeline.py, L7;
SURVEY.md §3.1).

Host shell around the device core: load/accept a DataPack → build the
initial model (grid sized to enclose all rays, Chapman prior) → per
timestep: rays (straight or bent) → solve (MAP GN / LSQR / steepest /
Kalman over the whole sequence) → Solution + atomic checkpoints + JSONL
metrics. The per-timestep solve is one jitted program; the host only
orchestrates setup, checkpointing and logging (SURVEY.md §7 "Host/device
boundary").

Where the reference fanned out over dask workers (⊗ in SURVEY §3.1), this
pipeline shards the ray axis over the attached device mesh automatically
when more than one device is present.
"""
from __future__ import annotations

import json
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..config import EngineConfig
from ..data.datapack import DataPack
from ..geometry import fermat, rays as rays_mod
from ..models import chapman
from ..parallel import sharding as shard_mod
from ..utils import checkpoint as ckpt_mod
from ..utils.metrics import MetricsWriter
from .kalman import (ensemble_kalman_filter, initial_ensemble,
                     kalman_filter, member_parallel_enkf)
from .priors import GPCovariance
from .solution import Solution
from . import solvers


class InversionPipeline:
    """Drives a full reconstruction from a DataPack."""

    def __init__(self, datapack: DataPack, config: EngineConfig = None):
        self.datapack = datapack
        self.config = config or EngineConfig()
        self.metrics = MetricsWriter(self.config.runtime.metrics_path)
        dev = self.datapack.to_device_arrays()
        self.antennas = dev["antennas_enu"]
        self.directions = dev["directions_enu"]      # (Nt, Nd, 3)
        self.d_obs = dev["dtec"]                      # (Na, Nt, Nd)
        # flagged samples are soft-masked by noise inflation (their weight
        # in every C_d^-1-weighted misfit becomes ~0, shapes stay static)
        self.noise_std = np.where(dev["flags"], 1e6, dev["noise_std"])
        self.i0 = dev["ref_antenna"]
        self.grid = chapman.grid_enclosing_rays(
            self.antennas, self.directions.reshape(-1, 3),
            max_length_km=self.config.physics.max_length_km,
            shape=self.config.grid.shape,
            pad_km=self.config.grid.pad_km,
            h_min_km=self.config.grid.h_min_km)
        self.m_prior = self._clim_field(self.datapack.times.mean())
        self._m_prior0 = self.m_prior     # pristine prior; run() restores
                                          # it so repeated runs (with or
                                          # without anchors) are identical
                                          # to fresh-pipeline runs
        pr = self.config.prior
        self.cov = GPCovariance.create(self.grid, sigma=pr.sigma,
                                       length_scale=pr.length_scale_km,
                                       kind=pr.kind)
        self.anchors = None            # TecAnchors via run(anchors=...)
        self.anchor_cov = None         # background-error covariance
        self._profile_theta = None     # θ̂ from estimate_profile, per run
        self._profile_build = None     # its θ→field builder (single or
                                       # multi-layer, flat or curved)
        self.mesh = (shard_mod.ray_mesh()
                     if len(jax.devices()) > 1 else None)
        self._na_padded = None        # lazy; see _padded_na
        if pr.auto_select:
            self._auto_select_prior()

    def _clim_field(self, mjd: float):
        """Climatological log-density field at epoch time ``mjd`` — the
        a-priori model (Chapman / multi-Chapman, flat or curved Earth)
        modulated by the solar zenith at that instant. Used for the run
        prior (at the observation midpoint) and, with
        ``physics.time_varying_clim``, per epoch as the filters' fade-pull
        target so long sequences track the day/night terminator
        (VERDICT r2 weak #3)."""
        p = self.config.physics
        from ..geometry import frames
        enu_frame = self.datapack.array.enu_frame
        r_earth = None
        if p.curved_earth:
            # true-altitude profile + per-column solar factor: the
            # reference's astropy-exact geometry (frames/chapman docstrings)
            r_earth = frames.gaussian_earth_radius(enu_frame.lat)
            cos_chi = chapman.terminator_cos_chi(self.grid, enu_frame, mjd)
        else:
            cos_chi = float(frames.solar_cos_zenith(mjd, enu_frame))
        if p.apriori_model == "multi_chapman":
            ne0 = chapman.multi_chapman_field(
                self.grid, cos_chi=cos_chi,
                plasmasphere_n0=p.plasmasphere_n0,
                curved=p.curved_earth, earth_radius_km=r_earth)
        else:
            ne0 = chapman.chapman_field(self.grid, n_peak=p.chapman_n_peak,
                                        h_peak_km=p.chapman_h_peak_km,
                                        scale_km=p.chapman_scale_km,
                                        cos_chi=cos_chi,
                                        curved=p.curved_earth,
                                        earth_radius_km=r_earth)
        return chapman.log_parametrize(ne0)

    def _clim_seq(self, c0: int, c1: int):
        """(c1-c0, *grid.shape) per-epoch climatological fields for the
        time-domain solvers, or None when ``time_varying_clim`` is off.

        When a profile was estimated this run (``estimate_profile``), the
        per-epoch target is the ESTIMATED profile modulated by the solar
        factor relative to the estimation epoch (timestep 0) — otherwise
        the fade pull would drag the state back toward the unestimated
        configured climatology, undoing the estimate."""
        if not self.config.physics.time_varying_clim:
            return None
        if self._profile_theta is not None:
            from ..geometry import frames
            from ..models.chapman import solar_zenith_factor
            enu_frame = self.datapack.array.enu_frame
            base = self._profile_build(self._profile_theta)
            f_ref = float(solar_zenith_factor(jnp.float32(
                frames.solar_cos_zenith(float(self.datapack.times[0]),
                                        enu_frame))))
            out = []
            for t in range(c0, c1):
                f_t = float(solar_zenith_factor(jnp.float32(
                    frames.solar_cos_zenith(
                        float(self.datapack.times[t]), enu_frame))))
                out.append(base + jnp.log(jnp.float32(f_t / f_ref)))
            return jnp.stack(out)
        return jnp.stack([self._clim_field(float(self.datapack.times[t]))
                          for t in range(c0, c1)])

    def _estimate_profile(self, anchors, probes=None):
        """Run the joint (θ, δm) MAP solve on timestep-0 data + anchors
        (+ optional ionosonde probe rows) and install the estimated
        profile as the run's prior mean (honouring
        ``physics.curved_earth``). With ``apriori_model="chapman"`` θ is
        the single-layer (log N_peak, h_peak, H); with ``"multi_chapman"``
        θ is the flat per-layer vector over the E/F1/F2 stack
        (models.chapman.DEFAULT_LAYERS), each layer's prior std scaled by
        its thickness relative to the thickest layer — thin
        photochemical layers (E) are allowed proportionally small
        excursions, so the data's profile information lands on the
        transport-dominated F2 layer where the climatology is genuinely
        uncertain. Multi-layer estimation is only ~km-identifiable with
        ionosonde probe rows (measured, tests/test_ionosonde.py);
        without probes expect ~25 km on h_peak. θ and diagnostics go to
        the metrics stream; ``self._profile_theta``/``_profile_build``
        record θ̂ and its field builder so the time-varying climatology
        modulates the *estimated* profile, not the configured one."""
        from .profile import (ProfileParams, chapman_log_field,
                              map_gauss_newton_profile,
                              multi_chapman_log_field)
        p, sc = self.config.physics, self.config.solver
        curved = bool(p.curved_earth)
        grid = self.grid
        if p.apriori_model == "multi_chapman":
            if p.plasmasphere_n0:
                raise ValueError(
                    "estimate_profile with a plasmasphere tail is not "
                    "supported (the tail is not part of the θ "
                    "parametrization); set plasmasphere_n0=0 or call "
                    "inversion.profile.map_gauss_newton_profile with a "
                    "custom field_builder")
            from ..models.chapman import DEFAULT_LAYERS
            theta0 = jnp.asarray(
                [v for (_, n, h, s, _) in DEFAULT_LAYERS
                 for v in (float(np.log(n)), h, s)], jnp.float32)
            scales = [s for (_, _, _, s, _) in DEFAULT_LAYERS]
            s_max = max(scales)
            sigma = tuple(base * s / s_max
                          for s in scales for base in sc.profile_sigma)
            build = (lambda t: multi_chapman_log_field(grid, t,
                                                       curved=curved))
        else:
            theta0 = ProfileParams.create(n_peak=p.chapman_n_peak,
                                          h_peak_km=p.chapman_h_peak_km,
                                          scale_km=p.chapman_scale_km)
            sigma = sc.profile_sigma
            build = (lambda t: chapman_log_field(
                grid, ProfileParams(t[0], t[1], t[2]), curved=curved))
        nd = self.directions.shape[1]
        ants, d0, noise0, _ = self._padded_data(0)
        rb = self._shard(self.rays_for_time(0, antennas=ants))
        res = map_gauss_newton_profile(
            grid, rb, d0, noise0, theta0, sigma,
            self.cov, num_directions=nd, anchors=anchors, i0=self.i0,
            gn_iters=max(sc.gn_iters, 4), cg_iters=sc.cg_iters,
            quadrature=self.config.rays.quadrature,
                interp=self.config.rays.interp,
            field_builder=build, probes=probes)
        theta_flat = (jnp.stack([res.theta.log_n_peak,
                                 res.theta.h_peak_km, res.theta.scale_km])
                      if isinstance(res.theta, ProfileParams)
                      else res.theta)
        self.m_prior = build(theta_flat)
        self._profile_theta = theta_flat
        self._profile_build = build
        ev = dict(event="profile_estimated",
                  residual=float(res.residual_norm))
        if isinstance(res.theta, ProfileParams):
            ev.update(n_peak=float(res.theta.n_peak),
                      h_peak_km=float(res.theta.h_peak_km),
                      scale_km=float(res.theta.scale_km))
        else:
            t = np.asarray(theta_flat, np.float64)
            ev["layers"] = [dict(n_peak=float(np.exp(t[3 * l])),
                                 h_peak_km=float(t[3 * l + 1]),
                                 scale_km=float(t[3 * l + 2]))
                            for l in range(t.size // 3)]
        self.metrics.write(ev)

    def _auto_select_prior(self):
        """Data-driven prior hyperparameters at pipeline setup, scored on
        timestep-0 data with straight rays; the winner becomes the run's
        covariance, choice + scores logged to metrics. Two methods:
        ``auto_select="gcv"`` (or True) — generalised cross-validation
        over a candidate grid (inversion/model_selection.py);
        ``auto_select="evidence"`` — SLQ marginal likelihood
        (inversion/empirical_bayes.py), which prices a dense σ axis for
        free per (kind, L) Lanczos batch."""
        pr = self.config.prior
        method = (pr.auto_select if isinstance(pr.auto_select, str)
                  else ("gcv" if pr.auto_select else "off"))
        if method == "evidence":
            return self._auto_select_prior_evidence()
        from .model_selection import select_prior
        candidates = []
        ls0 = pr.length_scale_km
        for kind in dict.fromkeys([pr.kind, "von_karman", "exponential"]):
            for fs in (0.5, 1.0, 2.0):
                for fl in (0.5, 1.0, 2.0):
                    ls = (tuple(l * fl for l in ls0)
                          if isinstance(ls0, (tuple, list)) else ls0 * fl)
                    candidates.append(dict(
                        sigma=pr.sigma * fs, length_scale=ls, kind=kind))
        ants, d0, noise0, _ = self._padded_data(0)
        origins, dvecs = rays_mod.make_ray_batch(ants, self.directions[0])
        rb = self._shard(rays_mod.sample_straight_rays(
            origins, dvecs, max_length_km=self.config.physics.max_length_km,
            n_samples=self.config.rays.n_samples))
        cov, params, scores = select_prior(
            self.grid, rb, d0, noise0, self.m_prior, candidates,
            num_directions=self.directions.shape[1], i0=self.i0,
            key=jax.random.key(self.config.runtime.seed),
            cg_iters=self.config.solver.cg_iters)
        self.cov = cov
        self.metrics.write(dict(event="prior_auto_selected",
                                chosen=params,
                                n_candidates=len(candidates),
                                best_score=float(min(scores))))

    def _auto_select_prior_evidence(self):
        """Marginal-likelihood (σ, L, kind[, ρ]) fit on timestep-0 data —
        inversion/empirical_bayes.py. L and kind candidates around the
        configured prior; the σ axis (and, with ``prior.fit_noise``, the
        noise-rescaling ρ axis) is a dense log grid priced for free from
        each (kind, L) Lanczos batch. A fitted ρ* rescales the run's
        noise_std (flag-inflated entries stay effectively infinite)."""
        from .empirical_bayes import fit_hyperparameters
        pr = self.config.prior
        ls0 = pr.length_scale_km
        l_base = (float(np.mean(ls0)) if isinstance(ls0, (tuple, list))
                  else float(ls0))
        ells = [l_base * f for f in (0.5, 1.0, 2.0)]
        sigmas = pr.sigma * np.logspace(-0.9, 0.9, 9)
        rhos = np.logspace(-0.6, 0.6, 7) if pr.fit_noise else None
        ants, d0, noise0, _ = self._padded_data(0)
        origins, dvecs = rays_mod.make_ray_batch(ants, self.directions[0])
        rb = self._shard(rays_mod.sample_straight_rays(
            origins, dvecs, max_length_km=self.config.physics.max_length_km,
            n_samples=self.config.rays.n_samples))
        best = None
        for kind in dict.fromkeys([pr.kind, "von_karman", "exponential"]):
            fit = fit_hyperparameters(
                self.grid, rb, d0, noise0, self.m_prior,
                num_directions=self.directions.shape[1],
                length_scales=ells, sigmas=sigmas, kind=kind, i0=self.i0,
                quadrature=self.config.rays.quadrature,
                interp=self.config.rays.interp,
                seed=self.config.runtime.seed, noise_scales=rhos)
            if rhos is None:
                s_star, l_star, table, cov_star = fit
                rho_star = 1.0
            else:
                s_star, l_star, rho_star, table, cov_star = fit
            ll = float(table.max())
            if best is None or ll > best[0]:
                best = (ll, s_star, l_star, rho_star, kind, cov_star)
        ll, s_star, l_star, rho_star, kind, cov_star = best
        self.cov = cov_star
        if pr.fit_noise:
            self.noise_std = self.noise_std * rho_star
        self.metrics.write(dict(
            event="prior_auto_selected", method="evidence",
            chosen=dict(sigma=s_star, length_scale=l_star, kind=kind,
                        noise_scale=rho_star),
            log_evidence=ll))

    # --- ray building -------------------------------------------------------

    def rays_for_time(self, t: int, m_field=None, antennas=None):
        """RayBundle for timestep t; bent rays trace through ``m_field``
        (defaults to the prior model) when config.rays.bent. ``antennas``
        overrides the antenna set (used by the sharding pad)."""
        ants = self.antennas if antennas is None else antennas
        origins, dvecs = rays_mod.make_ray_batch(ants, self.directions[t])
        rc, p = self.config.rays, self.config.physics
        if rc.bent:
            field = self.m_prior if m_field is None else m_field
            bundle, _ = fermat.trace_rays(
                field, self.grid, origins, dvecs,
                self.datapack.frequency_hz, p.max_length_km,
                n_steps=rc.n_steps, keep_path=True, method=rc.method,
                interp=rc.interp)
            return bundle
        return rays_mod.sample_straight_rays(
            origins, dvecs, max_length_km=p.max_length_km,
            n_samples=rc.n_samples)

    def _inner(self, bundle):
        """Coarse companion bundle for mixed-fidelity solves (RayConfig
        .inner_samples > 0), or None. Subsampling preserves any ray-axis
        sharding (the slice is along the sample axis)."""
        k = self.config.rays.inner_samples
        return rays_mod.inner_bundle(bundle, k) if k > 0 else None

    # --- sharding ------------------------------------------------------------

    def _padded_na(self, na: int, nd: int) -> int:
        """Smallest Na' ≥ Na divisible by the mesh size.

        The solvers rely on the row-major (antenna × direction) ray layout
        and reshape the sharded flat ray axis back to (Na', Nd, …), which
        sharding-in-types only supports when every device holds whole
        antennas — i.e. Na' % n_devices == 0 (Na'·Nd % n_devices == 0 is
        NOT enough: 6 antennas × 4 directions on 8 devices splits antennas
        across devices and the paired-dTEC reshape fails to compile). Rays
        are padded in whole-antenna blocks: duplicated last antenna,
        observations zero with noise 1e6 (weight ~1e-12 in every C_d⁻¹
        misfit) — results match the unsharded solve (tests/test_multichip).
        Depends only on (Na, mesh) — computed and logged once.
        """
        if self.mesh is None:
            return na
        if self._na_padded is None:
            k = self.mesh.devices.size
            na_p = shard_mod.pad_to_multiple(na, k)
            self._na_padded = na_p
            if na_p != na:
                self.metrics.write(dict(event="ray_sharding_padded",
                                        na=na, na_padded=na_p,
                                        devices=k))
        return self._na_padded

    def _shard(self, bundle: rays_mod.RayBundle):
        """Place the ray axis across the mesh (callers pre-pad so the ray
        count always divides the device count)."""
        if self.mesh is None:
            return bundle
        assert bundle.num_rays % self.mesh.devices.size == 0
        sh = shard_mod.ray_sharding(self.mesh)
        return rays_mod.RayBundle(points=jax.device_put(bundle.points, sh),
                                  ds=jax.device_put(bundle.ds, sh))

    def _chunk_arrays(self, c0: int, c1: int, shard: bool = True):
        """Padded, ray-sharded per-timestep arrays for the time-domain
        solvers: (rays_seq with axis-1 sharded, d (Nt',Na',Nd),
        noise (Nt',Na',Nd)) for timesteps [c0, c1). ``shard=False``
        keeps the bundles replicated (member-parallel EnKF shards the
        ensemble axis instead)."""
        from jax.sharding import NamedSharding, PartitionSpec as P
        per = [self._padded_data(t) for t in range(c0, c1)]
        bundles = [self.rays_for_time(t, antennas=per[i][0])
                   for i, t in enumerate(range(c0, c1))]
        pts = jnp.stack([b.points for b in bundles])
        ds = jnp.stack([b.ds for b in bundles])
        if self.mesh is not None and shard:
            sh = NamedSharding(self.mesh, P(None, shard_mod.RAY_AXIS))
            pts = jax.device_put(pts, sh)
            ds = jax.device_put(ds, sh)
        rays_seq = rays_mod.RayBundle(points=pts, ds=ds)
        d = jnp.stack([p[1] for p in per])
        noise = jnp.stack([p[2] for p in per])
        return rays_seq, self._inner(rays_seq), d, noise

    def _padded_data(self, t: int):
        """(antennas, d_t, noise_t, na_real) with whole-antenna padding so
        Na'·Nd divides the mesh (the padded count is computed — and its
        metrics event logged — once, in _padded_na). With
        ``rays.beam_noise > 0`` the noise is inflated in quadrature with
        the epoch's chaotic beam spread (``_beam_inflation``)."""
        na, nd = self.d_obs.shape[0], self.directions.shape[1]
        na_p = self._padded_na(na, nd)
        d_t = np.asarray(self.d_obs[:, t, :])
        noise = np.asarray(self.noise_std[:, t, :])
        ants = self.antennas
        if na_p != na:
            pad = na_p - na
            ants = np.concatenate([ants, np.repeat(ants[-1:], pad, 0)])
            d_t = np.concatenate([d_t, np.zeros((pad, nd), d_t.dtype)])
            noise = np.concatenate(
                [noise, np.full((pad, nd), 1e6, noise.dtype)])
        noise = jnp.asarray(noise)
        if self.config.rays.beam_noise > 0:
            infl = self._beam_inflation(t, ants)
            noise = jnp.sqrt(noise * noise + infl * infl)
        return ants, jnp.asarray(d_t), noise, na

    def _beam_inflation(self, t: int, ants):
        """Strong-turbulence observation-noise inflation for timestep t
        (rays.beam_noise > 0): the chaotic dTEC spread of a stochastic
        Fresnel beam traced through the prior field
        (geometry.fermat.beam_noise_for_epoch). Keyed by the run seed +
        epoch index, so chunked and resumed runs inflate bit-identically;
        the spread magnitudes are logged per epoch. The prior field is
        the linearisation point — the error bar is a magnitude estimate
        and stays fixed across Gauss-Newton iterates (re-tracing the
        beam per iterate would re-randomise the misfit weights)."""
        rc, p = self.config.rays, self.config.physics
        key = jax.random.fold_in(
            jax.random.key(self.config.runtime.seed), 9000017 + t)
        infl = fermat.beam_noise_for_epoch(
            self.m_prior, self.grid, ants, self.directions[t],
            self.datapack.frequency_hz, key, n_paths=rc.beam_noise,
            i0=self.i0,
            jitter_rad=(rc.beam_jitter_rad or None),
            max_length_km=p.max_length_km, n_steps=rc.n_steps,
            method=rc.method, interp=rc.interp)
        self.metrics.write(dict(
            event="beam_noise", t=t, n_paths=rc.beam_noise,
            mean=float(jnp.mean(infl)), max=float(jnp.max(infl))))
        return infl

    # --- solving -------------------------------------------------------------

    def _solve_once(self, rb, d_t, noise, m_start, nd, m0=None):
        sc = self.config.solver
        quad = self.config.rays.quadrature
        itp = self.config.rays.interp
        itp_in = self.config.rays.interp_inner or None
        if sc.solver == "lsqr_smoothness":
            return solvers.lsqr_smoothness(
                self.grid, rb, d_t, noise, m_start, num_directions=nd,
                i0=self.i0, damp=self.config.prior.damp,
                smooth=self.config.prior.smooth, max_iters=sc.lsqr_iters,
                quadrature=quad, interp=itp)
        if sc.solver == "robust_gn":
            return solvers.map_gauss_newton_robust(
                self.grid, rb, d_t, noise, m_start, self.cov,
                num_directions=nd, i0=self.i0, gn_iters=sc.gn_iters,
                cg_iters=sc.cg_iters, cg_tol=sc.cg_tol,
                huber_k=sc.huber_k, irls_iters=sc.irls_iters,
                quadrature=quad, interp=itp, rays_inner=self._inner(rb),
                warm_start=sc.warm_start, interp_inner=itp_in)
        if sc.solver == "steepest":
            return solvers.steepest_descent_map(
                self.grid, rb, d_t, noise, m_start, self.cov,
                num_directions=nd, i0=self.i0, n_iters=sc.gn_iters * 8)
        return solvers.map_gauss_newton(
            self.grid, rb, d_t, noise, m_start, self.cov,
            num_directions=nd, i0=self.i0, gn_iters=sc.gn_iters,
            cg_iters=sc.cg_iters, cg_tol=sc.cg_tol, m0=m0,
            anchors=self.anchors, quadrature=quad, interp=itp,
            rays_inner=self._inner(rb),
            warm_start=sc.warm_start, interp_inner=itp_in)

    def solve_snapshot(self, t: int, m0=None):
        """Invert one timestep; returns (m, diagnostics dict).

        With bent rays and ``rays.retrace_every > 0`` this runs the
        reference's actual hot loop (SURVEY §3.1): rays are re-traced
        through the current iterate every ``retrace_every`` Gauss-Newton
        iterations and the solve continues from it — the nonlinear
        alternation calc_rays ↔ solve, stopping early when the whitened
        residual stalls (<1% improvement).
        """
        sc, rc = self.config.solver, self.config.rays
        nd = self.directions.shape[1]
        ants, d_t, noise, na_real = self._padded_data(t)
        m_start = self.m_prior if m0 is None else m0
        retrace = (rc.bent and rc.retrace_every > 0
                   and sc.solver == "map_gauss_newton"
                   and sc.gn_iters > 0)
        t0 = time.perf_counter()
        if not retrace:
            rb = self._shard(self.rays_for_time(t, antennas=ants))
            res = self._solve_once(rb, d_t, noise, m_start, nd, m0=m0)
            n_rays = rb.num_rays
            retraces = 0
        else:
            m_k, prev_res, res = m_start, float("inf"), None
            done_iters, retraces, u_carry = 0, 0, None
            while done_iters < sc.gn_iters:
                rb = self._shard(self.rays_for_time(t, m_field=m_k,
                                                    antennas=ants))
                if done_iters > 0:
                    retraces += 1
                n_iters = min(rc.retrace_every, sc.gn_iters - done_iters)
                res = solvers.map_gauss_newton(
                    self.grid, rb, d_t, noise, m_start, self.cov,
                    num_directions=nd, i0=self.i0, gn_iters=n_iters,
                    cg_iters=sc.cg_iters, cg_tol=sc.cg_tol, m0=m_k,
                    anchors=self.anchors,
                    quadrature=self.config.rays.quadrature,
                interp=self.config.rays.interp,
                    rays_inner=self._inner(rb),
                    warm_start=sc.warm_start, u0=u_carry,
                    interp_inner=self.config.rays.interp_inner or None)
                u_carry = res.u_final      # same data, re-traced paths:
                # the whitened departure keeps its meaning across calls
                m_k = res.m
                done_iters += n_iters
                cur = float(res.residual_norm)   # outer-loop stall check
                if prev_res - cur < 0.01 * prev_res:
                    break
                prev_res = cur
            n_rays = rb.num_rays
        jax.block_until_ready(res.m)
        dt = time.perf_counter() - t0
        diag = dict(timestep=t, seconds=dt,
                    residual=float(res.residual_norm),
                    solver=sc.solver,
                    rays=int(min(n_rays, na_real * nd)),
                    retraces=retraces,
                    rays_per_sec=n_rays / dt,
                    iters_per_sec=(sc.gn_iters / dt
                                   if sc.solver == "map_gauss_newton"
                                   else None))
        return res.m, diag

    def posterior_std(self, t: int, n_samples: int, m_field=None):
        """Per-voxel posterior std at timestep t from ``n_samples``
        linearised-posterior RTO draws (solvers.posterior_samples — all
        draws one batched-Krylov program). The spread depends only on
        (J, C, C_d), not on the point estimate, so it applies to every
        snapshot solver; with bent rays pass the converged field as
        ``m_field`` so J is linearised along the solved-through paths.
        Sequentially-assimilated anchors tighten the prior *mean* only —
        their spread contraction is represented in joint anchor mode
        (self.anchors is passed through as extra RTO rows)."""
        sc, rc = self.config.solver, self.config.rays
        nd = self.directions.shape[1]
        ants, d_t, noise, _ = self._padded_data(t)
        rb = self._shard(self.rays_for_time(
            t, m_field=(m_field if rc.bent else None), antennas=ants))
        key = jax.random.fold_in(
            jax.random.key(self.config.runtime.seed), 1000003 + t)
        _, _, std = solvers.posterior_samples(
            self.grid, rb, d_t, noise, self.m_prior, self.cov,
            num_directions=nd, key=key, n_samples=n_samples, i0=self.i0,
            cg_iters=sc.cg_iters, cg_tol=sc.cg_tol, anchors=self.anchors,
            quadrature=rc.quadrature, interp=rc.interp)
        return std

    def _fit_noise_scale(self, t: int, m_lin, scale: float) -> float:
        """One online noise-adaptation event (solver.noise_adapt_every):
        empirical-Bayes ρ fit on timestep t's innovation, linearised
        about the current filter state — the exact dense (γ, ρ) evidence
        family of inversion/empirical_bayes.py with the run's covariance
        as the prior hypothesis (γ around cov.σ² absorbs correlated
        signal so ρ isolates the white floor). Returns the multiplicative
        correction to the CURRENT scale (already applied to the noise
        passed in). Data spaces at pipeline scale (Na·Nd ≲ 4k) use the
        exact dense path; the SLQ ρ axis is untrustworthy (module doc).
        Flag-inflated rows shift the evidence by a (γ, ρ)-constant, so
        the argmax is unaffected."""
        from .empirical_bayes import log_marginal_family
        nd = self.directions.shape[1]
        ants, d_t, noise, _ = self._padded_data(t)
        rb = self._shard(self.rays_for_time(t, antennas=ants))
        cov1 = GPCovariance.create(self.grid, sigma=1.0,
                                   length_scale=self.cov.length_scale,
                                   kind=self.cov.kind)
        gammas = (self.cov.sigma * np.logspace(-0.6, 0.6, 9)) ** 2
        rhos = np.logspace(-0.6, 0.6, 9)
        ll, _ = log_marginal_family(
            self.grid, rb, d_t, noise * scale, m_lin, cov1,
            jnp.asarray(gammas, jnp.float32), nd, i0=self.i0,
            quadrature=self.config.rays.quadrature,
            interp=self.config.rays.interp,
            noise_scales=jnp.asarray(rhos, jnp.float32), method="dense")
        _, i_r = np.unravel_index(int(np.argmax(ll)), ll.shape)
        return float(rhos[i_r])

    def _diag_spectrum(self, t: int, m_lin, noise_scale: float) -> None:
        """One update-operator conditioning diagnostic
        (solver.diag_spectrum_every, VERDICT r4 #5): the randomized
        top-rank spectrum of I + C^½JᵀC_d⁻¹JC^½ linearised at the
        current filter state on timestep t's rays, logged as an
        ``update_spectrum`` metrics event. λ₁ IS the operator's
        condition-number bound (the spectrum lives in [1, λ₁]), the
        quantity that converts f32 rounding into field error under
        truncated CG (3e5× amplification measured at 1e-3 TECU noise —
        tests/test_multichip.py)."""
        from .kalman import update_operator_eigs
        sc = self.config.solver
        nd = self.directions.shape[1]
        ants, _, noise, _ = self._padded_data(t)
        rb = self._shard(self.rays_for_time(t, antennas=ants))
        rank = min(sc.diag_spectrum_rank, self.grid.num_voxels)
        _, lam = update_operator_eigs(
            self.grid, rb, noise * noise_scale, m_lin, self.cov, nd,
            jax.random.key(t), rank=rank, i0=self.i0,
            quadrature=self.config.rays.quadrature,
            interp=self.config.rays.interp)
        lam = [float(v) for v in np.asarray(lam)]
        self.metrics.write(dict(event="update_spectrum", t=t, rank=rank,
                                lam=lam, kappa_bound=lam[0]))

    def _config_compatible(self, cfg_json: str) -> bool:
        """A checkpoint is resumable only if its engine config matches ours
        on every physics/grid/ray/prior/solver field (runtime fields —
        paths, logging cadence — may differ). Silently warm-starting from a
        different run corrupts results (ADVICE r1)."""
        if not cfg_json:
            return True
        try:
            # round-trip through EngineConfig so fields added in newer
            # versions pick up their defaults instead of failing a raw
            # dict comparison (old checkpoints stay resumable)
            theirs = json.loads(EngineConfig.from_json(cfg_json).to_json())
            mine = json.loads(self.config.to_json())
        except (ValueError, KeyError, TypeError):
            return False
        theirs.pop("runtime", None)
        mine.pop("runtime", None)
        return theirs == mine

    def anchor_background_cov(self, sigma: float = 1.0,
                              vertical_scale_km: float = 150.0
                              ) -> GPCovariance:
        """Background-error covariance for sequential VTEC assimilation —
        see inversion.anchors.background_covariance (shared with the
        serving layer)."""
        from .anchors import background_covariance
        return background_covariance(self.grid, sigma=sigma,
                                     vertical_scale_km=vertical_scale_km)

    def run(self, resume: bool = True, anchors=None,
            anchor_mode: str = "sequential", anchor_cov=None,
            probes=None) -> Solution:
        """Full run: all timesteps, checkpointed, metrics-logged.
        With ``runtime.profile_dir`` set, the whole run is captured as a
        jax.profiler device trace (SURVEY §5.1).

        ``anchors`` (inversion.anchors.TecAnchors): external absolute-TEC
        constraints (e.g. a GNSS VTEC map over the array) — they pin the
        common-mode/profile component dTEC cannot observe.
        ``anchor_mode="sequential"`` (default, recommended) assimilates
        them into the prior mean once, before the dTEC solves — every
        solver mode (GN/LSQR/Kalman/EnKF) then starts from the corrected
        background; ``"joint"`` appends them as data rows of each MAP
        Gauss-Newton snapshot solve instead (needs generous cg_iters; see
        inversion/anchors.py on the truncated-CG direction competition).
        ``anchor_cov``: covariance of the background error the anchors
        correct (default: ``anchor_background_cov()`` — long-horizontal ×
        150 km-vertical, NOT the turbulence prior).

        ``probes`` (data.ionosonde.NeProbes): ionosonde point-density
        observations — the direct profile-*shape* channel (anchors pin
        only the column integral). With ``estimate_profile`` they join
        the joint (θ, δm) solve as extra rows (measured: multi-layer
        h_peak identifiability ~25 km → <2 km with two sounder
        stations); otherwise they are sequentially assimilated into the
        prior mean after the anchors, through a short-vertical-scale
        background covariance (inversion.anchors.assimilate_probes).
        """
        # anchor state never leaks between run() calls: a later
        # run(anchors=None) must be identical to a fresh pipeline's run
        self.anchors, self.anchor_cov = None, None
        self._profile_theta, self._profile_build = None, None
        self.m_prior = self._m_prior0
        if anchors is not None:
            from . import anchors as anchors_mod
            solver_name = self.config.solver.solver
            if anchor_mode == "joint" and solver_name != "map_gauss_newton":
                raise ValueError(
                    f"anchor_mode='joint' supports only the "
                    f"map_gauss_newton solver (got '{solver_name}'): the "
                    "other modes would silently ignore the anchors — use "
                    "anchor_mode='sequential', which works with every "
                    "solver (and re-anchors per epoch in kalman mode)")
            if anchor_mode == "joint" and self.config.solver.estimate_profile:
                raise ValueError(
                    "solver.estimate_profile requires "
                    "anchor_mode='sequential': the profile solve consumes "
                    "the anchors up front and installs the estimated "
                    "profile as the prior; with 'joint' it would be "
                    "silently skipped")
            self.metrics.write(dict(event="tec_anchors", mode=anchor_mode,
                                    n=int(anchors.values.shape[0])))
            self.anchor_cov = anchor_cov or self.anchor_background_cov()
            if anchor_mode == "sequential":
                if self.config.solver.estimate_profile:
                    # parametric profile estimation REPLACES the fixed-
                    # profile anchor assimilation: theta is solved from
                    # timestep-0 data + the anchors, and the estimated
                    # profile becomes the run's prior mean
                    # (inversion/profile.py; slant anchors recommended —
                    # vertical columns pin the column, not the shape)
                    self._estimate_profile(anchors, probes)
                else:
                    # the run's (quadrature, interp) thread through so
                    # the sequential anchor fit uses the same operator
                    # discretization as the solves (VERDICT r3 weak #3)
                    self.m_prior = anchors_mod.assimilate_anchors(
                        self.grid, self.m_prior, self.anchor_cov, anchors,
                        quadrature=self.config.rays.quadrature,
                        interp=self.config.rays.interp)
                if solver_name in ("kalman", "enkf"):
                    # time-evolving runs re-anchor every epoch (the state
                    # drifts; the filters' per-step anchor sub-update)
                    self.anchors = anchors
            else:
                self.anchors = anchors
        elif self.config.solver.estimate_profile:
            raise ValueError(
                "solver.estimate_profile needs absolute-TEC anchors "
                "(run(anchors=...)): the profile shape is measured to be "
                "unobservable from dTEC alone (DESIGN.md §8 null-result "
                "study); provide multi-elevation slant anchors "
                "(inversion.anchors.slant_bundle)")
        if probes is not None:
            self.metrics.write(dict(event="ionosonde_probes",
                                    n=int(probes.values.shape[0])))
            if not self.config.solver.estimate_profile:
                # sequential probe assimilation into the prior mean,
                # after the anchors (the profile-shape correction gets
                # the last word); with estimate_profile the probes were
                # already consumed by the joint (θ, δm) solve above
                from .anchors import assimilate_probes
                self.m_prior = assimilate_probes(
                    self.grid, self.m_prior, probes,
                    interp=self.config.rays.interp)
        rt = self.config.runtime
        if rt.profile_dir:
            from ..utils.metrics import profile_to
            with profile_to(rt.profile_dir):
                return self._run_inner(resume)
        return self._run_inner(resume)

    def _run_inner(self, resume: bool = True) -> Solution:
        rt = self.config.runtime
        nt = self.d_obs.shape[1]
        start_t, state = 0, None
        if resume:
            step, state, cfg_json = ckpt_mod.resume(rt.checkpoint_dir)
            if state is not None and not self._config_compatible(cfg_json):
                self.metrics.write(dict(
                    event="checkpoint_config_mismatch", action="ignored",
                    checkpoint_dir=rt.checkpoint_dir, step=step))
                step, state = 0, None
            start_t = step
        m_list = list(state["m_seq"][:start_t]) if state is not None else []

        if self.config.solver.solver == "kalman":
            return self._run_kalman(start_t=start_t, state=state)
        if self.config.solver.solver == "enkf":
            return self._run_enkf(start_t=start_t, state=state)
        if self.config.solver.solver == "batched_gn":
            if start_t >= nt:
                return Solution(self.grid, np.stack(m_list),
                                config_json=self.config.to_json())
            return self._run_batched()

        # warm start from the last checkpointed state, exactly as the
        # uninterrupted run would have chained timesteps
        sc = self.config.solver
        m_prev = (jnp.asarray(m_list[-1]) if m_list else None)
        std_list = (list(state["m_std"][:start_t])
                    if state is not None and "m_std" in state else [])
        for t in range(start_t, nt):
            m_t, diag = self.solve_snapshot(t, m0=m_prev)
            m_list.append(np.asarray(m_t))
            m_prev = m_t
            if sc.posterior_samples > 0:
                std = self.posterior_std(t, sc.posterior_samples,
                                         m_field=m_t)
                std_list.append(np.asarray(std))
                diag["posterior_std_mean"] = float(jnp.mean(std))
            self.metrics.write(diag)
            if (t + 1) % rt.checkpoint_every == 0 or t == nt - 1:
                state_out = {"m_seq": np.stack(m_list)}
                if std_list:
                    state_out["m_std"] = np.stack(std_list)
                ckpt_mod.save_checkpoint(
                    rt.checkpoint_dir, t + 1,
                    state_out, self.config.to_json())
        diags = dict(std_seq=np.stack(std_list)) if std_list else None
        return Solution(self.grid, np.stack(m_list), diagnostics=diags,
                        config_json=self.config.to_json())

    def _run_enkf(self, start_t: int = 0, state=None) -> Solution:
        """Ensemble Kalman mode: time-propagated posterior uncertainty
        (mean + spread per timestep). Chunked and resumable exactly like
        the point filter — the full ensemble is checkpointed and per-step
        randomness is keyed by the global timestep (fold_in), so chunked,
        resumed and single-scan runs are identical.
        """
        sc, rt = self.config.solver, self.config.runtime
        nd = self.directions.shape[1]
        nt = self.d_obs.shape[1]
        chunk = max(1, sc.kalman_chunk)
        dt_s = (float(np.diff(self.datapack.times).mean() * 86400.0)
                if nt > 1 else 0.0)
        if state is not None and "wind_kmps" in state:
            wind = np.asarray(state["wind_kmps"])
        else:
            wind = self._estimate_wind(nt, dt_s)
        wind = self._maybe_shear_state(wind)
        key = jax.random.key(rt.seed)
        mean_list = (list(state["m_seq"][:start_t])
                     if state is not None else [])
        std_list = (list(state["enkf_std"][:start_t])
                    if state is not None and "enkf_std" in state else [])
        pre = (list(state["kalman_pre"][:start_t])
               if state is not None and "kalman_pre" in state else [])
        ens = (jnp.asarray(state["enkf_ensemble"])
               if state is not None and start_t > 0
               and "enkf_ensemble" in state else None)
        member_mode = (self.mesh is not None and sc.enkf_shard == "members")
        if member_mode:
            # P3 member parallelism: each device owns enkf_members/n_dev
            # members end-to-end (kalman.member_parallel_enkf) — rays
            # stay replicated, the ensemble axis shards
            m_mesh = shard_mod.member_mesh()
            if sc.enkf_members % m_mesh.devices.size:
                raise ValueError(
                    f"enkf_shard='members' needs enkf_members "
                    f"({sc.enkf_members}) divisible by the device count "
                    f"({m_mesh.devices.size})")
            if ens is None:
                ens = initial_ensemble(self.grid, self.cov, self.m_prior,
                                       key, sc.enkf_members)
            ens = jax.device_put(jnp.asarray(ens),
                                 shard_mod.member_sharding(m_mesh))
        noise_scale = (float(state["noise_scale"])
                       if state is not None and "noise_scale" in state
                       else 1.0)
        t0 = time.perf_counter()
        for c0 in range(start_t, nt, chunk):
            c1 = min(c0 + chunk, nt)
            if (sc.noise_adapt_every > 0 and c0 > 0
                    and (c0 // chunk) % sc.noise_adapt_every == 0):
                # online R adaptation at chunk boundaries, linearised
                # about the ensemble mean (the point filter's doc above;
                # same cold-start skip)
                m_lin = (jnp.asarray(mean_list[-1]) if mean_list
                         else self.m_prior)
                rho = self._fit_noise_scale(c0, m_lin, noise_scale)
                noise_scale *= rho
                self.metrics.write(dict(event="noise_adapted", t=c0,
                                        rho=rho, noise_scale=noise_scale))
            if (sc.diag_spectrum_every > 0
                    and (c0 // chunk) % sc.diag_spectrum_every == 0):
                self._diag_spectrum(
                    c0, jnp.asarray(mean_list[-1]) if mean_list
                    else self.m_prior, noise_scale)
            rays_seq, inner_seq, d_chunk, noise_chunk = \
                self._chunk_arrays(c0, c1, shard=not member_mode)
            filter_fn = (partial(member_parallel_enkf, m_mesh)
                         if member_mode else ensemble_kalman_filter)
            res = filter_fn(
                self.grid, rays_seq, d_chunk,
                noise_chunk * noise_scale, self.m_prior, self.cov,
                wind, dt_s, num_directions=nd, key=key,
                n_members=sc.enkf_members, i0=self.i0,
                cg_iters=sc.cg_iters, cg_tol=sc.cg_tol,
                fade=sc.kalman_fade,
                process_sigma=sc.enkf_process_sigma,
                inflation=sc.enkf_inflation,
                spectrum_blend=sc.enkf_spectrum_blend,
                advect_first=(c0 > 0),
                m_clim=self.m_prior, ens0=ens, step_offset=c0,
                anchors=self.anchors,
                anchor_cov=(self.anchor_cov if self.anchors is not None
                            else None),
                anchor_update=sc.enkf_anchor_update,
                quadrature=self.config.rays.quadrature,
                interp=self.config.rays.interp,
                interp_inner=self.config.rays.interp_inner or None,
                m_clim_seq=self._clim_seq(c0, c1),
                rays_inner_seq=inner_seq,
                wind_adapt_iters=sc.wind_adapt_iters)
            jax.block_until_ready(res.mean_seq)
            mean_list.extend(np.asarray(res.mean_seq))
            std_list.extend(np.asarray(res.std_seq))
            pre.extend(np.asarray(res.residuals))
            ens = res.ensemble
            if sc.wind_adapt_iters > 0:
                wind = np.asarray(res.wind_seq[-1], np.float64)
            ckpt_mod.save_checkpoint(
                rt.checkpoint_dir, c1,
                {"m_seq": np.stack(mean_list),
                 "enkf_std": np.stack(std_list),
                 "kalman_pre": np.asarray(pre),
                 "enkf_ensemble": np.asarray(ens), "wind_kmps": wind,
                 "noise_scale": noise_scale},
                self.config.to_json())
            self.metrics.write(dict(solver="enkf", event="chunk",
                                    t_from=c0, t_to=c1,
                                    seconds=time.perf_counter() - t0))
        dt = time.perf_counter() - t0
        self.metrics.write(dict(solver="enkf", seconds=dt, timesteps=nt,
                                members=sc.enkf_members,
                                steps_per_sec=(nt - start_t) / max(dt, 1e-9)))
        return Solution(self.grid, np.stack(mean_list),
                        diagnostics=dict(
                            std_seq=np.stack(std_list),
                            pre_residuals=np.asarray(pre)),
                        config_json=self.config.to_json())

    def _run_batched(self) -> Solution:
        """SURVEY §2.1 P2 as one program: the reference ran independent
        time-chunks on separate dask workers; here every timestep is a
        batch row of ONE vmapped Gauss-Newton program (sharing the grid,
        prior and covariance), saturating the chip with a single compile.
        Timesteps are solved independently from the prior (no warm
        chaining) — use the sequential mode when the random-walk warm
        start matters, or Kalman when time coupling is physical. All-or-
        nothing (one checkpoint at the end): the program IS one step.
        """
        sc, rt = self.config.solver, self.config.runtime
        nd = self.directions.shape[1]
        nt = self.d_obs.shape[1]
        per_t = [self._padded_data(t) for t in range(nt)]
        bundles = [self._shard(self.rays_for_time(t, antennas=per_t[t][0]))
                   for t in range(nt)]
        rays_seq = rays_mod.RayBundle(
            points=jnp.stack([b.points for b in bundles]),
            ds=jnp.stack([b.ds for b in bundles]))
        d_seq = jnp.stack([p[1] for p in per_t])
        noise_seq = jnp.stack([p[2] for p in per_t])
        t0 = time.perf_counter()
        res = solvers.map_gauss_newton_batched(
            self.grid, rays_seq, d_seq, noise_seq, self.m_prior, self.cov,
            num_directions=nd, i0=self.i0, gn_iters=sc.gn_iters,
            cg_iters=sc.cg_iters, cg_tol=sc.cg_tol,
            quadrature=self.config.rays.quadrature,
                interp=self.config.rays.interp,
            rays_inner_seq=self._inner(rays_seq),
            warm_start=sc.warm_start,
            interp_inner=self.config.rays.interp_inner or None)
        jax.block_until_ready(res.m)
        dt = time.perf_counter() - t0
        self.metrics.write(dict(solver="batched_gn", seconds=dt,
                                timesteps=nt, timesteps_per_sec=nt / dt))
        ckpt_mod.save_checkpoint(rt.checkpoint_dir, nt,
                                 {"m_seq": np.asarray(res.m)},
                                 self.config.to_json())
        return Solution(self.grid, np.asarray(res.m),
                        diagnostics=dict(
                            residuals=np.asarray(res.residual_norm)),
                        config_json=self.config.to_json())

    def _maybe_shear_state(self, wind):
        """solver.wind_shear: promote a (3,) bulk wind to the (2,3)
        rigid+vertical-shear advection state (zero shear start — the
        shear row is learned online when wind_adapt_iters > 0; see
        frozen_flow.advect_periodic and DESIGN.md §12). Resumed states
        that are already (2,3) pass through unchanged."""
        if self.config.solver.wind_shear and np.ndim(wind) == 1:
            return np.stack([np.asarray(wind, np.float64), np.zeros(3)])
        return wind

    def _estimate_wind(self, nt: int, dt_s: float):
        """Bulk wind: datapack metadata when present (synthetic worlds),
        otherwise estimated from quick single-snapshot solves of the first
        two timesteps via the differentiable frozen-flow match."""
        wind = getattr(self.datapack, "wind_kmps", None)
        if wind is not None:
            return np.asarray(wind, np.float64)
        if nt >= 2 and dt_s > 0:
            m0_est, _ = self.solve_snapshot(0)
            m1_est, _ = self.solve_snapshot(1)
            from ..models.frozen_flow import estimate_wind
            v, _ = estimate_wind(m0_est - self.m_prior,
                                 m1_est - self.m_prior,
                                 self.grid, dt_s, n_iters=200)
            wind = np.asarray(v, np.float64)
            self.metrics.write(dict(event="wind_estimated",
                                    wind_kmps=list(map(float, wind))))
            return wind
        return np.zeros(3)

    def _run_kalman(self, start_t: int = 0, state=None) -> Solution:
        """Config-5 solver, chunked for fault tolerance: the Nt-step
        filter runs as ceil(Nt/kalman_chunk) scans,
        checkpointing the filtered sequence (+ wind) after each chunk.
        ``advect_first``/``m_clim`` make the chunked filter bit-identical
        to the single-scan filter (tests/test_kalman.py), and resume
        continues mid-sequence from the newest checkpoint (VERDICT r1 #5).
        """
        sc, rt = self.config.solver, self.config.runtime
        nd = self.directions.shape[1]
        nt = self.d_obs.shape[1]
        chunk = max(1, sc.kalman_chunk)
        dt_s = (float(np.diff(self.datapack.times).mean() * 86400.0)
                if nt > 1 else 0.0)
        if state is not None and "wind_kmps" in state:
            wind = np.asarray(state["wind_kmps"])
        else:
            wind = self._estimate_wind(nt, dt_s)
        wind = self._maybe_shear_state(wind)
        m_list = list(state["m_seq"][:start_t]) if state is not None else []
        pre = (list(state["kalman_pre"][:start_t])
               if state is not None and "kalman_pre" in state else [])
        post = (list(state["kalman_post"][:start_t])
                if state is not None and "kalman_post" in state else [])
        m_cur = jnp.asarray(m_list[-1]) if m_list else self.m_prior
        noise_scale = (float(state["noise_scale"])
                       if state is not None and "noise_scale" in state
                       else 1.0)
        t0 = time.perf_counter()
        for c0 in range(start_t, nt, chunk):
            c1 = min(c0 + chunk, nt)
            if (sc.noise_adapt_every > 0 and c0 > 0
                    and (c0 // chunk) % sc.noise_adapt_every == 0):
                # online R adaptation: per-chunk-boundary empirical-Bayes
                # ρ fit on the incoming innovation (absolute chunk index,
                # so resumed and uninterrupted runs adapt at the same
                # epochs). The cold c0=0 boundary is skipped: against an
                # unassimilated prior the innovation is all signal and
                # the fit conflates prior misspecification with noise
                rho = self._fit_noise_scale(c0, m_cur, noise_scale)
                noise_scale *= rho
                self.metrics.write(dict(event="noise_adapted", t=c0,
                                        rho=rho, noise_scale=noise_scale))
            if (sc.diag_spectrum_every > 0
                    and (c0 // chunk) % sc.diag_spectrum_every == 0):
                self._diag_spectrum(c0, m_cur, noise_scale)
            rays_seq, inner_seq, d_chunk, noise_chunk = \
                self._chunk_arrays(c0, c1)
            res = kalman_filter(
                self.grid, rays_seq, d_chunk, noise_chunk * noise_scale,
                m_cur, self.cov, wind, dt_s,
                num_directions=nd, i0=self.i0, cg_iters=sc.cg_iters,
                cg_tol=sc.cg_tol, fade=sc.kalman_fade,
                advect_first=(c0 > 0), m_clim=self.m_prior,
                anchors=self.anchors,
                anchor_cov=(self.anchor_cov if self.anchors is not None
                            else None),
                quadrature=self.config.rays.quadrature,
                interp=self.config.rays.interp,
                interp_inner=self.config.rays.interp_inner or None,
                m_clim_seq=self._clim_seq(c0, c1),
                rays_inner_seq=inner_seq,
                wind_adapt_iters=sc.wind_adapt_iters)
            jax.block_until_ready(res.m_seq)
            m_list.extend(np.asarray(res.m_seq))
            pre.extend(np.asarray(res.residuals))
            post.extend(np.asarray(res.post_residuals))
            m_cur = res.m_seq[-1]
            if sc.wind_adapt_iters > 0:
                # carry the refined wind into the next chunk AND the
                # checkpoint, so resume continues the adapted estimate
                wind = np.asarray(res.wind_seq[-1], np.float64)
            ckpt_mod.save_checkpoint(
                rt.checkpoint_dir, c1,
                {"m_seq": np.stack(m_list), "kalman_pre": np.asarray(pre),
                 "kalman_post": np.asarray(post), "wind_kmps": wind,
                 "noise_scale": noise_scale},
                self.config.to_json())
            self.metrics.write(dict(solver="kalman", event="chunk",
                                    t_from=c0, t_to=c1,
                                    seconds=time.perf_counter() - t0))
        dt = time.perf_counter() - t0
        self.metrics.write(dict(solver="kalman", seconds=dt, timesteps=nt,
                                steps_per_sec=(nt - start_t) / max(dt, 1e-9)))
        return Solution(self.grid, np.stack(m_list),
                        diagnostics=dict(
                            pre_residuals=np.asarray(pre),
                            post_residuals=np.asarray(post)),
                        config_json=self.config.to_json())
