"""One frozen dataclass-tree configuration (SURVEY.md §5.6).

The reference passes physical constants as scattered kwargs; here every run
is described by a single immutable ``EngineConfig`` that is serialised into
every checkpoint (utils.checkpoint) and metrics stream, so any artifact is
reproducible from its own metadata. No global flags.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Tuple

from . import constants


@dataclasses.dataclass(frozen=True)
class PhysicsConfig:
    frequency_hz: float = constants.DEFAULT_FREQUENCY_HZ
    k_ne: float = constants.K_NE
    tec_scale: float = constants.TEC_SCALE
    max_length_km: float = constants.DEFAULT_MAX_LENGTH_KM
    chapman_n_peak: float = 1.0e12
    chapman_h_peak_km: float = 350.0
    chapman_scale_km: float = 80.0
    apriori_model: str = "chapman"    # | "multi_chapman" (E/F1/F2 stack +
                                      # plasmasphere; models/chapman.py)
    plasmasphere_n0: float = 0.0      # multi_chapman topside tail density
    time_varying_clim: bool = False   # recompute the climatological field
                                      # (Chapman × solar-zenith factor) per
                                      # epoch from the epoch timestamp in
                                      # the filters/serving, so the fade
                                      # pull tracks the day/night
                                      # terminator instead of a background
                                      # frozen at bootstrap
    curved_earth: bool = False        # evaluate the a-priori profile at true
                                      # altitude above the curved Earth (and
                                      # the solar factor per column) instead
                                      # of the flat ENU plane height — the
                                      # reference's astropy-exact geometry;
                                      # matters beyond ~200 km grid half-width


@dataclasses.dataclass(frozen=True)
class GridConfig:
    shape: Tuple[int, int, int] = (128, 128, 128)
    pad_km: float = 25.0
    h_min_km: float = 0.0


@dataclasses.dataclass(frozen=True)
class RayConfig:
    n_samples: int = constants.DEFAULT_N_SAMPLES   # straight-ray quadrature
    quadrature: str = "hermite"   # straight-ray operator rule: "hermite"
                                  # (gradient-augmented, production default
                                  # — equal-or-better skill at ~half the
                                  # samples; PRECISION.md round-3 study)
                                  # | "simpson" (the r2 operator)
    inner_samples: int = 0    # >0: mixed-fidelity (inexact Gauss-Newton)
                              # solves — the linear solve's Jacobian (rhs
                              # and matvec) from a coarse subsample of the
                              # fine bundle at this many samples; misfit
                              # and residuals stay full-fidelity. Measured
                              # frontier in DESIGN.md (config5 @65/
                              # inner@49: faster at BETTER held-out skill).
                              # Needs (n_samples-1) % (inner_samples-1)==0.
    interp: str = "cubic"   # C1 field model of the gridded log-density,
                            # everywhere the engine interpolates it (bent
                            # tracer AND the straight-ray TEC operators):
                            # "cubic" (Catmull-Rom tricubic, 16 row
                            # gathers — the r2 model) | "zp" (prefiltered
                            # Zwart-Powell box spline, 8 row gathers —
                            # 1.65x the cubic tracer's rays/s on one H100
                            # (PERF.md) at ~2x LOWER model error on
                            # band-limited fields; core.boxspline,
                            # DESIGN.md sec. 14)
    interp_inner: str = ""  # non-empty: mixed FIELD-MODEL fidelity — the
                            # linear solves' Jacobian (rhs and matvec)
                            # runs on this field model while residuals/
                            # misfit stay on `interp` (solvers.
                            # map_gauss_newton / kalman filters,
                            # interp_inner=). Production 256³ setting:
                            # interp="cubic", interp_inner="zp" — the
                            # 8-row operator drives the step at ~2× lower
                            # gather cost; its near-Nyquist xy bias never
                            # enters the misfit (DESIGN.md §14/§16).
                            # Composes with inner_samples.
    n_steps: int = 64     # bent-ray integrator; solver-grade per the
                          # PRECISION.md convergence study (128 buys nothing)
    method: str = "leapfrog"                       # "leapfrog" | "rk4"
    bent: bool = False
    retrace_every: int = 0    # bent only: re-trace rays through the updated
                              # model every N Gauss-Newton iterations — the
                              # reference's calc_rays-inside-the-iterate hot
                              # loop (SURVEY §3.1). 0 = paths frozen at the
                              # prior (pure linearised mode).
    beam_noise: int = 0       # >0: strong-turbulence forward-model error
                              # bar — trace a stochastic Fresnel beam of
                              # this many paths per ray each epoch
                              # (fermat.beam_noise_for_epoch) and inflate
                              # C_d in quadrature with the chaotic dTEC
                              # spread; logged as a beam_noise metrics
                              # event. 0 = off (the benign-regime
                              # default; the spread is a no-op there)
    beam_jitter_rad: float = 0.0   # beam launch jitter; 0 = the Fresnel
                                   # angle sqrt(lambda/L) default


@dataclasses.dataclass(frozen=True)
class PriorConfig:
    kind: str = "exponential"        # GP kernel family
    sigma: float = 0.3               # log-density std
    length_scale_km: float = 60.0    # scalar, or (Lx, Ly, Lz) tuple for an
                                     # anisotropic prior (priors.GPCovariance)
    smooth: float = 1.0              # Laplacian weight (config-3 solver)
    damp: float = 1e-2
    auto_select: object = False      # False | True/"gcv" (GCV over a
                                     # candidate grid, model_selection.py)
                                     # | "evidence" (SLQ marginal
                                     # likelihood, empirical_bayes.py —
                                     # prices the whole sigma axis per L)
    fit_noise: bool = False          # evidence mode only: also fit a common
                                     # noise rescaling rho from the same
                                     # Ritz decomposition (free) and scale
                                     # the run's noise_std by rho*


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    solver: str = "map_gauss_newton"  # | "lsqr_smoothness" | "steepest"
                                      # | "batched_gn" | "robust_gn"
                                      # | "kalman" | "enkf"
    huber_k: float = 3.0      # robust_gn: Huber threshold [sigma units]
    irls_iters: int = 3       # robust_gn: re-weighting rounds
    enkf_members: int = 8
    enkf_inflation: float = 1.0
    enkf_process_sigma: float = 0.0
    enkf_spectrum_blend: float = 0.0  # >0: per-step adaptive spectral gain
                                      # (shell-fitted prediction covariance;
                                      # inversion/kalman.py)
    enkf_shard: str = "rays"          # multi-device EnKF axis: "rays"
                                      # (data-parallel gathers, grid work
                                      # replicated) | "members" (each chip
                                      # owns n_members/n_devices members
                                      # end-to-end incl. the grid-sized FFT
                                      # covariance solves — kalman.
                                      # member_parallel_enkf; requires
                                      # enkf_members % n_devices == 0)
    enkf_anchor_update: str = "sqrt"  # anchored-EnKF member update:
                                      # "sqrt" (deterministic square-root,
                                      # no perturbed-anchor sampling noise)
                                      # | "stochastic" (perturbed values)
    estimate_profile: bool = False    # MAP-estimate the profile parameters
                                      # from timestep-0 data + slant anchors
                                      # before the run (inversion/profile):
                                      # the Chapman (N_peak, h_peak, H), or
                                      # per-layer over the E/F1/F2 stack
                                      # when apriori_model="multi_chapman".
                                      # Requires anchors — the profile is
                                      # measured unobservable without them
    profile_sigma: Tuple[float, float, float] = (0.7, 50.0, 30.0)
                                      # prior std of (log N_peak, h_peak
                                      # [km], H [km]) for the profile solve;
                                      # multi_chapman scales it per layer by
                                      # thickness (H_l / max H)
    gn_iters: int = 3
    cg_iters: int = 40
    cg_tol: float = 1e-4
    warm_start: bool = False  # snapshot GN modes: carry the whitened CG
                              # solution across Gauss-Newton iterations,
                              # IRLS rounds and bent re-trace calls
                              # (solvers.map_gauss_newton warm_start=) —
                              # same-data Krylov continuation, so
                              # cg_iters can drop ~2× at equal skill
                              # (DESIGN.md §16). NOT offered for
                              # the sequential filters: warm-starting
                              # across epochs accumulates fit depth
                              # against fresh noise and measurably
                              # diverges (DESIGN.md §16)
    lsqr_iters: int = 64
    kalman_fade: float = 1.0
    wind_adapt_iters: int = 0  # >0: kalman/serving online wind tracking —
                               # per-epoch innovation-GN refinement of the
                               # frozen-flow wind (kalman.kalman_filter);
                               # the refined wind is chunk-carried and
                               # checkpointed
    wind_shear: bool = False   # promote the wind to the (2,3) rigid+
                               # vertical-shear state (frozen_flow.
                               # advect_periodic; zero shear start) —
                               # with wind_adapt_iters > 0 the shear row
                               # is learned online
    kalman_chunk: int = 8     # timesteps per scan: the checkpoint
                              # granularity of the kalman/enkf runs
    posterior_samples: int = 0  # snapshot modes: >0 draws N linearised-
                                # posterior RTO samples per timestep
                                # (solvers.posterior_samples) and stores
                                # the per-voxel std as the solution's
                                # std_seq diagnostic (checkpointed,
                                # resumable)
    noise_adapt_every: int = 0  # kalman/enkf: >0 re-fits a common noise
                                # rescaling every N-th chunk boundary by
                                # the exact dense evidence on that
                                # epoch's innovation (batch adaptive R —
                                # pipeline._fit_noise_scale); the scale
                                # is checkpointed and resume-identical
    diag_spectrum_every: int = 0  # >0: surface the update operator's
                                # conditioning as a runtime diagnostic
                                # (VERDICT r4 #5) — every N-th chunk
                                # boundary (pipeline kalman/enkf) or
                                # N-th epoch (serving) logs an
                                # "update_spectrum" metrics event with
                                # the randomized top-rank eigenvalues of
                                # I + C^½JᵀC_d⁻¹JC^½ (kalman.
                                # update_operator_eigs). λ₁ bounds the
                                # operator's κ (spectrum ⊂ [1, λ₁]), so
                                # a deployment can see when it enters
                                # the f32 rounding-amplification regime
                                # (κ ~ 3e5 measured at 1e-3 TECU noise;
                                # tests/test_multichip.py docstring)
                                # without an offline re-run
    diag_spectrum_rank: int = 16  # eigenpairs per diagnostic event
    adapt_r: float = 0.0        # streaming adaptive R (online filters +
                                # serving): per-epoch innovation-
                                # consistency noise-scale MLE, EMA'd with
                                # this weight into the running scale
                                # (kalman._innov_noise_scale_sq /
                                # online._ema_scale); the scale persists
                                # in state.npz, restart-bit-identical


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    checkpoint_dir: str = "checkpoints"
    checkpoint_every: int = 1
    metrics_path: str = "metrics.jsonl"
    seed: int = 0
    nan_checks: bool = False          # jax.debug/checkify mode (SURVEY §5.2)
    profile_dir: str = ""             # non-empty: capture a jax.profiler
                                      # device trace of the run there
                                      # (SURVEY §5.1; view with xprof)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    physics: PhysicsConfig = PhysicsConfig()
    grid: GridConfig = GridConfig()
    rays: RayConfig = RayConfig()
    prior: PriorConfig = PriorConfig()
    solver: SolverConfig = SolverConfig()
    runtime: RuntimeConfig = RuntimeConfig()

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @staticmethod
    def from_json(text: str) -> "EngineConfig":
        raw = json.loads(text)
        return EngineConfig(
            physics=PhysicsConfig(**raw["physics"]),
            grid=GridConfig(shape=tuple(raw["grid"].pop("shape")),
                            **raw["grid"]),
            rays=RayConfig(**raw["rays"]),
            prior=PriorConfig(**raw["prior"]),
            solver=SolverConfig(
                **{**raw["solver"],
                   **({"profile_sigma":
                       tuple(raw["solver"]["profile_sigma"])}
                      if "profile_sigma" in raw["solver"] else {})}),
            runtime=RuntimeConfig(**raw["runtime"]),
        )
