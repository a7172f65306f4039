"""Bent-ray Fermat tracer (device-side) — the engine's hot kernel.

Physics (SURVEY.md §3.3 / §8): rays in an isotropic refractive medium obey
Fermat's principle; in arc-length parametrisation the Euler–Lagrange
equations are

    d/ds (n t̂) = ∇n,   dx/ds = t̂,

with t̂ the unit tangent. Writing p := n·t̂ gives the first-order system
dx/ds = p/|p|, dp/ds = ∇n(x). The refractive index is the cold-plasma
Appleton–Hartree form n = sqrt(1 − KAPPA·n_e/f²), n_e = K_NE·exp(m(x)) from
the tricubic-interpolated log-density field.

Accelerator design (vs the reference's per-ray scipy.integrate.odeint, its
biggest bottleneck): a **fixed-step RK4 under lax.scan, batched over the
whole ray bundle** — the RHS operates on (R,3) arrays directly so every
integrator stage is one fused gather+arithmetic program over all rays; the
TEC path integral rides along as extra ODE state (dτ/ds = n_e), integrated
at the same 4th order. No Python in the loop, no host round-trips; state
(x, p, τ) stays on the device across the scan.

Step-count contract (SURVEY.md §7 "Bent-ray step control"): the
PRECISION.md convergence study against the adaptive f64 oracle fixes
solver-grade at leapfrog@64 — both endpoint and TEC error sit at the
f32/interpolant floor there, and 128 steps buys nothing measurable.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .. import constants
from ..core import boxspline, tricubic, triquadratic, zpcubic
from ..core.grids import Grid3D
from .rays import RayBundle


def refractive_index(ne, frequency_hz):
    """n = sqrt(1 − KAPPA·n_e/f²), clipped above 0 for over-dense plasma."""
    w = constants.KAPPA / (frequency_hz * frequency_hz)
    return jnp.sqrt(jnp.maximum(1.0 - w * ne, 1e-6))


def log_field_ne_vg(interp_vg):
    """Adapt a log-density evaluator ``interp_vg(x) -> (m, ∇m)`` to the
    integrator's native (n_e, ∇n_e) contract: n_e = K_NE·e^m,
    ∇n_e = n_e·∇m [m⁻³/km]. The default full-field path (trace_rays) and
    the halo-exchange sharded path both wrap through here; the split-field
    tracer (trace_rays_split) supplies (n_e, ∇n_e) directly."""

    def ne_vg(x):
        m, gm = interp_vg(x)
        ne = constants.K_NE * jnp.exp(m)
        return ne, ne[:, None] * gm

    return ne_vg


def _rhs(ne_vg, x: jax.Array, p: jax.Array, inv_f2: jax.Array):
    """Batched ODE right-hand side.

    x, p: (R, 3). Returns (dx/ds (R,3), dp/ds (R,3), n_e (R,), dn_e/ds).
    One field evaluation per stage serves all four.
    ``ne_vg(x) -> (n_e, ∇n_e [m⁻³/km])`` is the field evaluator — the
    row-gather fast path over a replicated log-density grid by default
    (trace_rays, via ``log_field_ne_vg``), the shard_map halo-exchange
    path for x-sharded grids (parallel.grid_sharding.trace_rays_sharded),
    or the analytic-background + gathered-perturbation split field
    (``trace_rays_split``).
    """
    ne, gne = ne_vg(x)                                    # (R,), (R, 3)
    w = constants.KAPPA * inv_f2
    clipped = 1.0 - w * ne <= 1e-6                        # over-dense plasma
    n = jnp.sqrt(jnp.maximum(1.0 - w * ne, 1e-6))         # (R,)
    # ∇n = -KAPPA/(2 n f²) · ∇n_e.  Where the over-dense clip is active n
    # is held constant, so its gradient must be zeroed too — otherwise the
    # 1/n≈1e-3 division manufactures huge unphysical forces at low
    # frequency (ADVICE r1).
    grad_n = jnp.where(clipped[:, None], 0.0,
                       (-0.5 * w / n)[:, None] * gne)      # (R, 3)
    tangent = p / jnp.linalg.norm(p, axis=-1, keepdims=True)
    # path derivative of n_e: dn_e/ds = ∇n_e·t̂ — free from the same
    # gather; feeds the Hermite (4th-order) TEC quadrature in leapfrog
    dne_ds = jnp.einsum("rd,rd->r", gne, tangent)
    return tangent, grad_n, ne, dne_ds


def field_evaluator(field_m: jax.Array, grid: Grid3D,
                    interp: str = "cubic"):
    """Build the log-density ``(m, ∇m)`` evaluator for a given C¹ field
    model, paying any prefilter/layout cost once (outside scans).

    - ``cubic``: Catmull-Rom tricubic, 16 row gathers/eval — the
      historical model, the most accurate *convolution* kernel here.
    - ``zp``: Zwart-Powell box spline ⊗ quadratic-z, **8 row gathers** —
      half of cubic's rows, AND ~2× lower value/gradient model error
      than ``cubic`` on band-limited fields (core.boxspline; round-3
      study, DESIGN.md §14).
    - ``quadratic``: tensor quadratic B-spline, 9 row gathers — the
      tensor-product C¹ minimum; accuracy of ``zp``, speed of ``cubic``
      (9 rows falls off the aligned-gather fast path). Kept for study
      parity (core.triquadratic).

    All three are C¹ models of the same grid samples with exact AD.
    """
    nx, ny, nz = grid.shape
    if interp == "cubic":
        field2d = field_m.reshape(nx * ny, nz)
        return lambda x: tricubic.interp_rows_with_grad(field2d, grid, x)
    if interp.startswith("zpc"):     # before "zp": shared prefix
        order = zpcubic.zpc_order(interp)
        coef2d = zpcubic.prefilter(field_m, order).reshape(nx * ny, nz)
        return lambda x: zpcubic.interp_rows_with_grad(coef2d, grid, x)
    if interp.startswith("zp"):
        order = boxspline.zp_order(interp)
        coef2d = boxspline.prefilter(field_m, order).reshape(nx * ny, nz)
        return lambda x: boxspline.interp_rows_with_grad(coef2d, grid, x)
    if interp == "quadratic":
        coef2d = triquadratic.prefilter(field_m).reshape(nx * ny, nz)
        return lambda x: triquadratic.interp_rows_with_grad(coef2d, grid,
                                                            x)
    raise ValueError(f"unknown interp: {interp!r}")


@partial(jax.jit, static_argnames=("n_steps", "keep_path", "method",
                                   "interp"))
def trace_rays(field_m: jax.Array, grid: Grid3D, origins: jax.Array,
               directions: jax.Array, frequency_hz,
               max_length_km=constants.DEFAULT_MAX_LENGTH_KM,
               n_steps: int = 128, keep_path: bool = True,
               method: str = "rk4", interp: str = "cubic"):
    """Trace all rays at once; returns (RayBundle, tec).

    origins, directions: (R, 3), directions unit-norm. The bundle holds
    n_steps+1 uniformly-spaced (in arc length) sample positions per ray —
    directly consumable by the linearised forward operator — and ``tec`` is
    the path integral of n_e in TEC_SCALE working units.

    With ``keep_path=False`` only the endpoint state is kept (the benchmark
    configuration: rays/sec with TEC, minimal HBM traffic).

    Integrators:
    - ``rk4``: classic 4-stage Runge-Kutta, 4 field evaluations/step, TEC
      integrated at 4th order. The accuracy reference.
    - ``leapfrog``: velocity-Verlet kick-drift with the field gradient
      carried between steps — **one** field evaluation/step (4× fewer
      gathers than rk4), 2nd order in the path, **Hermite (4th-order)
      TEC** from the same gather. Since the gather dominates the cost
      of a step, leapfrog dominates rk4 in accuracy-per-second;
      leapfrog@64 is solver-grade (PRECISION.md) and
      the benchmark/production configuration (see bench.py).

    ``interp`` selects the C¹ field model (see ``field_evaluator``):
    "cubic" (historical), "zp" (8-row box spline — faster AND lower
    model error; the round-3 headline configuration), "quadratic".
    """
    interp_vg = field_evaluator(field_m, grid, interp)
    return _trace_impl(log_field_ne_vg(interp_vg), origins, directions,
                       frequency_hz, max_length_km, n_steps, keep_path,
                       method)


def _trace_impl(ne_vg, origins, directions, frequency_hz,
                max_length_km, n_steps, keep_path, method):
    """Integrator core over an arbitrary (n_e, ∇n_e) field evaluator
    (see _rhs; log-density evaluators wrap via log_field_ne_vg)."""
    origins = jnp.asarray(origins, jnp.float32)
    directions = jnp.asarray(directions, jnp.float32)
    h = jnp.float32(max_length_km / n_steps)
    inv_f2 = jnp.float32(1.0 / (frequency_hz * frequency_hz))
    # initial momentum p0 = n(x0)·t̂0
    ne0_init, _ = ne_vg(origins)
    n0 = refractive_index(ne0_init, frequency_hz)
    p0 = n0[:, None] * directions

    tau0 = jnp.zeros(origins.shape[0], jnp.float32)
    tec_unit = constants.KM_TO_M / constants.TEC_SCALE

    if method == "rk4":

        def step(carry, _):
            x, p, tau = carry
            k1x, k1p, ne1, _ = _rhs(ne_vg, x, p, inv_f2)
            k2x, k2p, ne2, _ = _rhs(ne_vg, x + 0.5 * h * k1x,
                                    p + 0.5 * h * k1p, inv_f2)
            k3x, k3p, ne3, _ = _rhs(ne_vg, x + 0.5 * h * k2x,
                                    p + 0.5 * h * k2p, inv_f2)
            k4x, k4p, ne4, _ = _rhs(ne_vg, x + h * k3x,
                                    p + h * k3p, inv_f2)
            sixth = h / 6.0
            x_new = x + sixth * (k1x + 2 * k2x + 2 * k3x + k4x)
            p_new = p + sixth * (k1p + 2 * k2p + 2 * k3p + k4p)
            tau_new = tau + sixth * (ne1 + 2 * ne2 + 2 * ne3 + ne4) \
                * tec_unit
            out = x_new if keep_path else None
            return (x_new, p_new, tau_new), out

        (x_f, p_f, tau_f), path = jax.lax.scan(
            step, (origins, p0, tau0), None, length=n_steps)

    elif method == "leapfrog":
        # velocity-Verlet: carry (x, p, ∇n(x), n_e(x), dn_e/ds(x), τ); one
        # field evaluation per step. TEC accumulates by the **Hermite
        # (cubic-osculatory) rule**: ∫ f ds over a step ≈ h/2·(f₀+f₁) +
        # h²/12·(f₀′−f₁′), 4th-order using the path derivative the gather
        # already yields — two orders better than trapezoid at zero extra
        # gathers (convergence table in PRECISION.md).
        _, gn0, ne0, dne0 = _rhs(ne_vg, origins, p0, inv_f2)

        def step(carry, _):
            x, p, gn, ne, dne, tau = carry
            p_half = p + (0.5 * h) * gn
            x_new = x + h * (p_half / jnp.linalg.norm(p_half, axis=-1,
                                                      keepdims=True))
            _, gn_new, ne_new, dne_new = _rhs(ne_vg, x_new, p_half,
                                              inv_f2)
            p_new = p_half + (0.5 * h) * gn_new
            tau_new = tau + ((0.5 * h) * (ne + ne_new)
                             + (h * h / 12.0) * (dne - dne_new)) * tec_unit
            out = x_new if keep_path else None
            return (x_new, p_new, gn_new, ne_new, dne_new, tau_new), out

        (x_f, p_f, _, _, _, tau_f), path = jax.lax.scan(
            step, (origins, p0, gn0, ne0, dne0, tau0), None, length=n_steps)

    else:
        raise ValueError(f"unknown method: {method}")

    if keep_path:
        pts = jnp.concatenate([origins[:, None, :],
                               jnp.moveaxis(path, 0, 1)], axis=1)
    else:
        pts = jnp.stack([origins, x_f], axis=1)
    ds = jnp.full((origins.shape[0],), h, jnp.float32)
    return RayBundle(points=pts, ds=ds), tau_f


@partial(jax.jit, static_argnames=("n_steps", "keep_path", "method",
                                   "background"))
def trace_rays_split(field_m: jax.Array, grid: Grid3D, origins: jax.Array,
                     directions: jax.Array, frequency_hz,
                     background,
                     max_length_km=constants.DEFAULT_MAX_LENGTH_KM,
                     n_steps: int = 32, keep_path: bool = True,
                     method: str = "leapfrog"):
    """Split-field bent trace: n_e = analytic background + gathered
    perturbation (VERDICT r2 "split-field tracer" experiment, shipped).

    ``background`` is a closed-form evaluator from
    ``models.chapman.background_ne_fn`` (hashable/static — build it once
    per configuration). The perturbation grid δ = K_NE·e^{m} −
    n_e_bg(grid points) is formed once per call; each integrator step
    then pays the same 16 row gathers as the full-field tracer for δ
    only, while the background profile is evaluated in closed form with
    its exact gradient.

    **What this buys (measured — DESIGN.md §9):** exactness in the
    background — the profile no longer passes through the grid at all,
    so coarse grids cost nothing where the field is smooth (the
    zero-perturbation test traces exactly on an 8³ grid), and parametric
    backgrounds (h_peak, N_peak, H as solve unknowns) get exact
    gather-free physics. **What it does NOT buy:** fewer integrator
    steps on turbulent fields — the round-3 step-count study measured
    split@N ≈ full@N error at every N, grid and frequency tried, because
    fixed-step error is dominated by the turbulent perturbation's
    gradients, which both tracers resolve identically. The step-count
    contract (leapfrog@64, PRECISION.md) carries over unchanged.

    The field model differs from the full-field tracer's (tricubic of
    log n_e vs analytic + tricubic of δn_e): both are C¹ models of the
    same grid data; each has its own f64 oracle parity test.
    """
    nx, ny, nz = grid.shape
    ax, ay, az = grid.axes()                      # jnp — traceable
    pts = jnp.stack(jnp.meshgrid(ax, ay, az, indexing="ij"),
                    axis=-1).reshape(-1, 3)
    ne_bg_grid, _ = background(pts)
    pert = (constants.K_NE * jnp.exp(field_m)
            - ne_bg_grid.reshape(grid.shape))
    pert2d = pert.reshape(nx * ny, nz)

    def ne_vg(x):
        d, gd = tricubic.interp_rows_with_grad(pert2d, grid, x)
        nb, gb = background(x)
        return nb + d, gb + gd

    return _trace_impl(ne_vg, origins, directions, frequency_hz,
                       max_length_km, n_steps, keep_path, method)


def trace_rays_callable(ne_and_grad, origins: jax.Array,
                        directions: jax.Array, frequency_hz,
                        max_length_km=constants.DEFAULT_MAX_LENGTH_KM,
                        n_steps: int = 128, keep_path: bool = True,
                        method: str = "rk4"):
    """Bent trace over an arbitrary closed-form field evaluator
    ``ne_and_grad(x (R, 3)) → (n_e (R,), ∇n_e (R, 3) [m⁻³/km])`` — no
    grid, no interpolant (the device twin of the f64 oracle's
    ``trace_ray_callable_ref``). Use for analytic worlds, e.g. the
    Fourier-mode von Kármán truth of ``models.turbulence.analytic_ne_fn``
    that the honest inversion benches trace data through (so no solver's
    interpolation model secretly defines reality — bench/common.
    analytic_world). Callers jit; ``ne_and_grad`` is closed over."""
    return _trace_impl(ne_and_grad, origins, directions, frequency_hz,
                       max_length_km, n_steps, keep_path, method)


def straight_line_limit_error(field_m, grid, origins, directions,
                              frequency_hz, max_length_km, n_steps=128):
    """Max endpoint deviation [km] from the straight path — diagnostics and
    the n→1 invariant test (SURVEY.md §4: "bent ray → straight ray in the
    limit of zero density / high frequency")."""
    bundle, _ = trace_rays(field_m, grid, origins, directions, frequency_hz,
                           max_length_km, n_steps)
    straight_end = origins + max_length_km * directions
    return jnp.linalg.norm(bundle.points[:, -1] - straight_end, axis=-1)


def trace_rays_stochastic(field_m: jax.Array, grid: Grid3D,
                          origins: jax.Array, directions: jax.Array,
                          frequency_hz, key, n_paths: int = 8,
                          jitter_rad: float = None,
                          max_length_km=constants.DEFAULT_MAX_LENGTH_KM,
                          n_steps: int = 64, method: str = "leapfrog",
                          interp: str = "cubic"):
    """Beam-ensemble (stochastic) trace for the strong-turbulence regime.

    At σ_log ≳ 0.3 the Fermat endpoint is chaotic: true neighbouring
    rays diverge, a single deterministic trace is accurate only for its
    exact launch direction, and the endpoint error vs an adaptive f64
    oracle stops converging with step count (measured, DESIGN.md §9).
    The physically meaningful observable there is the beam average —
    an antenna receives power over its Fresnel zone, not along one
    mathematical ray. This traces ``n_paths`` rays per (origin,
    direction) with launch directions perturbed transversally by
    N(0, jitter_rad²) per axis, and returns

      (tec_mean, tec_std, endpoint_rms)  — each (R,)

    tec_mean: the beam-averaged TEC (the robust forward value);
    tec_std: per-ray chaotic TEC spread — the forward-model error bar
    for this regime, directly usable as observation-noise inflation
    (C_d ← C_d + diag(tec_std²) in the solvers' whitened misfits);
    endpoint_rms: rms 3-D distance of path endpoints from their mean —
    ≈ jitter·L geometric fan-out in the benign regime, amplified
    ~1.0–1.6× by bending at ~8-outer-scale path lengths (measured;
    the *discriminating* chaos observable is tec_std, which grows
    ~50× from amp 0.02/150 MHz to amp 0.3/60 MHz in the same test).

    ``jitter_rad`` defaults to the Fresnel angle sqrt(λ/L) — the
    smallest transverse scale a physical beam distinguishes; in weak
    turbulence this leaves tec_std ≪ |tec| (test_fermat.py), so the
    function degrades gracefully to the deterministic trace. Cost:
    n_paths × the deterministic trace, all paths one vmapped program
    (gathers stay batched). The per-path
    randomness is keyed only by ``key`` — chunked/resumed callers get
    identical beams from identical keys.
    """
    origins = jnp.asarray(origins, jnp.float32)
    directions = jnp.asarray(directions, jnp.float32)
    if jitter_rad is None:
        lam_km = 299792.458 / float(frequency_hz)      # c [km/s] / f
        jitter_rad = float(lam_km / max_length_km) ** 0.5

    # transverse orthonormal basis per ray (any smooth completion works;
    # the jitter is isotropic in the transverse plane)
    helper = jnp.where(jnp.abs(directions[:, 2:3]) < 0.9,
                       jnp.asarray([0.0, 0.0, 1.0], jnp.float32),
                       jnp.asarray([1.0, 0.0, 0.0], jnp.float32))
    e1 = jnp.cross(directions, jnp.broadcast_to(helper, directions.shape))
    e1 = e1 / jnp.linalg.norm(e1, axis=-1, keepdims=True)
    e2 = jnp.cross(directions, e1)

    # path 0 is the unperturbed central ray; paths 1..n-1 jittered
    eps = jax.random.normal(key, (n_paths - 1, directions.shape[0], 2),
                            jnp.float32) * jnp.float32(jitter_rad)
    d_pert = (directions[None] + eps[..., 0:1] * e1[None]
              + eps[..., 1:2] * e2[None])
    d_all = jnp.concatenate([directions[None], d_pert], axis=0)
    d_all = d_all / jnp.linalg.norm(d_all, axis=-1, keepdims=True)

    def one(dirs_p):
        bundle, tec = trace_rays(field_m, grid, origins, dirs_p,
                                 frequency_hz, max_length_km,
                                 n_steps=n_steps, keep_path=False,
                                 method=method, interp=interp)
        return tec, bundle.points[:, -1]

    tec_p, ends = jax.vmap(one)(d_all)           # (P, R), (P, R, 3)
    tec_mean = tec_p.mean(0)
    tec_std = tec_p.std(0)
    end_mu = ends.mean(0)
    endpoint_rms = jnp.sqrt(
        jnp.sum((ends - end_mu[None]) ** 2, axis=-1).mean(0))
    return tec_mean, tec_std, endpoint_rms


def beam_noise_for_epoch(field_m: jax.Array, grid: Grid3D, antennas_enu,
                         directions_enu, frequency_hz, key,
                         n_paths: int = 8, num_directions: int = None,
                         i0: int = 0, jitter_rad: float = None,
                         max_length_km=constants.DEFAULT_MAX_LENGTH_KM,
                         n_steps: int = 64, method: str = "leapfrog",
                         interp: str = "cubic") -> jax.Array:
    """Per-(antenna, direction) dTEC observation-noise inflation from the
    chaotic beam spread — the production entry point of the strong-
    turbulence error bar (VERDICT r3 weak #5 plumbing).

    Traces one ``trace_rays_stochastic`` beam per (antenna × direction)
    ray through ``field_m`` (the best current field estimate — the prior
    for batch solves, the filter state for streaming) and maps the
    per-ray chaotic TEC spreads into dTEC noise rows via
    ``forward.tec.dtec_noise_from_beam``. Add the result in quadrature to
    the instrument noise: ``noise_eff = sqrt(noise² + beam²)`` — rays
    whose Fresnel beam decoheres (long, low-elevation, strong-turbulence
    paths) are automatically down-weighted in every C_d⁻¹ misfit instead
    of dragging the reconstruction with un-modellable refraction error.
    In the benign regime the spread is ≪ the instrument noise and the
    inflation is a no-op (measured, test_fermat.py).

    Returns an (Na, Nd) array in TEC working units. Deterministic given
    ``key`` — callers derive it from the epoch index so chunked/resumed
    runs inflate identically.
    """
    from ..forward.tec import dtec_noise_from_beam
    from .rays import make_ray_batch

    dirs = jnp.asarray(directions_enu, jnp.float32)
    origins, dvecs = make_ray_batch(antennas_enu, dirs)
    _, tec_std, _ = trace_rays_stochastic(
        field_m, grid, origins, dvecs, frequency_hz, key,
        n_paths=n_paths, jitter_rad=jitter_rad,
        max_length_km=max_length_km, n_steps=n_steps, method=method,
        interp=interp)
    nd = dirs.shape[0] if num_directions is None else int(num_directions)
    return dtec_noise_from_beam(tec_std, nd, i0)
