"""Parametric vertical-profile estimation — closing dTEC's profile null
space with physics, not just anchoring (VERDICT r2 "next round" #3).

Measured background (DESIGN.md §8): dTEC is exactly blind to
the horizontally-uniform vertical profile; VTEC anchors pin the *column*
(the integral) but not its altitude *shape* — even multi-frequency bent
dTEC leaves the horizontally-averaged log-profile rms unmoved to 4 digits.
The physical channel that DOES constrain shape is **multi-elevation slant
absolute TEC** (e.g. GNSS slant observations, `anchors.slant_bundle`): a
slant path at elevation `el` weights altitude h by the geometry of its
crossing, so the set of slant TECs over elevations is a (mild) Abel-type
transform of the profile — peak height and scale height become
observable.

This module exploits it by making the Chapman profile parameters
θ = (log N_peak, h_peak, H) **explicit unknowns of the MAP solve**,
jointly with the voxel perturbation field:

    m_total(x) = chapman_log_field(grid; θ) + δm(x)
    minimise ½‖g(θ, δm) − d‖²_{C_d⁻¹} + ½‖δm‖²_{C⁻¹}
             + ½‖θ − θ0‖²_{Σ_θ⁻¹}

solved by Gauss-Newton with a block-preconditioned model-space CG: the
same C^{1/2} substitution as `solvers.map_gauss_newton` for δm, and the
prior std Σ_θ^{1/2} for θ — the joint system is identity-plus-PSD over
the (θ, δm) pytree and `core.linalg.cg` runs it directly (pytree
operands). AD provides the exact Jacobian columns ∂g/∂θ through the
analytic profile field — no finite differences, no special casing.

This is a capability the reference never had: its `a_priori_model`
parameters were fixed inputs (SURVEY.md §2 "A-priori ionosphere model");
here they are estimated from data.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .. import constants
from ..core import linalg
from ..core.grids import Grid3D
from ..forward import tec as tec_mod
from ..geometry.rays import RayBundle
from ..models import chapman
from .priors import GPCovariance


class ProfileParams(NamedTuple):
    """Chapman profile parameters as solve unknowns.

    log_n_peak: natural log of N_peak [m⁻³] (log keeps positivity and
    makes the prior scale-free); h_peak_km, scale_km in km.
    """

    log_n_peak: jax.Array
    h_peak_km: jax.Array
    scale_km: jax.Array

    @staticmethod
    def create(n_peak=1.0e12, h_peak_km=350.0, scale_km=80.0):
        return ProfileParams(
            log_n_peak=jnp.float32(jnp.log(n_peak)),
            h_peak_km=jnp.float32(h_peak_km),
            scale_km=jnp.float32(scale_km))

    @property
    def n_peak(self):
        return jnp.exp(self.log_n_peak)


def _altitude(grid: Grid3D, curved: bool):
    """Altitude coordinate the profile is evaluated at: the grid's z axis
    (flat ENU, (nz,)) or each voxel's true altitude above the curved
    Earth ((nx,ny,nz); models.chapman.altitude_field geometry). θ-free,
    so curvature costs the solve nothing extra."""
    if curved:
        from ..models.chapman import altitude_field
        return altitude_field(grid)
    return grid.origin[2] + grid.spacing[2] * jnp.arange(grid.shape[2])


def chapman_log_field(grid: Grid3D, theta: ProfileParams,
                      curved: bool = False) -> jax.Array:
    """Differentiable log-density field m(x) = log(n_e(x; θ)/K_NE) of the
    Chapman profile — the parametric background of the joint solve. Kept
    in pure jnp so jax.linearize yields the exact ∂field/∂θ Jacobian
    columns. ``curved=True`` evaluates the profile at true altitudes
    above the curved Earth (flat ENU planes are 12–25 km low at ±400 km;
    models/chapman.py)."""
    h = _altitude(grid, curved)
    zt = (h - theta.h_peak_km) / theta.scale_km
    log_ne = theta.log_n_peak + 0.5 * (1.0 - zt - jnp.exp(-zt))
    # the shared vacuum floor (models.chapman.M_FLOOR, applied to m
    # itself) — the steep bottomside otherwise reaches log-densities of
    # -100s (physically all zero) that would dominate norms and stiffen
    # the solve; one constant keeps parametric and gridded log-fields
    # identical in the vacuum tail (ADVICE r3)
    prof = jnp.maximum(log_ne - jnp.log(constants.K_NE), chapman.M_FLOOR)
    if curved:
        return prof
    return jnp.broadcast_to(prof[None, None, :], grid.shape)


def multi_chapman_log_field(grid: Grid3D, theta_arr: jax.Array,
                            curved: bool = False) -> jax.Array:
    """Differentiable multi-layer log-density field from a flat parameter
    vector ``theta_arr`` = (log N₁, h₁, H₁, log N₂, h₂, H₂, …) — the
    multi-layer (E/F1/F2…) analogue of ``chapman_log_field`` for the
    joint solve. Layers sum in density; logsumexp keeps the log-space
    form stable through the vacuum tails."""
    n_layers = theta_arr.shape[0] // 3
    h = _altitude(grid, curved)
    hh = h if curved else h[None, None, :]
    logs = []
    for l in range(n_layers):
        ln, hp, sc = theta_arr[3 * l], theta_arr[3 * l + 1],             theta_arr[3 * l + 2]
        zt = (hh - hp) / sc
        logs.append(ln + 0.5 * (1.0 - zt - jnp.exp(-zt)))
    log_ne = jax.scipy.special.logsumexp(jnp.stack(logs, axis=0), axis=0)
    prof = jnp.maximum(log_ne - jnp.log(constants.K_NE), chapman.M_FLOOR)
    return jnp.broadcast_to(prof, grid.shape)


class ProfileResult(NamedTuple):
    theta: ProfileParams       # estimated profile parameters
    m: jax.Array               # full field: chapman_log_field(θ) + δm
    delta_m: jax.Array         # voxel perturbation about the profile
    residual_norm: jax.Array   # final whitened data residual
    info: tuple


@partial(jax.jit, static_argnames=("num_directions", "i0", "gn_iters",
                                   "cg_iters", "quadrature", "interp",
                                   "field_builder"))
def map_gauss_newton_profile(grid: Grid3D, rays: RayBundle, d_obs,
                             noise_std, theta0, theta_sigma,
                             cov: GPCovariance,
                             num_directions: int, anchors=None,
                             i0: int = 0, gn_iters: int = 4,
                             cg_iters: int = 20, cg_tol: float = 1e-4,
                             quadrature: str = "hermite",
                             interp: str = "cubic",
                             field_builder=None, probes=None):
    """Joint MAP over (profile parameters θ, voxel perturbation δm).

    ``theta0``: prior mean of θ (the climatological guess);
    ``theta_sigma``: prior std per parameter, e.g. (0.7, 50.0, 30.0) —
    ~2× in N_peak, ±50 km peak height, ±30 km scale height.
    ``anchors`` (inversion.anchors.TecAnchors): absolute-TEC rows; use
    **multi-elevation slant anchors** (`anchors.slant_bundle`) — vertical
    columns alone constrain the column integral but barely the shape.
    dTEC rows keep constraining the 3-D turbulent structure exactly as in
    `solvers.map_gauss_newton`; θ rides along as 3 extra preconditioned
    unknowns whose Jacobian columns AD extracts from the analytic field.

    ``probes`` (data.ionosonde.NeProbes): optional point log-density rows
    (ionosonde bottomside profiles) — the direct profile-shape
    observation, linear in the total field m(θ, δm). Slant anchors
    constrain the profile only through a mild Abel-type transform; probe
    rows observe n_e(h) itself, so they dominate the θ update wherever a
    sounder exists (measured: tests/test_ionosonde.py — multi-layer
    h_peak identifiability tightens from ~25 km to a few km).

    ``field_builder`` (static; build once per configuration): optional
    ``theta_arr → log-density field`` replacing the default single
    flat-Earth Chapman — e.g.
    ``lambda t: chapman_log_field(grid, ProfileParams(t[0], t[1], t[2]),
    curved=True)`` or ``lambda t: multi_chapman_log_field(grid, t)``
    with a 3·n_layers ``theta0``/``theta_sigma`` vector (tighten the
    prior std on layers that should stay put). ``theta0`` may be a
    ProfileParams (default builder) or a flat parameter vector; the
    result's ``theta`` mirrors the input form.
    """
    d = jnp.asarray(d_obs).ravel()
    cd_diag = jnp.broadcast_to(jnp.asarray(noise_std),
                               jnp.asarray(d_obs).shape).ravel() ** 2
    from .solvers import _join_anchor_rows
    d, cd_diag = _join_anchor_rows(d, cd_diag, anchors, probes)
    inv_cd = 1.0 / cd_diag
    s_theta = jnp.asarray(theta_sigma, jnp.float32)
    as_params = isinstance(theta0, ProfileParams)
    t0 = (jnp.stack([theta0.log_n_peak, theta0.h_peak_km,
                     theta0.scale_km]).astype(jnp.float32)
          if as_params else jnp.asarray(theta0, jnp.float32))
    build = field_builder or (lambda t: chapman_log_field(
        grid, ProfileParams(t[0], t[1], t[2])))

    from .solvers import anchored_forward
    field_fwd = anchored_forward(grid, rays, num_directions, i0, anchors,
                                 quadrature, probes, interp)

    def fwd(theta_arr, dm):
        return field_fwd(build(theta_arr) + dm)

    def gn_step(carry, _):
        theta_k, dm_k = carry
        g0, jvp = jax.linearize(fwd, theta_k, dm_k)
        vjp = jax.linear_transpose(jvp, theta_k, dm_k)

        # prior pulls: Δθ = (θ0 − θk) + Σ^{1/2} v, Δδm = −δm_k + C^{1/2} u
        dt_pull = t0 - theta_k
        dm_pull = -dm_k
        r_hat = d - g0 - jvp(dt_pull, dm_pull)

        def matvec(x):
            v, u = x
            w = jvp(s_theta * v, cov.apply_sqrt(u)) * inv_cd
            tb, db = vjp(w)
            return (v + s_theta * tb, u + cov.apply_sqrt(db))

        tb0, db0 = vjp(r_hat * inv_cd)
        rhs = (s_theta * tb0, cov.apply_sqrt(db0))
        (v, u), info = linalg.cg(matvec, rhs, max_iters=cg_iters,
                                 tol=cg_tol)
        theta_n = theta_k + dt_pull + s_theta * v
        dm_n = dm_k + dm_pull + cov.apply_sqrt(u)
        res = jnp.linalg.norm((fwd(theta_n, dm_n) - d) / jnp.sqrt(cd_diag))
        return (theta_n, dm_n), (res, info.iterations)

    init = (t0, jnp.zeros(grid.shape, jnp.float32))
    (theta_f, dm_f), diags = jax.lax.scan(gn_step, init, None,
                                          length=gn_iters)
    theta = (ProfileParams(theta_f[0], theta_f[1], theta_f[2])
             if as_params else theta_f)
    m = build(theta_f) + dm_f
    return ProfileResult(theta=theta, m=m, delta_m=dm_f,
                         residual_norm=diags[0][-1], info=diags)


def log_profile_rms(m, m_true, grid: Grid3D, floor: float = -4.0
                    ) -> jax.Array:
    """Horizontally-averaged log-profile rms error — the metric of the
    round-2 null-result study (DESIGN.md §8): rms over z of the difference
    of horizontal means, restricted to altitudes where the true profile
    is populated (mean log-density above ``floor`` ≈ n_e > 2e9 m⁻³ at
    the default) — the exponential bottomside/vacuum tails are zero
    density under any profile and would otherwise dominate the metric.
    Measures exactly the component dTEC cannot see."""
    prof = jnp.mean(m, axis=(0, 1))
    prof_true = jnp.mean(m_true, axis=(0, 1))
    mask = prof_true > floor
    e2 = jnp.where(mask, (prof - prof_true) ** 2, 0.0)
    return jnp.sqrt(jnp.sum(e2) / jnp.maximum(mask.sum(), 1))
