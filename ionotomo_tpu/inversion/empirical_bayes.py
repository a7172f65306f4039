"""Empirical-Bayes prior hyperparameter estimation from the dTEC data.

The reference fixes its prior covariance hyperparameters by hand (SURVEY.md
§2 "Prior covariance operator"; its GP toolkit fits marginal likelihoods
only for 2-D antenna screens). This module completes that layer for the 3-D
field prior: estimate the von Kármán (or any GPCovariance family)
hyperparameters (σ_m, L) **from the observed dTEC itself** by maximising
the exact linear-Gaussian marginal likelihood

    r = d − g(m_prior) ~ N(0, S(γ, L)),   S = γ·J C₀(L) Jᵀ + σ_n² I

where J is the linearised dTEC operator about the prior mean, C₀ the
unit-variance covariance, and γ = σ_m². Both terms of

    −2 log ML = rᵀ S⁻¹ r + logdet S + n log 2π

are evaluated matrix-free with **stochastic Lanczos quadrature** (SLQ;
Ubaru–Chen–Saad 2017): Lanczos tridiagonalisation of the PSD data-space
operator A = J C₀ Jᵀ turns f(S) quadratic forms into k-point Gauss
quadratures on the Ritz values,

    logdet S ≈ (n/m) Σ_i Σ_j w_ij · log(γ θ_ij + σ_n²)       (probes z_i)
    rᵀS⁻¹r  ≈ ‖r‖²  Σ_j w_j  / (γ θ_j  + σ_n²)              (seed r/‖r‖)

Structure: S is an **affine family in (γ, ρ²)** over a fixed
A (ρ rescales the noise), so ONE spectral factorisation of A prices the
*entire* (γ, ρ) plane for free; only the outer loop over candidate L
re-factorises (the covariance spectrum is a pytree data field, so every
L reuses one compiled program). Two factorisation regimes:

- **dense** (n ≤ ~4k — pipeline bootstrap scale): A assembled by n
  chunked batched matvecs (one XLA program) + one (n, n)
  eigh → the family is EXACT. Cost ≈ n forward/adjoint pairs.
- **slq** (large n): stochastic Lanczos quadrature (Ubaru–Chen–Saad
  2017) as below — (n_probes+1)·k forward/adjoint pairs ≈ one MAP
  solve. Accurate for the γ axis; the ρ axis needs the small-eigenvalue
  tail of a ~10-decade spectrum, which k-node quadrature cannot place
  nodes in — prefer dense wherever ρ is being fitted.

Full reorthogonalisation keeps the f32 Lanczos honest (k ≤ 64, V is
(k, n_data) — a few MB); the dense (k, k) eigenproblems are trivial and
vmapped. Accuracy is validated against dense logdet/solves in
tests/test_empirical_bayes.py, and hyperparameter recovery on data drawn
from a known prior.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core.grids import Grid3D
from ..geometry.rays import RayBundle
from .priors import GPCovariance
from .solvers import _dtec_operator


def _lanczos_batch(matvec, v0s, k):
    """Lanczos with full reorthogonalisation, vmapped over seed vectors.

    ``v0s`` (m, n) unit-norm seeds; ``matvec`` maps (m, n) → (m, n)
    (batched). Returns (alphas (m, k), betas (m, k-1)). Breakdown
    (β → 0: the Krylov space is exhausted, e.g. n small or A low-rank)
    is guarded by freezing the recursion — the spurious trailing Ritz
    values get ~zero quadrature weight.
    """
    m, n = v0s.shape

    def step(carry, _):
        V, v, v_prev, beta_prev, j = carry
        w = matvec(v)
        # contractions over the data axis as axis-reductions, not
        # dot_general: the data axis may be ray-sharded (pipeline use),
        # and reductions lower to an unambiguous psum while a sharded
        # dot contraction needs an explicit out_sharding
        alpha = jnp.sum(w * v, axis=1)
        w = w - alpha[:, None] * v - beta_prev[:, None] * v_prev
        # full reorthogonalisation against all stored vectors (V holds
        # zeros beyond step j, which project to nothing)
        proj = jnp.sum(V * w[:, None, :], axis=-1)
        w = w - jnp.sum(proj[:, :, None] * V, axis=1)
        beta = jnp.linalg.norm(w, axis=1)
        ok = beta > 1e-7
        v_next = jnp.where(ok[:, None], w / jnp.maximum(beta, 1e-30)[:, None],
                           v)
        # one-hot write (not .at[].set): propagates a sharded data axis
        # cleanly, and the final step (j+1 == k) is naturally a no-op
        onehot = (jnp.arange(V.shape[1]) == j + 1)
        V_next = jnp.where(onehot[None, :, None],
                           jnp.where(ok[:, None], v_next, 0.0)[:, None, :],
                           V)
        carry = (V_next, jnp.where(ok[:, None], v_next, v),
                 jnp.where(ok[:, None], v, v_prev),
                 jnp.where(ok, beta, 0.0), j + 1)
        return carry, (alpha, jnp.where(ok, beta, 0.0))

    V0 = jnp.where((jnp.arange(k) == 0)[None, :, None], v0s[:, None, :],
                   jnp.zeros((m, k, n), v0s.dtype))
    carry = (V0, v0s, jnp.zeros_like(v0s), jnp.zeros((m,), v0s.dtype),
             jnp.asarray(0))
    _, (alphas, betas) = jax.lax.scan(step, carry, None, length=k)
    # alphas (k, m) → (m, k); betas: last one closes the recursion only
    return alphas.T, betas.T[:, :-1]


def _ritz(alphas, betas):
    """Ritz values θ (m, k) and quadrature weights w = (e₁ᵀq)² (m, k)
    from batched Lanczos tridiagonals."""
    T = jax.vmap(lambda a, b: jnp.diag(a) + jnp.diag(b, 1) + jnp.diag(b, -1)
                 )(alphas, betas)
    theta, Q = jnp.linalg.eigh(T)
    w = Q[:, 0, :] ** 2
    return theta, w


def log_marginal_family(grid: Grid3D, rays: RayBundle, d_obs, noise_std,
                        m_prior, cov_unit: GPCovariance, gammas,
                        num_directions: int, i0: int = 0,
                        quadrature: str = "hermite",
                        interp: str = "cubic", n_probes: int = 8,
                        lanczos_iters: int = 48,
                        key=jax.random.key(0), noise_scales=None,
                        method: str = "slq"):
    """log ML(γ[, ρ]) for S = γ·J C₀ Jᵀ + ρ²·diag(σ_n²).

    One spectral factorisation prices the whole family: in whitened form
    S̃ = γ·Ã + ρ²·I, so BOTH the prior-variance axis γ = σ_m² and the
    noise-scale axis ρ (a common rescaling of the supplied noise_std —
    real instruments' noise estimates are routinely off by a factor)
    are closed-form in the γ/ρ-independent spectrum of Ã.
    Returns (log_ml (n_γ,), diag) when ``noise_scales`` is None, else
    (log_ml (n_γ, n_ρ), diag).

    ``method="slq"`` estimates the spectrum by stochastic Lanczos
    quadrature — (n_probes+1)·k matvecs, any n. ``method="dense"``
    builds Ã explicitly with n chunked matvecs and eigendecomposes it —
    EXACT for every (γ, ρ). The distinction matters for the ρ axis: Ã's
    spectrum spans ~10 decades and the noise scale lives in its small-
    eigenvalue tail, which a k-node quadrature on a Rademacher measure
    cannot place nodes in (the smallest node lands ~λ_max/k², decades
    above the noise floor — measured: the SLQ ρ axis is flat where the
    dense axis has 600-unit log-evidence contrasts). Setup-scale data
    spaces (n = Na·Nd ≲ 4096 at pipeline bootstrap) should use dense;
    fit_hyperparameters switches automatically.
    """
    if method == "dense":
        A, r, logdet_noise = _assemble_dense(
            grid, rays, d_obs, noise_std, m_prior, cov_unit,
            num_directions, i0, quadrature, interp)
        # the (n, n) eigh runs on host LAPACK in true f64: the device
        # path is f32 without x64, and the ρ-sensitive small-eigenvalue
        # tail of the ~10-decade spectrum needs better than f32 here
        # (measured: f32 eigh leaves ~1% log-evidence error in the
        # small-ρ corners). Assembly — the expensive part — stays one
        # XLA program above.
        A64 = np.asarray(jax.device_get(A), np.float64)
        r64 = np.asarray(jax.device_get(r), np.float64)
        n = r64.shape[0]
        lam, U = np.linalg.eigh(0.5 * (A64 + A64.T))
        lam = np.maximum(lam, 0.0)
        proj2 = (U.T @ r64) ** 2
        r_norm2 = float(r64 @ r64)
        th_z = lam[None, :]                 # exact spectrum, weight 1/n
        w_z = np.full((1, n), 1.0 / n)
        th_r, w_r = lam, proj2 / max(r_norm2, 1e-30)
        ld_noise = float(logdet_noise)
    else:
        th, w, r_norm, logdet_noise = _slq_summary(
            grid, rays, d_obs, noise_std, m_prior, cov_unit,
            num_directions, i0, quadrature, interp, n_probes,
            lanczos_iters, key)
        th = np.asarray(jax.device_get(th), np.float64)
        w = np.asarray(jax.device_get(w), np.float64)
        n = int(np.prod(np.shape(d_obs)))
        th_z, w_z = th[:-1], w[:-1]   # probe runs → logdet
        th_r, w_r = th[-1], w[-1]     # data-seeded run → quadratic form
        r_norm2 = float(r_norm) ** 2
        ld_noise = float(logdet_noise)

    gammas_np = np.asarray(gammas, np.float64).ravel()
    rho2s = (np.asarray([1.0], np.float64) if noise_scales is None
             else np.asarray(noise_scales, np.float64).ravel() ** 2)

    # pricing is closed form in the factorisation — negligible cost, so
    # it runs on host in f64 for both methods
    g = gammas_np[:, None, None]                     # (nγ, 1, 1)
    p = rho2s[None, :, None]                         # (1, nρ, 1)
    logdet = n * np.mean(
        np.sum(w_z[None, None] * np.log(g[..., None] * th_z[None, None]
                                        + p[..., None]), axis=-1),
        axis=-1) + ld_noise                          # (nγ, nρ)
    quad = r_norm2 * np.sum(w_r / (g * th_r[None, None] + p), axis=-1)
    log_ml = -0.5 * (quad + logdet + n * np.log(2 * np.pi))
    if noise_scales is None:
        log_ml = log_ml[:, 0]
    return log_ml, {"ritz_probe": th_z, "ritz_data": th_r,
                    "r_norm": np.sqrt(r_norm2)}


def _whitened_operator(grid, rays, d_obs, noise_std, m_prior, cov_unit,
                       num_directions, i0, quadrature, interp):
    """Shared prep: whitened residual r̃, batched matvec of
    Ã = D^{-1/2} J C₀ Jᵀ D^{-1/2}, and logdet of the noise whitener.

    Heteroscedastic noise (scalar or per-datum) is absorbed by the
    whitening so the family stays affine: S̃ = γ·Ã + ρ²·I with
    logdet S = logdet S̃ + Σ log σᵢ².
    """
    d = jnp.asarray(d_obs, jnp.float32).ravel()
    n = d.shape[0]
    apply_j, apply_jt, g0 = _dtec_operator(grid, rays, num_directions, i0,
                                           m_prior, None,
                                           quadrature=quadrature,
                                           interp=interp)
    sd = jnp.broadcast_to(
        jnp.asarray(noise_std, jnp.float32).ravel()
        if jnp.ndim(jnp.asarray(noise_std)) else
        jnp.asarray(noise_std, jnp.float32), (n,))
    inv_sd = 1.0 / jnp.maximum(sd, 1e-30)
    r = inv_sd * (d - g0)
    logdet_noise = 2.0 * jnp.sum(jnp.log(sd))

    def a_single(y):
        v = cov_unit.apply(apply_jt(inv_sd * y))
        return inv_sd * apply_j(v)

    return jax.vmap(a_single), r, logdet_noise


@partial(jax.jit, static_argnames=("num_directions", "i0", "quadrature",
                                   "interp"))
def _assemble_dense(grid: Grid3D, rays: RayBundle, d_obs, noise_std,
                    m_prior, cov_unit: GPCovariance, num_directions: int,
                    i0: int, quadrature: str, interp: str):
    """Ã assembled column-block-wise (chunked so the batched grid-sized
    intermediates stay bounded) — one XLA program, n matvecs."""
    a_batched, r, logdet_noise = _whitened_operator(
        grid, rays, d_obs, noise_std, m_prior, cov_unit, num_directions,
        i0, quadrature, interp)
    n = r.shape[0]
    chunk = 128
    n_pad = -(-n // chunk) * chunk
    eye = jnp.eye(n_pad, n, dtype=jnp.float32)
    cols = jax.lax.map(a_batched, eye.reshape(-1, chunk, n))
    A = cols.reshape(n_pad, n)[:n]          # row i = (Ã e_i)ᵀ = column i
    try:
        sh = jax.typeof(A).sharding
        if any(s is not None for s in sh.spec):
            # pipeline use: the matvec output carries the ray sharding —
            # gather the (small) matrix before it leaves the program
            A = jax.sharding.reshard(
                A, jax.sharding.NamedSharding(
                    sh.mesh,
                    jax.sharding.PartitionSpec(*([None] * A.ndim))))
            r = jax.sharding.reshard(
                r, jax.sharding.NamedSharding(
                    sh.mesh, jax.sharding.PartitionSpec(None)))
    except Exception:
        pass
    return A, r, logdet_noise


@partial(jax.jit, static_argnames=("num_directions", "i0", "quadrature",
                                   "interp", "n_probes", "lanczos_iters"))
def _slq_summary(grid: Grid3D, rays: RayBundle, d_obs, noise_std, m_prior,
                 cov_unit: GPCovariance, num_directions: int, i0: int,
                 quadrature: str, interp: str, n_probes: int,
                 lanczos_iters: int, key):
    """Ritz values + Gauss-quadrature weights for n_probes Rademacher
    seeds and the data seed — one batched Lanczos program."""
    a_batched, r, logdet_noise = _whitened_operator(
        grid, rays, d_obs, noise_std, m_prior, cov_unit, num_directions,
        i0, quadrature, interp)
    n = r.shape[0]
    z = jax.random.rademacher(key, (n_probes, n), jnp.float32)
    z = z / jnp.sqrt(jnp.float32(n))
    r_norm = jnp.linalg.norm(r)
    seeds = jnp.concatenate([z, (r / jnp.maximum(r_norm, 1e-30))[None]], 0)
    alphas, betas = _lanczos_batch(a_batched, seeds, lanczos_iters)
    theta, w = _ritz(alphas, betas)
    theta = jnp.maximum(theta, 0.0)  # Ã is PSD; clip f32 Ritz leakage
    return theta, w, r_norm, logdet_noise


def fit_hyperparameters(grid: Grid3D, rays: RayBundle, d_obs, noise_std,
                        m_prior, num_directions: int,
                        length_scales, sigmas, kind: str = "von_karman",
                        i0: int = 0, quadrature: str = "hermite",
                        interp: str = "cubic", n_probes: int = 8,
                        lanczos_iters: int = 48, seed: int = 0,
                        noise_scales=None, dense_threshold: int = 4096):
    """Maximise the dTEC marginal likelihood over (σ_m, L[, ρ]) grids.

    Host loop over ``length_scales`` (each L is one spectral
    factorisation; the covariance spectrum is a pytree data field so all
    L share one compile); the σ_m axis — and, when ``noise_scales`` is
    given, the noise-rescaling ρ axis — is priced in closed form from
    each factorisation. Data spaces up to ``dense_threshold`` rows use
    the exact dense-eigendecomposition family (required for a trustworthy
    ρ axis — see log_marginal_family); larger ones fall back to SLQ.
    Returns (sigma*, length_scale*, ll_table (n_L, n_σ), fitted
    GPCovariance); with ``noise_scales``: (sigma*, length_scale*, rho*,
    ll_table (n_L, n_σ, n_ρ), fitted GPCovariance).
    """
    length_scales = [float(v) for v in np.asarray(length_scales).ravel()]
    sigmas = np.asarray(sigmas, np.float64).ravel()
    n_data = int(np.prod(np.shape(d_obs)))
    lanczos_iters = min(lanczos_iters, n_data)
    # (k > n buys nothing: the Krylov space is exhausted)
    method = "dense" if n_data <= dense_threshold else "slq"
    gammas = jnp.asarray(sigmas**2, jnp.float32)
    rhos = (None if noise_scales is None
            else jnp.asarray(np.asarray(noise_scales, np.float64).ravel(),
                             jnp.float32))
    template = None
    rows = []
    key = jax.random.key(seed)
    for ell in length_scales:
        cov_l = GPCovariance.create(grid, sigma=1.0, length_scale=ell,
                                    kind=kind)
        if template is None:
            # constant pytree metadata across L → one compiled program
            template = dataclasses.replace(cov_l, length_scale=-1.0,
                                           sigma=1.0)
        cov_t = dataclasses.replace(template, spectrum=cov_l.spectrum)
        ll, _ = log_marginal_family(grid, rays, d_obs, noise_std, m_prior,
                                    cov_t, gammas, num_directions, i0,
                                    quadrature, interp, n_probes,
                                    lanczos_iters, key,
                                    noise_scales=rhos, method=method)
        rows.append(np.asarray(ll))
    table = np.stack(rows)             # (n_L, n_sigma[, n_rho])
    idx = np.unravel_index(int(np.argmax(table)), table.shape)
    sigma_star = float(sigmas[idx[1]])
    ell_star = float(length_scales[idx[0]])
    cov_star = GPCovariance.create(grid, sigma=sigma_star,
                                   length_scale=ell_star, kind=kind)
    if noise_scales is None:
        return sigma_star, ell_star, table, cov_star
    rho_star = float(np.asarray(noise_scales, np.float64).ravel()[idx[2]])
    return sigma_star, ell_star, rho_star, table, cov_star
