"""Prior hyperparameter selection for the voxel inversion (GCV).

The reference fits GP hyperparameters by marginal likelihood for its
dense phase screens (utils/gaussian_process — SURVEY §2 "GP toolkit");
the voxel prior's (σ, L, kernel family) were left to the user. This
module closes that gap with **generalised cross-validation** on the
linearised problem — a held-out-error proxy that needs only matrix-free
solves:

    GCV(σ, L) = R · ‖(I − S) r‖² / (R − tr S)²,
    S = J C Jᵀ (J C Jᵀ + C_d)⁻¹   (the data-space influence matrix)

S·y is one covariance-preconditioned CG solve (identical machinery to
solvers.map_gauss_newton); tr S is estimated with Hutchinson Rademacher
probes — so a candidate costs (1 + n_probes) solves, all inside one jit.
The measured DESIGN.md prior-family study (sqexp leaves 2× the
held-out error of von Kármán on turbulent skies) is exactly the kind of
mistake this automates away.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..core import linalg
from ..core.grids import Grid3D
from ..geometry.rays import RayBundle
from .priors import GPCovariance
from .solvers import _dtec_operator


@partial(jax.jit, static_argnames=("num_directions", "i0", "cg_iters",
                                   "n_probes"))
def gcv_score(grid: Grid3D, rays: RayBundle, d_obs, noise_std, m0,
              cov: GPCovariance, num_directions: int, key, i0: int = 0,
              cg_iters: int = 30, cg_tol: float = 1e-4,
              n_probes: int = 4):
    """GCV score of one prior candidate (lower is better).

    Linearises about m0 (normally the prior mean) and scores how well the
    resulting posterior generalises: the numerator is the leave-out-like
    residual, the denominator penalises effective degrees of freedom
    tr S (estimated with ``n_probes`` Rademacher probes).
    """
    d = jnp.asarray(d_obs).ravel()
    cd_diag = jnp.broadcast_to(jnp.asarray(noise_std),
                               jnp.asarray(d_obs).shape).ravel() ** 2
    inv_cd = 1.0 / cd_diag
    apply_j, apply_jt, g0 = _dtec_operator(grid, rays, num_directions, i0,
                                           m0)
    r = d - g0

    def matvec(u):
        v = cov.apply_sqrt(u.reshape(grid.shape))
        w = apply_j(v) * inv_cd
        z = cov.apply_sqrt(apply_jt(w))
        return u + z.ravel()

    def s_apply(y):
        """S y = J·dm(y): the data-space prediction of the MAP update
        fitted to data-residual y."""
        rhs = cov.apply_sqrt(apply_jt(y * inv_cd)).ravel()
        u, _ = linalg.cg(matvec, rhs, max_iters=cg_iters, tol=cg_tol)
        return apply_j(cov.apply_sqrt(u.reshape(grid.shape)))

    s_r = s_apply(r)
    n_data = r.shape[0]
    z = (jax.random.rademacher(key, (n_probes, n_data))
         .astype(r.dtype))
    tr_s = jnp.mean(jax.vmap(lambda zz: jnp.vdot(zz, s_apply(zz)))(z))
    tr_s = jnp.clip(tr_s, 0.0, n_data - 1.0)
    resid = jnp.sum(((r - s_r) / jnp.sqrt(cd_diag)) ** 2)
    return n_data * resid / (n_data - tr_s) ** 2


def select_prior(grid: Grid3D, rays: RayBundle, d_obs, noise_std, m0,
                 candidates, num_directions: int, key=None, i0: int = 0,
                 cg_iters: int = 30, n_probes: int = 4):
    """Score a list of prior candidates and return the winner.

    candidates: iterable of dicts accepted by ``GPCovariance.create``
    (sigma, length_scale, kind). Returns (best_cov, best_params, scores)
    with scores a list aligned to candidates. Host loop over candidates
    (each is a different covariance spectrum — same compiled program).
    """
    key = jax.random.key(0) if key is None else key
    scores, covs = [], []
    for params in candidates:
        cov = GPCovariance.create(grid, **params)
        covs.append(cov)
        scores.append(float(gcv_score(
            grid, rays, d_obs, noise_std, m0, cov,
            num_directions=num_directions, key=key, i0=i0,
            cg_iters=cg_iters, n_probes=n_probes)))
    best = int(jnp.argmin(jnp.asarray(scores)))
    return covs[best], candidates[best], scores
