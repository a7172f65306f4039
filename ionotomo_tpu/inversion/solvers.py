"""Tomographic inversion solvers (configs 3–4 of BASELINE.json).

Three device-resident solvers, all matrix-free over the frozen-path ray
operator (paths from geometry.rays or geometry.fermat are fixed during the
solve; only the field varies — standard linearisation, matching the
reference's per-iteration ray freeze, SURVEY.md §3.1):

- ``lsqr_smoothness``: config 3 — linear LSQR on the damped ray–voxel
  system with a gradient-smoothness prior.
- ``map_gauss_newton``: config 4 — Bayesian MAP with a GP covariance
  prior: Gauss-Newton outer loop, C^{1/2}-preconditioned model-space CG
  inner solves (identity-plus-PSD systems; see its docstring).
- ``posterior_samples``: randomise-then-optimise posterior draws (vmapped
  batched Krylov).
- ``map_gauss_newton_batched``: independent snapshots as one vmapped batch.
- ``steepest_descent_map``: the reference's own iteration (covariance-
  preconditioned gradient + line search, SURVEY.md §8) for parity testing.

All loops are jit-compiled end-to-end: state lives in HBM, zero host
round-trips (SURVEY.md north-star).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import linalg
from ..core.grids import Grid3D
from ..forward import tec as tec_mod
from ..geometry.rays import RayBundle
from .priors import GPCovariance, laplacian


class InversionResult(NamedTuple):
    m: jax.Array               # reconstructed log-density field
    residual_norm: jax.Array   # ‖W(g(m) − d)‖ final
    info: tuple                # solver-specific diagnostics
    u_final: jax.Array = None  # whitened departure C^{-1/2}(m − m_prior)
                               # when warm_start=True — carry it into the
                               # next solve over the same data (bent
                               # re-trace / IRLS rounds) as u0


def anchored_forward(grid: Grid3D, rays: RayBundle, num_directions: int,
                     i0: int, anchors=None, quadrature: str = "hermite",
                     probes=None, interp: str = "cubic"):
    """``fwd(m) → stacked data vector`` — paired dTEC rows plus optional
    absolute-TEC anchor rows plus optional point-density probe rows
    (data/ionosonde.py; linear in m), with the sharded-rays/replicated-
    extras concat handling in one place (shared by ``_dtec_operator`` and
    the parametric profile solve, inversion/profile.py). Row order is
    [dTEC, anchors, probes] — ``_join_anchor_rows`` must match."""

    def fwd(m):
        g = tec_mod.dtec_paired_q(m, grid, rays, num_directions, i0,
                                  quadrature, interp).ravel()
        if anchors is None and probes is None:
            return g
        extra = []
        if anchors is not None:
            extra.append(tec_mod.tec_q(m, grid, anchors.rays, quadrature,
                                       interp))
        if probes is not None:
            extra.append(tec_mod.log_ne_at(m, grid, probes.points,
                                           interp))
        try:
            sh_g = jax.typeof(g).sharding
            if any(s is not None for s in sh_g.spec):
                # rays-sharded dTEC + replicated anchor rows: gather the
                # (small) dTEC vector so the stacked data space is
                # replicated — concatenate cannot mix shardings. The
                # replicated target is built from g's OWN mesh: the
                # anchor rows may carry an empty-mesh sharding when the
                # bundle was never device_put onto the ray mesh.
                g = jax.sharding.reshard(
                    g, jax.sharding.NamedSharding(
                        sh_g.mesh, jax.sharding.PartitionSpec(None)))
        except Exception:
            pass
        return jnp.concatenate([g, *extra])

    return fwd


def _dtec_operator(grid: Grid3D, rays: RayBundle, num_directions: int,
                   i0: int, m0: jax.Array, anchors=None,
                   quadrature: str = "hermite", probes=None,
                   interp: str = "cubic"):
    """Linearised dTEC operator about m0 and its exact transpose.

    J δm = dtec'(m0)[δm]; both directions via jax JVP/VJP of the paired
    forward — XLA turns the gather into the scatter-add adjoint
    automatically, which matches the hand adjoint (tested).
    Returns (apply, applyT, g0) with data space flattened to (Na*Nd,).

    ``anchors`` (inversion.anchors.TecAnchors): absolute-TEC rows appended
    to the data space (Na*Nd + A,) — external VTEC constraints that pin
    the common-mode component dTEC cannot see.

    ``quadrature``: "simpson" (historical default) or "hermite" — the
    gradient-augmented rule reaching equal accuracy at ~half the samples
    (forward.tec.tec_hermite; round-3 study in PRECISION.md).
    """

    fwd = anchored_forward(grid, rays, num_directions, i0, anchors,
                           quadrature, probes, interp)
    g0, jvp_lin = jax.linearize(fwd, m0)
    applyT = jax.linear_transpose(jvp_lin, m0)

    def apply(dm):
        return jvp_lin(dm)

    def applyt(y):
        (out,) = applyT(y)
        return out

    return apply, applyt, g0


def _join_anchor_rows(d, cd_diag, anchors, probes=None):
    """Append absolute-TEC anchor rows and point-density probe rows
    (data/ionosonde.py) to a flattened data vector and its noise-variance
    diagonal — same [dTEC, anchors, probes] row order as
    ``anchored_forward`` (shared by map_gauss_newton, posterior_samples
    and the parametric profile solve)."""
    if anchors is not None:
        ca = jnp.broadcast_to(jnp.asarray(anchors.noise_std),
                              anchors.values.shape).ravel() ** 2
        d = jnp.concatenate([d, anchors.values])
        cd_diag = jnp.concatenate([cd_diag, ca])
    if probes is not None:
        cp = jnp.broadcast_to(jnp.asarray(probes.noise_std),
                              probes.values.shape).ravel() ** 2
        d = jnp.concatenate([d, probes.values])
        cd_diag = jnp.concatenate([cd_diag, cp])
    return d, cd_diag


@partial(jax.jit, static_argnames=("num_directions", "i0", "max_iters",
                                   "quadrature", "interp"))
def lsqr_smoothness(grid: Grid3D, rays: RayBundle, d_obs, noise_std,
                    m0, num_directions: int, i0: int = 0,
                    damp: float = 1e-2, smooth: float = 1.0,
                    max_iters: int = 64, quadrature: str = "hermite",
                    interp: str = "cubic"):
    """Config 3: single-snapshot linear inversion with smoothness prior.

    Solves min ‖W(J δm − r)‖² + damp²‖δm‖² + smooth²‖L δm‖² by LSQR on the
    stacked operator [W J; smooth·L; damp·I] — matrix-free, one jit.
    d_obs: (Na, Nd) observed dTEC; noise_std broadcastable to it.
    """
    w = 1.0 / jnp.maximum(jnp.asarray(noise_std), 1e-12)
    w = jnp.broadcast_to(w, d_obs.shape).ravel()
    apply_j, apply_jt, g0 = _dtec_operator(grid, rays, num_directions, i0,
                                           m0, quadrature=quadrature,
                                           interp=interp)
    r = (jnp.asarray(d_obs).ravel() - g0) * w
    nvox = grid.num_voxels

    def aop(x):
        dm = x.reshape(grid.shape)
        top = apply_j(dm) * w
        mid = smooth * laplacian(dm, grid).ravel()
        return jnp.concatenate([top, mid])

    def atop(y):
        y1 = y[: r.shape[0]] * w
        y2 = y[r.shape[0]:].reshape(grid.shape)
        out = apply_jt(y1.reshape(-1)) + smooth * laplacian(y2, grid)
        return out.ravel()

    b = jnp.concatenate([r, jnp.zeros((nvox,), r.dtype)])
    dm, info = linalg.lsqr(aop, atop, b, jnp.zeros((nvox,), r.dtype),
                           damp=damp, max_iters=max_iters)
    m = m0 + dm.reshape(grid.shape)
    res = jnp.linalg.norm(apply_j(dm.reshape(grid.shape)) * w - r)
    return InversionResult(m=m, residual_norm=res, info=(info,))


@partial(jax.jit, static_argnames=("num_directions", "i0", "gn_iters",
                                   "cg_iters", "quadrature", "interp",
                                   "warm_start", "interp_inner"))
def map_gauss_newton(grid: Grid3D, rays: RayBundle, d_obs, noise_std,
                     m_prior, cov: GPCovariance, num_directions: int,
                     i0: int = 0, gn_iters: int = 3, cg_iters: int = 40,
                     cg_tol: float = 1e-4, m0=None, anchors=None,
                     quadrature: str = "hermite", probes=None,
                     rays_inner: RayBundle = None,
                     interp: str = "cubic",
                     warm_start: bool = False, u0=None,
                     interp_inner: str = None):
    """Config 4: Bayesian MAP with GP covariance prior.

    Minimises S(m) = ½‖g(m)−d‖²_{C_d⁻¹} + ½‖m−m_prior‖²_{C_m⁻¹}
    (SURVEY.md §8) by Gauss-Newton with **C^{1/2}-preconditioned
    model-space CG**: substituting δm = (m_prior − m_k) + C^{1/2} u turns
    each inner system into (I + C^{1/2} Jᵀ C_d⁻¹ J C^{1/2}) u = rhs — an
    identity-plus-PSD operator whose truncated-CG iterates are themselves
    regularised steps (each CG iteration fits one more dominant data
    direction, the rest stays at the prior). The raw representer system
    (J C Jᵀ + C_d) is catastrophically ill-conditioned at high SNR and
    diverges under truncated CG; this is the standard B^{1/2} trick from
    variational data assimilation.

    ``m0``: warm-start iterate (defaults to m_prior). The prior pull stays
    anchored at m_prior either way — used by the nonlinear bent-ray outer
    loop, which re-traces rays through the current iterate and continues
    the solve from it (pipeline.solve_snapshot).

    ``anchors`` (inversion.anchors.TecAnchors): optional absolute-TEC
    constraints (e.g. a GNSS VTEC map) appended as extra data rows —
    they observe the common-mode component that dTEC cannot, shrinking
    the null space that dominates model-space error.

    ``probes`` (data.ionosonde.NeProbes): optional point log-density rows
    (ionosonde bottomside profiles) — exactly linear in m, they observe
    the profile *shape* that neither dTEC nor column anchors can.

    ``rays_inner``: optional coarser-sampled bundle over the same
    geometry (e.g. hermite@33 vs @65) supplying the linear solve's
    Jacobian (rhs and matvec) — mixed-fidelity inexact Gauss-Newton;
    residuals stay full-fidelity; see ``kalman_filter``. Anchor/probe
    rows are shared, so row shapes are unchanged.

    ``interp_inner``: mixed FIELD-MODEL fidelity — the linear solve's
    Jacobian (rhs and matvec) evaluates on this field model while the
    residuals/misfit stay on ``interp``. The production 256³ case is
    interp="cubic", interp_inner="zp": the 8-row box-spline operator is
    ~2× cheaper per CG iteration but its xy near-Nyquist attenuation
    loses measured skill at 3-km voxels when used as the FULL model
    (DESIGN.md §14) — as the inner Jacobian only, that bias never enters
    the residuals (measured, DESIGN.md §16). Composes with
    ``rays_inner`` (coarse samples AND coarse model).

    ``warm_start``: carry the whitened CG solution u across Gauss-Newton
    iterations. The substitution makes u encode the TOTAL departure
    m_{k+1} = m_prior + C^{1/2}u regardless of the iterate, so
    consecutive GN systems (same data, refreshed linearisation) solve
    for nearly the same u — starting iteration k+1's CG from iteration
    k's solution (optimally rescaled, linalg.cg ``scale_x0``) continues
    the SAME solve instead of re-discovering the dominant data
    directions from zero, so ``cg_iters`` can drop at equal skill
    (measured: DESIGN.md §16). On the same data this
    accumulation converges toward the exact MAP solution — legitimate
    deeper fitting, in contrast to the sequential filters where
    warm-starting across steps accumulates depth against FRESH noise
    each epoch and measurably diverges (DESIGN.md §16: held-out
    185k vs 1.9k on the 12-step honest world — kalman_filter therefore
    has no such knob). ``u0`` carries the whitened departure between
    CALLS over the same data (bent re-trace / IRLS rounds — pass the
    previous result's ``u_final``); with u0=None and m0 far from
    m_prior the first inner solve simply starts cold.
    """
    d = jnp.asarray(d_obs).ravel()
    cd_diag = jnp.broadcast_to(jnp.asarray(noise_std),
                               jnp.asarray(d_obs).shape).ravel() ** 2
    d, cd_diag = _join_anchor_rows(d, cd_diag, anchors, probes)
    inv_cd = 1.0 / cd_diag
    inner_model = interp_inner or interp

    def gn_step(carry, _):
        m_k, u_prev = carry
        apply_j, apply_jt, g0 = _dtec_operator(grid, rays, num_directions,
                                               i0, m_k, anchors,
                                               quadrature=quadrature,
                                               probes=probes, interp=interp)
        if rays_inner is not None or inner_model != interp:
            # mixed-fidelity (inexact Gauss-Newton; see kalman_filter,
            # measured on config 5, DESIGN.md): data misfit and
            # residuals at full fidelity — the coarse rule's systematic
            # quadrature bias never enters them — with the linear
            # solve's Jacobian (rhs AND matvec; both sides or the step
            # is no contraction) the coarser operator's. The inner
            # operator may be coarser in SAMPLES (rays_inner), in FIELD
            # MODEL (interp_inner — e.g. the 8-row zp model driving the
            # step direction while residuals stay on the 16-pencil
            # cubic model whose 256³ skill is measured better,
            # DESIGN.md §14/§16), or both.
            apply_jc, apply_jtc, _ = _dtec_operator(
                grid, rays_inner if rays_inner is not None else rays,
                num_directions, i0, m_k, anchors,
                quadrature=quadrature, probes=probes, interp=inner_model)
        else:
            apply_jc, apply_jtc = apply_j, apply_jt
        dm_prior = m_prior - m_k
        r_hat = d - g0 - apply_j(dm_prior)     # residual after prior pull

        def matvec(u):
            v = cov.apply_sqrt(u.reshape(grid.shape))
            w = apply_jc(v) * inv_cd
            z = cov.apply_sqrt(apply_jtc(w))
            return u + z.ravel()

        rhs = cov.apply_sqrt(apply_jtc(r_hat * inv_cd)).ravel()
        u, info = linalg.cg(matvec, rhs,
                            x0=(u_prev if warm_start else None),
                            max_iters=cg_iters, tol=cg_tol,
                            scale_x0=warm_start)
        dm = dm_prior + cov.apply_sqrt(u.reshape(grid.shape))
        m_next = m_k + dm
        res = jnp.linalg.norm((g0 + apply_j(dm) - d) / jnp.sqrt(cd_diag))
        return (m_next, u), (res, info.iterations, info.residual_norm)

    m_init = m_prior if m0 is None else m0
    u_init = (jnp.zeros((jnp.asarray(m_init).size,), jnp.float32)
              if u0 is None else jnp.asarray(u0).ravel())
    (m_final, u_final), diags = jax.lax.scan(gn_step, (m_init, u_init),
                                             None, length=gn_iters)
    return InversionResult(m=m_final, residual_norm=diags[0][-1],
                           info=diags,
                           u_final=(u_final if warm_start else None))


@partial(jax.jit, static_argnames=("num_directions", "i0", "gn_iters",
                                   "cg_iters", "irls_iters", "quadrature",
                                   "interp", "warm_start", "interp_inner"))
def map_gauss_newton_robust(grid: Grid3D, rays: RayBundle, d_obs,
                            noise_std, m_prior, cov: GPCovariance,
                            num_directions: int, i0: int = 0,
                            gn_iters: int = 1, cg_iters: int = 30,
                            cg_tol: float = 1e-4, huber_k: float = 3.0,
                            irls_iters: int = 3,
                            quadrature: str = "hermite",
                            rays_inner: RayBundle = None,
                            interp: str = "cubic",
                            warm_start: bool = False,
                            interp_inner: str = None):
    """Outlier-robust MAP: Huber loss on the whitened data residual via
    IRLS — each round re-weights observations by w = min(1, k/|r/σ|) and
    runs Gauss-Newton with noise inflated to σ/√w, so unflagged corrupted
    samples (RFI, cycle slips) are automatically down-weighted instead of
    dragging the reconstruction (the flag system handles *known* bad data;
    this handles the unknown kind). One jit; IRLS rounds under lax.scan.

    ``rays_inner``: mixed-fidelity linear solves (see map_gauss_newton).
    The IRLS re-weighting residual stays full-fidelity.

    ``warm_start``: carry the whitened departure across IRLS rounds too
    (same data, re-weighted noise — see map_gauss_newton; rounds after
    the first continue the solve instead of restarting it).
    """
    d = jnp.asarray(d_obs)
    sigma = jnp.broadcast_to(jnp.asarray(noise_std), d.shape)

    def irls_round(carry, _):
        m_k, u_prev = carry
        g = tec_mod.dtec_paired_q(m_k, grid, rays, num_directions, i0,
                                  quadrature, interp)
        r_w = jnp.abs(g - d) / sigma
        w = jnp.minimum(1.0, huber_k / jnp.maximum(r_w, 1e-12))
        noise_eff = sigma / jnp.sqrt(jnp.maximum(w, 1e-12))
        res = map_gauss_newton(grid, rays, d, noise_eff, m_prior, cov,
                               num_directions=num_directions, i0=i0,
                               gn_iters=gn_iters, cg_iters=cg_iters,
                               cg_tol=cg_tol, m0=m_k,
                               quadrature=quadrature,
                               rays_inner=rays_inner, interp=interp,
                               warm_start=warm_start, u0=u_prev,
                               interp_inner=interp_inner)
        u_next = res.u_final if warm_start else u_prev
        return (res.m, u_next), (res.residual_norm, jnp.sum(w < 1.0))

    u_init = jnp.zeros((jnp.asarray(m_prior).size,), jnp.float32)
    (m_final, _), (res_hist, n_down) = jax.lax.scan(
        irls_round, (m_prior, u_init), None, length=irls_iters)
    return InversionResult(m=m_final, residual_norm=res_hist[-1],
                           info=(res_hist, n_down))


@partial(jax.jit, static_argnames=("num_directions", "i0", "n_samples",
                                   "cg_iters", "quadrature", "interp"))
def posterior_samples(grid: Grid3D, rays: RayBundle, d_obs, noise_std,
                      m_prior, cov: GPCovariance, num_directions: int,
                      key, n_samples: int = 8, i0: int = 0,
                      cg_iters: int = 40, cg_tol: float = 1e-4,
                      anchors=None, quadrature: str = "hermite",
                      interp: str = "cubic"):
    """Randomise-then-optimise posterior sampling (uncertainty beyond MAP).

    Draws n_samples from the linearised Bayesian posterior by solving the
    MAP system with perturbed data d + C_d^{1/2}ε and perturbed prior mean
    m_prior + C^{1/2}η — each solve identical in structure to
    map_gauss_newton's inner system and all of them vmapped into one
    batched-Krylov program (the "batched Krylov solves" of config 4).
    Returns (samples (n_samples, *grid.shape), mean, std). The spread of
    the samples estimates posterior uncertainty (exact in the linearised
    Gaussian limit).

    ``anchors`` (inversion.anchors.TecAnchors): absolute-TEC rows joined
    to the data space; each sample's anchor values are perturbed by the
    anchor noise automatically (they are just more data rows to RTO), so
    the sampled uncertainty contracts in the anchored directions. Same
    truncated-CG caveat as the joint MAP mode (DESIGN.md §8): with ~10⁴
    dTEC rows the anchor directions need generous ``cg_iters`` to be
    fit — for point estimates at that scale prefer sequential
    assimilation, and sample about the anchored background.
    """
    d = jnp.asarray(d_obs).ravel()
    cd_diag = jnp.broadcast_to(jnp.asarray(noise_std),
                               jnp.asarray(d_obs).shape).ravel() ** 2
    d, cd_diag = _join_anchor_rows(d, cd_diag, anchors)
    inv_cd = 1.0 / cd_diag
    apply_j, apply_jt, g0 = _dtec_operator(grid, rays, num_directions, i0,
                                           m_prior, anchors,
                                           quadrature=quadrature,
                                           interp=interp)
    r0 = d - g0

    def matvec(u):
        v = cov.apply_sqrt(u.reshape(grid.shape))
        w = apply_j(v) * inv_cd
        z = cov.apply_sqrt(apply_jt(w))
        return u + z.ravel()

    k1, k2 = jax.random.split(key)
    eps = jax.random.normal(k1, (n_samples,) + d.shape) \
        * jnp.sqrt(cd_diag)[None, :]
    eta = jax.random.normal(k2, (n_samples,) + grid.shape)

    def solve_one(e, h):
        # perturbed system: data residual gains noise draw, prior mean
        # shifts by a prior draw (whose J-image enters the rhs)
        prior_shift = cov.apply_sqrt(h)
        rhs_vec = (r0 + e - apply_j(prior_shift)) * inv_cd
        rhs = cov.apply_sqrt(apply_jt(rhs_vec)).ravel()
        u, _ = linalg.cg(matvec, rhs, max_iters=cg_iters, tol=cg_tol)
        return m_prior + prior_shift \
            + cov.apply_sqrt(u.reshape(grid.shape))

    samples = jax.vmap(solve_one)(eps, eta)
    return samples, samples.mean(0), samples.std(0)


@partial(jax.jit, static_argnames=("num_directions", "i0", "gn_iters",
                                   "cg_iters", "quadrature", "interp",
                                   "warm_start", "interp_inner"))
def map_gauss_newton_batched(grid: Grid3D, rays_seq: RayBundle, d_obs_seq,
                             noise_std, m_prior, cov: GPCovariance,
                             num_directions: int, i0: int = 0,
                             gn_iters: int = 2, cg_iters: int = 30,
                             cg_tol: float = 1e-4,
                             quadrature: str = "hermite",
                             rays_inner_seq: RayBundle = None,
                             interp: str = "cubic",
                             warm_start: bool = False,
                             interp_inner: str = None):
    """Independent snapshots inverted as one vmapped batch (SURVEY.md §2.1
    P2 — the reference ran time-chunks on separate dask workers; here they
    are a leading batch axis over the same compiled Gauss-Newton program,
    sharing the grid/prior and saturating the chip).

    rays_seq: RayBundle with leading time axis (points (Nt,R,N,3),
    ds (Nt,R)); d_obs_seq: (Nt, Na, Nd); noise_std broadcastable to
    d_obs_seq (per-timestep noise/flag inflation supported). Returns
    stacked InversionResult.

    ``rays_inner_seq``: mixed-fidelity linear solves per snapshot (same
    leading time axis; see map_gauss_newton).
    """
    d_seq = jnp.asarray(d_obs_seq)
    noise_seq = jnp.broadcast_to(jnp.asarray(noise_std), d_seq.shape)

    if rays_inner_seq is not None:
        def solve_one_mixed(pts, ds, ipts, ids, d_t, noise_t):
            return map_gauss_newton(
                grid, RayBundle(points=pts, ds=ds), d_t, noise_t,
                m_prior, cov, num_directions=num_directions, i0=i0,
                gn_iters=gn_iters, cg_iters=cg_iters, cg_tol=cg_tol,
                quadrature=quadrature, interp=interp,
                rays_inner=RayBundle(points=ipts, ds=ids),
                warm_start=warm_start, interp_inner=interp_inner)

        return jax.vmap(solve_one_mixed)(
            rays_seq.points, rays_seq.ds, rays_inner_seq.points,
            rays_inner_seq.ds, d_seq, noise_seq)

    def solve_one(pts, ds, d_t, noise_t):
        return map_gauss_newton(grid, RayBundle(points=pts, ds=ds), d_t,
                                noise_t, m_prior, cov,
                                num_directions=num_directions, i0=i0,
                                gn_iters=gn_iters, cg_iters=cg_iters,
                                cg_tol=cg_tol, quadrature=quadrature,
                                interp=interp, warm_start=warm_start,
                                interp_inner=interp_inner)

    return jax.vmap(solve_one)(rays_seq.points, rays_seq.ds, d_seq,
                               noise_seq)


@partial(jax.jit, static_argnames=("num_directions", "i0", "n_iters",
                                   "n_linesearch"))
def steepest_descent_map(grid: Grid3D, rays: RayBundle, d_obs, noise_std,
                         m_prior, cov: GPCovariance, num_directions: int,
                         i0: int = 0, n_iters: int = 20,
                         n_linesearch: int = 8, eps_max: float = 1.0):
    """Reference-style covariance-preconditioned steepest descent with a
    grid line search (SURVEY.md §8: m ← m − ε(C_m Jᵀ C_d⁻¹ r + (m−m_prior)),
    line-searched ε) — kept for behavioural parity with the reference
    pipeline; Gauss-Newton above is the faster default.

    Cost warning: the vmapped line search evaluates the FULL objective
    (forward model + C_m⁻¹ contraction) ``n_linesearch`` times per
    iteration — 8 forward models per step by default. Intended for parity
    testing at ≤128³; at 256³/10k-ray scale use ``map_gauss_newton``,
    which reaches the same stationary point in far fewer forward
    evaluations (VERDICT r1 weak #8).
    """
    d = jnp.asarray(d_obs)
    inv_var = 1.0 / jnp.broadcast_to(jnp.asarray(noise_std), d.shape) ** 2

    def objective(m):
        g = tec_mod.dtec_paired(m, grid, rays, num_directions, i0)
        data = 0.5 * jnp.sum((g - d) ** 2 * inv_var)
        dmp = m - m_prior
        prior = 0.5 * jnp.vdot(dmp, cov.apply_inv(dmp))
        return data + prior

    epsilons = jnp.concatenate(
        [jnp.zeros((1,)), jnp.logspace(-3, 0, n_linesearch - 1)]) * eps_max

    def it(m_k, _):
        def data_res(m):
            g = tec_mod.dtec_paired(m, grid, rays, num_directions, i0)
            return jnp.sum(0.5 * (g - d) ** 2 * inv_var)

        grad_data = jax.grad(data_res)(m_k)
        direction = -(cov.apply(grad_data) + (m_k - m_prior))
        # normalise so ε is a step in log-density units — the raw
        # preconditioned gradient scale depends on C_d and would overflow
        # exp(m) for any fixed ε grid
        direction = direction / (jnp.max(jnp.abs(direction)) + 1e-20)
        objs = jax.vmap(lambda e: objective(m_k + e * direction))(epsilons)
        best = jnp.argmin(objs)
        m_next = m_k + epsilons[best] * direction
        return m_next, objs[best]

    m_final, hist = jax.lax.scan(it, m_prior, None, length=n_iters)
    g = tec_mod.dtec_paired(m_final, grid, rays, num_directions, i0)
    res = jnp.linalg.norm((g - d) * jnp.sqrt(inv_var))
    return InversionResult(m=m_final, residual_norm=res, info=(hist,))
