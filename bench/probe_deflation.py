"""Measured rejection: spectral deflation of the filter-update CG.

VERDICT r3 #2 proposed carrying Krylov information across the sequential
filter's per-step solves, either by warm-starting each step's CG from the
previous (advected) solution or by deflating the shared dominant data
directions. Both were measured; both hurt:

- Solution warm-starting across steps accumulates fit depth against
  FRESH observation noise each epoch and diverges (held-out 185k vs 1.9k
  on the 12-step honest world — DESIGN.md §16; the filters deliberately
  have no such knob).
- Spectral deflation (this probe): build the top-k eigenpairs of the
  update operator I + C^{1/2}JᵀC_d⁻¹JC^{1/2} once (the observation
  geometry is identical every step, so the dominant data directions are
  shared) and precondition every step's CG with
  ``linalg.spectral_preconditioner`` — M⁻¹ = I + U(1/λ−1)Uᵀ, which
  collapses the deflated directions to ~1. Mathematically this is the
  textbook deflation PCG and converges faster to the EXACT solution
  (verified on a synthetic dense system: 2 preconditioned iterations
  reach the f32 floor where plain CG needs ≫15). But the filter's
  truncated CG is not trying to reach the exact solution — the
  truncation IS the regularisation, and its value rests on plain CG's
  greedy property of fitting the dominant (highest-SNR) data directions
  first. Flattening the top of the spectrum inverts that order: the
  preconditioned iterate spends its few iterations on directions the
  regularised update should have left at the prior.

Measured on the moving-blob tracking world (tests/test_kalman.py
moving_world, 4 steps; mean voxel rms error over the sequence — the
same metric the filter tests gate on):

    plain    cg25                     err 0.0281   (deep reference)
    plain    cg6                      err 0.0286   (production-style)
    deflated cg6, rank 12, 2 power its  err 0.456  (16× worse)
    deflated cg6, rank 12, 6 power its  err 0.458  (accuracy no rescue)
    deflated cg6, rank 24, 10 its, ovs 24 err 0.110 (4× worse at a build
                                          cost ≈ 530 matvecs — far past
                                          amortizable, still worse)
    deflated cg3 variants             err 0.19–0.28

Conclusion: cross-step Krylov reuse in truncation-regularised
sequential updates is rejected in both forms. ``linalg.subspace_eigs``
and ``linalg.spectral_preconditioner`` remain available (tested) for
run-to-convergence solves, and ``kalman.update_operator_eigs`` exposes
the spectrum as a diagnostic for sizing ``cg_iters``.

Run: JAX_PLATFORMS=cpu python -m bench.probe_deflation
"""
import sys
import pathlib

import numpy as np
import jax

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "tests"))


def main():
    from test_kalman import moving_world
    from ionotomo_tpu.inversion.kalman import (kalman_filter,
                                               update_operator_eigs)
    from ionotomo_tpu.geometry import rays as rays_mod
    from ionotomo_tpu.inversion.priors import GPCovariance
    from ionotomo_tpu.core import linalg

    w = moving_world()
    cov = GPCovariance.create(w["grid"], sigma=0.3, length_scale=80.0,
                              kind="sqexp")
    rb0 = rays_mod.RayBundle(points=w["rays_seq"].points[0],
                             ds=w["rays_seq"].ds[0])

    def run(cg, defl):
        # kalman_filter is jitted and resolves linalg.cg at TRACE time —
        # flush the trace cache so the monkeypatched CG takes effect
        jax.clear_caches()
        if defl is not None:
            # re-enact the rejected design: monkeypatch the CG the filter
            # calls to apply the spectral preconditioner
            orig = linalg.cg

            def cg_defl(matvec, b, **kw):
                kw["preconditioner"] = linalg.spectral_preconditioner(
                    *defl)
                return orig(matvec, b, **kw)

            linalg.cg = cg_defl
        try:
            res = kalman_filter(
                w["grid"], w["rays_seq"], w["d_seq"], w["noise"],
                w["m_bg"], cov, w["wind"], w["dt_s"],
                num_directions=w["n_dirs"], cg_iters=cg, fade=0.95)
        finally:
            if defl is not None:
                linalg.cg = orig
        return float(np.mean(
            [np.sqrt(np.mean((np.asarray(res.m_seq[t])
                              - w["m_true"][t]) ** 2))
             for t in range(res.m_seq.shape[0])]))

    print(f"plain cg25: err {run(25, None):.5f}")
    print(f"plain cg6:  err {run(6, None):.5f}")
    for rank, iters, ovs in [(12, 2, 8), (12, 6, 16), (24, 10, 24)]:
        defl = update_operator_eigs(
            w["grid"], rb0, w["noise"], w["m_bg"], cov,
            num_directions=w["n_dirs"], key=jax.random.PRNGKey(7),
            rank=rank, power_iters=iters, oversample=ovs)
        print(f"deflated cg6 rank={rank} its={iters} ovs={ovs}: "
              f"err {run(6, defl):.5f} "
              f"(lam1={float(defl[1][0]):.3g}, "
              f"lam_k={float(defl[1][-1]):.3g})")


if __name__ == "__main__":
    main()
