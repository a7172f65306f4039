"""A/B: what the batched rows_value_p hand transpose buys the EnKF
member axis (VERDICT r4 #3).

Round 4's primitive fell back to the vmapped plain impl — XLA's derived
adjoint, with its ~nz/L excess scatter traffic — whenever the field was
vmapped, and vmap over the field IS the member axis of the production
ensemble filter (inversion.kalman member_update). Round 5's batching
rule rebinds the primitive with the member axis leading on the
table/weights (the stencil indices are member-invariant), so the hand
scatter runs once with batched updates.

Two measurements at serving/ensemble scale (62 ant x 10 dir, 64^3 grid,
zp + cubic, hermite@33):
  member_vjp   — vmapped linearize + transpose of the dTEC operator
                 (the adjoint each CG iteration of every member update
                 pays), members x {8, 16}
  enkf_step    — one full ensemble_kalman_filter step (8 members, cg=8)

Run both arms:
  python -m bench.probe_enkf_adjoint                      # hand scatter
  ROWS_VALUE_BATCH_FALLBACK=1 python -m bench.probe_enkf_adjoint  # r4
"""
import json
import os
import time

import numpy as np


def t(fn, *args, reps=5):
    import jax
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def main():
    import jax
    import jax.numpy as jnp

    from bench.common import make_rays
    from ionotomo_tpu.models import chapman
    from ionotomo_tpu.geometry import rays as rays_mod
    from ionotomo_tpu.forward import tec as tec_mod
    from ionotomo_tpu.inversion.priors import GPCovariance
    from ionotomo_tpu.inversion import kalman

    arm = ("fallback_derived"
           if os.environ.get("ROWS_VALUE_BATCH_FALLBACK", "0") == "1"
           else "hand_batched")
    na, nd = 62, 10
    ants, dirs = make_rays(na, nd)
    grid = chapman.grid_enclosing_rays(ants, dirs, shape=(64, 64, 64),
                                      h_min_km=0.0)
    m = chapman.log_parametrize(chapman.chapman_field(grid))
    o, dv = rays_mod.make_ray_batch(ants, dirs)
    rb = rays_mod.sample_straight_rays(o, dv, n_samples=33)

    for interp in ("zp", "cubic"):
        def fwd(mm):
            return tec_mod.dtec_paired_q(mm, grid, rb, nd, 0, "hermite",
                                         interp).ravel()

        def member_vjp(m1, y1):
            out, vjp = jax.vjp(fwd, m1)
            return vjp(y1)[0]

        for n_mem in (8, 16):
            ens = m[None] + 0.01 * jax.random.normal(
                jax.random.key(0), (n_mem,) + grid.shape)
            ys = jnp.ones((n_mem, na * nd), jnp.float32)
            f = jax.jit(jax.vmap(member_vjp))
            secs = t(f, ens, ys)
            print(json.dumps({"probe": "enkf_adjoint", "arm": arm,
                              "case": "member_vjp", "interp": interp,
                              "n_members": n_mem,
                              "seconds": round(secs, 5)}), flush=True)

    # one full EnKF step, the production composite
    cov = GPCovariance.create(grid, sigma=0.3, length_scale=80.0,
                              kind="von_karman")
    d = jnp.zeros((1, na, nd), jnp.float32)
    rays_seq = rays_mod.RayBundle(points=rb.points[None],
                                  ds=rb.ds[None])

    def one_step():
        res = kalman.ensemble_kalman_filter(
            grid, rays_seq, d, 5.0, m, cov,
            jnp.asarray([0.0, 0.0, 0.0]), 0.0, num_directions=nd,
            key=jax.random.key(1), n_members=8, i0=0, cg_iters=8,
            quadrature="hermite", interp="zp")
        return res.mean_seq

    secs = t(one_step, reps=3)
    print(json.dumps({"probe": "enkf_adjoint", "arm": arm,
                      "case": "enkf_step_8mem_cg8_zp",
                      "seconds": round(secs, 4)}), flush=True)


if __name__ == "__main__":
    main()
