"""Field-model gather forms on the GPU: z-pencil rows vs a direct stencil.

The engine's field models fetch whole z-pencils per point (16 rows for
cubic, 8 for zp) and contract z against a dense band. That form was
chosen for hardware that serialises single-scalar gathers (DESIGN.md
§1); a GPU gathers scalars natively, and the pencil reads about nz/4 times the bytes a
stencil needs. This probe times both forms of value+gradient in the
tracer's access pattern (2^17 points × 64 chained steps, 128³ grid):

  cubic_rows     tricubic.interp_rows_with_grad (16 pencils)
  cubic_stencil  tricubic.interp_with_grad (64 scalar gathers)
  zp_rows        boxspline.interp_rows_with_grad (8 pencils)
  zp_stencil     the same box-spline weights on 8 × 3 scalar gathers

Run: python -m bench.probe_gather     (one JSON line, GPU only)
"""
import json
import time

import numpy as np


def zp_stencil_with_grad(coef2d, grid, points):
    """Box-spline value + physical gradient from 24 scalar gathers (the
    8 xy rows × 3 z taps the row form reads whole pencils for)."""
    import jax.numpy as jnp
    from ionotomo_tpu.core import boxspline as bs

    nz = grid.shape[2]
    bx, by, bz, u, v, w = bs._neighborhood(grid, points)
    dx, dy, wxy, wu, wv = bs._xy_weights(u, v, with_grad=True)
    ri = bs._row_index(bx, by, dx, dy, grid)                  # (N, 8)
    zi = jnp.clip(bz[:, None] + jnp.arange(-1, 2), 0, nz - 1)  # (N, 3)
    vals = coef2d.reshape(-1)[ri[:, :, None] * nz + zi[:, None, :]]
    wz, dwz = bs._qb_weights(w), bs._qb_dweights(w)           # (N, 3)
    cz = jnp.einsum("nkz,nz->nk", vals, wz, precision="highest")
    cz_d = jnp.einsum("nkz,nz->nk", vals, dwz, precision="highest")
    value = jnp.sum(cz * wxy, -1)
    du = jnp.stack([jnp.sum(cz * wu, -1), jnp.sum(cz * wv, -1),
                    jnp.sum(cz_d * wxy, -1)], -1)
    return value, du / grid.spacing[None, :]


def start_points(n_pts):
    import jax.numpy as jnp
    rng = np.random.default_rng(0)
    return jnp.asarray(
        np.stack([rng.uniform(-300, 300, n_pts),
                  rng.uniform(-300, 300, n_pts),
                  rng.uniform(100, 900, n_pts)], -1), jnp.float32)


def chained_rate(eval_vg, pts, n_steps, reps=3):
    """M point-evals/s of ``eval_vg`` chained through a scan the way the
    tracer chains it (each step's points depend on the last step's
    values)."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def chained(p0):
        def step(p, _):
            v, g = eval_vg(p)
            gn = g / (jnp.linalg.norm(g, axis=-1, keepdims=True) + 1e-12)
            return p + 0.5 * gn + 1e-6 * v[:, None], None
        return jax.lax.scan(step, p0, None, length=n_steps)[0]

    out = jax.block_until_ready(chained(pts))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = chained(pts)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / reps
    return pts.shape[0] * n_steps / dt / 1e6


def main(nx=128, n_pts=1 << 17, n_steps=64):
    from bench.common import setup
    rec = setup()

    from ionotomo_tpu.core import boxspline, tricubic
    from ionotomo_tpu.core.grids import Grid3D
    from ionotomo_tpu.models import chapman

    grid = Grid3D.from_bounds((-400.0, -400.0, 0.0),
                              (400.0, 400.0, 1100.0), (nx, nx, nx))
    m = chapman.log_parametrize(chapman.chapman_field(grid))
    f2d = m.reshape(nx * nx, nx)
    c2d = boxspline.prefilter(m).reshape(nx * nx, nx)
    forms = dict(
        cubic_rows=lambda p: tricubic.interp_rows_with_grad(f2d, grid, p),
        cubic_stencil=lambda p: tricubic.interp_with_grad(m, grid, p),
        zp_rows=lambda p: boxspline.interp_rows_with_grad(c2d, grid, p),
        zp_stencil=lambda p: zp_stencil_with_grad(c2d, grid, p))
    pts = start_points(n_pts)
    rates = {name: chained_rate(fn, pts, n_steps)
             for name, fn in forms.items()}
    # both forms of one model compute the same interpolant
    same = {}
    for k in ("cubic", "zp"):
        v1, g1 = forms[f"{k}_rows"](pts)
        v2, g2 = forms[f"{k}_stencil"](pts)
        same[k] = dict(value=float(np.abs(v1 - v2).max()),
                       grad=float(np.abs(g1 - g2).max()))
    print(json.dumps(dict(
        metric="field_model_point_evals_per_sec", unit="M evals/s",
        grid=nx, points=n_pts, chained_steps=n_steps, rates=rates,
        rows_vs_stencil_max_abs_diff=same, **rec)))


if __name__ == "__main__":
    main()
