"""Scatter-formulation probe for the row-gather adjoint (round 4).

The TEC operators' transpose deposits per-point stencil contributions
into the (nx*ny, nz) field table. Candidate formulations, all exactly
the same linear map, measured at config-5 inner-Jacobian scale
(N = 490k points, 128^3 grid):

  A scalar      — .at[flat].add of K*L scalars/point (K=8, L=3 zp)
  B dense-row   — .at[rows].add of K nz-deep rows/point (what XLA's
                  derived transpose of the row-gather forward emits)
  C window      — lax.scatter_add of ONE (3,3,nz) window/point
                  (xy-neighborhood block x dense z-band)
  D segment     — sort contributions by row, segment_sum, one dense add

The hypothesis under test round 4, on that round's hardware: scatter
cost is per-INDEX bound, not per-byte. GPU scatter-add is atomic
and may rank the forms differently (ROADMAP S2). Round-5 correction
(DESIGN.md §18): the round-4 run used
PURELY RANDOM indices (despite the old comment claiming ray locality)
and its cross-variant error check was broken (shape mismatch — B/C/D
never actually ran to a recorded number). Production scatters are
spatially COHERENT — consecutive points advance along rays, so
consecutive stencils overlap — and coherence changes the ranking;
SCAT_RANDOM=1 restores the round-4 random-index regime for comparison.

Run: python -m bench.probe_scatter   (JSON lines)
Env: SCAT_N (default 490000), SCAT_GRID (128), SCAT_RANDOM (0).
"""
import json
import os
import time

import numpy as np


def t(fn, *args, reps=10):
    import jax
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def ray_coherent_bases(n, g, rng, n_samples=49):
    """Integer stencil base positions with production ray locality:
    n/n_samples rays, each a straight line of n_samples steps (~0.7
    voxels/step) from a random boundary-ish origin in a random upward
    direction — the access pattern the TEC operators actually scatter
    with."""
    n_rays = -(-n // n_samples)
    o = np.stack([rng.uniform(1, g - 2, n_rays),
                  rng.uniform(1, g - 2, n_rays),
                  np.full(n_rays, 1.0)], -1)
    zen = rng.uniform(0.0, 0.5, n_rays)
    az = rng.uniform(0, 2 * np.pi, n_rays)
    d = np.stack([np.sin(zen) * np.sin(az), np.sin(zen) * np.cos(az),
                  np.cos(zen)], -1)
    s = np.arange(n_samples) * 0.7
    pts = o[:, None, :] + s[None, :, None] * d[:, None, :]
    pts = pts.reshape(-1, 3)[:n]
    return np.clip(np.floor(pts), 1, g - 2).astype(np.int32).T


def main():
    import jax
    import jax.numpy as jnp

    n = int(os.environ.get("SCAT_N", "490000"))
    g = int(os.environ.get("SCAT_GRID", "128"))
    random_idx = os.environ.get("SCAT_RANDOM", "0") == "1"
    n_rows, nz = g * g, g
    k, l = 8, 3
    rng = np.random.default_rng(0)
    if random_idx:
        bx = jnp.asarray(rng.integers(1, g - 1, n), jnp.int32)
        by = jnp.asarray(rng.integers(1, g - 1, n), jnp.int32)
        bz = jnp.asarray(rng.integers(1, g - 1, n), jnp.int32)
    else:
        bxyz = ray_coherent_bases(n, g, rng)
        bx, by, bz = (jnp.asarray(a) for a in bxyz)
    dx = jnp.asarray(rng.integers(-1, 2, (n, k)), jnp.int32)
    dy = jnp.asarray(rng.integers(-1, 2, (n, k)), jnp.int32)
    wxy = jnp.asarray(rng.normal(size=(n, k)), jnp.float32)
    wz = jnp.asarray(rng.normal(size=(n, l)), jnp.float32)
    y = jnp.asarray(rng.normal(size=(n,)), jnp.float32)
    ri = jnp.clip(bx[:, None] + dx, 0, g - 1) * g + jnp.clip(
        by[:, None] + dy, 0, g - 1)
    zi = bz[:, None] + jnp.arange(-1, 2, dtype=jnp.int32)[None, :]

    def scalar(yv):
        contrib = yv[:, None, None] * wxy[:, :, None] * wz[:, None, :]
        flat = (ri[:, :, None] * nz + zi[:, None, :]).reshape(-1)
        out = jnp.zeros((n_rows * nz,), jnp.float32)
        return out.at[flat].add(contrib.reshape(-1))

    def dense_row(yv):
        lanes = jax.lax.broadcasted_iota(jnp.int32, (1, nz), 1)
        band = jnp.zeros((n, nz), jnp.float32)
        for o in range(l):
            band = band + jnp.where(lanes == zi[:, o][:, None],
                                    wz[:, o][:, None], 0.0)
        rows_ct = (yv[:, None] * wxy)[:, :, None] * band[:, None, :]
        out = jnp.zeros((n_rows, nz), jnp.float32)
        return out.at[ri].add(rows_ct)

    def window(yv):
        # one (3,3,nz) window per point at (bx-1, by-1): w2d x band
        onex = jax.nn.one_hot(dx + 1, 3, dtype=jnp.float32)
        oney = jax.nn.one_hot(dy + 1, 3, dtype=jnp.float32)
        w2d = jnp.einsum("nk,nki,nkj->nij", wxy, onex, oney)
        lanes = jax.lax.broadcasted_iota(jnp.int32, (1, nz), 1)
        band = jnp.zeros((n, nz), jnp.float32)
        for o in range(l):
            band = band + jnp.where(lanes == zi[:, o][:, None],
                                    wz[:, o][:, None], 0.0)
        upd = (yv[:, None, None, None] * w2d[..., None]
               * band[:, None, None, :])                    # (N,3,3,nz)
        starts = jnp.stack([bx - 1, by - 1], axis=-1)       # (N,2)
        dnums = jax.lax.ScatterDimensionNumbers(
            update_window_dims=(1, 2, 3),
            inserted_window_dims=(),
            scatter_dims_to_operand_dims=(0, 1))
        out = jnp.zeros((g, g, nz), jnp.float32)
        out = jax.lax.scatter_add(
            out, starts, upd, dnums,
            indices_are_sorted=False, unique_indices=False,
            mode=jax.lax.GatherScatterMode.CLIP)
        return out.reshape(n_rows, nz)

    def segment(yv):
        lanes = jax.lax.broadcasted_iota(jnp.int32, (1, nz), 1)
        band = jnp.zeros((n, nz), jnp.float32)
        for o in range(l):
            band = band + jnp.where(lanes == zi[:, o][:, None],
                                    wz[:, o][:, None], 0.0)
        rows_ct = ((yv[:, None] * wxy)[:, :, None]
                   * band[:, None, :]).reshape(n * k, nz)
        flat_ri = ri.reshape(-1)
        order = jnp.argsort(flat_ri)
        return jax.ops.segment_sum(rows_ct[order], flat_ri[order],
                                   num_segments=n_rows,
                                   indices_are_sorted=True)

    fns = dict(A_scalar=scalar, B_dense_row=dense_row, C_window=window,
               D_segment=segment)
    ref = None
    for name, fn in fns.items():
        try:
            jf = jax.jit(fn)
            out = jf(y).ravel()       # variants differ in output layout
            if ref is None:
                ref = out
                err = 0.0
            else:
                err = float(jnp.abs(out - ref).max()
                            / jnp.maximum(jnp.abs(ref).max(), 1e-30))
            secs = t(jf, y)
            print(json.dumps({"probe": "scatter", "variant": name,
                              "coherent": not random_idx,
                              "seconds": round(secs, 5),
                              "rel_err_vs_A": round(err, 9)}), flush=True)
        except Exception as e:
            print(json.dumps({"probe": "scatter", "variant": name,
                              "error": f"{type(e).__name__}: {e}"[:200]}),
                  flush=True)


if __name__ == "__main__":
    main()
