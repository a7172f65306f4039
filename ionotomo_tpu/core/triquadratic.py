"""C¹ triquadratic B-spline interpolation — the 9-row-gather fast path.

Why this module exists (round-3 perf study, DESIGN.md §14): the engine's
hot-path cost is **per row-gather issue** (~3.4 ns/row; DESIGN.md §1 — all
ten round-1/2 formulations kept the tricubic 4×4 = 16-pencil stencil).
A prefiltered quadratic B-spline is C¹ like the Catmull–Rom tricubic, needs
only a 3×3×3 stencil = **9 z-pencil row gathers per evaluation**, and —
because B-spline *interpolation* (with its exact prefilter) has a smaller
asymptotic error constant than cubic *convolution* — it is measurably MORE
accurate than the tricubic kernel in both value and gradient on
band-limited fields (both schemes are 3rd order; the measured ratio is
~2× in favour of the quadratic spline at every frequency below Nyquist;
see tests/test_triquadratic.py and PRECISION.md).

The price is a global linear **prefilter**: the interpolant passes through
the samples only if the gathered table holds B-spline *coefficients* c,
where (c_{j-1} + 6 c_j + c_{j+1})/8 = f_j along each axis. Here the
prefilter is applied as one dense (n, n) matmul per axis (exact inverse
built once per axis length in f64 on the host) with the
linear-extrapolation boundary closure c_{-1} := 2c_0 − c_1,
which makes the boundary rows the identity (c_0 = f_0) and preserves
linear fields globally. The prefilter is linear, so AD transposes it
exactly — solver operators differentiate straight through it.

API mirrors ``core.tricubic`` but consumes the *coefficient* grid
(``prefilter(field)``), never the raw samples — call sites pay the
prefilter once per field, outside any scan.

The f64 oracle twin lives in ``reference_kernels/triquadratic_ref.py``.
"""
from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from .grids import Grid3D
from .tricubic import _sharded_take


@lru_cache(maxsize=64)
def _prefilter_matrix(n: int) -> np.ndarray:
    """Exact inverse of the 1-D interpolation system (f64 → f32, cached).

    Interior rows (c_{j-1} + 6 c_j + c_{j+1})/8 = f_j; boundary rows are
    the identity (linear-extrapolation closure — see module docstring).
    The inverse of the diagonally-dominant tridiagonal system is dense
    with geometrically decaying off-diagonals; at n ≤ 512 the dense form
    is a few hundred KB and turns the prefilter into dense matmuls.
    """
    if n < 3:
        return np.eye(n, dtype=np.float32)
    B = np.zeros((n, n), np.float64)
    B[0, 0] = 1.0
    B[n - 1, n - 1] = 1.0
    idx = np.arange(1, n - 1)
    B[idx, idx - 1] = 1.0 / 8.0
    B[idx, idx] = 6.0 / 8.0
    B[idx, idx + 1] = 1.0 / 8.0
    return np.linalg.inv(B).astype(np.float32)


def prefilter(field: jax.Array) -> jax.Array:
    """Field samples (nx, ny, nz) → B-spline coefficient grid, same shape.

    Three dense per-axis matmuls (full f32 precision — reduced-precision
    passes, bf16 or TF32 on a GPU, would cost ~1e-3 relative
    error in the physics field).
    Linear in the field, so ``jax.vjp`` through it is exact.
    """
    nx, ny, nz = field.shape
    px = jnp.asarray(_prefilter_matrix(nx))
    py = jnp.asarray(_prefilter_matrix(ny))
    pz = jnp.asarray(_prefilter_matrix(nz))
    c = jnp.einsum("ai,ijk->ajk", px, field, precision="highest")
    c = jnp.einsum("bj,ajk->abk", py, c, precision="highest")
    return jnp.einsum("ck,abk->abc", pz, c, precision="highest")


def _qb_weights(u: jax.Array):
    """Quadratic B-spline weights for offsets (-1, 0, 1); (..., 3)."""
    return jnp.stack([
        0.5 * (0.5 - u) ** 2,
        0.75 - u * u,
        0.5 * (0.5 + u) ** 2,
    ], axis=-1)


def _qb_dweights(u: jax.Array):
    """d/du of the quadratic B-spline weights; (..., 3)."""
    return jnp.stack([u - 0.5, -2.0 * u, u + 0.5], axis=-1)


def _neighborhood(grid: Grid3D, points: jax.Array):
    """Per-axis 3-point stencil indices and signed offsets.

    points: (N, 3) physical coordinates → (idx (N, 3, 3) int32,
    frac (N, 3) signed offset from the *nearest* sample in [-0.5, 0.5]
    interior, up to ±1 in the clamped boundary half-cells).
    """
    t = grid.world_to_index(points)                      # (N, 3)
    shape = jnp.asarray(grid.shape, jnp.float32)
    t = jnp.clip(t, 0.0, shape - 1.0)
    base = jnp.round(t)
    base = jnp.clip(base, 1.0, shape - 2.0)
    frac = t - base                                      # (N, 3)
    offsets = jnp.arange(-1, 2, dtype=jnp.int32)         # (3,)
    idx = base.astype(jnp.int32)[..., None] + offsets    # (N, 3, 3)
    return idx, frac


def interp(coef: jax.Array, grid: Grid3D, points: jax.Array) -> jax.Array:
    """Triquadratic interpolation of a *coefficient* grid at (N, 3) points.

    Block-gather form (27 scalars/point) — the obviously-correct twin of
    the row path, used by tests and the stencil-weights export.
    """
    idx, frac = _neighborhood(grid, points)
    nx, ny, nz = grid.shape
    ix = idx[:, 0, :, None, None]
    iy = idx[:, 1, None, :, None]
    iz = idx[:, 2, None, None, :]
    flat = (ix * ny + iy) * nz + iz                      # (N,3,3,3)
    blocks = _sharded_take(coef.reshape(-1),
                           flat.reshape(flat.shape[0], 27)
                           ).reshape(flat.shape)
    wx = _qb_weights(frac[:, 0])
    wy = _qb_weights(frac[:, 1])
    wz = _qb_weights(frac[:, 2])
    w = wx[:, :, None, None] * wy[:, None, :, None] * wz[:, None, None, :]
    return jnp.sum(blocks * w, axis=(1, 2, 3))


def _row_neighborhood(grid: Grid3D, points: jax.Array):
    """Row-gather setup: 9 (x, y) z-pencil indices + the z stencil."""
    idx, frac = _neighborhood(grid, points)
    ny = grid.shape[1]
    row_idx = idx[:, 0, :, None] * ny + idx[:, 1, None, :]  # (N,3,3)
    n = points.shape[0]
    return idx, frac, row_idx.reshape(n, 9)


def _z_band(idx_z: jax.Array, w: jax.Array, nz: int):
    """Dense (N, nz) vector with w[:, o] at positions idx_z[:, o]."""
    lanes = jax.lax.broadcasted_iota(jnp.int32, (1, nz), 1)
    band = jnp.zeros((idx_z.shape[0], nz), w.dtype)
    for o in range(3):
        band = band + jnp.where(lanes == idx_z[:, o][:, None],
                                w[:, o][:, None], 0.0)
    return band


def interp_rows(coef2d: jax.Array, grid: Grid3D, points: jax.Array
                ) -> jax.Array:
    """Row-gather triquadratic interpolation.

    ``coef2d`` is the coefficient grid pre-reshaped to (nx*ny, nz) — the
    same free layout view as the tricubic path, paid once outside scans.
    9 row-gather issues per point vs the tricubic path's 16.
    """
    idx, frac, row_idx = _row_neighborhood(grid, points)
    nz = grid.shape[2]
    rows = _sharded_take(coef2d, row_idx)                # (N,9,nz)
    wz = _z_band(idx[:, 2], _qb_weights(frac[:, 2]), nz)
    pencil = jnp.einsum("nkz,nz->nk", rows, wz)          # (N,9)
    wx = _qb_weights(frac[:, 0])
    wy = _qb_weights(frac[:, 1])
    wxy = (wx[:, :, None] * wy[:, None, :]).reshape(-1, 9)
    return jnp.sum(pencil * wxy, axis=-1)


def interp_rows_with_grad(coef2d: jax.Array, grid: Grid3D,
                          points: jax.Array):
    """Row-gather value + physical gradient.

    Same contraction structure as the tricubic twin: the z axis handled by
    two dense banded vectors against the 9 gathered pencils, partial sums
    reused across the three gradient components.
    """
    idx, frac, row_idx = _row_neighborhood(grid, points)
    nz = grid.shape[2]
    rows = _sharded_take(coef2d, row_idx)                # (N,9,nz)
    wz_band = _z_band(idx[:, 2], _qb_weights(frac[:, 2]), nz)
    dwz_band = _z_band(idx[:, 2], _qb_dweights(frac[:, 2]), nz)
    cz = jnp.einsum("nkz,nz->nk", rows, wz_band).reshape(-1, 3, 3)
    cz_d = jnp.einsum("nkz,nz->nk", rows, dwz_band).reshape(-1, 3, 3)

    wx = _qb_weights(frac[:, 0])
    wy = _qb_weights(frac[:, 1])
    dwx = _qb_dweights(frac[:, 0])
    dwy = _qb_dweights(frac[:, 1])

    czy = jnp.einsum("nxy,ny->nx", cz, wy)
    czy_dy = jnp.einsum("nxy,ny->nx", cz, dwy)
    czy_dz = jnp.einsum("nxy,ny->nx", cz_d, wy)
    value = jnp.einsum("nx,nx->n", czy, wx)
    du = jnp.stack(
        [
            jnp.einsum("nx,nx->n", czy, dwx),
            jnp.einsum("nx,nx->n", czy_dy, wx),
            jnp.einsum("nx,nx->n", czy_dz, wx),
        ],
        axis=-1,
    )
    return value, du / grid.spacing[None, :]


def interp_with_grad(coef: jax.Array, grid: Grid3D, points: jax.Array):
    """Value and physical gradient from a coefficient grid (block form)."""
    nx, ny, nz = grid.shape
    return interp_rows_with_grad(coef.reshape(nx * ny, nz), grid, points)


def interp_weights(grid: Grid3D, points: jax.Array):
    """(flat voxel indices (N, 27), weights (N, 27)) of the stencil.

    The weights apply to the *coefficient* grid:
    ``interp(coef, grid, pts) == (coef.ravel()[idx] * w).sum(-1)``.
    An adjoint that must scatter into the *sample* field composes these
    with the prefilter transpose (``jax.vjp(prefilter, field)``), which
    is exact — the prefilter is linear.
    """
    idx, frac = _neighborhood(grid, points)
    nx, ny, nz = grid.shape
    ix = idx[:, 0, :, None, None]
    iy = idx[:, 1, None, :, None]
    iz = idx[:, 2, None, None, :]
    flat = (ix * ny + iy) * nz + iz
    flat = jnp.broadcast_to(flat, (points.shape[0], 3, 3, 3))
    wx = _qb_weights(frac[:, 0])
    wy = _qb_weights(frac[:, 1])
    wz = _qb_weights(frac[:, 2])
    w = wx[:, :, None, None] * wy[:, None, :, None] * wz[:, None, None, :]
    n = points.shape[0]
    return flat.reshape(n, 27), w.reshape(n, 27)
