"""ZP-xy × cubic-z hybrid field model (``interp="zpc"``, round 5).

The untried third route of the 256³ field-model problem (VERDICT r4 #6,
DESIGN.md §14/§17): the ZP box spline reads the fewest rows (7+1 = 8
xy pencil rows per point vs tricubic's 16) but, as a full 3-D model,
measurably loses inversion skill at 3-km voxels, and was found
nondeterministic inside large fused programs on an earlier round's
backend (DESIGN.md §17; ROADMAP R1 asks again on the GPU). This hybrid
keeps the Zwart–Powell element in the gathered (x, y) plane — same
8-row gather economics, same xy quasi-interpolation prefilter — and
replaces the prefiltered quadratic z B-spline with the **interpolating
Catmull–Rom cubic along the dense z axis**:

    f(x, y, z) = Σ_{k,l} ZP(x−k, y−l) · Σ_m c_{k,l,m} CR(z−m)

- z taps: 4 (vs zp's 3) — still a banded dense vector against the
  gathered pencils, zero extra gather cost;
- NO z prefilter: CR is interpolating, so the coefficient grid is the
  xy-quasi-interpolated samples only (one fewer matmul per
  operator application than zp);
- z response: the same 4th-order Catmull–Rom kernel the production
  256³ model (``cubic``) uses — the hybrid changes zp's two 256³
  failure terms at once (z-model fidelity and the fused-program shape
  the backend nondeterminism appeared in).

C¹ in all three axes (ZP is C¹, CR is C¹); reproduces all quadratics
(ZP-xy with the order-2 quasi-interpolation reproduces xy quadratics
exactly, CR reproduces cubics along z). Same padded-grid / clamped-
index boundary contract as the other field models. The f64 oracle twin
(full-support loop, no tables) lives in
``reference_kernels/zpcubic_ref.py``.

Gate before trusting at 256³: the backend-determinism question that
rejected zp (DESIGN.md §17) applies unchanged; ROADMAP R1 tracks it.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .grids import Grid3D
from .tricubic import (_catmull_rom_weights, _catmull_rom_dweights,
                       _sharded_take, _z_band, rows_value)
from .boxspline import _xy_weights, _row_index, _apply_a_xy


def zpc_order(interp: str) -> int:
    """Parse ``"zpc"`` / ``"zpc<order>"`` → xy-prefilter Neumann order
    (``"zpc"`` ≡ ``"zpc2"``, exact quadratic reproduction)."""
    if interp == "zpc":
        return 2
    if interp.startswith("zpc") and interp[3:].isdigit():
        order = int(interp[3:])
        if order >= 2:
            return order
    raise ValueError(
        f"unknown zpc interp spec {interp!r} (use 'zpc' or 'zpc<order>=2>')")


def prefilter(field: jax.Array, order: int = 2) -> jax.Array:
    """Samples (nx, ny, nz) → hybrid coefficient grid: the ZP xy
    quasi-interpolation only (boxspline.prefilter's xy half); the z axis
    stays raw samples because Catmull–Rom interpolates them directly."""
    acc = field
    d = field
    for _ in range(order):
        d = d - _apply_a_xy(d)
        acc = acc + d
    return acc


def _neighborhood(grid: Grid3D, points: jax.Array):
    """xy: nearest-lattice ZP setup (boxspline contract); z: floor-based
    4-tap Catmull–Rom stencil (tricubic contract). Returns
    (bx, by (N,) int32; u, v (N,) signed xy offsets; zi (N, 4) int32
    clamped z taps; fz (N,) z cell fraction in [0, 1])."""
    t = grid.world_to_index(points)
    shape = jnp.asarray(grid.shape, jnp.float32)
    t = jnp.clip(t, 0.0, shape - 1.0)
    bxy = jnp.clip(jnp.round(t[:, :2]), 1.0, shape[:2] - 2.0)
    u = t[:, 0] - bxy[:, 0]
    v = t[:, 1] - bxy[:, 1]
    nz = grid.shape[2]
    bz = jnp.clip(jnp.floor(t[:, 2]), 0.0, nz - 2.0)
    fz = t[:, 2] - bz
    zi = (bz.astype(jnp.int32)[:, None]
          + jnp.arange(-1, 3, dtype=jnp.int32)[None, :])
    zi = jnp.clip(zi, 0, nz - 1)
    return (bxy[:, 0].astype(jnp.int32), bxy[:, 1].astype(jnp.int32),
            u, v, zi, fz)


def interp_rows(coef2d: jax.Array, grid: Grid3D, points: jax.Array
                ) -> jax.Array:
    """Row-gather hybrid interpolation — ONE aligned 8-row gather group
    per point, 4 dense z taps. ``coef2d`` is ``prefilter(field)``
    reshaped to (nx*ny, nz) once outside any scan. The linear
    coef→values map runs as ``core.tricubic.rows_value_p`` (xy-first,
    the box-spline family's measured order) with the dense-row /
    batched-scalar hand transpose (DESIGN.md §18)."""
    bx, by, u, v, zi, fz = _neighborhood(grid, points)
    dx, dy, wxy = _xy_weights(u, v, with_grad=False)
    ri = _row_index(bx, by, dx, dy, grid)
    wz4 = _catmull_rom_weights(fz)
    return rows_value(coef2d, ri, wxy, zi, wz4, xy_first=True)


def interp_rows_with_grad(coef2d: jax.Array, grid: Grid3D,
                          points: jax.Array):
    """Row-gather value + physical gradient from the same 8-row gather
    (same contraction order and precision pins as boxspline — see its
    docstring for the measured reasons)."""
    hi = jax.lax.Precision.HIGHEST
    bx, by, u, v, zi, fz = _neighborhood(grid, points)
    dx, dy, wxy, wu, wv = _xy_weights(u, v, with_grad=True)
    rows = _sharded_take(coef2d, _row_index(bx, by, dx, dy, grid))
    nz = grid.shape[2]
    s = jnp.einsum("nkz,nk->nz", rows, wxy, precision=hi)
    su = jnp.einsum("nkz,nk->nz", rows, wu, precision=hi)
    sv = jnp.einsum("nkz,nk->nz", rows, wv, precision=hi)
    band = _z_band(zi, _catmull_rom_weights(fz), nz)
    dband = _z_band(zi, _catmull_rom_dweights(fz), nz)
    value = jnp.einsum("nz,nz->n", s, band, precision=hi)
    du = jnp.stack([
        jnp.einsum("nz,nz->n", su, band, precision=hi),
        jnp.einsum("nz,nz->n", sv, band, precision=hi),
        jnp.einsum("nz,nz->n", s, dband, precision=hi),
    ], axis=-1)
    return value, du / grid.spacing[None, :]


def interp(coef: jax.Array, grid: Grid3D, points: jax.Array) -> jax.Array:
    """Convenience wrapper over the row path for a 3-D coefficient grid."""
    nx, ny, nz = grid.shape
    return interp_rows(coef.reshape(nx * ny, nz), grid, points)


def interp_with_grad(coef: jax.Array, grid: Grid3D, points: jax.Array):
    nx, ny, nz = grid.shape
    return interp_rows_with_grad(coef.reshape(nx * ny, nz), grid, points)
