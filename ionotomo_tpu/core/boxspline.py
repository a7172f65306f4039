"""C¹ Zwart–Powell box-spline interpolation — the 8-row-gather fast path.

The round-3 gather study (DESIGN.md §14; an earlier round's hardware,
not yet measured on the H100) found the row-gather cost quantized in groups of 8
rows: an (N, 8)-indexed gather of (1, nz) pencils ran faster than the
tricubic kernel's (N, 16), while 9 rows (the tensor-product quadratic
minimum, core.triquadratic) fell off the fast path. A C¹ scheme with
≤ 8 pencils per point therefore reads the fewest rows — and no
*tensor-product* C¹ scheme can do it (3×3 = 9 is minimal).

The **Zwart–Powell (ZP) element** — the box spline on the four directions
{e₁, e₂, e₁+e₂, e₁−e₂} — is the classical non-tensor answer: C¹,
piecewise quadratic on the criss-cross partition, octagonal support with
exactly **7 nonzero lattice translates at any generic point**, and full
third-order accuracy (it reproduces all quadratics). This module
interpolates fields as

    f(x, y, z) = Σ_{k,l,m} c_{k,l,m} · ZP(x−k, y−l) · β₂(z−m)

i.e. ZP in the gathered (x, y) plane — 7 pencils + 1 zero-weight pad = one
aligned 8-row gather group — and a quadratic B-spline along the dense
z axis, contracted with a banded weight vector.

Prefilter: z uses the exact tridiagonal B-spline inverse (dense matmul,
shared with core.triquadratic); the (x, y) plane uses an order-3
**quasi-interpolation** filter q = I + (I−A) + (I−A)², A being the ZP
integer-sample mask (centre 1/2, 4-neighbours 1/8 — derived exactly from
the box-spline geometry, see reference_kernels/boxspline_ref.py). Exact
inversion of A is impossible (its symbol vanishes at the (π,π) Nyquist
corner), but q cancels the reproduction error to O((I−A)³), which
restores *exact* reproduction of all quadratic polynomials (the residual
D = I−A annihilates quadratics after one application; measured 3-D
accuracy equals the exactly-prefiltered tensor quadratic B-spline and is
~2× better than the Catmull-Rom tricubic kernel in both value and
gradient — tests/test_boxspline.py).

The piecewise-quadratic translate weights are evaluated from exact
rational coefficient tables (denominator 16) derived offline by symbolic
area integration of the box-spline convolution (the derivation and its
checks — partition of unity, quadratic reproduction, 7-translate support,
fit residual ~3e-14 — are reproduced in the oracle module). The four
pieces per cell are selected by the signs of (u+v, u−v) around the
nearest lattice point; boundary cells use analytic continuation of the
edge piece under index clamping (same padded-grid contract as the other
kernels).

The f64 oracle twin (independent: evaluates ZP by exact area integrals,
no tables) lives in ``reference_kernels/boxspline_ref.py``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .grids import Grid3D
from .tricubic import _sharded_take
from .triquadratic import _prefilter_matrix, _qb_weights, _qb_dweights

# Per-piece translate offsets (7 + zero-weight pad) and quadratic
# coefficients over monomials (1, u, v, u², uv, v²), ×16 (exact rationals).
_ZP_DX = np.asarray(
    [[-1, -1, -1, 0, 0, 0, 1, 0], [-1, -1, 0, 0, 0, 1, 1, 0],
     [-1, -1, 0, 0, 0, 1, 1, 0], [-1, 0, 0, 0, 1, 1, 1, 0]], np.int32)
_ZP_DY = np.asarray(
    [[-1, 0, 1, -1, 0, 1, 0, 0], [-1, 0, -1, 0, 1, -1, 0, 0],
     [0, 1, -1, 0, 1, 0, 1, 0], [0, -1, 0, 1, -1, 0, 1, 0]], np.int32)
_ZP_CW = np.asarray([
    [[0, 0, 0, 4, 8, 4], [2, -8, 0, 0, 0, -8], [0, 0, 0, 4, -8, 4],
     [2, 0, -8, -4, -8, 4], [8, 0, 0, -8, 0, -8], [2, 0, 8, -4, 8, 4],
     [2, 8, 0, 8, 0, 0], [0, 0, 0, 0, 0, 0]],
    [[0, 0, 0, 4, 8, 4], [2, -8, 0, 4, -8, -4], [2, 0, -8, -8, 0, 0],
     [8, 0, 0, -8, 0, -8], [2, 0, 8, 0, 0, 8], [0, 0, 0, 4, -8, 4],
     [2, 8, 0, 4, 8, -4], [0, 0, 0, 0, 0, 0]],
    [[2, -8, 0, 4, 8, -4], [0, 0, 0, 4, -8, 4], [2, 0, -8, 0, 0, 8],
     [8, 0, 0, -8, 0, -8], [2, 0, 8, -8, 0, 0], [2, 8, 0, 4, -8, -4],
     [0, 0, 0, 4, 8, 4], [0, 0, 0, 0, 0, 0]],
    [[2, -8, 0, 8, 0, 0], [2, 0, -8, -4, 8, 4], [8, 0, 0, -8, 0, -8],
     [2, 0, 8, -4, -8, 4], [0, 0, 0, 4, -8, 4], [2, 8, 0, 0, 0, -8],
     [0, 0, 0, 4, 8, 4], [0, 0, 0, 0, 0, 0]],
], np.float32) / 16.0


def _apply_a_xy(f: jax.Array) -> jax.Array:
    """The ZP integer-sample mask A over (x, y): centre 1/2, 4-neighbours
    1/8, edge-clamped (replicate) so constants are preserved at the
    boundary exactly like the interpolator's index clamp."""
    fp = jnp.pad(f, ((1, 1), (1, 1), (0, 0)), mode="edge")
    return (0.5 * f
            + 0.125 * (fp[:-2, 1:-1] + fp[2:, 1:-1]
                       + fp[1:-1, :-2] + fp[1:-1, 2:]))


def prefilter(field: jax.Array, order: int = 2) -> jax.Array:
    """Field samples (nx, ny, nz) → box-spline coefficient grid.

    z axis: exact quadratic-B-spline inverse (dense matmul, shared
    with core.triquadratic). (x, y) plane: quasi-interpolation by the
    truncated Neumann series q = Σ_{j≤order} Dʲ, D = I − A (``order`` =
    number of correction terms beyond the identity; the symbol of A
    vanishes at the (π,π) corner so the exact inverse does not exist,
    but the series sharpens the near-Nyquist response monotonically
    where |D̂| < 1). ``order=2`` restores exact quadratic reproduction
    (the default); ``order=4`` roughly halves near-Nyquist pointwise
    rms (tested in test_boxspline) and is the right choice for FORWARD
    work — prediction/simulation through a known fine field. For
    INVERSION it is measured WORSE at 256³ (held-out 2273 vs 1567 for
    order 2; DESIGN.md §14 addendum): the order-2 attenuation acts as
    implicit regularization of the barely-constrained near-Nyquist
    band, so the solvers keep ``zp`` ≡ ``zp2``. Each extra term is one
    5-point stencil pass — linear in the field (AD-exact transpose),
    negligible next to the per-ray gathers.
    """
    nz = field.shape[2]
    pz = jnp.asarray(_prefilter_matrix(nz))
    c = jnp.einsum("ck,abk->abc", pz, field, precision="highest")
    acc = c
    d = c
    for _ in range(order):
        d = d - _apply_a_xy(d)
        acc = acc + d
    return acc


def zp_order(interp: str) -> int:
    """Parse the ``interp`` grammar ``"zp"`` / ``"zp<order>"`` →
    xy-prefilter Neumann order (``"zp"`` ≡ ``"zp2"``, the exact-quadratic
    -reproduction minimum). Raises on anything else."""
    if interp == "zp":
        return 2
    if interp.startswith("zp") and interp[2:].isdigit():
        order = int(interp[2:])
        if order >= 2:
            return order
    raise ValueError(
        f"unknown zp interp spec {interp!r} (use 'zp' or 'zp<order>=2>')")


def _neighborhood(grid: Grid3D, points: jax.Array):
    """Nearest-lattice setup: (N,) base per axis + signed offsets.

    Returns (bx, by, bz (N,) int32 clamped; u, v, w (N,) signed fractional
    offsets in roughly [−1/2, 1/2] for interior points).
    """
    t = grid.world_to_index(points)
    shape = jnp.asarray(grid.shape, jnp.float32)
    t = jnp.clip(t, 0.0, shape - 1.0)
    base = jnp.clip(jnp.round(t), 1.0, shape - 2.0)
    frac = t - base
    b = base.astype(jnp.int32)
    return b[:, 0], b[:, 1], b[:, 2], frac[:, 0], frac[:, 1], frac[:, 2]


def _z_band3(bz: jax.Array, w: jax.Array, nz: int):
    """Dense (N, nz) band with the 3 z-tap weights at bz−1, bz, bz+1."""
    lanes = jax.lax.broadcasted_iota(jnp.int32, (1, nz), 1)
    band = jnp.zeros((bz.shape[0], nz), w.dtype)
    for o in range(3):
        band = band + jnp.where(lanes == (bz + (o - 1))[:, None],
                                w[:, o][:, None], 0.0)
    return band


# Canonical-piece tables: only piece 3 (u+v>0, u−v>0) is stored for
# evaluation; the other three pieces are reached through the ZP element's
# D4 symmetry (below). _CU/_CV are the exact ∂/∂u, ∂/∂v coefficient
# tables over the reduced monomials (1, u, v).
_CU = np.stack([_ZP_CW[..., 1], 2 * _ZP_CW[..., 3], _ZP_CW[..., 4]], -1)
_CV = np.stack([_ZP_CW[..., 2], _ZP_CW[..., 4], 2 * _ZP_CW[..., 5]], -1)
_DX3 = np.asarray(_ZP_DX[3], np.float32)
_DY3 = np.asarray(_ZP_DY[3], np.float32)
_CW3 = np.ascontiguousarray(_ZP_CW[3].T)                  # (6, 8)
_CU3 = np.ascontiguousarray(_CU[3].T)                     # (3, 8)
_CV3 = np.ascontiguousarray(_CV[3].T)                     # (3, 8)


def _xy_weights(u, v, with_grad: bool):
    """Translate row offsets + weights via the canonical piece.

    A per-point selection of the 4 piece tables erased the 8-row gather
    win in the round-3 study (a ``jnp.take`` of the tables is a gather
    of its own; DESIGN.md §14, not yet measured on the H100). Instead we use the ZP
    element's D4 symmetry: ZP is
    invariant under (u,v) → (−u,−v) and under ±90° rotation (its four
    directions {e₁, e₂, e₁+e₂, e₁−e₂} map to themselves up to sign), so
    every point maps onto the canonical piece 3 (u+v>0, u−v>0) by an
    orthogonal map T with entries in {−1, 0, 1}:

        piece 3: T = I          piece 0: T = −I
        piece 1: (u,v)→(−v,u)   piece 2: (u,v)→(v,−u)

    Weights become ONE constant (6×8) monomial matmul in canonical
    coordinates; gradients pull back through Tᵀ and translates through
    T⁻¹ = Tᵀ — pure per-point sign arithmetic, no table selection.

    Returns (dx (N,8), dy (N,8), w (N,8)[, wu (N,8), wv (N,8)]).
    """
    s1 = (u + v > 0).astype(u.dtype)
    s2 = (u - v > 0).astype(u.dtype)
    ne = jnp.abs(s1 - s2)                 # 1 where s1 != s2 (pieces 1, 2)
    sg = 2.0 * s1 - 1.0
    a11 = (1.0 - ne) * sg                 # T = [[a11, a12], [a21, a11]]
    a12 = ne * sg
    a21 = -a12
    uc = a11 * u + a12 * v
    vc = a21 * u + a11 * v
    one = jnp.ones_like(u)
    hi = jax.lax.Precision.HIGHEST
    mon6 = jnp.stack([one, uc, vc, uc * uc, uc * vc, vc * vc], axis=-1)
    w = jnp.einsum("nc,ck->nk", mon6, jnp.asarray(_CW3), precision=hi)
    dx3, dy3 = jnp.asarray(_DX3), jnp.asarray(_DY3)
    dx = (a11[:, None] * dx3 + a21[:, None] * dy3).astype(jnp.int32)
    dy = (a12[:, None] * dx3 + a11[:, None] * dy3).astype(jnp.int32)
    if not with_grad:
        return dx, dy, w
    mon3 = mon6[:, :3]
    wu_c = jnp.einsum("nc,ck->nk", mon3, jnp.asarray(_CU3), precision=hi)
    wv_c = jnp.einsum("nc,ck->nk", mon3, jnp.asarray(_CV3), precision=hi)
    wu = a11[:, None] * wu_c + a21[:, None] * wv_c
    wv = a12[:, None] * wu_c + a11[:, None] * wv_c
    return dx, dy, w, wu, wv


def _row_index(bx, by, dx, dy, grid: Grid3D):
    nx, ny, _ = grid.shape
    ix = jnp.clip(bx[:, None] + dx, 0, nx - 1)
    iy = jnp.clip(by[:, None] + dy, 0, ny - 1)
    return ix * ny + iy                                   # (N,8)


def interp_rows(coef2d: jax.Array, grid: Grid3D, points: jax.Array
                ) -> jax.Array:
    """Row-gather box-spline interpolation — ONE aligned 8-row gather
    group per point. ``coef2d`` is ``prefilter(field)`` reshaped to
    (nx*ny, nz) once outside any scan. The linear coef→values map runs
    as ``core.tricubic.rows_value_p`` (xy-first contraction, this
    module's measured order); its transpose is the dense-row hand
    scatter when the table is unbatched and the shared-index scalar
    scatter under the EnKF member vmap — see the custom-adjoint block
    in core/tricubic.py and DESIGN.md §18 for the measurements."""
    from .tricubic import rows_value

    bx, by, bz, u, v, w = _neighborhood(grid, points)
    dx, dy, wxy = _xy_weights(u, v, with_grad=False)
    ri = _row_index(bx, by, dx, dy, grid)
    zi = bz[:, None] + jnp.arange(-1, 2, dtype=jnp.int32)[None, :]
    return rows_value(coef2d, ri, wxy, zi, _qb_weights(w), xy_first=True)


def interp_rows_with_grad(coef2d: jax.Array, grid: Grid3D,
                          points: jax.Array):
    """Row-gather value + physical gradient from the same 8-row gather.

    The xy weights are contracted FIRST ("nkz,nk->nz"; the faster order
    in the round-3 study, DESIGN.md §14, not yet measured on the H100).
    A batched-band formulation ("nkz,nbz->nbk") would be a true matrix
    product, which XLA may run at reduced precision (bf16 passes, or
    TF32 on a GPU) — far outside the engine's f32 contract. The HIGHEST pins
    keep every contraction here at full f32 whatever the lowering."""
    hi = jax.lax.Precision.HIGHEST
    bx, by, bz, u, v, w = _neighborhood(grid, points)
    dx, dy, wxy, wu, wv = _xy_weights(u, v, with_grad=True)
    rows = _sharded_take(coef2d, _row_index(bx, by, dx, dy, grid))
    nz = grid.shape[2]
    s = jnp.einsum("nkz,nk->nz", rows, wxy, precision=hi)
    su = jnp.einsum("nkz,nk->nz", rows, wu, precision=hi)
    sv = jnp.einsum("nkz,nk->nz", rows, wv, precision=hi)
    band = _z_band3(bz, _qb_weights(w), nz)
    dband = _z_band3(bz, _qb_dweights(w), nz)
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
