"""C¹ tricubic interpolation on a regular 3D grid — the engine's L0 kernel.

The reference implements the Lekien–Marsden 64-coefficient tricubic scheme
with finite-difference derivative closure (SURVEY.md §2, `TriCubic`).  With
central-difference derivatives that scheme is mathematically equivalent to
**separable cubic-convolution (Catmull–Rom) interpolation** over the same
4×4×4 neighbourhood, which is the formulation used here:

- per query point: 64 neighbour gathers + a separable weight outer product,
  instead of a 64×64 coefficient matrix solve per cell;
- the same gathered 4×4×4 block yields the value *and* the spatial gradient
  (analytic basis derivatives), so the Fermat ray tracer gets n and ∇n from
  one gather;
- everything is static-shape, vmappable, and fuses under jit.

Boundary handling: indices are clamped (edge replication), giving constant
extrapolation outside the grid — rays are expected to live inside a grid
built with padding (see inversion.initial model helpers).

The f64 oracle twin lives in ``reference_kernels/tricubic_ref.py``.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .grids import Grid3D


def _catmull_rom_weights(u: jax.Array):
    """Cubic-convolution weights (a=-0.5) for offsets (-1,0,1,2).

    u has shape (...,); returns shape (..., 4).
    """
    u2 = u * u
    u3 = u2 * u
    w0 = 0.5 * (-u3 + 2.0 * u2 - u)
    w1 = 0.5 * (3.0 * u3 - 5.0 * u2 + 2.0)
    w2 = 0.5 * (-3.0 * u3 + 4.0 * u2 + u)
    w3 = 0.5 * (u3 - u2)
    return jnp.stack([w0, w1, w2, w3], axis=-1)


def _catmull_rom_dweights(u: jax.Array):
    """d/du of the cubic-convolution weights; shape (..., 4)."""
    u2 = u * u
    w0 = 0.5 * (-3.0 * u2 + 4.0 * u - 1.0)
    w1 = 0.5 * (9.0 * u2 - 10.0 * u)
    w2 = 0.5 * (-9.0 * u2 + 8.0 * u + 1.0)
    w3 = 0.5 * (3.0 * u2 - 2.0 * u)
    return jnp.stack([w0, w1, w2, w3], axis=-1)


def _neighborhood(grid: Grid3D, points: jax.Array):
    """Shared setup: per-axis neighbour indices and fractional offsets.

    points: (N, 3) physical coordinates.
    Returns (idx, frac): idx (N, 3, 4) int32 clamped voxel indices per axis,
    frac (N, 3) fractional position in the central cell.
    """
    t = grid.world_to_index(points)                      # (N, 3)
    shape = jnp.asarray(grid.shape, jnp.float32)
    # Clamp the query into the valid interpolation domain so that frac stays
    # in [0,1] and extrapolation is constant beyond the edges.
    t = jnp.clip(t, 0.0, shape - 1.0)
    base = jnp.floor(t)
    # Keep the full 4-point stencil addressable: base in [0, n-2].
    base = jnp.clip(base, 0.0, shape - 2.0)
    frac = t - base                                      # (N, 3) in [0, 1]
    offsets = jnp.arange(-1, 3, dtype=jnp.int32)         # (4,)
    idx = base.astype(jnp.int32)[..., None] + offsets    # (N, 3, 4)
    ns = jnp.asarray(grid.shape, jnp.int32)
    idx = jnp.clip(idx, 0, ns[None, :, None] - 1)
    return idx, frac


def _sharded_take(table: jax.Array, idx: jax.Array) -> jax.Array:
    """Gather rows of ``table`` at ``idx``, propagating the indices'
    sharding to the output (a batch-sharded gather of a replicated table —
    the engine's standard data layout; SURVEY.md §2.1 P1). Under jax's
    sharding-in-types the output spec of a gather is ambiguous and must be
    given explicitly whenever the indices are sharded."""
    try:
        sh = jax.typeof(idx).sharding
        if any(s is not None for s in sh.spec):
            from jax.sharding import NamedSharding, PartitionSpec as P
            out_spec = P(*sh.spec, *([None] * (table.ndim - 1)))
            return table.at[idx].get(
                mode="clip", out_sharding=NamedSharding(sh.mesh, out_spec))
    except Exception:
        pass
    return jnp.take(table, idx, axis=0)


def _sharded_take_batched(table: jax.Array, idx: jax.Array) -> jax.Array:
    """Gather rows of a leading-batched ``table`` (B, R, nz) at shared
    point indices ``idx`` (N, K) → (B, N, K, nz), propagating the
    indices' point sharding to the output's point axis (the batch axis —
    the EnKF member axis or a Krylov block — stays replicated)."""
    try:
        sh = jax.typeof(idx).sharding
        if any(s is not None for s in sh.spec):
            from jax.sharding import NamedSharding, PartitionSpec as P
            out_spec = P(None, *sh.spec, None)
            return table.at[:, idx].get(
                mode="clip", out_sharding=NamedSharding(sh.mesh, out_spec))
    except (TypeError, ValueError, AttributeError):
        pass
    return jnp.take(table, idx, axis=1)


def _gather_blocks(field: jax.Array, grid: Grid3D, idx: jax.Array):
    """Gather the 4×4×4 neighbourhoods.

    field: (nx, ny, nz); idx: (N, 3, 4) → (N, 4, 4, 4).
    A single flat gather keeps this one XLA gather op rather than three
    chained fancy-index ops.
    """
    nx, ny, nz = grid.shape
    ix = idx[:, 0, :, None, None]                        # (N,4,1,1)
    iy = idx[:, 1, None, :, None]                        # (N,1,4,1)
    iz = idx[:, 2, None, None, :]                        # (N,1,1,4)
    flat = (ix * ny + iy) * nz + iz                      # (N,4,4,4)
    return _sharded_take(field.reshape(-1),
                         flat.reshape(flat.shape[0], 64)).reshape(flat.shape)


def _contract_value(blocks: jax.Array, frac: jax.Array) -> jax.Array:
    """(N,4,4,4) stencil blocks × separable weights → (N,) values."""
    wx = _catmull_rom_weights(frac[:, 0])                # (N,4)
    wy = _catmull_rom_weights(frac[:, 1])
    wz = _catmull_rom_weights(frac[:, 2])
    w = wx[:, :, None, None] * wy[:, None, :, None] * wz[:, None, None, :]
    return jnp.sum(blocks * w, axis=(1, 2, 3))


def _contract_value_grad(blocks: jax.Array, frac: jax.Array):
    """(N,4,4,4) blocks → ((N,) value, (N,3) d/d(index units)).

    Contract z then y then x, keeping partial sums so the three gradient
    components reuse intermediate contractions (12 fused FMAs instead of
    3 full 64-term sums). Shared by the replicated interpolators below and
    the halo-exchange shards (parallel.grid_sharding).
    """
    wx = _catmull_rom_weights(frac[:, 0])
    wy = _catmull_rom_weights(frac[:, 1])
    wz = _catmull_rom_weights(frac[:, 2])
    dwx = _catmull_rom_dweights(frac[:, 0])
    dwy = _catmull_rom_dweights(frac[:, 1])
    dwz = _catmull_rom_dweights(frac[:, 2])
    cz = jnp.einsum("nxyz,nz->nxy", blocks, wz)
    cz_d = jnp.einsum("nxyz,nz->nxy", blocks, dwz)
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
    return value, du


@partial(jax.jit, static_argnames=())
def interp(field: jax.Array, grid: Grid3D, points: jax.Array) -> jax.Array:
    """Tricubic interpolation of ``field`` at ``points`` (N, 3) → (N,)."""
    idx, frac = _neighborhood(grid, points)
    blocks = _gather_blocks(field, grid, idx)            # (N,4,4,4)
    return _contract_value(blocks, frac)


@partial(jax.jit, static_argnames=())
def interp_with_grad(field: jax.Array, grid: Grid3D, points: jax.Array):
    """Value and spatial gradient at ``points``.

    Returns (values (N,), grads (N, 3)).  Gradient is the analytic
    derivative of the interpolant (in physical units, 1/km if the grid is in
    km) — this is what the Fermat tracer consumes as ∇n.
    """
    idx, frac = _neighborhood(grid, points)
    blocks = _gather_blocks(field, grid, idx)            # (N,4,4,4)
    value, du = _contract_value_grad(blocks, frac)
    return value, du / grid.spacing[None, :]


def _row_neighborhood(grid: Grid3D, points: jax.Array):
    """Row-gather setup: (x,y) pencil indices + dense z weight vectors.

    Instead of 64 scalar neighbours we fetch the 16 (x,y) z-pencils of
    the stencil (slice size (1, nz)) and contract the z axis with a
    dense, 4-banded weight vector built from iota comparisons (no
    gather). The form was chosen for hardware whose gathers of single
    scalars serialise (DESIGN.md §1); on the GPU it reads about nz/4 the
    bytes of a direct stencil, and bench/probe_gather.py times both forms (PERF.md,
    ROADMAP S1).
    """
    idx, frac = _neighborhood(grid, points)
    nx, ny, nz = grid.shape
    row_idx = (idx[:, 0, :, None] * ny + idx[:, 1, None, :])  # (N,4,4)
    n = points.shape[0]
    return idx, frac, row_idx.reshape(n, 16)


def _z_band(idx_z: jax.Array, w: jax.Array, nz: int):
    """Dense (N, nz) vector with w[:, o] at positions idx_z[:, o]
    (L = w.shape[1] taps: 4 for tricubic, 3 for the box spline's
    quadratic z B-spline)."""
    lanes = jax.lax.broadcasted_iota(jnp.int32, (1, nz), 1)
    band = jnp.zeros((idx_z.shape[0], nz), w.dtype)
    for o in range(w.shape[1]):
        band = band + jnp.where(lanes == idx_z[:, o][:, None],
                                w[:, o][:, None], 0.0)
    return band


# --- custom adjoint for the row-gather value path (round 4, corrected
# --- round 5) ------------------------------------------------------------
#
# An earlier round's measurements, not yet repeated on the H100 (bench/
# probe_vjp_forms.py, DESIGN.md §18): at config-5 inner-Jacobian scale
# (490k points, 128³, zp) the DENSE-ROW transpose — K full nz-deep rows
# ct·w_xy⊗band(w_z) per point, K row indices — matched XLA's derived
# transpose of the plain impl there, while the K×L SCALAR form (ct·w_xy·
# w_z at K·L flat indices) was 3.5× slower, because that backend's
# scatter cost is bound per index, not per byte. GPU scatter-add is
# atomic and may rank the forms differently (ROADMAP S2). The unbatched
# transpose is the dense-row form.
#
# ``rows_value_p`` keeps each model's measured-fast forward contraction
# order (a static param) with that hand transpose; forward.tec.
# tec_linear_adjoint scatters by hand for the LSQR path.
# jax.custom_derivatives.linear_call would express this without a
# primitive, but it has no batching rule — and vmap over the FIELD is
# the EnKF member axis — so a primitive it is, with: a batching rule
# that rebinds the primitive with a leading batch axis on the table
# (and, when present, the weights) while the point/stencil indices stay
# shared — so the EnKF member axis keeps the hand scatter (one shared-
# index scatter with a member axis on the updates; VERDICT r4 #3) —
# falling back to the vmapped plain impl only when the INDICES are
# batch-variant; vma propagation via standard_insert_pvary/
# standard_vma_rule so shard_map callers work; explicit-sharding
# propagation (the output inherits the point batch axis' spec, the
# transpose scatter declares a replicated table cotangent). AD w.r.t.
# the sample points falls back to the plain-jnp impl's derived AD
# (round 5, ADVICE r4): the hot solver paths only ever carry table
# tangents and keep the hand adjoint; a caller differentiating through
# ray geometry gets the pre-primitive semantics at the pre-primitive
# cost instead of a trace-time error. (The Fermat tracer still consumes
# the cheaper analytic gradients from interp_rows_with_grad.)
#
# JAX-internals pin (ADVICE r4): standard_insert_pvary /
# standard_vma_rule / ShapedArray(sharding=...) / scatter out_sharding
# are private surface, verified against the image's pinned jax 0.9.0.
# The adjoint-identity + vmap-parity tests in tests/test_boxspline.py
# are the upgrade canary — run them first after any jax bump.

from jax._src import core as _jcore
from jax.extend import core as _jex_core
from jax.interpreters import ad as _ad, batching as _batching, \
    mlir as _mlir

rows_value_p = _jex_core.Primitive("rows_value")

# Shapes (B = optional leading batch axis, the EnKF member axis):
#   table (R, nz) | (B, R, nz);  ri (N, K) int32;  zi (N, L) int32
#   wxy (N, K) | (B, N, K);      wz (N, L) | (B, N, L)
#   out (N,) | (B, N)
# The indices are NEVER batched through the primitive (the batcher
# falls back for that case); weights may be unbatched while the table
# is batched (broadcast in the einsum) and vice versa.


def _is_batched(table, ri, wxy, wz):
    if table.ndim == 3 or wxy.ndim == 3 or wz.ndim == 3:
        return True
    return False


def _rows_value_impl(table, ri, wxy, zi, wz, *, xy_first):
    hi = jax.lax.Precision.HIGHEST
    nz = table.shape[-1]
    if not _is_batched(table, ri, wxy, wz):
        rows = _sharded_take(table, ri)                  # (N,K,nz)
        band = _z_band(zi, wz, nz)                       # (N,nz)
        if xy_first:    # box spline's measured order (DESIGN.md §14)
            s = jnp.einsum("nkz,nk->nz", rows, wxy, precision=hi)
            return jnp.einsum("nz,nz->n", s, band, precision=hi)
        pencil = jnp.einsum("nkz,nz->nk", rows, band)    # tricubic order
        return jnp.sum(pencil * wxy, axis=-1)
    # batched: shared indices, batch axis on table and/or weights
    if table.ndim == 3:
        rows = _sharded_take_batched(table, ri)          # (B,N,K,nz)
    else:
        rows = _sharded_take(table, ri)[None]            # (1,N,K,nz)
    if wz.ndim == 3:
        band = jax.vmap(lambda w: _z_band(zi, w, nz))(wz)    # (B,N,nz)
    else:
        band = _z_band(zi, wz, nz)[None]                 # (1,N,nz)
    wxy_b = wxy if wxy.ndim == 3 else wxy[None]          # (B|1,N,K)
    if xy_first:
        s = jnp.einsum("bnkz,bnk->bnz", rows, wxy_b, precision=hi)
        out = jnp.einsum("bnz,bnz->bn", s, band, precision=hi)
    else:
        pencil = jnp.einsum("bnkz,bnz->bnk", rows, band)
        out = jnp.sum(pencil * wxy_b, axis=-1)
    b = max(table.shape[0] if table.ndim == 3 else 1,
            wxy.shape[0] if wxy.ndim == 3 else 1,
            wz.shape[0] if wz.ndim == 3 else 1)
    return jnp.broadcast_to(out, (b, ri.shape[0]))


def _rows_value_abstract(table, ri, wxy, zi, wz, *, xy_first):
    vma = _jcore.standard_vma_rule("rows_value", table, ri, wxy, zi, wz)
    kw = dict(vma=vma)
    if _is_batched(table, ri, wxy, wz):
        b = max(table.shape[0] if table.ndim == 3 else 1,
                wxy.shape[0] if wxy.ndim == 3 else 1,
                wz.shape[0] if wz.ndim == 3 else 1)
        sh = getattr(ri, "sharding", None)
        if sh is not None and getattr(sh, "mesh", None) is not None \
                and not getattr(sh.mesh, "empty", False):
            try:
                from jax.sharding import PartitionSpec as _P
                kw["sharding"] = sh.update(spec=_P(None, sh.spec[0]))
            except (TypeError, ValueError, AttributeError):
                pass
        return _jcore.ShapedArray((b, ri.shape[0]), table.dtype, **kw)
    sh = getattr(ri, "sharding", None)
    if sh is not None and getattr(sh, "mesh", None) is not None \
            and not getattr(sh.mesh, "empty", False):
        tsh = getattr(table, "sharding", None)
        if tsh is not None and any(s is not None for s in tsh.spec):
            # Layout contract (ADVICE r4): this path assumes a
            # replicated table with the batch axis on the points. A
            # sharded table must use parallel.grid_sharding's halo
            # operators — fail loudly instead of propagating an
            # ambiguous spec.
            raise ValueError(
                "rows_value: table is sharded "
                f"({tsh.spec}); the row-gather value path requires a "
                "replicated table (use parallel.grid_sharding for "
                "grid-decomposed fields)")
        try:
            from jax.sharding import PartitionSpec as _P
            kw["sharding"] = sh.update(spec=_P(sh.spec[0]))
        except (TypeError, ValueError, AttributeError):
            pass
    return _jcore.ShapedArray((ri.shape[0],), table.dtype, **kw)


def _rows_value_jvp(primals, tangents, *, xy_first):
    table, ri, wxy, zi, wz = primals
    dt, _, dwxy, _, dwz = tangents
    if type(dwxy) is not _ad.Zero or type(dwz) is not _ad.Zero:
        # Point-side tangents (weights depend on sample positions):
        # derived-AD fallback through the plain impl — pre-primitive
        # semantics at pre-primitive cost (ADVICE r4).
        f = partial(_rows_value_impl, xy_first=xy_first)
        zeros = tuple(
            jnp.zeros(p.shape, p.dtype) if type(t) is _ad.Zero
            else t for p, t in zip(primals, tangents))
        return jax.jvp(lambda tb, w1, w2: f(tb, ri, w1, zi, w2),
                       (table, wxy, wz), (zeros[0], zeros[2], zeros[4]))
    out = rows_value_p.bind(table, ri, wxy, zi, wz, xy_first=xy_first)
    if type(dt) is _ad.Zero:
        t_out = _ad.Zero(jax.core.get_aval(out).to_tangent_aval())
    else:
        t_out = rows_value_p.bind(dt, ri, wxy, zi, wz, xy_first=xy_first)
    return out, t_out


def _rows_value_transpose(ct, table, ri, wxy, zi, wz, *, xy_first):
    assert _ad.is_undefined_primal(table)
    batched = table.aval.ndim == 3
    if batched:
        b, n_rows, nz = table.aval.shape
        # Batched (EnKF member) case: the K×L SCALAR contributions per
        # point, scatter-added at shared flat (row, z) indices with the
        # member axis riding the updates. Two reasons this is the scalar
        # form while the unbatched path is dense-row (DESIGN.md §18):
        # the dense-row update tensor (B,N,K,nz) is B× the forward
        # pencil — 16 GB at config-5 scale — and B members amortize one
        # index stream (the per-index scatter cost of DESIGN.md §18, not
        # yet measured on the H100).
        contrib = (ct[..., :, None, None]
                   * (wxy[..., :, :, None] if wxy.ndim == 3
                      else wxy[:, :, None])
                   * (wz[..., :, None, :] if wz.ndim == 3
                      else wz[:, None, :]))
        flat = (ri[:, :, None] * nz + zi[:, None, :]).reshape(-1)
        out = jnp.zeros((b, n_rows * nz), ct.dtype)
        kw = {}
        try:
            sh = jax.typeof(flat).sharding
            if any(s is not None for s in sh.spec):
                from jax.sharding import NamedSharding as _NS, \
                    PartitionSpec as _P
                kw["out_sharding"] = _NS(sh.mesh, _P(None, None))
        except (TypeError, ValueError, AttributeError):
            pass
        out = out.at[:, flat].add(
            contrib.reshape(b, -1), **kw).reshape(b, n_rows, nz)
        return [out, None, None, None, None]
    n_rows, nz = table.aval.shape
    # Unbatched: DENSE-ROW scatter (probe_scatter form B) — K full
    # nz-rows ct·w_xy ⊗ band(w_z) per point, scatter-added at the K row
    # indices. Where scatter cost is bound per index, K indices of
    # nz-deep rows beat K·L indices of scalars despite ~nz/L more
    # scattered bytes (DESIGN.md §18); not yet measured on the H100.
    if wxy.ndim == 3 or wz.ndim == 3:
        # batched weights against an unbatched table (rare; not a
        # production path): every batch member scatters into the same
        # cotangent — scalar contributions summed over the batch
        contrib = (ct[..., :, None, None]
                   * (wxy[..., :, :, None] if wxy.ndim == 3
                      else wxy[:, :, None])
                   * (wz[..., :, None, :] if wz.ndim == 3
                      else wz[:, None, :])).sum(axis=0)
        flat = (ri[:, :, None] * nz + zi[:, None, :]).reshape(-1)
        out = jnp.zeros((n_rows * nz,), ct.dtype)
        out = out.at[flat].add(contrib.reshape(-1)).reshape(n_rows, nz)
        return [out, None, None, None, None]
    band = _z_band(zi, wz, nz)                           # (N,nz)
    rows_ct = (ct[:, None, None] * wxy[:, :, None]
               * band[:, None, :])                       # (N,K,nz)
    out = jnp.zeros((n_rows, nz), ct.dtype)
    kw = {}
    try:
        sh = jax.typeof(ri).sharding
        if any(s is not None for s in sh.spec):
            # explicit-sharding mode: scatter of point-sharded updates
            # into the replicated table cotangent (the engine's standard
            # layout — grid-sharded fields use parallel.grid_sharding's
            # own operators, never this path)
            from jax.sharding import NamedSharding as _NS, \
                PartitionSpec as _P
            kw["out_sharding"] = _NS(sh.mesh, _P(None, None))
    except (TypeError, ValueError, AttributeError):
        pass
    out = out.at[ri].add(rows_ct, **kw)
    return [out, None, None, None, None]


# A/B switch for bench/probe_enkf_adjoint.py ONLY: force the round-4
# derived-adjoint fallback under vmap to measure what the batched hand
# transpose buys the EnKF member axis. Never set in production.
import os as _os
_BATCH_FALLBACK = _os.environ.get(
    "ROWS_VALUE_BATCH_FALLBACK", "0") == "1"


def _rows_value_batch(args, dims, *, xy_first):
    # vmap over the FIELD axis is the EnKF member axis (DESIGN.md §13).
    # When the stencil indices are batch-invariant — the production
    # case: every member sees the same rays — rebind the primitive with
    # the batch axis leading on the table/weights so the hand transpose
    # stays in effect (a single shared-index scatter with a member axis
    # on the updates). Index-batched or already-batched calls fall back
    # to the vmapped plain impl (XLA-derived adjoint).
    table, ri, wxy, zi, wz = args
    dt, di, dwxy, dzi, dwz = dims
    nb = _batching.not_mapped
    if (not _BATCH_FALLBACK and di is nb and dzi is nb
            and (dt is nb or table.ndim == 3)
            and (dwxy is nb or wxy.ndim == 3)
            and (dwz is nb or wz.ndim == 3)):
        mv = jnp.moveaxis
        out = rows_value_p.bind(
            table if dt is nb else mv(table, dt, 0),
            ri,
            wxy if dwxy is nb else mv(wxy, dwxy, 0),
            zi,
            wz if dwz is nb else mv(wz, dwz, 0),
            xy_first=xy_first)
        return out, 0
    return jax.vmap(partial(_rows_value_impl, xy_first=xy_first),
                    in_axes=dims)(*args), 0


rows_value_p.def_impl(_rows_value_impl)
rows_value_p.def_abstract_eval(_rows_value_abstract)
_mlir.register_lowering(
    rows_value_p, _mlir.lower_fun(_rows_value_impl,
                                  multiple_results=False))
_ad.primitive_jvps[rows_value_p] = _rows_value_jvp
_ad.primitive_transposes[rows_value_p] = _rows_value_transpose
_batching.primitive_batchers[rows_value_p] = _rows_value_batch


def rows_value(table, ri, wxy, zi, wz, xy_first: bool) -> jax.Array:
    """Bind ``rows_value_p`` with vma equalisation (shard_map callers mix
    a replicated table with device-varying points; pvary broadcasts the
    table so the standard vma rule holds, and pvary's transpose supplies
    the cross-device psum of the table cotangent)."""
    table, ri, wxy, zi, wz = _jcore.standard_insert_pvary(
        table, ri, wxy, zi, wz)
    return rows_value_p.bind(table, ri, wxy, zi, wz, xy_first=xy_first)


def interp_rows(field2d: jax.Array, grid: Grid3D, points: jax.Array
                ) -> jax.Array:
    """Row-gather tricubic interpolation (the hot-loop path).

    ``field2d`` is the field pre-reshaped to (nx*ny, nz) — pass it reshaped
    once outside any scan so the layout change isn't paid per step. The
    linear field→values map runs as ``rows_value_p`` for its batching rule
    (the EnKF member axis keeps a hand scatter) and sharding contract; the
    unbatched transpose is the dense-row scatter (block comment above —
    measured equal to XLA's derived adjoint, DESIGN.md §18).
    """
    idx, frac, row_idx = _row_neighborhood(grid, points)
    wx = _catmull_rom_weights(frac[:, 0])
    wy = _catmull_rom_weights(frac[:, 1])
    wxy = (wx[:, :, None] * wy[:, None, :]).reshape(-1, 16)
    wz4 = _catmull_rom_weights(frac[:, 2])
    return rows_value(field2d, row_idx, wxy, idx[:, 2], wz4,
                      xy_first=False)


def interp_rows_with_grad(field2d: jax.Array, grid: Grid3D,
                          points: jax.Array):
    """Row-gather value + physical gradient (the tracer's path).

    Same contraction structure as ``interp_with_grad`` but with the z axis
    handled by two dense banded vectors (weights and derivative weights)
    against the gathered pencils.
    """
    idx, frac, row_idx = _row_neighborhood(grid, points)
    nz = grid.shape[2]
    rows = _sharded_take(field2d, row_idx)               # (N,16,nz)
    wz_band = _z_band(idx[:, 2], _catmull_rom_weights(frac[:, 2]), nz)
    dwz_band = _z_band(idx[:, 2], _catmull_rom_dweights(frac[:, 2]), nz)
    cz = jnp.einsum("nkz,nz->nk", rows, wz_band).reshape(-1, 4, 4)
    cz_d = jnp.einsum("nkz,nz->nk", rows, dwz_band).reshape(-1, 4, 4)

    wx = _catmull_rom_weights(frac[:, 0])
    wy = _catmull_rom_weights(frac[:, 1])
    dwx = _catmull_rom_dweights(frac[:, 0])
    dwy = _catmull_rom_dweights(frac[:, 1])

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


def interp_weights(grid: Grid3D, points: jax.Array):
    """Expose (flat voxel indices, weights) of the interpolation stencil.

    Returns (flat_idx (N, 64) int32, weights (N, 64) f32) such that
    ``interp(field, grid, points) == (field.ravel()[flat_idx] * w).sum(-1)``.
    This is the matrix-free ray–voxel Jacobian building block: the TEC
    operator's adjoint scatters through exactly these index/weight pairs
    (SURVEY.md §7 "Adjoint scatter-add").
    """
    idx, frac = _neighborhood(grid, points)
    nx, ny, nz = grid.shape
    ix = idx[:, 0, :, None, None]
    iy = idx[:, 1, None, :, None]
    iz = idx[:, 2, None, None, :]
    flat = ((ix * ny + iy) * nz + iz)
    flat = jnp.broadcast_to(flat, (points.shape[0], 4, 4, 4))
    wx = _catmull_rom_weights(frac[:, 0])
    wy = _catmull_rom_weights(frac[:, 1])
    wz = _catmull_rom_weights(frac[:, 2])
    w = wx[:, :, None, None] * wy[:, None, :, None] * wz[:, None, None, :]
    n = points.shape[0]
    return flat.reshape(n, 64), w.reshape(n, 64)
