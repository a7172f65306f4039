"""TEC path integrals and differential-TEC forward equation (device-side).

The reference's ``forward_equation`` (SURVEY.md §3.2): predicted dTEC
``g[i,j,k] = ∫ K_ne·e^{m(x)} ds`` via Simpson quadrature over ray samples,
minus the same integral for the reference antenna ``i0``. Here the gather +
quadrature is one fused XLA program over the whole ray batch; the hand-
written transpose (adjoint scatter-add) lives in inversion/ and reuses the
stencil weights exposed by core.tricubic.

Units: ray geometry in km, n_e in m^-3; TEC returned in working units of
``constants.TEC_SCALE`` m^-2 (1e13 = 1 mTECU), matching the reference's
~1e13 working scale (SURVEY.md §8).
"""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp

from .. import constants
from ..core import boxspline, tricubic, zpcubic
from ..core.grids import Grid3D
from ..geometry.rays import RayBundle, simpson_weights, trapezoid_weights


def _ref_row(arr: jax.Array, i0: int) -> jax.Array:
    """arr[i0] that stays valid when arr's leading (antenna) axis is
    sharded: the reference antenna's row lives on one shard and dTEC
    referencing broadcasts it — under sharding-in-types the replicated
    output spec must be stated explicitly."""
    try:
        sh = jax.typeof(arr).sharding
        sharded = any(s is not None for s in sh.spec)
    except Exception:
        sharded = False
    if sharded:
        # one-hot masked reduction over the sharded axis: the sum
        # all-reduces to a replicated row (slicing a sharded dim is not
        # supported; a psum-backed reduce is the natural collective here)
        iota = jax.lax.broadcasted_iota(
            jnp.int32, (arr.shape[0],) + (1,) * (arr.ndim - 1), 0)
        return jnp.sum(jnp.where(iota == i0, arr, 0), axis=0)
    return arr[i0]


def _coef2d(field_m: jax.Array, grid: Grid3D, interp: str) -> jax.Array:
    """The (nx*ny, nz) row-gather table for the chosen C¹ field model:
    a free layout view for "cubic" (convolution kernel, no prefilter), the
    prefiltered box-spline coefficient grid for "zp" (one matmul + two
    5-point stencil passes — linear, AD-transposable, and CSE'd by XLA
    across the repeated operator applications inside one jit program)."""
    nx, ny, nz = grid.shape
    if interp == "cubic":
        return field_m.reshape(nx * ny, nz)
    if interp.startswith("zpc"):     # before "zp": shared prefix
        order = zpcubic.zpc_order(interp)
        return zpcubic.prefilter(field_m, order).reshape(nx * ny, nz)
    if interp.startswith("zp"):
        order = boxspline.zp_order(interp)
        return boxspline.prefilter(field_m, order).reshape(nx * ny, nz)
    raise ValueError(f"unknown interp: {interp!r}")


def _rows_of(interp: str):
    if interp.startswith("zpc"):
        return zpcubic
    if interp.startswith("zp"):
        return boxspline
    return {"cubic": tricubic}[interp]


def _interp_fast(field_m: jax.Array, grid: Grid3D, pts2d: jax.Array,
                 interp: str = "cubic"):
    """Row-gather interp (the hot path for both the forward gather
    and — via its AD transpose — the row-aligned adjoint scatter), under
    the selected C¹ field model ("cubic": Catmull-Rom tricubic, 16 rows;
    "zp": prefiltered Zwart-Powell box spline, 8 rows — see
    core.boxspline / DESIGN.md §14).

    The gathered (N, rows, nz) pencil is bounded by two budgets, read at
    trace time. The whole batch runs MONOLITHIC when its pencil fits
    ``IONO_TEC_MONO_MB`` (default 24576 MiB); otherwise it runs as a
    ``lax.map`` over chunks of ``IONO_TEC_CHUNK_MB`` (default 512 MiB),
    which also bounds the VJP's memory — what the Krylov solvers
    differentiate through. Set on one H100 (80 GB, 700 W; PERF.md) from
    the 256³ MAP solve of 10k rays × 129 cubic samples, a 21 GB pencil:
    monolithic 1.88 s at 45.6 GB peak, chunked at 512 MiB 2.11–2.15 s,
    at 2 GiB 2.09 s. The budget counts one field: under a vmap over the
    field (the EnKF member axis) the pencil is that many times larger,
    so 256³ ensembles want a smaller ``IONO_TEC_MONO_MB``.
    """
    nz = grid.shape[2]
    mod = _rows_of(interp)
    table = _coef2d(field_m, grid, interp)
    n_rows = 16 if interp == "cubic" else 8
    n = pts2d.shape[0]
    per_pt = n_rows * nz * 4  # pencil bytes per point
    mono = int(os.environ.get("IONO_TEC_MONO_MB", "24576")) * 1024 * 1024
    budget = int(os.environ.get("IONO_TEC_CHUNK_MB", "512")) * 1024 * 1024
    chunk = max(8192, budget // per_pt)
    if n <= chunk or n * per_pt <= mono:
        return mod.interp_rows(table, grid, pts2d)
    n_chunks = -(-n // chunk)
    n_pad = n_chunks * chunk
    pts_p = jnp.concatenate(
        [pts2d, jnp.broadcast_to(pts2d[-1:], (n_pad - n, 3))], axis=0)
    out = jax.lax.map(
        lambda p: mod.interp_rows(table, grid, p),
        pts_p.reshape(n_chunks, chunk, 3))
    return out.reshape(n_pad)[:n]


def ne_at(field_m: jax.Array, grid: Grid3D, points: jax.Array,
          interp: str = "cubic") -> jax.Array:
    """n_e [m^-3] at points (..., 3) from the log-density field m."""
    shape = points.shape[:-1]
    m = _interp_fast(field_m, grid, points.reshape(-1, 3), interp)
    return constants.K_NE * jnp.exp(m).reshape(shape)


def log_ne_at(field_m: jax.Array, grid: Grid3D, points: jax.Array,
              interp: str = "cubic") -> jax.Array:
    """Log-density m = log(n_e/K_NE) at points (..., 3) — the forward
    operator of point density observations (data/ionosonde.py). Because
    the solve unknown IS m, this observation is exactly *linear* in the
    model (tricubic interpolation), so probe rows join any Gauss-Newton /
    Krylov solve with the operator's own machinery and no extra
    linearisation error."""
    shape = points.shape[:-1]
    m = _interp_fast(field_m, grid, points.reshape(-1, 3), interp)
    return m.reshape(shape)


def tec_from_log_values(m_values: jax.Array, rays: RayBundle) -> jax.Array:
    """Simpson TEC quadrature from log-density samples m (R·N,) or (R, N)
    along the bundle — the single home of the weights/unit chain, shared
    by the replicated path below and the sharded twin
    (parallel.grid_sharding.tec_sharded)."""
    r, n = rays.points.shape[:2]
    ne = constants.K_NE * jnp.exp(m_values).reshape(r, n)
    w = simpson_weights(n, ne.dtype)
    integral = jnp.einsum("rn,n->r", ne, w) * rays.ds * constants.KM_TO_M
    return integral / constants.TEC_SCALE


def dtec_paired_from_log_values(m_values: jax.Array, rays: RayBundle,
                                num_directions: int, i0: int = 0
                                ) -> jax.Array:
    """Cancellation-free paired-dTEC quadrature from log-density samples —
    shared by dtec_paired and parallel.grid_sharding.dtec_paired_sharded
    (including the sharded-safe reference-row reduction)."""
    r, n = rays.points.shape[:2]
    na = r // num_directions
    ne = constants.K_NE * jnp.exp(m_values).reshape(na, num_directions, n)
    dne = ne - _ref_row(ne, i0)[None, :, :]
    w = simpson_weights(n, ne.dtype)
    ds = rays.ds.reshape(na, num_directions)
    out = jnp.einsum("akn,n->ak", dne, w) * ds * constants.KM_TO_M
    return out / constants.TEC_SCALE


def tec(field_m: jax.Array, grid: Grid3D, rays: RayBundle,
        interp: str = "cubic") -> jax.Array:
    """TEC per ray, (R,), in TEC_SCALE working units.

    TEC = ∫ n_e ds = Σ w_n · K_ne·exp(m(x_n)) · ds, ds in km → ×1e3 m.
    """
    m = _interp_fast(field_m, grid, rays.points.reshape(-1, 3), interp)
    return tec_from_log_values(m, rays)


def dtec(field_m: jax.Array, grid: Grid3D, rays: RayBundle,
         num_directions: int, i0: int = 0,
         interp: str = "cubic") -> jax.Array:
    """Differential TEC w.r.t. reference antenna ``i0``.

    rays must be the row-major (antenna × direction) flat batch from
    geometry.rays.make_ray_batch: ray r = i*Nd + k. Returns (Na, Nd) with
    dtec[i0, :] ≡ 0 by construction.
    """
    t = tec(field_m, grid, rays, interp)
    t = t.reshape(-1, num_directions)          # (Na, Nd)
    return t - _ref_row(t, i0)[None, :]


def dtec_paired(field_m: jax.Array, grid: Grid3D, rays: RayBundle,
                num_directions: int, i0: int = 0,
                interp: str = "cubic") -> jax.Array:
    """Cancellation-free differential TEC (straight-ray fast path).

    ``dtec`` subtracts two large, nearly equal TEC integrals, which in f32
    loses ~eps·|TEC| ≈ 2e-3 working units to catastrophic cancellation.
    All rays built by this engine share one arc-length grid s_n = n·ds per
    direction (straight sampler and fixed-step Fermat tracer alike), so
    the subtraction commutes into the integrand exactly:
    dTEC[i,k] = Σ_n w_n · (n_e(x_{i,k,n}(s)) − n_e(x_{i0,k,n}(s))) · ds —
    valid for bent paths too, since both TECs are integrals over the same
    s ∈ [0, L]. The differences are formed sample-wise *before* the large
    reduction, recovering f32 accuracy at the dTEC scale. This is the
    default forward path everywhere; ``dtec`` remains for externally
    supplied bundles with per-antenna ds.
    """
    m = _interp_fast(field_m, grid, rays.points.reshape(-1, 3), interp)
    return dtec_paired_from_log_values(m, rays, num_directions, i0)


def _endpoint_tangents(points: jax.Array):
    """(ends (2R,3), unit tangents (2R,3)) at each ray's first and last
    sample — first/last path segments (exact for straight rays,
    O(ds²)-accurate for stored bent paths). Shared by the replicated and
    sharded Hermite operators."""
    seg0 = points[:, 1] - points[:, 0]
    seg1 = points[:, -1] - points[:, -2]
    t_hat = jnp.concatenate([seg0, seg1], axis=0)
    t_hat = t_hat / jnp.linalg.norm(t_hat, axis=-1, keepdims=True)
    ends = jnp.concatenate([points[:, 0], points[:, -1]], axis=0)
    return ends, t_hat


def endpoint_dne_ds_from(m_ends: jax.Array, gm_ends: jax.Array,
                         t_hat: jax.Array):
    """dn_e/ds at the 2R endpoint samples from interpolated (m, ∇m) and
    unit tangents: dn_e/ds = K_NE·e^m · (∇m·t̂) [m⁻³/km] — the single
    home of the derivative identity, shared by the replicated path and
    the sharded twins (parallel.grid_sharding). Returns (d_first (R,),
    d_last (R,))."""
    r = m_ends.shape[0] // 2
    ne = constants.K_NE * jnp.exp(m_ends)
    dnds = ne * jnp.einsum("pd,pd->p", gm_ends, t_hat)
    return dnds[:r], dnds[r:]


def tec_hermite_from_values(m_values: jax.Array, d0: jax.Array,
                            d1: jax.Array, rays: RayBundle) -> jax.Array:
    """Hermite TEC quadrature from log-density samples m (R·N,) and the
    n_e path derivatives at the first/last samples (R,) each [m⁻³/km] —
    the single home of the weights/units chain, shared by the replicated
    path and the sharded twin (parallel.grid_sharding)."""
    r, n = rays.points.shape[:2]
    ne = constants.K_NE * jnp.exp(m_values).reshape(r, n)
    w = trapezoid_weights(n, ne.dtype)
    integral = (jnp.einsum("rn,n->r", ne, w) * rays.ds
                + (d0 - d1) * (rays.ds * rays.ds) / 12.0)
    return integral * (constants.KM_TO_M / constants.TEC_SCALE)


def dtec_paired_hermite_from_values(m_values: jax.Array, d0: jax.Array,
                                    d1: jax.Array, rays: RayBundle,
                                    num_directions: int, i0: int = 0
                                    ) -> jax.Array:
    """Paired-dTEC twin of ``tec_hermite_from_values`` (sample-wise
    reference-antenna subtraction of values AND endpoint derivatives)."""
    r, n = rays.points.shape[:2]
    na = r // num_directions
    ne = constants.K_NE * jnp.exp(m_values).reshape(na, num_directions, n)
    dne = ne - _ref_row(ne, i0)[None, :, :]
    w = trapezoid_weights(n, ne.dtype)
    corr = (d0 - d1).reshape(na, num_directions)
    corr = corr - _ref_row(corr, i0)[None, :]
    ds = rays.ds.reshape(na, num_directions)
    out = (jnp.einsum("akn,n->ak", dne, w) * ds + corr * ds * ds / 12.0)
    return out * (constants.KM_TO_M / constants.TEC_SCALE)


def _endpoint_dne_ds(field_m: jax.Array, grid: Grid3D, rays: RayBundle,
                     interp: str = "cubic"):
    """Path derivative of n_e at each ray's first and last sample.

    dn_e/ds = n_e · (∇m · t̂) — the same identity the bent tracer's Hermite
    TEC accumulation uses (geometry.fermat), here evaluated only at the 2R
    endpoint samples (the only places the telescoped composite Hermite
    rule has nonzero derivative weights; see rays.trapezoid_weights).
    Tangents from the first/last path segments — exact for straight rays,
    O(ds²)-accurate for stored bent paths (a second-order error on an
    O(ds²) correction term). Returns (d_first (R,), d_last (R,)) in
    m⁻³/km.
    """
    ends, t_hat = _endpoint_tangents(rays.points)             # (2R, 3)
    m, gm = _rows_of(interp).interp_rows_with_grad(
        _coef2d(field_m, grid, interp), grid, ends)
    return endpoint_dne_ds_from(m, gm, t_hat)


def tec_hermite(field_m: jax.Array, grid: Grid3D, rays: RayBundle,
                interp: str = "cubic") -> jax.Array:
    """Gradient-augmented (composite cubic-Hermite) TEC per ray, (R,).

    The integral of the C¹ cubic-Hermite spline through (n_e, dn_e/ds)
    samples: trapezoid values + ds²/12·(f'_first − f'_last). Interior
    derivative terms telescope exactly (the interpolant is C¹), so the
    rule needs value gathers at all N samples plus value+gradient gathers
    at the 2 endpoints only — cheaper than Simpson at equal N, 4th order
    on smooth integrands, and with a flat (comb-free) response to
    unresolved voxel-scale structure (see rays.trapezoid_weights and the
    round-3 quadrature study in PRECISION.md).
    """
    m = _interp_fast(field_m, grid, rays.points.reshape(-1, 3), interp)
    d0, d1 = _endpoint_dne_ds(field_m, grid, rays, interp)
    return tec_hermite_from_values(m, d0, d1, rays)


def dtec_paired_hermite(field_m: jax.Array, grid: Grid3D, rays: RayBundle,
                        num_directions: int, i0: int = 0,
                        interp: str = "cubic") -> jax.Array:
    """Cancellation-free paired dTEC under the Hermite rule — the
    quadrature of ``tec_hermite`` with the reference-antenna subtraction
    commuted into the integrand sample-wise (see ``dtec_paired``), for
    both the value and the endpoint-derivative terms.
    """
    m = _interp_fast(field_m, grid, rays.points.reshape(-1, 3), interp)
    d0, d1 = _endpoint_dne_ds(field_m, grid, rays, interp)
    return dtec_paired_hermite_from_values(m, d0, d1, rays,
                                           num_directions, i0)


#: Operator quadrature registry: the production straight-ray TEC/dTEC
#: forwards, selectable by name through the solver/pipeline ``quadrature``
#: knob. "simpson" is the historical default; "hermite" reaches the same
#: accuracy with ~half the samples on solver-relevant fields (round-3
#: study, PRECISION.md) at lower cost per sample.
def dtec_paired_q(field_m, grid, rays, num_directions, i0=0,
                  quadrature: str = "simpson", interp: str = "cubic"):
    if quadrature == "hermite":
        return dtec_paired_hermite(field_m, grid, rays, num_directions, i0,
                                   interp)
    if quadrature != "simpson":
        raise ValueError(f"unknown quadrature: {quadrature!r}")
    return dtec_paired(field_m, grid, rays, num_directions, i0, interp)


def tec_q(field_m, grid, rays, quadrature: str = "simpson",
          interp: str = "cubic"):
    if quadrature == "hermite":
        return tec_hermite(field_m, grid, rays, interp)
    if quadrature != "simpson":
        raise ValueError(f"unknown quadrature: {quadrature!r}")
    return tec(field_m, grid, rays, interp)


def tec_linear(ne_field: jax.Array, grid: Grid3D, rays: RayBundle,
               interp: str = "cubic") -> jax.Array:
    """TEC as a *linear* operator of the n_e field itself (m^-3 in, working
    units out). This is the literal ray–voxel projection matrix applied
    matrix-free — the operator LSQR/CG invert in config 3."""
    r, n = rays.points.shape[:2]
    v = _interp_fast(ne_field, grid, rays.points.reshape(-1, 3), interp)
    v = v.reshape(r, n)
    w = simpson_weights(n, v.dtype)
    return jnp.einsum("rn,n->r", v, w) * rays.ds * constants.KM_TO_M \
        / constants.TEC_SCALE


def vtec_map(field_m: jax.Array, grid: Grid3D) -> jax.Array:
    """Vertical TEC map: ∫ n_e dz per (x, y) column, (nx, ny) in
    TEC_SCALE working units — the standard map product of a tomographic
    reconstruction (divide by 1000 for TECU at the default 1e13 scale:
    1 working unit = 1 mTECU).
    Simpson over the grid's own z axis; exact for the voxel model."""
    ne = constants.K_NE * jnp.exp(field_m)               # (nx, ny, nz)
    w = simpson_weights(grid.shape[2], ne.dtype)
    dz = grid.spacing[2] * constants.KM_TO_M
    return jnp.einsum("xyz,z->xy", ne, w) * dz / constants.TEC_SCALE


def ray_coverage(grid: Grid3D, rays: RayBundle,
                 interp: str = "cubic") -> jax.Array:
    """Per-voxel sampling weight: adjoint of the path integral applied to
    ones — how much total ray path (in quadrature-weight units) touches
    each voxel. Use as a diagnostic and to restrict error metrics to the
    constrained region (voxels with ~zero coverage are unobservable)."""
    ones = jnp.ones((rays.num_rays,), jnp.float32)
    return tec_linear_adjoint(ones, grid, rays, interp)


def tec_linear_adjoint(y: jax.Array, grid: Grid3D, rays: RayBundle,
                       interp: str = "cubic") -> jax.Array:
    """Exact transpose of ``tec_linear``: data-space (R,) → voxel grid.

    "cubic": scatter-adds y_r · w_n · ds_r · 1e3 / TEC_SCALE through the
    tricubic stencil weights — segment-sum-style scatter (SURVEY.md
    §5.2) via jnp .at[].add on flat indices; on the GPU that scatter is
    atomic, so its summation order varies from run to run.
    "zp": jax.linear_transpose of ``tec_linear`` — the prefilter is
    linear, so XLA derives the exact coefficient-space scatter plus the
    prefilter transpose automatically (a hand scatter would need the
    quasi-interpolation filter's transpose spelled out for no measured
    gain; the adjoint identity is tested either way).
    """
    if interp != "cubic":
        zeros = jnp.zeros(grid.shape, y.dtype)
        (out,) = jax.linear_transpose(
            lambda f: tec_linear(f, grid, rays, interp), zeros)(y)
        return out
    r, n = rays.points.shape[:2]
    idx, w64 = tricubic.interp_weights(grid, rays.points.reshape(-1, 3))
    wq = simpson_weights(n, y.dtype)
    coef = (y[:, None] * wq[None, :] * rays.ds[:, None]
            * (constants.KM_TO_M / constants.TEC_SCALE)).reshape(-1)
    contrib = w64 * coef[:, None]              # (R*N, 64)
    flat = jnp.zeros((grid.num_voxels,), y.dtype)
    flat = flat.at[idx.reshape(-1)].add(contrib.reshape(-1))
    return flat.reshape(grid.shape)


def dtec_noise_from_beam(tec_std: jax.Array, num_directions: int,
                         i0: int = 0) -> jax.Array:
    """Per-(antenna, direction) dTEC observation-noise contribution from
    per-ray chaotic TEC spreads (geometry.fermat.trace_rays_stochastic).

    dTEC_ad = TEC_ad − TEC_{i0,d}: with independent beam-decoherence
    errors per ray, σ_dTEC = sqrt(σ_ad² + σ_{i0,d}²) (the reference-
    antenna row gets its own pairing with itself → exactly 0, matching
    dtec_paired's identically-zero i0 rows). Add in quadrature to the
    instrumental noise: noise_eff = sqrt(noise² + dtec_noise²) — the
    strong-turbulence forward-model error bar entering C_d.
    """
    sd = jnp.asarray(tec_std).reshape(-1, num_directions)
    ref = sd[i0][None, :]
    out = jnp.sqrt(sd ** 2 + ref ** 2)
    return out.at[i0].set(0.0)
