"""Transpose forms of the row-gather adjoint (DESIGN.md §18). In an
earlier round's measurements the 24-scalar hand scatter (probe_scatter form
A) was slower than the dense-row form B in isolation yet faster inside
the config-5 inner-Jacobian VJP; this probe reconciles the two, and on
the GPU answers ROADMAP S2 (atomic scatter-add may rank them
differently).

Three transpose formulations of the SAME linear map are timed, plus the
mechanically derived one, at config-5 inner-Jacobian scale (N = 490k
points, 128³ grid, zp shape K=8/L=3), both monolithic and through the
production lax.map point-chunking (tec._interp_fast structure, chunk
131072):

  vjp_derived         — XLA's derived transpose of the plain impl
  vjp_hand_scalar     — the shipped round-4 form: K·L scalar
                        contributions per point (24 indices/point)
  vjp_hand_rows       — dense-row hand form: band cotangent ⊗ wxy,
                        K full nz-rows per point (8 indices/point —
                        probe_scatter's per-index-bound winner)
  B-member vmapped twins (the EnKF member axis; B=8)

Indices are ray-coherent by default (probe_scatter.ray_coherent_bases —
the production access pattern); VJP_RANDOM=1 switches to the round-4
random-index regime, which is what probe_scatter's round-4 numbers
were actually measured on.

Run: python -m bench.probe_vjp_forms    (JSON lines)
Env: VJP_N (default 490000), VJP_GRID (128), VJP_MEMBERS (8),
     VJP_CHUNK (131072), VJP_RANDOM (0).
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


def main():
    import jax
    import jax.numpy as jnp
    from functools import partial

    from ionotomo_tpu.core.tricubic import (rows_value, _rows_value_impl,
                                            _z_band)

    from bench.probe_scatter import ray_coherent_bases

    n = int(os.environ.get("VJP_N", "490000"))
    g = int(os.environ.get("VJP_GRID", "128"))
    b = int(os.environ.get("VJP_MEMBERS", "8"))
    chunk = int(os.environ.get("VJP_CHUNK", "131072"))
    random_idx = os.environ.get("VJP_RANDOM", "0") == "1"
    n_rows, nz = g * g, g
    k, l = 8, 3
    rng = np.random.default_rng(0)
    table = jnp.asarray(rng.normal(size=(n_rows, nz)), jnp.float32)
    tables = jnp.asarray(rng.normal(size=(b, n_rows, nz)), jnp.float32)
    if random_idx:
        bx = rng.integers(1, g - 1, n)
        by = rng.integers(1, g - 1, n)
        bz = rng.integers(1, g - 1, n)
    else:
        bx, by, bz = ray_coherent_bases(n, g, rng)
    ri = jnp.asarray(
        np.clip(bx[:, None] + rng.integers(-1, 2, (n, k)), 0, g - 1) * g
        + np.clip(by[:, None] + rng.integers(-1, 2, (n, k)), 0, g - 1),
        jnp.int32)
    zi = jnp.asarray(np.asarray(bz)[:, None] + np.arange(-1, 2), jnp.int32)
    wxy = jnp.asarray(rng.normal(size=(n, k)), jnp.float32)
    wz = jnp.asarray(rng.normal(size=(n, l)), jnp.float32)
    ct = jnp.asarray(rng.normal(size=(n,)), jnp.float32)
    cts = jnp.asarray(rng.normal(size=(b, n)), jnp.float32)

    def f_plain(tb, sl=slice(None)):
        return _rows_value_impl(tb, ri[sl], wxy[sl], zi[sl], wz[sl],
                                xy_first=True)

    def f_prim(tb):
        return rows_value(tb, ri, wxy, zi, wz, xy_first=True)

    def hand_scalar_ct(c, sl=slice(None)):
        contrib = c[:, None, None] * wxy[sl][:, :, None] * wz[sl][:, None, :]
        flat = (ri[sl][:, :, None] * nz + zi[sl][:, None, :]).reshape(-1)
        out = jnp.zeros((n_rows * nz,), c.dtype)
        return out.at[flat].add(contrib.reshape(-1)).reshape(n_rows, nz)

    def hand_rows_ct(c, sl=slice(None)):
        band = _z_band(zi[sl], wz[sl], nz)                 # (N, nz)
        rows_ct = (c[:, None] * wxy[sl])[:, :, None] * band[:, None, :]
        out = jnp.zeros((n_rows, nz), c.dtype)
        return out.at[ri[sl]].add(rows_ct)

    # parity of the three transposes
    g_d = jax.jit(lambda c: jax.vjp(f_plain, table)[1](c)[0])(ct)
    g_s = jax.jit(hand_scalar_ct)(ct)
    g_r = jax.jit(hand_rows_ct)(ct)
    print(json.dumps({
        "probe": "vjp_forms", "check": "parity",
        "scalar_vs_derived": float(jnp.abs(g_s - g_d).max()
                                   / jnp.abs(g_d).max()),
        "rows_vs_derived": float(jnp.abs(g_r - g_d).max()
                                 / jnp.abs(g_d).max())}), flush=True)

    rows = dict(
        fwd=jax.jit(lambda tb: f_plain(tb)),
        vjp_derived=jax.jit(lambda tb, c: jax.vjp(f_plain, tb)[1](c)[0]),
        vjp_hand_scalar=jax.jit(lambda tb, c: hand_scalar_ct(c)),
        vjp_hand_rows=jax.jit(lambda tb, c: hand_rows_ct(c)),
        vjp_primitive=jax.jit(
            lambda tb, c: jax.vjp(f_prim, tb)[1](c)[0]),
    )
    for name, fn in rows.items():
        args = (table,) if name == "fwd" else (table, ct)
        print(json.dumps({"probe": "vjp_forms", "variant": name,
                          "seconds": round(t(fn, *args), 5)}), flush=True)

    # --- production chunking (tec._interp_fast lax.map structure) -----
    n_chunks = -(-n // chunk)
    n_pad = n_chunks * chunk
    pad = n_pad - n
    ct_p = jnp.concatenate([ct, jnp.zeros((pad,), ct.dtype)])
    ridx = jnp.arange(n_pad).reshape(n_chunks, chunk) % n  # wrap padding

    def chunked(fn_ct):
        def run(tb, c):
            def one(args):
                idx, cc = args
                return fn_ct(cc, idx)
            parts = jax.lax.map(
                one, (ridx, c.reshape(n_chunks, chunk)))
            return parts.sum(0)
        return jax.jit(run)

    def hand_scalar_idx(cc, idx):
        contrib = (cc[:, None, None] * wxy[idx][:, :, None]
                   * wz[idx][:, None, :])
        flat = (ri[idx][:, :, None] * nz
                + zi[idx][:, None, :]).reshape(-1)
        out = jnp.zeros((n_rows * nz,), cc.dtype)
        return out.at[flat].add(contrib.reshape(-1)).reshape(n_rows, nz)

    def hand_rows_idx(cc, idx):
        band = _z_band(zi[idx], wz[idx], nz)
        rows_ct = (cc[:, None] * wxy[idx])[:, :, None] * band[:, None, :]
        out = jnp.zeros((n_rows, nz), cc.dtype)
        return out.at[ri[idx]].add(rows_ct)

    def plain_chunked(tb):
        def one(idx):
            return _rows_value_impl(tb, ri[idx], wxy[idx], zi[idx],
                                    wz[idx], xy_first=True)
        return jax.lax.map(one, ridx).reshape(-1)[:n]

    for name, fn in (
        ("chunked_vjp_derived", jax.jit(
            lambda tb, c: jax.vjp(plain_chunked, tb)[1](c)[0])),
        ("chunked_vjp_hand_scalar", chunked(hand_scalar_idx)),
        ("chunked_vjp_hand_rows", chunked(hand_rows_idx)),
    ):
        print(json.dumps({"probe": "vjp_forms", "variant": name,
                          "seconds": round(t(fn, table, ct_p
                                             if "hand" in name else ct),
                                           5)}), flush=True)

    # --- the EnKF member axis: vmap over the field/table --------------
    for name, f in (("derived", lambda tb: f_plain(tb)),
                    ("primitive", f_prim)):
        def vrun(tbs, cs, f=f):
            def one(tb, c):
                return jax.vjp(f, tb)[1](c)[0]
            return jax.vmap(one)(tbs, cs)
        vrun = jax.jit(vrun)
        try:
            print(json.dumps({"probe": "vjp_forms",
                              "variant": f"vmap{b}_vjp_{name}",
                              "seconds": round(t(vrun, tables, cts), 5)}),
                  flush=True)
        except Exception as e:
            # the derived form's (B,N,K,nz) backward intermediate OOMs
            # at production scale — that is itself the finding
            print(json.dumps({"probe": "vjp_forms",
                              "variant": f"vmap{b}_vjp_{name}",
                              "error": f"{type(e).__name__}: {e}"[:160]}),
                  flush=True)
    # batched hand forms (the round-5 batched-primitive candidates):
    # shared indices, member axis only on the cotangent/updates
    def vmap_hand_scalar(cs):
        contrib = (cs[:, :, None, None] * wxy[None, :, :, None]
                   * wz[None, :, None, :])
        flat = (ri[:, :, None] * nz + zi[:, None, :]).reshape(-1)
        out = jnp.zeros((b, n_rows * nz), cs.dtype)
        return out.at[:, flat].add(
            contrib.reshape(b, -1)).reshape(b, n_rows, nz)

    def vmap_hand_rows(cs):
        band = _z_band(zi, wz, nz)                        # (N, nz)
        rows_ct = ((cs[:, :, None] * wxy[None])[:, :, :, None]
                   * band[None, :, None, :])              # (B,N,K,nz)
        out = jnp.zeros((b, n_rows, nz), cs.dtype)
        return out.at[:, ri].add(rows_ct)

    for name, fn in (("vmap_hand_scalar", jax.jit(vmap_hand_scalar)),
                     ("vmap_hand_rows", jax.jit(vmap_hand_rows))):
        try:
            got = fn(cts)
            ref = jax.vmap(lambda c: hand_rows_ct(c))(cts)
            err = float(jnp.abs(got - ref).max() / jnp.abs(ref).max())
            print(json.dumps({"probe": "vjp_forms", "variant": name,
                              "seconds": round(t(fn, cts), 5),
                              "rel_err": round(err, 9)}), flush=True)
        except Exception as e:
            print(json.dumps({"probe": "vjp_forms", "variant": name,
                              "error": f"{type(e).__name__}: {e}"[:200]}),
                  flush=True)


if __name__ == "__main__":
    main()
