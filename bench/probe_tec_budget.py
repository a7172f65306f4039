"""Pencil budget of the TEC operators (``forward.tec._interp_fast``) on
the GPU: one 256³ MAP Gauss-Newton solve through ``InversionPipeline``
from 100 × 100 rays (chip_smoke phase 3's large solve) under each
``(IONO_TEC_MONO_MB, IONO_TEC_CHUNK_MB)`` setting, in turns.

At 256³ the cubic pencil of 10k rays × 129 samples is ~21 GB, so the
setting decides between one monolithic gather and a ``lax.map`` over
chunks. The variables are read at trace time, so each setting clears
JAX's caches and compiles anew.

Run: python -m bench.probe_tec_budget   (one JSON line per setting)
"""
import json
import os
import tempfile
import time

#: (mono MiB, chunk MiB): chunked at 512 MiB, monolithic, chunked at
#: 2 GiB, then the first again (parent, change, change, parent).
SETTINGS = ((4096, 512), (65536, 512), (4096, 2048), (4096, 512))


def main(n=256, n_ants=100, n_dirs=100, seed=0):
    from bench.common import setup
    rec = setup()

    import jax
    import numpy as np
    from chip_smoke import engine_config, whitened_residual
    from ionotomo_tpu.data.synth import generate_example_datapack
    from ionotomo_tpu.inversion.pipeline import InversionPipeline

    dp, _ = generate_example_datapack(n_antennas=n_ants, n_directions=n_dirs,
                                      noise_tecu=1e-2, seed=seed)
    with tempfile.TemporaryDirectory(prefix="tec_budget_") as work:
        for i, (mono, chunk) in enumerate(SETTINGS):
            os.environ["IONO_TEC_MONO_MB"] = str(mono)
            os.environ["IONO_TEC_CHUNK_MB"] = str(chunk)
            jax.clear_caches()
            pipe = InversionPipeline(dp, engine_config(n, work, f"b{i}"))
            out = dict(metric="map_gn_256_seconds", mono_mb=mono,
                       chunk_mb=chunk, grid=n, rays=n_ants * n_dirs)
            try:
                t0 = time.perf_counter()
                pipe.run(resume=False)
                out["first_s"] = time.perf_counter() - t0
                t0 = time.perf_counter()
                sol = pipe.run(resume=False)
                out["steady_s"] = time.perf_counter() - t0
                out["residual_post"] = whitened_residual(pipe,
                                                         np.asarray(sol.m[0]))
            except jax.errors.JaxRuntimeError as e:     # out of memory
                out["error"] = str(e).splitlines()[0][:300]
            out["peak_bytes_in_use"] = (
                jax.devices()[0].memory_stats() or {}).get(
                    "peak_bytes_in_use")
            print(json.dumps(dict(out, **rec)), flush=True)


if __name__ == "__main__":
    main()
