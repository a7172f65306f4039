"""Serving steady-state latency harness: seconds per epoch through the
full EpochService path (file ingest -> ray build -> online filter update
-> Solution + JSONL write), at the reference deployment scale
62 antennas x 10 directions on a 64^3 grid.

Epochs are fed ONE AT A TIME into
the watch directory and each ``process_available()`` call is timed —
exactly the per-epoch cost a live 30 s calibration cadence sees.
The first SERVE_WARMUP epochs (compile + bootstrap) are excluded from
the steady-state statistic.

Run:  python -m bench.serve_latency          (one JSON line; needs
      h5py, the optional ``io`` extra, for the epoch files)
Env:  SERVE_INTERP (cubic|zp, default zp — production-trustworthy at
      <=128^3, DESIGN.md section 17), SERVE_INNER (default 33),
      SERVE_CG (default 8), SERVE_EPOCHS (default 24), SERVE_WARMUP (4),
      SERVE_SOLVER (kalman|enkf), SERVE_ADAPT_R (EMA weight, 0 = off),
      SERVE_BEAM (stochastic-beam paths for per-ray noise inflation,
      0 = off — the round-4 feature, costs one beam trace per epoch).
"""
import json
import os
import shutil
import tempfile
import time

import numpy as np


def main():
    from bench.common import emit, setup
    setup()
    from ionotomo_tpu.config import (EngineConfig, GridConfig, RayConfig,
                                     SolverConfig, PriorConfig,
                                     RuntimeConfig)
    from ionotomo_tpu.data.synth import generate_example_datapack
    from ionotomo_tpu.serving import EpochService

    interp = os.environ.get("SERVE_INTERP", "zp")
    inner = int(os.environ.get("SERVE_INNER", "33"))
    cg = int(os.environ.get("SERVE_CG", "8"))
    n_epochs = int(os.environ.get("SERVE_EPOCHS", "24"))
    warmup = int(os.environ.get("SERVE_WARMUP", "4"))
    solver = os.environ.get("SERVE_SOLVER", "kalman")
    adapt_r = float(os.environ.get("SERVE_ADAPT_R", "0"))
    beam = int(os.environ.get("SERVE_BEAM", "0"))

    root = tempfile.mkdtemp(prefix="serve_bench_")
    watch, out = os.path.join(root, "in"), os.path.join(root, "out")
    os.makedirs(watch)

    cfg = EngineConfig(
        grid=GridConfig(shape=(64, 64, 64)),
        rays=RayConfig(n_samples=65, interp=interp,
                       inner_samples=(inner or None), beam_noise=beam),
        prior=PriorConfig(sigma=0.3, length_scale_km=80.0,
                          kind="von_karman"),
        solver=SolverConfig(solver=solver, cg_iters=cg, adapt_r=adapt_r),
        runtime=RuntimeConfig(checkpoint_dir=os.path.join(out, "ckpt"),
                              metrics_path=os.path.join(out, "m.jsonl")),
    )
    svc = EpochService(watch, out, cfg, wind_kmps=(0.15, 0.05, 0.0))

    per_epoch = []
    try:
        for i in range(n_epochs):
            dp, _ = generate_example_datapack(
                n_antennas=62, n_directions=10, n_times=1,
                mjd0=58000.45 + i * 30.0 / 86400.0, seed=7,
                grid_shape=(48, 48, 48), n_samples=49)
            p = os.path.join(watch, f"epoch_{i:04d}.h5")
            dp.save(p + ".tmp")
            os.replace(p + ".tmp", p)
            t0 = time.perf_counter()
            n = svc.process_available()
            dt = time.perf_counter() - t0
            assert n == 1, (i, n)
            per_epoch.append(dt)
        steady = np.asarray(per_epoch[warmup:])
        emit("serve", "seconds_per_epoch", float(np.median(steady)), "s",
             mean=round(float(steady.mean()), 4),
             p90=round(float(np.percentile(steady, 90)), 4),
             min=round(float(steady.min()), 4),
             epochs=n_epochs, warmup=warmup, interp=interp,
             inner_samples=inner, cg_iters=cg, solver=solver,
             adapt_r=adapt_r, beam_noise=beam,
             data="62 ant x 10 dir / 64^3 grid, one file per epoch, "
                  "full ingest->filter->persist path")
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
