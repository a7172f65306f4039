"""Real-data workflow: h5parm in → anchored, curved-Earth inversion → products.

The path a LOFAR user takes to switch from the reference to this engine:

1. solutions arrive as a losoto **h5parm** (tec/phase soltabs) →
   ``DataPack.from_h5parm``;
2. the a-priori ionosphere is evaluated with **curved-Earth** geometry
   (true altitudes + solar terminator across the wide grid);
3. an external GNSS **VTEC map** is assimilated as absolute-TEC anchors
   (sequential DA through the long-horizontal background covariance) —
   fixing the common-mode/profile component dTEC cannot observe;
4. the MAP inversion runs, and science products come out (VTEC map of
   the reconstruction, dTEC predictions onto any geometry).

Self-contained: synthesizes its own "observed" h5parm and VTEC values.
Run: python examples/real_data_workflow.py   (CPU ok; GPU if attached)
"""
import numpy as np
import jax.numpy as jnp

from ionotomo_tpu.config import (EngineConfig, GridConfig, PhysicsConfig,
                                 RayConfig, SolverConfig, RuntimeConfig)
from ionotomo_tpu.data.datapack import DataPack
from ionotomo_tpu.data.synth import generate_example_datapack
from ionotomo_tpu.forward import tec as tec_mod
from ionotomo_tpu.inversion import anchors as anch
from ionotomo_tpu.inversion.pipeline import InversionPipeline


def main(workdir="/tmp/ionotomo_real_data_demo"):
    import os
    os.makedirs(workdir, exist_ok=True)

    # --- 1. "observed" solutions as an h5parm ---------------------------
    dp0, truth = generate_example_datapack(
        n_antennas=14, n_directions=8, n_times=1, grid_shape=(28, 28, 28),
        curved_earth=True, noise_tecu=0.01, turbulence_amp=0.3)
    h5parm_path = os.path.join(workdir, "solutions.h5")
    dp0.to_h5parm(h5parm_path)
    dp = DataPack.from_h5parm(h5parm_path, noise_tecu=0.01)
    print(f"h5parm ingested: {dp.shape} (antennas, times, directions)")

    # --- 2. curved-Earth pipeline ---------------------------------------
    from ionotomo_tpu.config import PriorConfig
    cfg = EngineConfig(
        physics=PhysicsConfig(curved_earth=True),
        grid=GridConfig(shape=(28, 28, 28)),
        rays=RayConfig(n_samples=33),
        prior=PriorConfig(kind="von_karman", sigma=0.3,
                          length_scale_km=80.0),
        solver=SolverConfig(solver="map_gauss_newton", gn_iters=2,
                            cg_iters=10),
        runtime=RuntimeConfig(
            checkpoint_dir=os.path.join(workdir, "ckpt"),
            metrics_path=os.path.join(workdir, "metrics.jsonl")),
    )
    pipe = InversionPipeline(dp, cfg)

    # --- 3. external VTEC map as absolute-TEC anchors -------------------
    # (here synthesized from the truth field; in reality: a GNSS product)
    bundle = anch.vertical_anchor_bundle(pipe.grid, nx=3, ny=3)
    m_true = jnp.asarray(truth["m"][0])
    v_obs = tec_mod.tec(m_true, truth["grid"], bundle)
    anchors = anch.TecAnchors(
        rays=bundle, values=v_obs,
        noise_std=jnp.float32(0.01 * float(v_obs.mean())))

    sol = pipe.run(resume=False, anchors=anchors)

    # --- 4. science products --------------------------------------------
    m = jnp.asarray(sol.m[0])
    vtec = tec_mod.vtec_map(m, pipe.grid)
    v_rec = tec_mod.tec(m, pipe.grid, bundle)
    rel = float(jnp.mean(jnp.abs(v_rec - v_obs) / v_obs))
    print(f"reconstruction VTEC map: {vtec.shape}, "
          f"mean {float(vtec.mean()):.0f} working units "
          f"({float(vtec.mean())/1000.0:.1f} TECU)")
    print(f"absolute-VTEC error at the anchor columns: {100 * rel:.1f}% "
          f"(unanchored runs of this world leave ~10%; dTEC alone cannot "
          f"pin the absolute level)")
    assert np.isfinite(np.asarray(m)).all()
    print("workflow complete; artifacts in", workdir)


if __name__ == "__main__":
    main()
