"""Headline benchmark: bent rays traced per second with their TEC
integrals, on the GPU(s) JAX sees. Prints one JSON line naming the
platform, device kind and count and the cards' power limits; refuses to
run anywhere but a GPU.

Configuration: config 2's physics (bent Fermat rays through a 128³ n_e
cube) at the **solver-grade** settings of the PRECISION.md convergence
study — leapfrog integrator with Hermite TEC quadrature, 64 steps,
1000 km paths, 150 MHz — over 262,144 rays per device, sharded over the
ray axis when more than one device is attached. 64 steps is not a
reduced-accuracy shortcut: the study shows 128 steps does not improve
endpoint or TEC error beyond the f32/interpolant floor.

``BENCH_INTERP`` selects the field model: ``zp`` (default, the
Zwart-Powell box spline) or ``cubic`` (Catmull-Rom tricubic).
"""
import json
import os
import time

import numpy as np


def main():
    from bench.common import setup
    rec = setup()

    import jax
    import jax.numpy as jnp

    from ionotomo_tpu.core.grids import Grid3D
    from ionotomo_tpu.geometry import fermat
    from ionotomo_tpu.models import chapman
    from ionotomo_tpu.parallel import sharding as shard_mod

    n_dev = len(jax.devices())
    grid = Grid3D.from_bounds((-400.0, -400.0, 0.0), (400.0, 400.0, 1100.0),
                              (128, 128, 128))
    m = chapman.log_parametrize(chapman.chapman_field(grid))

    n_rays = 262144 * n_dev
    rng = np.random.default_rng(0)
    o = np.concatenate([rng.uniform(-30, 30, (n_rays, 2)),
                        np.zeros((n_rays, 1))], -1).astype(np.float32)
    zen = rng.uniform(0.05, 0.6, n_rays)
    az = rng.uniform(0, 2 * np.pi, n_rays)
    d = np.stack([np.sin(zen) * np.sin(az), np.sin(zen) * np.cos(az),
                  np.cos(zen)], -1).astype(np.float32)

    # leapfrog@64 sits at the f32/interpolant error floor of the
    # convergence study against the f64 adaptive oracle (PRECISION.md)
    n_steps = 64
    mesh = shard_mod.ray_mesh()
    (o_s, d_s), _ = shard_mod.shard_ray_batch(mesh, jnp.asarray(o),
                                              jnp.asarray(d))
    (m_r,) = shard_mod.replicate(mesh, m)

    interp = os.environ.get("BENCH_INTERP", "zp")
    f = jax.jit(lambda mm, oo, dd: fermat.trace_rays(
        mm, grid, oo, dd, 150e6, 1000.0, n_steps=n_steps,
        keep_path=False, method="leapfrog", interp=interp))

    out = f(m_r, o_s, d_s)
    jax.block_until_ready(out)
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        out = f(m_r, o_s, d_s)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / reps

    print(json.dumps(dict(
        metric="bent_rays_per_sec_with_tec", value=n_rays / dt,
        unit="rays/s", rays=n_rays, integrator=f"leapfrog@{n_steps}",
        grid="128^3", interp=interp, **rec)))


if __name__ == "__main__":
    main()
