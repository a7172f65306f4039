"""Config 2: bent-ray Fermat tracer through a tricubic 128³ n_e cube,
62 stations × 100 directions (BASELINE.json configs[1]).

Metrics: the literal config (6200 rays) and the saturated-batch headline
(rays/sec with TEC at 256k rays — the bench.py number)."""
import numpy as np
import jax

from bench.common import setup, make_rays, timed, emit
from ionotomo_tpu.core.grids import Grid3D
from ionotomo_tpu.geometry import fermat, rays as rays_mod
from ionotomo_tpu.models import chapman


def main():
    setup()
    grid = Grid3D.from_bounds((-400, -400, 0.0), (400, 400, 1100.0),
                              (128, 128, 128))
    m = chapman.log_parametrize(chapman.chapman_field(grid))

    # literal config: 62 stations x 100 directions
    ants, dirs = make_rays(62, 100)
    origins, dvecs = rays_mod.make_ray_batch(ants, dirs)
    f = jax.jit(lambda mm, oo, dd: fermat.trace_rays(
        mm, grid, oo, dd, 150e6, 1000.0, n_steps=128, keep_path=False,
        method="leapfrog")[1])
    _, secs = timed(f, m, origins, dvecs, reps=5)
    emit("config2", "bent_rays_per_sec_6200", origins.shape[0] / secs,
         "rays/s", seconds=secs)

    # saturated batch (the headline configuration)
    rng = np.random.default_rng(0)
    n = 262144
    ants2, dirs2 = make_rays(512, n // 512)
    o2, d2 = rays_mod.make_ray_batch(ants2, dirs2)
    _, secs2 = timed(f, m, o2, d2, reps=3)
    emit("config2", "bent_rays_per_sec_saturated", n / secs2, "rays/s",
         seconds=secs2)


if __name__ == "__main__":
    main()
