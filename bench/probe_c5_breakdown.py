"""Per-component cost breakdown of one config-5 filter step (128^3 grid,
10k rays, hermite@65 residuals / @49 inner Jacobian, zp field model) —
which of {full forward, inner JVP, inner VJP, C^{1/2} FFT apply,
spectral advection} owns a filter step's time.

Run: python -m bench.probe_c5_breakdown   (JSON lines, one per component)
"""
import json
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

    from bench.common import make_rays
    from ionotomo_tpu.models import chapman
    from ionotomo_tpu.models.frozen_flow import advect_periodic
    from ionotomo_tpu.geometry import rays as rays_mod
    from ionotomo_tpu.forward import tec as tec_mod
    from ionotomo_tpu.inversion.priors import GPCovariance

    ants, dirs = make_rays(100, 100)
    grid = chapman.grid_enclosing_rays(ants, dirs, shape=(128, 128, 128),
                                       h_min_km=0.0)
    m = chapman.log_parametrize(chapman.chapman_field(grid))
    cov = GPCovariance.create(grid, sigma=0.3, length_scale=80.0,
                              kind="von_karman")
    o, dv = rays_mod.make_ray_batch(ants, dirs)
    rb65 = rays_mod.sample_straight_rays(o, dv, n_samples=65)
    rb49 = rays_mod.sample_straight_rays(o, dv, n_samples=49)

    def fwd65(mm):
        return tec_mod.dtec_paired_q(mm, grid, rb65, 100, 0, "hermite",
                                     "zp").ravel()

    def fwd49(mm):
        return tec_mod.dtec_paired_q(mm, grid, rb49, 100, 0, "hermite",
                                     "zp").ravel()

    # linearize stays INSIDE jit: a jitted residual of an outer
    # linearize would close over ~500k-sample primal constants and embed
    # them in the program. jvp/vjp timings therefore INCLUDE one primal
    # evaluation; the tangent-only cost is (measured - fwd_inner_49).
    jvp_j = jax.jit(lambda mm, v: jax.jvp(fwd49, (mm,), (v,))[1])
    vjp_j = jax.jit(lambda mm, y: jax.vjp(fwd49, mm)[1](y)[0])
    y = jnp.ones((10000,), jnp.float32)
    v = jnp.ones(grid.shape, jnp.float32)
    sqrt_j = jax.jit(lambda f: cov.apply_sqrt(f))
    adv_j = jax.jit(lambda f: advect_periodic(
        f, grid, jnp.asarray([9.0, 3.0, 0.0])))
    f65_j = jax.jit(fwd65)
    f49_j = jax.jit(fwd49)

    comps = dict(
        fwd_full_65=t(f65_j, m),
        fwd_inner_49=t(f49_j, m),
        jvp_plus_primal_49=t(jvp_j, m, v),
        vjp_plus_primal_49=t(vjp_j, m, y),
        cov_sqrt_fft=t(sqrt_j, m),
        advect_fft=t(adv_j, m),
    )
    comps["jvp_inner_49"] = comps["jvp_plus_primal_49"] - comps[
        "fwd_inner_49"]
    comps["vjp_inner_49"] = comps["vjp_plus_primal_49"] - comps[
        "fwd_inner_49"]
    cg = 10
    model = (2 * comps["fwd_full_65"]            # misfit g0 + post resid
             + comps["jvp_inner_49"]             # linearize primal
             + cg * (comps["jvp_inner_49"] + comps["vjp_inner_49"]
                     + 2 * comps["cov_sqrt_fft"])
             + 2 * comps["cov_sqrt_fft"]         # rhs + final update
             + comps["vjp_inner_49"]             # rhs
             + comps["advect_fft"])
    for k, v in comps.items():
        print(json.dumps({"probe": "c5_breakdown", "component": k,
                          "seconds": round(v, 5)}), flush=True)
    print(json.dumps({"probe": "c5_breakdown",
                      "component": "modelled_step_total_cg10",
                      "seconds": round(model, 4),
                      "note": "2*fwd65 + (2cg+2)*sqrt + (cg+1)*(jvp+vjp)"
                              " + advect"}), flush=True)


if __name__ == "__main__":
    main()
