"""Config 1: straight-line TEC forward model — analytic Chapman n_e on a
64³ grid, 50 antennas × 10 sources (BASELINE.json configs[0]).

Two rows since round 3:
- legacy (cubic field model, Simpson@129) — continuity with the r1/r2
  numbers, gated against the f64 grid oracle at the same samples
  (implementation parity).
- production (ZP box-spline field model, Hermite@65 — the solver-default
  forward everywhere since round 3) — gated against PHYSICAL truth: a
  dense f64 quadrature of the closed-form Chapman profile along each ray
  (the analytic-world pattern of configs 3–5), so each row is charged its
  full interpolation + quadrature model error against the true integral.
"""
import numpy as np
import jax

from bench.common import setup, make_rays, timed, emit
from ionotomo_tpu.models import chapman
from ionotomo_tpu.geometry import rays as rays_mod
from ionotomo_tpu.forward import tec as tec_mod


def _analytic_truth_tec(origins, dvecs, max_length_km=1000.0, n_dense=4097):
    """Per-ray TEC of the closed-form Chapman profile by dense f64 Simpson
    quadrature — physical truth, no grid anywhere."""
    from scipy.integrate import simpson
    K_NE, KM_TO_M, TEC_SCALE = 1e11, 1e3, 1e13
    s = np.linspace(0.0, max_length_km, n_dense)
    z = (np.asarray(origins, np.float64)[:, 2:3]
         + s[None, :] * np.asarray(dvecs, np.float64)[:, 2:3])
    ne = np.asarray(chapman.chapman_ne(z), np.float64)
    # chapman_ne returns n_e in m^-3; integrate over path length in km
    return simpson(ne, x=s, axis=1) * KM_TO_M / TEC_SCALE


def main():
    setup()
    ants, dirs = make_rays(50, 10)
    grid = chapman.grid_enclosing_rays(ants, dirs, shape=(64, 64, 64),
                                       h_min_km=0.0)
    m = chapman.log_parametrize(chapman.chapman_field(grid))
    origins, dvecs = rays_mod.make_ray_batch(ants, dirs)
    truth = _analytic_truth_tec(origins, dvecs)
    tec_mag = np.abs(truth).max()

    # --- legacy row: cubic + Simpson@129 (r1/r2 configuration) ---------
    rb = rays_mod.sample_straight_rays(origins, dvecs, n_samples=129)
    f = jax.jit(lambda mm: tec_mod.dtec_paired(mm, grid, rb, 10, 0))
    g, secs = timed(f, m, reps=10)

    # implementation-parity gate vs the f64 grid oracle at the same samples
    from reference_kernels import tec_ref
    ref = tec_ref.dtec_ref(np.asarray(m, np.float64),
                           np.asarray(grid.origin), np.asarray(grid.spacing),
                           np.asarray(rb.points), np.asarray(rb.ds), 10, 0)
    err = np.abs(np.asarray(g) - ref).max()
    # physical-truth gate: per-ray TEC vs the dense analytic integral
    t_leg = np.asarray(jax.jit(
        lambda mm: tec_mod.tec(mm, grid, rb))(m))
    truth_err_leg = np.abs(t_leg - truth).max() / tec_mag
    emit("config1", "tec_integrals_per_sec", rb.num_rays / secs, "rays/s",
         oracle_max_abs_err_working_units=float(err),
         oracle_err_rel_to_tec=float(err / tec_mag),
         truth_rel_err=float(truth_err_leg),
         seconds_per_forward=secs, interp="cubic", quadrature="simpson",
         n_samples=129)

    # --- production row: zp + Hermite@65 (the solver default) ----------
    rb_p = rays_mod.sample_straight_rays(origins, dvecs, n_samples=65)
    fp = jax.jit(lambda mm: tec_mod.dtec_paired_q(
        mm, grid, rb_p, 10, 0, quadrature="hermite", interp="zp"))
    _, secs_p = timed(fp, m, reps=10)
    t_pro = np.asarray(jax.jit(
        lambda mm: tec_mod.tec_hermite(mm, grid, rb_p, interp="zp"))(m))
    truth_err_pro = np.abs(t_pro - truth).max() / tec_mag
    emit("config1", "tec_integrals_per_sec_production",
         rb_p.num_rays / secs_p, "rays/s",
         truth_rel_err=float(truth_err_pro),
         seconds_per_forward=secs_p, interp="zp", quadrature="hermite",
         n_samples=65)


if __name__ == "__main__":
    main()
