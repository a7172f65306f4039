"""Multi-device sharding tests on the virtual 8-device CPU mesh
(SURVEY.md §4: sharding logic CI-testable without accelerators).

The contract: sharded execution is *numerically identical* (up to f32
reduction order) to single-device execution, for the forward TEC, the bent
tracer, and a full gradient step (forward + adjoint psum).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ionotomo_tpu.parallel import sharding as shard_mod
from ionotomo_tpu.geometry import rays as rays_mod, fermat
from ionotomo_tpu.forward import tec as tec_mod
from ionotomo_tpu.models import chapman
from ionotomo_tpu.core.grids import Grid3D

pytestmark = pytest.mark.skipif(len(jax.devices()) < 2,
                                reason="needs multi-device mesh")


def world(nx=16, n_rays=40):
    rng = np.random.default_rng(0)
    grid = Grid3D.from_bounds((-300, -300, 0.0), (300, 300, 1000.0),
                              (nx, nx, nx))
    m = chapman.log_parametrize(chapman.chapman_field(grid))
    o = np.concatenate([rng.uniform(-30, 30, (n_rays, 2)),
                        np.zeros((n_rays, 1))], -1).astype(np.float32)
    zen = rng.uniform(0.05, 0.5, n_rays)
    az = rng.uniform(0, 2 * np.pi, n_rays)
    d = np.stack([np.sin(zen) * np.sin(az), np.sin(zen) * np.cos(az),
                  np.cos(zen)], -1).astype(np.float32)
    return grid, m, jnp.asarray(o), jnp.asarray(d)


def test_mesh_and_padding():
    mesh = shard_mod.ray_mesh()
    assert mesh.devices.size == len(jax.devices())
    o = jnp.ones((13, 3))
    (o_p,), n = shard_mod.shard_ray_batch(mesh, o)
    assert n == 13
    assert o_p.shape[0] % mesh.devices.size == 0
    o_np = np.asarray(o_p)
    np.testing.assert_allclose(o_np[12], o_np[-1])


def test_sharded_tec_matches_single_device():
    grid, m, o, d = world()
    rb = rays_mod.sample_straight_rays(o, d, n_samples=33)
    want = np.asarray(tec_mod.tec(m, grid, rb))

    mesh = shard_mod.ray_mesh()
    (pts, ds), n = shard_mod.shard_ray_batch(mesh, rb.points, rb.ds)
    (m_r,) = shard_mod.replicate(mesh, m)
    got = jax.jit(lambda mm, p, s: tec_mod.tec(
        mm, grid, rays_mod.RayBundle(points=p, ds=s)))(m_r, pts, ds)
    np.testing.assert_allclose(np.asarray(got)[:n], want, rtol=2e-6,
                               atol=1e-3 * np.abs(want).max())


def test_sharded_bent_tracer_matches_single_device():
    grid, m, o, d = world()
    _, tec_single = fermat.trace_rays(m, grid, o, d, 150e6, 1000.0,
                                      n_steps=16, keep_path=False,
                                      method="leapfrog")
    mesh = shard_mod.ray_mesh()
    (o_p, d_p), n = shard_mod.shard_ray_batch(mesh, o, d)
    (m_r,) = shard_mod.replicate(mesh, m)
    f = jax.jit(lambda mm, oo, dd: fermat.trace_rays(
        mm, grid, oo, dd, 150e6, 1000.0, n_steps=16, keep_path=False,
        method="leapfrog")[1])
    got = f(m_r, o_p, d_p)
    np.testing.assert_allclose(np.asarray(got)[:n], np.asarray(tec_single),
                               rtol=3e-6)


def test_pipeline_shards_rays_on_the_mesh():
    """With 8 devices and Na*Nd divisible by 8, the pipeline's snapshot
    solve runs with ray-sharded bundles and matches the unsharded solve."""
    from ionotomo_tpu.data.synth import generate_example_datapack
    from ionotomo_tpu.inversion.pipeline import InversionPipeline
    from ionotomo_tpu.config import (EngineConfig, GridConfig, RayConfig,
                                     SolverConfig, RuntimeConfig)
    import tempfile, os

    dp, _ = generate_example_datapack(
        n_antennas=8, n_directions=4, n_times=1, mjd0=58000.45,
        grid_shape=(12, 12, 12), n_samples=17)   # 32 rays / 8 devices
    with tempfile.TemporaryDirectory() as td:
        cfg = EngineConfig(
            grid=GridConfig(shape=(12, 12, 12)),
            rays=RayConfig(n_samples=17),
            solver=SolverConfig(gn_iters=1, cg_iters=10),
            runtime=RuntimeConfig(checkpoint_dir=os.path.join(td, "c"),
                                  metrics_path=os.path.join(td, "m.jsonl")))
        pipe = InversionPipeline(dp, cfg)
        assert pipe.mesh is not None
        rb = pipe._shard(pipe.rays_for_time(0))
        assert len(rb.points.sharding.device_set) == len(jax.devices())
        m_t, diag = pipe.solve_snapshot(0)
        assert np.isfinite(np.asarray(m_t)).all()


def test_sharded_gradient_step_psums_correctly():
    """Gradient of a data-misfit wrt the replicated grid, with rays sharded:
    XLA must all-reduce the scatter-add; compare against single-device."""
    grid, m, o, d = world(n_rays=48)
    rb = rays_mod.sample_straight_rays(o, d, n_samples=33)
    target = tec_mod.tec(m, grid, rb) * 1.1

    def loss(mm, pts, ds, tgt):
        g = tec_mod.tec(mm, grid, rays_mod.RayBundle(points=pts, ds=ds))
        return jnp.sum((g - tgt) ** 2)

    g_single = np.asarray(jax.grad(loss)(m, rb.points, rb.ds, target))

    mesh = shard_mod.ray_mesh()
    (pts, ds, tgt), n = shard_mod.shard_ray_batch(
        mesh, rb.points, rb.ds, target)
    # mask padded rays out of the loss by zeroing their target AND their
    # prediction contribution via a weight vector
    w = jnp.zeros(pts.shape[0]).at[:n].set(1.0)
    w = jax.device_put(w, shard_mod.ray_sharding(mesh))
    (m_r,) = shard_mod.replicate(mesh, m)

    def loss_masked(mm, pts, ds, tgt, w):
        g = tec_mod.tec(mm, grid, rays_mod.RayBundle(points=pts, ds=ds))
        return jnp.sum(w * (g - tgt) ** 2)

    g_sharded = jax.jit(jax.grad(loss_masked))(m_r, pts, ds, tgt, w)
    np.testing.assert_allclose(np.asarray(g_sharded), g_single,
                               atol=2e-3 * np.abs(g_single).max())


def test_pipeline_pads_indivisible_ray_batches():
    """Na·Nd not divisible by the mesh: the pipeline pads whole antennas
    (noise-inflated) and shards — and matches the unsharded solve
    (VERDICT r1 #7: no silent replication)."""
    from ionotomo_tpu.data.synth import generate_example_datapack
    from ionotomo_tpu.inversion.pipeline import InversionPipeline
    from ionotomo_tpu.config import (EngineConfig, GridConfig, RayConfig,
                                     SolverConfig, RuntimeConfig)
    import tempfile, os

    dp, _ = generate_example_datapack(
        n_antennas=7, n_directions=5, n_times=1, mjd0=58000.45,
        grid_shape=(12, 12, 12), n_samples=17)   # 35 rays: 35 % 8 != 0
    with tempfile.TemporaryDirectory() as td:
        def cfg(sub):
            return EngineConfig(
                grid=GridConfig(shape=(12, 12, 12)),
                rays=RayConfig(n_samples=17),
                solver=SolverConfig(gn_iters=1, cg_iters=10),
                runtime=RuntimeConfig(
                    checkpoint_dir=os.path.join(td, sub, "c"),
                    metrics_path=os.path.join(td, sub, "m.jsonl")))
        pipe = InversionPipeline(dp, cfg("a"))
        assert pipe.mesh is not None
        m_sharded, diag = pipe.solve_snapshot(0)
        events = [r for r in pipe.metrics.read_all()
                  if r.get("event") == "ray_sharding_padded"]
        assert len(events) == 1 and events[0]["na_padded"] * 5 % 8 == 0
        assert diag["rays"] == 35          # diagnostics report real rays

        pipe_un = InversionPipeline(dp, cfg("b"))
        pipe_un.mesh = None                # force single-device path
        m_single, _ = pipe_un.solve_snapshot(0)
        # the padded solve's data vector differs from the unpadded one
        # (extra ~zero-weight rows) so truncated-CG iterates differ by a
        # benign trajectory perturbation on top of f32 psum reduction
        # noise — measured ~4% of the reconstruction delta under the
        # Simpson operator and ~6.4% under the (r3 default) Hermite
        # operator's slightly different Krylov trajectory; bound at 8%
        delta = np.abs(np.asarray(m_single) - np.asarray(pipe_un.m_prior))
        diff = np.abs(np.asarray(m_sharded) - np.asarray(m_single))
        assert diff.max() < 0.08 * delta.max(), (diff.max(), delta.max())


def test_pipeline_kalman_shards_rays_with_padding():
    """The time-domain solver also pads + shards the ray axis (axis 1 of
    the stacked sequence); result matches the unsharded filter.

    Noise level: 1e-2 TECU — the production-noise class. At this world's
    original 1e-3 the filter's truncated-CG update is so sharply
    conditioned that ANY f32 operator-level perturbation at the 3e-7
    rounding bound is amplified ~3e5× into ~10% field differences
    (measured, round 4: sharded-vs-unsharded AND hand-vs-derived adjoint
    summation orders both land at ~0.08 max while each operator pair
    agrees to 5e-7 — the exact-adjoint contract is pinned at the operator
    level in test_boxspline.test_hand_transpose_matches_derived_adjoint).
    The parity contract asserted here is meaningful at physical SNR, not
    at rounding-chaos SNR."""
    from ionotomo_tpu.data.synth import generate_example_datapack
    from ionotomo_tpu.inversion.pipeline import InversionPipeline
    from ionotomo_tpu.config import (EngineConfig, GridConfig, RayConfig,
                                     SolverConfig, RuntimeConfig)
    import tempfile, os

    dp, truth = generate_example_datapack(
        n_antennas=7, n_directions=5, n_times=3, mjd0=58000.45,
        grid_shape=(12, 12, 12), n_samples=17,
        noise_tecu=1e-2)   # 35 rays: 35 % 8 != 0
    dp.wind_kmps = truth["wind_kmps"]
    with tempfile.TemporaryDirectory() as td:
        def cfg(sub):
            return EngineConfig(
                grid=GridConfig(shape=(12, 12, 12)),
                rays=RayConfig(n_samples=17),
                solver=SolverConfig(solver="kalman", cg_iters=10),
                runtime=RuntimeConfig(
                    checkpoint_dir=os.path.join(td, sub, "c"),
                    metrics_path=os.path.join(td, sub, "m.jsonl")))
        pipe = InversionPipeline(dp, cfg("a"))
        assert pipe.mesh is not None
        sol_sh = pipe.run(resume=False)
        pipe_un = InversionPipeline(dp, cfg("b"))
        pipe_un.mesh = None
        sol_un = pipe_un.run(resume=False)
        delta = np.abs(sol_un.m - np.asarray(pipe_un.m_prior)).max()
        assert np.abs(sol_sh.m - sol_un.m).max() < 0.05 * delta


@pytest.mark.parametrize("interp", ["cubic", "zp"])
def test_sharded_operator_applies_match_unsharded_tightly(interp):
    """Operator-level shard-parity contract (ADVICE r4): one J apply and
    one Jᵀ apply of the linearised dTEC operator on a padded + sharded
    ray axis must match the unsharded operator to near-f32-rounding
    tolerance, independent of any CG amplification. This keeps the
    sharply-conditioned regime covered after the end-to-end Kalman
    parity test moved to physical (1e-2 TECU) noise: a genuine
    cross-shard reduction bug shows up HERE at 1e-6, not hidden inside
    a 3e5×-amplified filter trajectory."""
    nd = 5
    grid, m, o, d = world(nx=12, n_rays=0)
    rng = np.random.default_rng(5)
    na = 7                                # 35 rays: 35 % 8 != 0 → padding
    ants = np.concatenate([rng.uniform(-40, 40, (na, 2)),
                           np.zeros((na, 1))], -1).astype(np.float32)
    zen = rng.uniform(0.05, 0.4, nd)
    az = rng.uniform(0, 2 * np.pi, nd)
    dirs = np.stack([np.sin(zen) * np.sin(az), np.sin(zen) * np.cos(az),
                     np.cos(zen)], -1).astype(np.float32)
    origins, dvecs = rays_mod.make_ray_batch(ants, dirs)
    rb = rays_mod.sample_straight_rays(origins, dvecs, n_samples=17)

    def fwd(mm, rr):
        return tec_mod.dtec_paired_q(mm, grid, rr, nd, 0,
                                     "hermite", interp).ravel()

    v = jnp.asarray(rng.normal(size=grid.shape).astype(np.float32))
    w = jnp.asarray(rng.normal(size=(na * nd,)).astype(np.float32))

    _, jvp_un = jax.linearize(lambda mm: fwd(mm, rb), jnp.asarray(m))
    j_un = np.asarray(jvp_un(v))
    (jt_un,) = jax.linear_transpose(jvp_un, jnp.asarray(m))(w)
    jt_un = np.asarray(jt_un)

    # pad the antenna axis (the pipeline's padding unit: whole antennas,
    # so paired dTEC referencing stays row-major) and shard the ray axis
    mesh = shard_mod.ray_mesh()
    ndev = mesh.devices.size
    na_p = na
    while (na_p * nd) % ndev:
        na_p += 1
    pts = rb.points.reshape(na, nd, -1, 3)
    pts_p = jnp.concatenate(
        [pts, jnp.broadcast_to(pts[-1:], (na_p - na,) + pts.shape[1:])],
        axis=0).reshape(na_p * nd, -1, 3)
    ds_p = jnp.concatenate(
        [rb.ds.reshape(na, nd),
         jnp.broadcast_to(rb.ds.reshape(na, nd)[-1:], (na_p - na, nd))],
        axis=0).reshape(-1)
    sh = shard_mod.ray_sharding(mesh)
    pts_p = jax.device_put(pts_p, sh)
    ds_p = jax.device_put(ds_p, sh)
    (m_r, v_r) = shard_mod.replicate(mesh, jnp.asarray(m), v)
    rb_p = rays_mod.RayBundle(points=pts_p, ds=ds_p)
    w_p = jnp.concatenate(
        [w, jnp.zeros(((na_p - na) * nd,), w.dtype)], axis=0)
    # the cotangent lives in data space: it must carry the operator
    # output's ray sharding
    w_r = jax.device_put(w_p, sh)

    @jax.jit
    def apply_j(mm, vv, pp, ss):
        rr = rays_mod.RayBundle(points=pp, ds=ss)
        _, jvp = jax.linearize(lambda x: fwd(x, rr), mm)
        return jvp(vv)

    @jax.jit
    def apply_jt(mm, ww, pp, ss):
        rr = rays_mod.RayBundle(points=pp, ds=ss)
        _, jvp = jax.linearize(lambda x: fwd(x, rr), mm)
        (out,) = jax.linear_transpose(jvp, mm)(ww)
        return out

    j_sh = np.asarray(apply_j(m_r, v_r, pts_p, ds_p))[:na * nd]
    jt_sh = np.asarray(apply_jt(m_r, w_r, pts_p, ds_p))

    np.testing.assert_allclose(j_sh, j_un, rtol=3e-6,
                               atol=3e-6 * np.abs(j_un).max())
    np.testing.assert_allclose(jt_sh, jt_un, rtol=3e-6,
                               atol=3e-6 * np.abs(jt_un).max())


def test_anchored_solve_with_sharded_rays_matches_unsharded():
    """Joint anchor rows (replicated) + dTEC rays (sharded) in one MAP
    solve: the mixed-sharding program must run and match the unsharded
    result; slant anchors cover the non-vertical GNSS geometry."""
    from ionotomo_tpu.inversion import solvers, anchors as anch
    from ionotomo_tpu.inversion.priors import GPCovariance

    grid, m, o, d = world(nx=12, n_rays=0)
    n_ants, n_dirs = 8, 4
    rng = np.random.default_rng(3)
    ants = np.concatenate([rng.uniform(-40, 40, (n_ants, 2)),
                           np.zeros((n_ants, 1))], -1).astype(np.float32)
    zen = rng.uniform(0.05, 0.4, n_dirs)
    az = rng.uniform(0, 2 * np.pi, n_dirs)
    dirs = np.stack([np.sin(zen) * np.sin(az), np.sin(zen) * np.cos(az),
                     np.cos(zen)], -1).astype(np.float32)
    origins, dvecs = rays_mod.make_ray_batch(ants, dirs)
    rb = rays_mod.sample_straight_rays(origins, dvecs, max_length_km=800.0,
                                       n_samples=17)
    m_true = m + 0.2
    d_obs = tec_mod.dtec_paired(m_true, grid, rb, n_dirs, 0)
    cov = GPCovariance.create(grid, sigma=0.3, length_scale=120.0,
                              kind="sqexp")
    bundle = anch.slant_bundle(
        grid, rng.uniform(-40, 40, (6, 2)),
        az_rad=rng.uniform(0, 2 * np.pi, 6),
        el_rad=rng.uniform(0.8, 1.5, 6), n_samples=17)
    a = anch.TecAnchors(rays=bundle,
                        values=tec_mod.tec(m_true, grid, bundle),
                        noise_std=jnp.float32(1.0))

    ref = solvers.map_gauss_newton(grid, rb, d_obs, 1.0, m, cov,
                                   num_directions=n_dirs, gn_iters=1,
                                   cg_iters=10, anchors=a)

    mesh = shard_mod.ray_mesh()
    sh = shard_mod.ray_sharding(mesh)
    rb_s = rays_mod.RayBundle(points=jax.device_put(rb.points, sh),
                              ds=jax.device_put(rb.ds, sh))
    (m_r,) = shard_mod.replicate(mesh, m)
    got = solvers.map_gauss_newton(grid, rb_s, d_obs, 1.0, m_r, cov,
                                   num_directions=n_dirs, gn_iters=1,
                                   cg_iters=10, anchors=a)
    # f32 psum/all-gather reduction order differs from the single-device
    # sum; 10 CG iterations amplify it to ~1e-3 on O(10) field values
    np.testing.assert_allclose(np.asarray(got.m), np.asarray(ref.m),
                               atol=3e-3)


def test_slant_bundle_geometry_and_mapping():
    """Slant rays exit at the grid top; the 3D slant/vertical TEC ratio of
    a horizontally-uniform field matches the thin-shell mapping function
    to a few percent (flat-grid geometry ~ secant law)."""
    from ionotomo_tpu.inversion import anchors as anch

    grid, m, _, _ = world(nx=16, n_rays=0)
    el = np.deg2rad(55.0)
    sb = anch.slant_bundle(grid, [[0.0, 0.0]], az_rad=0.7, el_rad=el,
                           n_samples=33)
    top = float(np.asarray(sb.points)[0, -1, 2])
    z_top = float(grid.origin[2] + grid.spacing[2] * (grid.shape[2] - 1))
    assert abs(top - z_top) < 1e-3
    vb = anch.columns_bundle(grid, [[0.0, 0.0]], n_samples=33)
    stec = float(tec_mod.tec(m, grid, sb)[0])
    vtec = float(tec_mod.tec(m, grid, vb)[0])
    # flat-slab secant: STEC/VTEC = 1/sin(el); thin-shell mapping at the
    # same el is within ~10% of that for el≥45°
    assert abs(stec / vtec - 1.0 / np.sin(el)) < 0.03 / np.sin(el)
    msf = anch.thin_shell_mapping(el)
    assert 0.85 < (stec / vtec) / msf < 1.25


def test_member_parallel_enkf_matches_unsharded():
    """kalman.member_parallel_enkf (P3 member parallelism via shard_map):
    with the exact same global per-member randomness (generated at global
    shape on every device and locally sliced), the member-sharded filter
    matches the unsharded one to the f32 reduction bound — incl. the
    inflation centering pmean, the shared wind refinement on the global
    ensemble mean, and the deterministic sqrt anchored update's pmean."""
    from ionotomo_tpu.inversion.kalman import (ensemble_kalman_filter,
                                               initial_ensemble,
                                               member_parallel_enkf)
    from ionotomo_tpu.inversion.priors import GPCovariance
    from ionotomo_tpu.inversion.anchors import (TecAnchors,
                                                background_covariance,
                                                columns_bundle)

    grid, m, o, d = world(nx=12, n_rays=16)
    n_dirs, nt, n_members = 4, 3, 8
    rb = rays_mod.sample_straight_rays(o, d, max_length_km=900.0,
                                       n_samples=33)
    rs = rays_mod.RayBundle(points=jnp.stack([rb.points] * nt),
                            ds=jnp.stack([rb.ds] * nt))
    d_seq = jnp.stack([tec_mod.dtec_paired(m, grid, rb, n_dirs, 0)] * nt)
    cov = GPCovariance.create(grid, sigma=0.3, length_scale=120.0,
                              kind="sqexp")
    # a few VTEC anchors exercising the sqrt anchored update's pmean
    pts_xy = np.asarray([[0.0, 0.0], [150.0, -100.0]], np.float32)
    arb = columns_bundle(grid, pts_xy)
    anchors = TecAnchors(rays=arb,
                         values=tec_mod.tec(m, grid, arb),
                         noise_std=jnp.float32(0.5))
    a_cov = background_covariance(grid)
    key = jax.random.key(3)
    kw = dict(num_directions=n_dirs, key=key, n_members=n_members,
              cg_iters=5, fade=0.95, inflation=1.05, process_sigma=0.02,
              wind_adapt_iters=1, anchors=anchors, anchor_cov=a_cov)

    ens0 = initial_ensemble(grid, cov, m, key, n_members)
    base = ensemble_kalman_filter(grid, rs, d_seq, jnp.float32(1e-2), m,
                                  cov, (0.1, 0.0, 0.0), 60.0, ens0=ens0,
                                  **kw)
    mesh = shard_mod.member_mesh()
    ens0_s = jax.device_put(ens0, shard_mod.member_sharding(mesh))
    sh = member_parallel_enkf(mesh, grid, rs, d_seq, jnp.float32(1e-2), m,
                              cov, (0.1, 0.0, 0.0), 60.0, ens0=ens0_s,
                              **kw)
    assert sh.ensemble.sharding.spec[0] == shard_mod.MEMBER_AXIS
    scale = float(jnp.abs(base.ensemble - m[None]).max())
    for name in ("mean_seq", "std_seq", "ensemble", "wind_seq"):
        a, b = getattr(base, name), getattr(sh, name)
        diff = float(jnp.abs(a - b).max())
        ref = scale if name != "wind_seq" else 1.0
        # f32 reduction-order drift compounds through 3 nonlinear filter
        # steps (anchored + wind-adaptive). Round 5 widened the expected
        # drift: the member-vmapped path runs the BATCHED rows_value_p
        # transpose (shared-index scalar scatter) while each shard_map
        # member runs the unbatched dense-row form — different f32
        # summation orders BY DESIGN (DESIGN.md §18), observed ~7e-4 at
        # scale ~1 (was ~1.6e-4 when both paths shared one form).
        # Operator-level sharded parity stays pinned at 3e-6
        # (test_sharded_operator_applies_match_unsharded_tightly) and
        # batched-vs-plain vmap parity at operator level in
        # test_boxspline.py — this end-to-end bound only guards against
        # gross cross-member reduction bugs.
        assert diff < 2e-3 * max(ref, 1.0), (name, diff)
    rel = float(jnp.abs(base.residuals - sh.residuals).max()
                / jnp.abs(base.residuals).max())
    assert rel < 1e-4, rel


def test_member_parallel_enkf_guards():
    """Wrapper input validation: wrong mesh axis, indivisible members,
    missing ens0, spectrum_blend."""
    import pytest as _pytest
    from ionotomo_tpu.inversion.kalman import (initial_ensemble,
                                               member_parallel_enkf)
    from ionotomo_tpu.inversion.priors import GPCovariance

    grid, m, o, d = world(nx=8, n_rays=8)
    cov = GPCovariance.create(grid, sigma=0.3, length_scale=120.0,
                              kind="sqexp")
    mesh = shard_mod.member_mesh()
    n_dev = mesh.devices.size
    ens0 = initial_ensemble(grid, cov, m, jax.random.key(0), n_dev)
    args = (grid, None, None, None, m, cov, (0, 0, 0), 30.0)
    with _pytest.raises(ValueError, match="member_mesh"):
        member_parallel_enkf(shard_mod.ray_mesh(), *args, ens0=ens0,
                             n_members=n_dev)
    with _pytest.raises(ValueError, match="divide"):
        member_parallel_enkf(mesh, *args, ens0=ens0, n_members=n_dev + 1)
    with _pytest.raises(ValueError, match="requires ens0"):
        member_parallel_enkf(mesh, *args, ens0=None, n_members=n_dev)
    with _pytest.raises(ValueError, match="spectrum_blend"):
        member_parallel_enkf(mesh, *args, ens0=ens0, n_members=n_dev,
                             spectrum_blend=0.5)


def test_pipeline_enkf_member_sharding_matches_rays_mode():
    """SolverConfig.enkf_shard='members' end-to-end: the member-sharded
    pipeline EnKF matches the ray-sharded (default) run closely — both
    consume identical per-member randomness — and checkpoints a gatherable
    ensemble."""
    from ionotomo_tpu.data.synth import generate_example_datapack
    from ionotomo_tpu.inversion.pipeline import InversionPipeline
    from ionotomo_tpu.config import (EngineConfig, GridConfig, RayConfig,
                                     SolverConfig, RuntimeConfig)
    import tempfile, os

    n_dev = len(jax.devices())
    dp, truth = generate_example_datapack(
        n_antennas=7, n_directions=5, n_times=3, mjd0=58000.45,
        grid_shape=(12, 12, 12), n_samples=17)
    dp.wind_kmps = truth["wind_kmps"]
    with tempfile.TemporaryDirectory() as td:
        def cfg(sub, shard):
            return EngineConfig(
                grid=GridConfig(shape=(12, 12, 12)),
                rays=RayConfig(n_samples=17),
                solver=SolverConfig(solver="enkf", cg_iters=8,
                                    enkf_members=n_dev,
                                    enkf_shard=shard, kalman_chunk=2),
                runtime=RuntimeConfig(
                    checkpoint_dir=os.path.join(td, sub, "c"),
                    metrics_path=os.path.join(td, sub, "m.jsonl")))
        pipe_m = InversionPipeline(dp, cfg("m", "members"))
        assert pipe_m.mesh is not None
        sol_m = pipe_m.run(resume=False)
        pipe_r = InversionPipeline(dp, cfg("r", "rays"))
        sol_r = pipe_r.run(resume=False)
        delta = np.abs(sol_r.m - np.asarray(pipe_r.m_prior)).max()
        assert np.abs(sol_m.m - sol_r.m).max() < 0.02 * delta
        std_m = np.asarray(sol_m.diagnostics["std_seq"])
        std_r = np.asarray(sol_r.diagnostics["std_seq"])
        # spread parity is looser than mean parity: reduction-order f32
        # drift can flip a member-CG masked-convergence `done` flag at
        # the tolerance boundary, shifting that member's truncated
        # iterate — isolated voxels move visibly while the field agrees
        sd = np.abs(std_m - std_r)
        assert np.sqrt(np.mean(sd ** 2)) < 5e-3 and sd.max() < 0.05, (
            np.sqrt(np.mean(sd ** 2)), sd.max())
