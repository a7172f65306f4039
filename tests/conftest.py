"""Test harness configuration.

Tests run on a virtual 8-device CPU mesh so all sharding logic is CI-testable
without an accelerator (SURVEY.md §4 rebuild test plan). Must set the env
vars before jax initialises its backends. ``JAX_PLATFORMS`` defaults to
``cpu``; the ``gpu``-marked tests run on a card with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu_precision.py``
and skip elsewhere (the ``gpu`` fixture decides, at run time).
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax
import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)


@pytest.fixture(scope="session")
def gpu():
    """The first JAX device, when it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda python -m pytest "
                    "-m gpu tests/test_gpu_precision.py")
    return dev


# --- fast smoke tier (VERDICT r2 weak #8) ----------------------------------
# ``pytest -m fast`` runs a <5-minute subset covering at least one
# representative test per module; the full suite (~45 CPU-min on the
# virtual mesh) stays the merge gate. Curated centrally here so the tier
# never drifts silently when tests move: a listed name that no longer
# exists fails collection loudly below.

FAST_TESTS = {
    "test_cli.py::test_cli_simulate_invert_info",
    "test_datapack.py::test_generate_example_datapack_and_hdf5_roundtrip",
    "test_datapack.py::test_h5parm_roundtrip",
    "test_fermat.py::test_high_frequency_limit_is_straight",
    "test_fermat.py::test_leapfrog_matches_rk4_and_oracle",
    "test_frames.py::test_enu_roundtrip_and_orthonormality",
    "test_frames.py::test_icrs_to_enu_zenith_source",
    "test_fuzz.py::test_fuzz_constant_field_and_row_path_agree",
    "test_gp.py::test_gp_predict_interpolates_clean_data",
    "test_ionosonde.py::test_probe_forward_npz_roundtrip_and_validation",
    "test_grid_sharding.py::test_sharded_interp_matches_replicated",
    "test_kalman.py::test_kalman_tracks_moving_structure",
    "test_linalg.py::test_cg_solves_spd_system",
    "test_linalg.py::test_lsqr_overdetermined_least_squares",
    "test_model_selection.py::test_gcv_score_is_deterministic_given_key",
    "test_multichip.py::test_mesh_and_padding",
    "test_multichip.py::test_sharded_tec_matches_single_device",
    "test_online.py::test_online_kalman_matches_batch_filter",
    "test_pipeline.py::test_config_json_roundtrip",
    "test_pipeline.py::test_pipeline_runs_and_reduces_residual",
    "test_priors.py::test_covariance_apply_matches_dense_kernel_row",
    "test_rays_tec.py::test_dtec_reference_antenna_is_zero_and_matches_oracle",
    "test_rays_tec.py::test_tec_linear_adjoint_is_exact_transpose",
    "test_rm.py::test_uniform_field_rm_matches_tec_product",
    "test_screens.py::test_screen_interpolates_held_out_directions",
    "test_selection_plotting.py::test_core_remote_partition",
    "test_serving.py::test_service_ingests_once_and_restarts_identically",
    "test_solvers.py::test_map_gauss_newton_beats_prior_and_fits_data",
    "test_tricubic.py::test_matches_f64_oracle",
    "test_tricubic.py::test_gradient_matches_oracle_and_fd",
    "test_utils.py::test_metrics_jsonl_roundtrip",
    "test_utils.py::test_frozen_flow_shift_matches_roll",
    "test_uvw_phase.py::test_uvw_preserves_baseline_length",
    "test_wind_calcrays.py::test_calc_rays_straight_matches_sampler",
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "fast: <5-min smoke subset (run with -m fast)")


def _whole_tree_collected(config):
    """True only when the collection args cover the entire tests/ tree.

    The existence guard below must never fire on legitimate partial runs
    (``pytest tests/test_foo.py tests/test_bar.py`` of any size — VERDICT r3
    weak #6 reproduced a 151-item file subset dying on it). Keying on the
    command-line target set, not the collected item count, makes subset runs
    work at any size while a bare ``pytest`` / ``pytest tests`` still
    enforces that every curated fast-tier test exists.
    """
    import pathlib

    tests_dir = pathlib.Path(__file__).parent.resolve()
    whole = {tests_dir, tests_dir.parent}
    args = getattr(config, "args", None) or []
    if not args:
        return True  # defaults to testpaths = ["tests"]
    try:
        targets = {pathlib.Path(a.split("::")[0]).resolve() for a in args}
    except (OSError, ValueError):
        return False
    return targets <= whole and bool(targets)


def pytest_collection_modifyitems(config, items):
    seen = set()
    for item in items:
        key = f"{item.fspath.basename}::{item.name.split('[')[0]}"
        if key in FAST_TESTS:
            item.add_marker(pytest.mark.fast)
            seen.add(key)
    if _whole_tree_collected(config):
        missing = FAST_TESTS - seen
        assert not missing, f"fast-tier tests no longer exist: {missing}"
