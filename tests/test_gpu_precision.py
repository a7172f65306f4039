"""Field-model contractions and TEC quadrature on a GPU against the f64
oracles, at PRECISION.md's bounds. A float32 product that ran in TF32
(about three decimal digits) would break them by orders of magnitude.

Run on a card:
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu_precision.py``.
Elsewhere every test here skips (the ``gpu`` fixture decides)."""
import pytest

import chip_smoke
from tests import test_rays_tec, test_tricubic

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def field_model_gates(gpu):
    return chip_smoke.phase_field_models(0, n=64, n_points=1024)["gates"]


@pytest.mark.parametrize("model", ["cubic", "zp", "zpc"])
@pytest.mark.parametrize("quantity", ["value", "value_with_grad", "grad"])
def test_field_model_matches_oracle_on_gpu(field_model_gates, model,
                                           quantity):
    g = field_model_gates[f"{model}_{quantity}_err"]
    assert g["ok"], g


def test_tricubic_gradient_matches_oracle_on_gpu(gpu, rng):
    test_tricubic.test_gradient_matches_oracle_and_fd(rng)


def test_paired_dtec_matches_oracle_on_gpu(gpu):
    test_rays_tec.test_dtec_reference_antenna_is_zero_and_matches_oracle()


def test_hermite_quadrature_on_gpu(gpu):
    test_rays_tec.test_hermite_tec_matches_simpson_and_is_4th_order()
