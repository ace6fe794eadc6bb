"""Golden regression tests (SURVEY.md §4 test pyramid, level 3): fixed-seed
renders compared by RMSE against stored outputs — the framework's version of
the reference's saveImageCSV_MONO numeric-diff workflow (imageUtil.cu:123).

One golden per integrator family (unidirectional, mega-wavefront, BDPT,
VCM, SPPM), defined in cudapathtracer_tpu/goldens.py. Regenerate
deliberately with tools/gen_goldens.py only when an estimator change is
intended."""

import pytest

from cudapathtracer_tpu import goldens


@pytest.fixture(scope="module")
def setup():
    return goldens.setup()


def _check(setup, name, width=128):
    err = goldens.golden_rmse(setup, name, width)
    assert err < goldens.RMSE_MAX, f"golden drift vs {name}: rmse={err:.2e}"


@pytest.mark.smoke
def test_golden_unidirectional(setup):
    _check(setup, "uni")


@pytest.mark.smoke
def test_golden_mega(setup):
    """The persistent mega-wavefront integrator is a different (equally
    valid) noise realization than the classic — it has its OWN golden, and
    the image must be invariant to lane scheduling (width)."""
    for width in (128, 64):
        _check(setup, "mega", width)


@pytest.mark.smoke
def test_golden_bdpt(setup):
    _check(setup, "bdpt")


@pytest.mark.smoke
def test_golden_vcm(setup):
    _check(setup, "vcm")


@pytest.mark.smoke
def test_golden_sppm(setup):
    _check(setup, "sppm")
