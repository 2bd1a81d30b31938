"""lax.scan executor vs the numpy oracle, across causality/order/border."""

import numpy as np
import pytest

from recfilter import scan_core
from recfilter.spec import BorderMode, Dim, FilterSpec, Scan

CASES = [
    (1.0, [1.0]),
    (1.2, [0.8, -0.3]),
    (0.9, [0.6, 0.25, -0.1]),
]


@pytest.mark.parametrize("feedfwd,feedback", CASES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("border", [BorderMode.ZERO, BorderMode.CLAMP])
@pytest.mark.parametrize("width", [1, 2, 7, 20])
def test_apply_scan_matches_oracle(feedfwd, feedback, causal, border, width):
    rng = np.random.default_rng(42)
    x = rng.standard_normal((3, width)).astype(np.float64)
    got = np.asarray(
        scan_core.apply_scan(x, 1, causal, feedfwd, feedback, border)
    )
    want = scan_core.oracle_apply_scan(x, 1, causal, feedfwd, feedback, border)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_apply_scan_any_axis(axis):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((5, 6, 7))
    got = np.asarray(scan_core.apply_scan(x, axis, True, 1.0, [0.5, 0.2]))
    want = scan_core.oracle_apply_scan(x, axis, True, 1.0, [0.5, 0.2])
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)


def test_apply_filter_multi_scan():
    """Mixed-dimension, mixed-causality scan list in definition order —
    shape of the reference's tests/test_generic_xy.cpp."""
    x_d, y_d = Dim("x", 12), Dim("y", 10)
    spec = FilterSpec(
        name="G",
        dims=(x_d, y_d),
        scans=(
            Scan(0, True, 1.0, (0.5, 0.25)),
            Scan(0, False, 1.0, (0.5, 0.125)),
            Scan(1, True, 1.0, (0.5, 0.0625)),
            Scan(1, False, 1.0, (0.5, 0.125)),
        ),
        dtype="float64",
    )
    rng = np.random.default_rng(3)
    img = rng.standard_normal((12, 10))
    got = np.asarray(scan_core.apply_filter(spec, img))
    want = scan_core.oracle_apply(spec, img)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def test_integer_dtype_exact():
    """int16 summed-area table is exact (reference test_type_invariance)."""
    x_d, y_d = Dim("x", 9), Dim("y", 8)
    spec = FilterSpec(
        name="S",
        dims=(x_d, y_d),
        scans=(Scan(0, True, 1.0, (1.0,)), Scan(1, True, 1.0, (1.0,))),
        dtype="int16",
    )
    img = np.ones((9, 8), dtype=np.int16)
    got = np.asarray(scan_core.apply_filter(spec, img))
    want = scan_core.oracle_apply(spec, img)
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, want)
    # SAT of ones is the product of 1-based index grids.
    ii, jj = np.meshgrid(np.arange(1, 10), np.arange(1, 9), indexing="ij")
    np.testing.assert_array_equal(got, (ii * jj).astype(np.int16))
