"""Edge-of-envelope tests: high orders, growing filters, extreme tilings,
and the README quickstart verbatim."""

import numpy as np
import pytest

import recfilter as rf
from recfilter import dimfuse, scan_core
from recfilter.spec import BorderMode, Dim, FilterSpec, Scan


def _img(*shape, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("order", [4, 5, 6])
def test_high_order_tiled(order):
    """Orders above the reference's app range (audio overlap reaches 6)."""
    fb = tuple(0.5 / (j + 1) for j in range(order))
    scans = [Scan(1, True, 1.0, fb), Scan(1, False, 0.9, fb)]
    x = _img(4, 40, seed=order)
    got = np.asarray(
        dimfuse.fused_dim_pass(x, 1, scans, max(order, 8), BorderMode.ZERO)
    )
    want = x.astype(np.float64)
    for s in scans:
        want = scan_core.oracle_apply_scan(
            want, 1, s.causal, s.feedfwd, s.feedback
        )
    np.testing.assert_allclose(got, want.astype(np.float32), rtol=1e-3,
                               atol=1e-3)


def test_growing_filter():
    """|a| > 1 (unstable recurrence): W powers grow; algebra must still be
    exact within f32 dynamic range at modest widths."""
    scans = [Scan(1, True, 1.0, (1.1,))]
    x = _img(3, 32, seed=1)
    got = np.asarray(dimfuse.fused_dim_pass(x, 1, scans, 8, BorderMode.ZERO))
    want = scan_core.oracle_apply_scan(x, 1, True, 1.0, [1.1]).astype(
        np.float32
    )
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_tile_width_one_smaller_than_order_routes_to_scan():
    scans = [Scan(1, True, 1.0, (0.4, 0.3, 0.2))]
    x = _img(2, 5, seed=2)  # width 5, order 3: plan still works (T>=3)
    got = np.asarray(dimfuse.fused_dim_pass(x, 1, scans, 1, BorderMode.ZERO))
    want = scan_core.oracle_apply_scan(x, 1, True, 1.0, [0.4, 0.3, 0.2])
    np.testing.assert_allclose(got, want.astype(np.float32), rtol=1e-4,
                               atol=1e-4)


def test_wildly_asymmetric_tiles():
    spec = FilterSpec(
        "A", (Dim("y", 48), Dim("x", 48)),
        (Scan(0, True, 1.0, (0.5,)), Scan(1, False, 1.0, (0.6, 0.1))),
        tile_widths=(3, 48),
    )
    x = _img(48, 48, seed=3)
    got = np.asarray(dimfuse.apply_filter_fused(spec, x))
    want = scan_core.oracle_apply(spec, x).astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_single_pixel_dim():
    spec = FilterSpec(
        "P", (Dim("y", 1), Dim("x", 16)),
        (Scan(1, True, 1.0, (0.5,)),), tile_widths=(0, 4),
    )
    x = _img(1, 16, seed=4)
    got = np.asarray(dimfuse.apply_filter_fused(spec, x))
    want = scan_core.oracle_apply(spec, x).astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_readme_quickstart():
    """The README's quickstart block, verbatim semantics."""
    image = np.ones((64, 64), dtype=np.float32)
    x = rf.Dim("x", 64)
    y = rf.Dim("y", 64)
    F = rf.RecFilter("SAT")
    F[y, x] = image
    F.add_filter(+x, [1.0, 1.0])
    F.add_filter(+y, [1.0, 1.0])
    F.split(x, 32, y, 32)
    out = np.asarray(F.realize())
    ii, jj = np.meshgrid(np.arange(1, 65), np.arange(1, 65), indexing="ij")
    np.testing.assert_allclose(out, (ii * jj).astype(np.float32), rtol=1e-4)
    ms = F.profile(2)
    assert ms > 0
