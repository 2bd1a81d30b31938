"""Tiled (blocked matmul) executor vs the untiled oracle.

The analogs of the reference's end-to-end equivalence suite
(``tests/README.md``): repeated causal, repeated anticausal, mixed
causal/anticausal, 2-D and 3-D generic scan lists, dtype invariance — all
with awkward tile widths that do not divide the extent.
"""

import numpy as np
import pytest

from recfilter import scan_core, tiling
from recfilter.spec import BorderMode, Dim, FilterSpec, Scan

RTOL = 2e-5  # float32 comparisons vs float64 oracle


def _run(spec, img):
    got = np.asarray(tiling.apply_filter(spec, img))
    want = scan_core.oracle_apply(spec, img).astype(np.dtype(spec.dtype))
    return got, want


def _img(*shape, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("tile", [4, 5, 8, 16])
@pytest.mark.parametrize("feedfwd,feedback", [
    (1.0, [1.0]),
    (1.2, [0.8, -0.3]),
    (0.9, [0.6, 0.25, -0.1]),
])
@pytest.mark.parametrize("causal", [True, False])
def test_single_scan_tiled(tile, feedfwd, feedback, causal):
    w = 16
    x = _img(3, w)
    got = np.asarray(
        tiling.tiled_apply_scan(x, 1, causal, feedfwd, feedback, tile)
    )
    want = scan_core.oracle_apply_scan(
        x, 1, causal, feedfwd, feedback
    ).astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5)


@pytest.mark.parametrize("width", [13, 16, 20])
def test_non_dividing_width(width):
    x = _img(4, width, seed=1)
    got = np.asarray(
        tiling.tiled_apply_scan(x, 1, True, 1.0, [0.5, 0.25], 6)
    )
    want = scan_core.oracle_apply_scan(x, 1, True, 1.0, [0.5, 0.25]).astype(
        np.float32
    )
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5)


def test_repeated_causal():
    """Four 3rd-order causal scans in x (tests/test_repeated_causal.cpp:34-39)."""
    x_d, y_d = Dim("x", 16), Dim("y", 16)
    scans = tuple(
        Scan(0, True, 1.0, (0.5, 0.25, 0.0625)) for _ in range(4)
    )
    spec = FilterSpec("RC", (x_d, y_d), scans, tile_widths=(4, 4))
    got, want = _run(spec, _img(16, 16, seed=2))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_repeated_anticausal():
    """(tests/test_repeated_anticausal.cpp:34-39)"""
    x_d, y_d = Dim("x", 16), Dim("y", 16)
    scans = tuple(
        Scan(0, False, 1.0, (0.5, 0.25, 0.0625)) for _ in range(4)
    )
    spec = FilterSpec("RA", (x_d, y_d), scans, tile_widths=(4, 4))
    got, want = _run(spec, _img(16, 16, seed=3))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_causal_anticausal_1d():
    """Mixed 3rd-order causal+anticausal in x (tests/test_causal_anticausal.cpp)."""
    x_d, y_d = Dim("x", 16), Dim("y", 16)
    scans = (
        Scan(0, True, 1.0, (0.5, 0.25, 0.0625)),
        Scan(0, False, 1.0, (0.4, 0.2, 0.05)),
    )
    spec = FilterSpec("CA", (x_d, y_d), scans, tile_widths=(4, 0))
    got, want = _run(spec, _img(16, 16, seed=4))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_causal_xy():
    """2-D causal scans (tests/test_causal_xy.cpp:36-41)."""
    x_d, y_d = Dim("x", 16), Dim("y", 16)
    scans = (
        Scan(0, True, 1.0, (0.5, 0.25)),
        Scan(1, True, 1.0, (0.4, 0.2)),
    )
    spec = FilterSpec("CXY", (x_d, y_d), scans, tile_widths=(4, 4))
    got, want = _run(spec, _img(16, 16, seed=5))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_generic_xy():
    """Seven order-2 scans, mixed dims and causality, tiled both dims
    (tests/test_generic_xy.cpp:37-45) — the reference's hardest 2-D case."""
    x_d, y_d = Dim("x", 16), Dim("y", 16)
    W = [
        (0.5, 0.25), (0.5, 0.125), (0.5, 0.0625), (0.5, 0.125),
        (0.5, 0.250), (0.5, 0.0625), (0.5, 0.125),
    ]
    scans = (
        Scan(0, True, 1.0, W[0]),
        Scan(0, False, 1.0, W[1]),
        Scan(0, True, 1.0, W[2]),
        Scan(0, False, 1.0, W[3]),
        Scan(1, True, 1.0, W[4]),
        Scan(1, False, 1.0, W[5]),
        Scan(1, False, 1.0, W[6]),
    )
    spec = FilterSpec("GXY", (x_d, y_d), scans, tile_widths=(4, 4))
    got, want = _run(spec, _img(16, 16, seed=6))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_generic_xyz():
    """3-D, six scans tiled in x, y, z (tests/test_generic_xyz.cpp:38-45)."""
    dims = (Dim("x", 12), Dim("y", 12), Dim("z", 12))
    scans = (
        Scan(0, True, 1.0, (0.5, 0.25)),
        Scan(0, False, 1.0, (0.5, 0.125)),
        Scan(1, True, 1.0, (0.5, 0.0625)),
        Scan(1, False, 1.0, (0.5, 0.125)),
        Scan(2, True, 1.0, (0.5, 0.25)),
        Scan(2, False, 1.0, (0.5, 0.0625)),
    )
    spec = FilterSpec("GXYZ", dims, scans, tile_widths=(4, 4, 4))
    got, want = _run(spec, _img(12, 12, 12, seed=7))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("causal", [True, False])
def test_clamped_border_tiled(causal):
    """Clamp-border tiling: B_first variant on the boundary tile only
    (lib/split.cpp:625-654)."""
    x_d, y_d = Dim("x", 20), Dim("y", 8)
    scans = (Scan(0, causal, 0.9, (0.6, 0.25, -0.1)),)
    spec = FilterSpec(
        "CL", (x_d, y_d), scans, border=BorderMode.CLAMP, tile_widths=(5, 0)
    )
    got, want = _run(spec, _img(20, 8, seed=8))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_clamped_border_2d_gaussian_shape():
    """Causal+anticausal clamped scans in both dims — the Gaussian app shape."""
    from recfilter import iir

    w = iir.gaussian_weights(2.0, 3)
    dims = (Dim("x", 24), Dim("y", 24))
    scans = (
        Scan(0, True, w[0], tuple(w[1:])),
        Scan(0, False, w[0], tuple(w[1:])),
        Scan(1, True, w[0], tuple(w[1:])),
        Scan(1, False, w[0], tuple(w[1:])),
    )
    spec = FilterSpec(
        "GB", dims, scans, border=BorderMode.CLAMP, tile_widths=(8, 8)
    )
    got, want = _run(spec, _img(24, 24, seed=9))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


def test_tile_width_invariance():
    """Any tile width must produce the same output (property test)."""
    x_d = Dim("x", 32)
    y_d = Dim("y", 4)
    img = _img(32, 4, seed=10)
    outs = []
    for t in (2, 4, 8, 16, 32):
        spec = FilterSpec(
            "TI", (x_d, y_d),
            (Scan(0, True, 1.1, (0.7, -0.2)), Scan(0, False, 1.0, (0.5,))),
            tile_widths=(t, 0),
        )
        outs.append(np.asarray(tiling.apply_filter(spec, img)))
    for o in outs[1:]:
        np.testing.assert_allclose(o, outs[0], rtol=1e-4, atol=1e-5)


def test_int_dtype_routes_to_exact_path():
    x_d, y_d = Dim("x", 16), Dim("y", 16)
    spec = FilterSpec(
        "SATi", (x_d, y_d),
        (Scan(0, True, 1.0, (1.0,)), Scan(1, True, 1.0, (1.0,))),
        dtype="int32", tile_widths=(4, 4),
    )
    img = np.ones((16, 16), dtype=np.int32)
    got, want = _run(spec, img)
    np.testing.assert_array_equal(got, want)


def test_float64_tiled():
    x_d, y_d = Dim("x", 16), Dim("y", 8)
    spec = FilterSpec(
        "F64", (x_d, y_d), (Scan(0, True, 1.0, (0.5, 0.25)),),
        dtype="float64", tile_widths=(4, 0),
    )
    img = np.random.default_rng(11).standard_normal((16, 8))
    got, want = _run(spec, img)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_bfloat16_tiled_accumulates_in_f32():
    import jax.numpy as jnp

    x_d, y_d = Dim("x", 16), Dim("y", 8)
    spec = FilterSpec(
        "BF", (x_d, y_d), (Scan(0, True, 1.0, (0.5, 0.25)),),
        dtype="bfloat16", tile_widths=(4, 0),
    )
    img = _img(16, 8, seed=12)
    got = np.asarray(
        tiling.apply_filter(spec, jnp.asarray(img, dtype=jnp.bfloat16)),
        dtype=np.float32,
    )
    want = scan_core.oracle_apply_scan(img, 0, True, 1.0, [0.5, 0.25])
    # bf16 has ~3 decimal digits; bound the relative error accordingly.
    np.testing.assert_allclose(got, want, rtol=0.05, atol=0.05)
