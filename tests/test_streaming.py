"""Out-of-core streaming executor vs the in-core fused executor: chunked
host↔device sweeps with cross-chunk carries must be exact."""

import numpy as np
import pytest

from recfilter import dimfuse, streaming
from recfilter.spec import BorderMode, Dim, FilterSpec, Scan


def _img(*shape, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("border", [BorderMode.ZERO, BorderMode.CLAMP])
@pytest.mark.parametrize("chunk", [7, 16, 100])
def test_streamed_matches_fused_2d(border, chunk):
    """Mixed causal/anticausal scans in both dims, chunked along y."""
    spec = FilterSpec(
        "S",
        (Dim("y", 40), Dim("x", 24)),
        (
            Scan(1, True, 0.9, (0.6, 0.2)),
            Scan(1, False, 1.1, (0.4,)),
            Scan(0, True, 1.0, (0.5, 0.25)),
            Scan(0, False, 1.0, (0.3,)),
        ),
        border=border,
        tile_widths=(8, 8),
    )
    x = _img(40, 24, seed=0)
    want = np.asarray(dimfuse.apply_filter_fused(spec, x))
    got = streaming.apply_filter_streamed(spec, x, chunk_axis=0, chunk=chunk)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_streamed_chunk_along_x():
    spec = FilterSpec(
        "SX",
        (Dim("y", 12), Dim("x", 50)),
        (Scan(1, True, 1.0, (0.5,)), Scan(0, True, 1.0, (0.25,))),
        tile_widths=(4, 8),
    )
    x = _img(12, 50, seed=1)
    want = np.asarray(dimfuse.apply_filter_fused(spec, x))
    got = streaming.apply_filter_streamed(spec, x, chunk_axis=1, chunk=9)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_streamed_short_last_chunk_merges():
    """Width 21 with chunk 10 leaves a 1-line tail < order 3 — must merge."""
    spec = FilterSpec(
        "SM", (Dim("y", 21), Dim("x", 8)),
        (Scan(0, True, 0.9, (0.3, 0.2, 0.1)),), tile_widths=(4, 4),
    )
    x = _img(21, 8, seed=2)
    want = np.asarray(dimfuse.apply_filter_fused(spec, x))
    got = streaming.apply_filter_streamed(spec, x, chunk_axis=0, chunk=10)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_streamed_tuple_filter():
    spec = FilterSpec(
        "ST", (Dim("y", 18), Dim("x", 10)),
        (Scan(0, True, 1.0, (0.5,)), Scan(1, True, 1.0, (0.4,))),
        tile_widths=(6, 5), tuple_width=2,
    )
    x = _img(2, 18, 10, seed=3)
    want = np.asarray(dimfuse.apply_filter_fused(spec.stacked(), x))
    got = streaming.apply_filter_streamed(spec, x, chunk_axis=0, chunk=7)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_streamed_negative_chunk_axis():
    spec = FilterSpec(
        "SN", (Dim("y", 12), Dim("x", 50)),
        (Scan(1, True, 1.0, (0.5,)),), tile_widths=(4, 8),
    )
    x = _img(12, 50, seed=4)
    want = np.asarray(dimfuse.apply_filter_fused(spec, x))
    got = streaming.apply_filter_streamed(spec, x, chunk_axis=-1, chunk=9)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_streamed_chunk_smaller_than_order_rejected():
    spec = FilterSpec(
        "SR", (Dim("y", 20), Dim("x", 8)),
        (Scan(0, True, 1.0, (0.3, 0.2, 0.1)),), tile_widths=(4, 4),
    )
    with pytest.raises(ValueError, match="max scan order"):
        streaming.apply_filter_streamed(
            spec, _img(20, 8, seed=5), chunk_axis=0, chunk=2
        )


@pytest.mark.parametrize("border", [BorderMode.ZERO, BorderMode.CLAMP])
@pytest.mark.parametrize("chunk", [7, 16])
def test_streamed_integer_exact(border, chunk):
    """Integer dtypes stream bit-exactly: the carry is the real shift-
    register state, not a float rank-k correction (SAT-style int32)."""
    from recfilter import scan_core

    spec = FilterSpec(
        "SI",
        (Dim("y", 40), Dim("x", 24)),
        (
            Scan(1, True, 1, (1,)),
            Scan(0, True, 1, (1,)),
            Scan(0, False, 1, (1,)),
        ),
        dtype="int32",
        border=border,
        tile_widths=(8, 8),
    )
    x = np.asarray(
        np.random.default_rng(3).integers(-9, 9, size=(40, 24)), np.int32
    )
    want = scan_core.oracle_apply(spec, x)
    got = streaming.apply_filter_streamed(spec, x, chunk_axis=0, chunk=chunk)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_streamed_integer_second_order_chunk_axis():
    """Order-2 integer scan along the chunk axis (k-deep carry state)."""
    from recfilter import scan_core

    spec = FilterSpec(
        "SI2",
        (Dim("y", 33), Dim("x", 16)),
        (Scan(0, True, 1, (2, -1)),),  # second-order integral image column
        dtype="int64",
        tile_widths=(8, 8),
    )
    x = np.asarray(
        np.random.default_rng(4).integers(-3, 4, size=(33, 16)), np.int64
    )
    want = scan_core.oracle_apply(spec, x)
    got = streaming.apply_filter_streamed(spec, x, chunk_axis=0, chunk=5)
    np.testing.assert_array_equal(got, want)
