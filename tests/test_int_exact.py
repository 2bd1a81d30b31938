"""Exact tiled integer execution.

The reference runs integer images through its ONE tiled pipeline by
casting coefficients into the image type and letting values wrap
(``lib/recfilter.cpp:324-341``, ``tests/test_type_invariance.cpp:17-63``).
``dimfuse.apply_filter_int_exact`` is that capability on matmuls: signed
mantissa limbs through the tiled f32 executor in the drop-free f32x9 mode,
wrapping recombination, bit-exact vs the integer oracle — with a provable
gate (entry-abs cascade gain) and an honest lax.scan fallback beyond it.
"""

import numpy as np
import pytest

from recfilter import dimfuse, scan_core
from recfilter.spec import BorderMode, Dim, FilterSpec, Scan


def _check_exact(spec, img):
    got = dimfuse.apply_filter_int_exact(spec, img)
    assert got is not None, "limb path unexpectedly gated off"
    want = scan_core.oracle_apply(spec, img)
    np.testing.assert_array_equal(np.asarray(got), want)


def _rng(seed=0):
    return np.random.default_rng(seed)


def test_sat_int32_full_range():
    """Full-range int32 inputs wrap hard through a 512x512 SAT."""
    spec = FilterSpec(
        "S", (Dim("y", 512), Dim("x", 512)),
        (Scan(1, True, 1, (1,)), Scan(0, True, 1, (1,))),
        dtype="int32", tile_widths=(128, 128),
    )
    img = _rng(1).integers(-2**28, 2**28, (512, 512)).astype(np.int32)
    _check_exact(spec, img)


def test_sat_int16_wraps():
    spec = FilterSpec(
        "S16", (Dim("y", 128), Dim("x", 128)),
        (Scan(1, True, 1, (1,)), Scan(0, True, 1, (1,))),
        dtype="int16", tile_widths=(16, 16),
    )
    img = _rng(2).integers(-32768, 32767, (128, 128)).astype(np.int16)
    _check_exact(spec, img)


def test_int8_sat():
    spec = FilterSpec(
        "I8", (Dim("y", 64), Dim("x", 64)),
        (Scan(1, True, 1, (1,)),), dtype="int8", tile_widths=(8, 8),
    )
    img = _rng(3).integers(-128, 127, (64, 64)).astype(np.int8)
    _check_exact(spec, img)


@pytest.mark.parametrize("border", [BorderMode.ZERO, BorderMode.CLAMP])
def test_box2_order2_integrator(border):
    """box2's (2,-1) feedback: polynomial growth the entry-abs bound must
    accept (an abs-COEFFICIENT bound would be exponentially loose) —
    exercises the within-dim scan-cascade chunking when both causalities
    share the dim."""
    spec = FilterSpec(
        "B", (Dim("y", 96), Dim("x", 96)),
        (Scan(1, True, 1, (2, -1)), Scan(1, False, 1, (2, -1)),
         Scan(0, True, 1, (2, -1))),
        dtype="int32", border=border, tile_widths=(16, 16),
    )
    img = _rng(4).integers(-2**29, 2**29, (96, 96)).astype(np.int32)
    _check_exact(spec, img)


def test_box_cascade_six_scans():
    """box3-style cascade: six SAT scans, three per dimension."""
    spec = FilterSpec(
        "B6", (Dim("y", 64), Dim("x", 64)),
        tuple([Scan(1, True, 1, (1,)), Scan(0, True, 1, (1,))] * 3),
        dtype="int32", tile_widths=(16, 16),
    )
    img = _rng(5).integers(-2**30, 2**30, (64, 64)).astype(np.int32)
    _check_exact(spec, img)


def test_mixed_causality_and_feedfwd():
    spec = FilterSpec(
        "M", (Dim("y", 64), Dim("x", 96)),
        (Scan(1, True, 1, (1,)), Scan(1, False, 1, (-1,)),
         Scan(0, True, 2, (1,))),
        dtype="int32", tile_widths=(16, 16),
    )
    img = _rng(6).integers(-2**30, 2**30, (64, 96)).astype(np.int32)
    _check_exact(spec, img)


def test_noninteger_coeff_cast_semantics():
    """Non-integral coefficients cast into the image type (0.5 -> 0), the
    reference's and the oracle's semantics."""
    spec = FilterSpec(
        "C", (Dim("y", 32), Dim("x", 32)),
        (Scan(1, True, 1.0, (0.5,)), Scan(0, True, 1.0, (1.9,))),
        dtype="int32", tile_widths=(8, 8),
    )
    img = _rng(7).integers(-20, 20, (32, 32)).astype(np.int32)
    _check_exact(spec, img)


def test_non_dividing_extent_and_clamp():
    spec = FilterSpec(
        "P", (Dim("y", 61), Dim("x", 77)),
        (Scan(1, True, 1, (1,)), Scan(0, False, 1, (1,))),
        dtype="int32", border=BorderMode.CLAMP, tile_widths=(16, 16),
    )
    img = _rng(8).integers(-2**24, 2**24, (61, 77)).astype(np.int32)
    _check_exact(spec, img)


def test_unstable_feedback_falls_back():
    """|poles| > 1 feedback: values genuinely explode, exactness is not
    provable — the gate must return None (callers run lax.scan)."""
    spec = FilterSpec(
        "N", (Dim("y", 48), Dim("x", 80)),
        (Scan(1, True, 3, (-2, 1)),),
        dtype="int32", tile_widths=(16, 16),
    )
    img = np.ones((48, 80), np.int32)
    assert dimfuse.apply_filter_int_exact(spec, img) is None


def test_gain_gate_boundary_4k_box2():
    """Order-2 integral image at 4K: per-dim gain ~ w^2/2 = 2^23 exceeds
    the LIMB budget, but (2,−1) = (1−z)² decomposes into two chained
    unit cumsums — the additive route serves it exactly.
    Non-decomposable feedback past the gain gate (Fibonacci (1,1))
    still falls back honestly rather than corrupting."""
    spec = FilterSpec(
        "BG", (Dim("y", 8), Dim("x", 4096)),
        (Scan(1, True, 1, (2, -1)),),
        dtype="int32", tile_widths=(0, 128),
    )
    img = _rng(4).integers(-2**20, 2**20, (8, 4096)).astype(np.int32)
    _check_exact(spec, img)

    fib = FilterSpec(
        "FB", (Dim("y", 8), Dim("x", 4096)),
        (Scan(1, True, 1, (1, 1)),),
        dtype="int32", tile_widths=(0, 128),
    )
    assert dimfuse.apply_filter_int_exact(fib, img) is None


def test_int64_falls_back():
    spec = FilterSpec(
        "L", (Dim("y", 16), Dim("x", 16)),
        (Scan(1, True, 1, (1,)),), dtype="int64", tile_widths=(4, 4),
    )
    assert dimfuse.apply_filter_int_exact(
        spec, np.ones((16, 16), np.int64)) is None


def test_apply_filter_fused_routes_integers_through_limbs(monkeypatch):
    """The shipping whole-filter executor takes the limb path for integer
    specs (not the sequential scan fallback), and resolve_backend sends
    tiled integer specs to it."""
    from recfilter import planner
    from recfilter.planner import Plan

    spec = FilterSpec(
        "R", (Dim("y", 64), Dim("x", 64)),
        (Scan(1, True, 1, (1,)), Scan(0, True, 1, (1,))),
        dtype="int32", tile_widths=(16, 16),
    )
    assert planner.resolve_backend(spec, Plan(), "cpu") == "einsum"

    calls = []
    orig = dimfuse.apply_filter_int_exact

    def spy(*a, **k):
        r = orig(*a, **k)
        calls.append(r is not None)
        return r

    monkeypatch.setattr(dimfuse, "apply_filter_int_exact", spy)
    img = _rng(9).integers(-2**28, 2**28, (64, 64)).astype(np.int32)
    got = dimfuse.apply_filter_fused(spec, img)
    assert calls == [True]
    want = scan_core.oracle_apply(spec, img)
    np.testing.assert_array_equal(np.asarray(got), want)


def test_api_realize_int32_sat():
    """End-to-end through the public builder API."""
    import recfilter as rf

    w = 96
    img = _rng(10).integers(-2**27, 2**27, (w, w)).astype(np.int32)
    x = rf.Dim("x", w)
    y = rf.Dim("y", w)
    F = rf.RecFilter("IntSAT")
    F[y, x] = img  # dtype inferred from the image (int32)
    F.add_filter(+x, [1, 1])
    F.add_filter(+y, [1, 1])
    F.split(x, 16, y, 16)
    got = np.asarray(F.realize())
    want = scan_core.oracle_apply(F.spec, img)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# Wrapping additive fast path (dimfuse.int_unit_dim_pass)
# ---------------------------------------------------------------------------
#
# Unit-feedback integer dims (order 1, a = ±1, one integral tap — the
# SAT/integral-image class of lib/recfilter.cpp:324-341) skip the limb
# machinery entirely: int32 wrap IS the exact semantics, so the dimension
# is a chain of wrapping int32 cumulative sums.


def test_unit_route_taken_for_sat():
    """Both SAT dims must ride the additive route, not the limb path."""
    from recfilter import dimfuse

    spec = FilterSpec(
        "U", (Dim("y", 256), Dim("x", 256)),
        (Scan(1, True, 1, (1,)), Scan(0, True, 1, (1,))),
        dtype="int32", tile_widths=(128, 128),
    )
    img = _rng(7).integers(-2**24, 2**24, (256, 256)).astype(np.int32)
    calls = []
    orig = dimfuse.int_unit_dim_pass

    def spy(x, units, axis):
        calls.append(axis)
        return orig(x, units, axis)

    dimfuse.int_unit_dim_pass = spy
    try:
        _check_exact(spec, img)
    finally:
        dimfuse.int_unit_dim_pass = orig
    assert calls == [1, 0]


@pytest.mark.parametrize("dtype,hi", [("int32", 2**27), ("int16", 2**12),
                                      ("int8", 100)])
def test_unit_kernel_exact_all_widths(dtype, hi):
    """Wrap-exactness of the additive route at every integer width
    (mod-2^k via the mod-2^32 ring homomorphism)."""
    spec = FilterSpec(
        "U", (Dim("y", 192), Dim("x", 256)),
        (Scan(1, True, 1, (1,)), Scan(0, True, 1, (1,))),
        dtype=dtype, tile_widths=(64, 128),
    )
    img = _rng(8).integers(-hi, hi, (192, 256)).astype(dtype)
    _check_exact(spec, img)


def test_unit_kernel_anticausal_and_alternating():
    """Suffix scans (anticausal) and a = −1 (global-parity transform),
    chained on one axis, plus an f≠1 integral tap."""
    spec = FilterSpec(
        "U", (Dim("y", 64), Dim("x", 192)),
        (Scan(1, True, 2, (-1,)), Scan(1, False, 1, (-1,)),
         Scan(1, False, 3, (1,))),
        dtype="int32", tile_widths=(0, 64),
    )
    img = _rng(9).integers(-2**20, 2**20, (64, 192)).astype(np.int32)
    _check_exact(spec, img)


def test_unit_plus_limb_mixed_dims():
    """A unit dim (SAT axis) mixed with a limb dim (order-2 feedback):
    routes compose per dimension, both exact."""
    spec = FilterSpec(
        "U", (Dim("y", 64), Dim("x", 128)),
        (Scan(1, True, 1, (1,)), Scan(0, True, 1, (2, -1))),
        dtype="int16", tile_widths=(32, 64),
    )
    img = _rng(10).integers(-50, 50, (64, 128)).astype(np.int16)
    _check_exact(spec, img)


def test_unit_volume_leading_axis():
    """3-D integral image: the leading axis and both trailing axes all
    ride the additive route."""
    spec = FilterSpec(
        "U", (Dim("z", 16), Dim("y", 64), Dim("x", 128)),
        (Scan(2, True, 1, (1,)), Scan(1, True, 1, (1,)),
         Scan(0, True, 1, (1,))),
        dtype="int32", tile_widths=(0, 0, 64),
    )
    img = _rng(11).integers(-1000, 1000, (16, 64, 128)).astype(np.int32)
    _check_exact(spec, img)


def test_limb_route_still_exact_when_unit_disabled():
    """The limb executor keeps covering the SAT class (the unit route is
    an optimization, not a correctness dependency)."""
    from recfilter import dimfuse

    spec = FilterSpec(
        "U", (Dim("y", 128), Dim("x", 128)),
        (Scan(1, True, 1, (1,)), Scan(0, True, 1, (1,))),
        dtype="int16", tile_widths=(64, 64),
    )
    img = _rng(12).integers(-2**12, 2**12, (128, 128)).astype(np.int16)
    orig = dimfuse.unit_scans_of
    dimfuse.unit_scans_of = lambda s: None
    try:
        _check_exact(spec, img)
    finally:
        dimfuse.unit_scans_of = orig


def test_clamp_border_not_unit_routed():
    """CLAMP borders change the first-tile algebra — the additive route
    must not claim them; the limb path (which models clamp) serves."""
    from recfilter import dimfuse

    spec = FilterSpec(
        "U", (Dim("y", 64), Dim("x", 64)),
        (Scan(1, True, 1, (1,)),),
        dtype="int16", tile_widths=(0, 32), border=BorderMode.CLAMP,
    )
    img = _rng(13).integers(-100, 100, (64, 64)).astype(np.int16)
    calls = []
    orig = dimfuse.int_unit_dim_pass
    dimfuse.int_unit_dim_pass = (
        lambda *a, **k: (calls.append(1), orig(*a, **k))[1])
    try:
        _check_exact(spec, img)
    finally:
        dimfuse.int_unit_dim_pass = orig
    assert calls == []


def test_unit_decomposition_higher_order():
    """Feedback polynomials factoring as (1−z)^m (1+z)^(k−m) — double
    integrators (2,−1), mixed roots (0,1), triple (3,−3,1) — decompose
    into chained unit scans; general feedback (Fibonacci (1,1)) must not
    qualify."""
    from recfilter import dimfuse

    assert dimfuse.unit_scans_of(Scan(0, True, 3, (2, -1))) == [
        (3, 1, True), (1, 1, True)]
    assert dimfuse.unit_scans_of(Scan(0, True, 1, (1, 1))) is None

    spec = FilterSpec(
        "U", (Dim("y", 64), Dim("x", 128)),
        (Scan(1, True, 1, (0, 1)), Scan(0, True, 1, (3, -3, 1))),
        dtype="int16", tile_widths=(0, 64),
    )
    img = _rng(14).integers(-2**10, 2**10, (64, 128)).astype(np.int16)
    calls = []
    orig = dimfuse.int_unit_dim_pass
    dimfuse.int_unit_dim_pass = (
        lambda *a, **k: (calls.append(a[2]), orig(*a, **k))[1])
    try:
        _check_exact(spec, img)
    finally:
        dimfuse.int_unit_dim_pass = orig
    assert calls == [1, 0]


def test_segmented_large_extent_exact():
    """Large extents on the additive route: a 300k-sample cumsum (beyond
    the limb gain gate), an 8190-row leading dim, both directions and
    a = −1, odd extents."""
    from recfilter import dimfuse

    rng = _rng(15)
    x = rng.integers(-1000, 1000, (4, 300_001)).astype(np.int32)
    spec = FilterSpec(
        "Seg", (Dim("c", 4), Dim("x", 300_001)),
        (Scan(1, True, 1, (1,)),), dtype="int32", tile_widths=(0, 4096),
    )
    _check_exact(spec, x)

    y = rng.integers(-1000, 1000, (8190, 64)).astype(np.int32)
    spec2 = FilterSpec(
        "Seg2", (Dim("y", 8190), Dim("x", 64)),
        (Scan(0, False, 2, (-1,)),), dtype="int32", tile_widths=(128, 64),
    )
    _check_exact(spec2, y)

    # the 300k extent rides the additive route, not the lax.scan core
    seen = []
    orig = dimfuse.int_unit_dim_pass
    dimfuse.int_unit_dim_pass = (
        lambda *a, **k: (seen.append(a[2]), orig(*a, **k))[1])
    try:
        _check_exact(spec, x)
    finally:
        dimfuse.int_unit_dim_pass = orig
    assert seen == [1]


def test_streaming_integer_exact():
    """Out-of-core (chunked) execution stays bit-exact for integer specs
    — cross-chunk carries are exact integers, so any chunking equals the
    in-core result."""
    from recfilter import streaming

    spec = FilterSpec(
        "StInt", (Dim("y", 96), Dim("x", 96)),
        (Scan(1, True, 1, (1,)), Scan(0, True, 1, (1,))),
        dtype="int32", tile_widths=(16, 16),
    )
    img = _rng(16).integers(-2**24, 2**24, (96, 96)).astype(np.int32)
    got = np.asarray(
        streaming.apply_filter_streamed(spec, img, chunk_axis=0, chunk=40))
    want = scan_core.oracle_apply(spec, img)
    np.testing.assert_array_equal(got, want)


def test_extent_one_axis_applies_tap():
    """A degenerate extent-1 scan axis still applies the feed-forward
    taps: y = (Π f)·x."""
    from recfilter import dimfuse

    x = np.array([[3], [4]], np.int32)
    got = dimfuse.int_unit_dim_pass(x, [(2, 1, True), (3, -1, False)], 1)
    np.testing.assert_array_equal(np.asarray(got), [[18], [24]])

    spec = FilterSpec(
        "E1", (Dim("y", 4), Dim("x", 1)),
        (Scan(1, True, 5, (1,)),), dtype="int32", tile_widths=(2, 1),
    )
    img = np.arange(4, dtype=np.int32).reshape(4, 1)
    _check_exact(spec, img)


@pytest.mark.parametrize("dtype,hi", [("uint8", 200), ("uint16", 2**14),
                                      ("uint32", 2**30)])
def test_unsigned_dtypes_exact(dtype, hi):
    """Unsigned images are exact for free: int32 compute is congruent
    mod 2^32, and truncating to uint k bits equals the mod-2^k result
    (the same ring homomorphism as the signed widths)."""
    spec = FilterSpec(
        "U", (Dim("y", 96), Dim("x", 128)),
        (Scan(1, True, 1, (1,)), Scan(0, True, 1, (1,))),
        dtype=dtype, tile_widths=(32, 64),
    )
    img = _rng(17).integers(0, hi, (96, 128)).astype(dtype)
    _check_exact(spec, img)
