"""Fused per-dimension executor vs the oracle — the cross-scan tail algebra
(the analog of the reference's TDeps machinery) must be exact for any scan
mix, causality pattern, and border mode."""

import numpy as np
import pytest

from recfilter import dimfuse, scan_core
from recfilter.spec import BorderMode, Dim, FilterSpec, Scan


def _img(*shape, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape).astype(np.float32)


def _oracle_dim(x, scans, border):
    x = x.astype(np.float64)
    for s in scans:
        x = scan_core.oracle_apply_scan(
            x, s.axis, s.causal, s.feedfwd, s.feedback, border
        )
    return x.astype(np.float32)


@pytest.mark.parametrize("border", [BorderMode.ZERO, BorderMode.CLAMP])
@pytest.mark.parametrize("causal", [True, False])
def test_single_scan(border, causal):
    scans = [Scan(1, causal, 0.9, (0.6, 0.25, -0.1))]
    x = _img(5, 24, seed=0)
    got = np.asarray(dimfuse.fused_dim_pass(x, 1, scans, 6, border))
    want = _oracle_dim(x, scans, border)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("border", [BorderMode.ZERO, BorderMode.CLAMP])
def test_causal_anticausal_pair(border):
    scans = [
        Scan(1, True, 0.9, (0.6, 0.25, -0.1)),
        Scan(1, False, 1.1, (0.5, 0.2, 0.05)),
    ]
    x = _img(4, 24, seed=1)
    got = np.asarray(dimfuse.fused_dim_pass(x, 1, scans, 6, border))
    want = _oracle_dim(x, scans, border)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_four_scans_mixed_orders():
    """Repeated + mixed causality + differing orders in one dim — exercises
    all the cross-scan G/H terms."""
    scans = [
        Scan(1, True, 1.0, (0.5, 0.25)),
        Scan(1, False, 1.0, (0.4,)),
        Scan(1, True, 0.9, (0.3, 0.1, -0.05)),
        Scan(1, False, 1.0, (0.6, 0.2)),
    ]
    x = _img(3, 20, seed=2)
    got = np.asarray(dimfuse.fused_dim_pass(x, 1, scans, 5, BorderMode.ZERO))
    want = _oracle_dim(x, scans, BorderMode.ZERO)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("width,tile", [(19, 5), (16, 16), (7, 32)])
def test_non_dividing_and_degenerate_tiles(width, tile):
    scans = [
        Scan(1, True, 1.0, (0.5, 0.25)),
        Scan(1, False, 1.0, (0.4, 0.1)),
    ]
    x = _img(4, width, seed=3)
    got = np.asarray(dimfuse.fused_dim_pass(x, 1, scans, tile, BorderMode.ZERO))
    want = _oracle_dim(x, scans, BorderMode.ZERO)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_clamp_non_dividing_falls_back_to_divisor():
    scans = [Scan(1, False, 1.0, (0.5,))]
    x = _img(4, 18, seed=4)  # 18 % 5 != 0 → falls back to divisor tile
    got = np.asarray(dimfuse.fused_dim_pass(x, 1, scans, 5, BorderMode.CLAMP))
    want = _oracle_dim(x, scans, BorderMode.CLAMP)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_middle_axis_and_3d():
    scans = [
        Scan(1, True, 1.0, (0.5, 0.25)),
        Scan(1, False, 1.0, (0.3,)),
    ]
    x = _img(3, 16, 5, seed=5)
    got = np.asarray(dimfuse.fused_dim_pass(x, 1, scans, 4, BorderMode.ZERO))
    want = _oracle_dim(x, scans, BorderMode.ZERO)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_apply_filter_fused_2d_gaussian_clamped():
    from recfilter import iir

    w = iir.gaussian_weights(2.0, 3)
    dims = (Dim("y", 24), Dim("x", 24))
    scans = (
        Scan(1, True, w[0], tuple(w[1:])),
        Scan(1, False, w[0], tuple(w[1:])),
        Scan(0, True, w[0], tuple(w[1:])),
        Scan(0, False, w[0], tuple(w[1:])),
    )
    spec = FilterSpec(
        "G", dims, scans, border=BorderMode.CLAMP, tile_widths=(8, 8)
    )
    x = _img(24, 24, seed=6)
    got = np.asarray(dimfuse.apply_filter_fused(spec, x))
    want = scan_core.oracle_apply(spec, x).astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


def test_matches_per_scan_einsum_backend():
    from recfilter import tiling

    dims = (Dim("y", 16), Dim("x", 16))
    scans = (
        Scan(1, True, 1.0, (0.5, 0.25)),
        Scan(1, False, 1.0, (0.4, 0.1)),
        Scan(0, True, 1.0, (0.3,)),
    )
    spec = FilterSpec("X", dims, scans, tile_widths=(4, 4))
    x = _img(16, 16, seed=7)
    got = np.asarray(dimfuse.apply_filter_fused(spec, x))
    want = np.asarray(tiling.apply_filter(spec, x))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_associative_chain_solve_matches_matmul_solve():
    """Large-n path (associative_scan) must equal the block-Toeplitz path."""
    import recfilter.dimfuse as df

    scans = [
        Scan(1, True, 1.0, (0.5, 0.25)),
        Scan(1, False, 1.0, (0.4, 0.1)),
    ]
    x = _img(3, 64, seed=8)
    want = np.asarray(df.fused_dim_pass(x, 1, scans, 4, BorderMode.ZERO))
    old = df._CHAIN_MATMUL_MAX_TILES
    try:
        df._CHAIN_MATMUL_MAX_TILES = 0  # force associative path (n = 16)
        got = np.asarray(df.fused_dim_pass(x, 1, scans, 4, BorderMode.ZERO))
    finally:
        df._CHAIN_MATMUL_MAX_TILES = old
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    ref = _oracle_dim(x, scans, BorderMode.ZERO)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_audio_scale_many_tiles():
    """1-D filter with hundreds of tiles routes through the associative
    solve and matches the oracle (audio app shape)."""
    scans = [Scan(0, True, 1.0, (0.1, 0.05, 0.02))]
    x = _img(5000, seed=9)
    got = np.asarray(dimfuse.fused_dim_pass(x, 0, scans, 16, BorderMode.ZERO))
    want = _oracle_dim(x, scans, BorderMode.ZERO)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_prime_width_clamp_routes_to_scan_core():
    scans = [Scan(1, True, 1.0, (0.5, 0.25))]
    x = _img(3, 17, seed=10)  # prime width, order 2: no divisor tiling
    got = np.asarray(dimfuse.fused_dim_pass(x, 1, scans, 5, BorderMode.CLAMP))
    want = _oracle_dim(x, scans, BorderMode.CLAMP)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_bf16_matmul_mode_close_to_f32():
    import jax.numpy as jnp

    scans = [
        Scan(1, True, 0.9, (0.6, 0.25, -0.1)),
        Scan(1, False, 1.1, (0.5, 0.2, 0.05)),
    ]
    x = _img(8, 64, seed=11)
    f32 = np.asarray(dimfuse.fused_dim_pass(x, 1, scans, 16, BorderMode.ZERO))
    bf = np.asarray(
        dimfuse.fused_dim_pass(
            x, 1, scans, 16, BorderMode.ZERO, matmul_dtype=jnp.bfloat16
        )
    )
    # bf16 input rounding: ~3 decimal digits
    np.testing.assert_allclose(bf, f32, rtol=0.05, atol=0.05)
    assert np.abs(bf - f32).max() > 0  # it actually took the bf16 path


def test_bf16_storage_mode():
    """spec dtype bfloat16 runs the bf16-storage pipeline (f32 accumulation)
    and stays within bf16 tolerance of the f64 oracle."""
    import jax.numpy as jnp

    spec = FilterSpec(
        "BF", (Dim("y", 8), Dim("x", 64)),
        (
            Scan(1, True, 0.9, (0.6, 0.25)),
            Scan(1, False, 1.0, (0.4,)),
        ),
        dtype="bfloat16", tile_widths=(0, 16),
    )
    x = _img(8, 64, seed=12)
    got = np.asarray(
        dimfuse.apply_filter_fused(spec, jnp.asarray(x, jnp.bfloat16)),
        dtype=np.float32,
    )
    want = _oracle_dim(x, list(spec.scans), BorderMode.ZERO)
    np.testing.assert_allclose(got, want, rtol=0.06, atol=0.06)


def test_transpose_chaining_non_square_and_batch():
    """The trailing-2-dims transpose-chaining path must be exact for
    non-square images and leading batch axes."""
    scans = (
        Scan(1, True, 1.0, (0.5, 0.25)),
        Scan(2, False, 1.0, (0.4, 0.1)),
        Scan(2, True, 1.0, (0.3,)),
    )
    spec = FilterSpec(
        "TC", (Dim("c", 3), Dim("y", 20), Dim("x", 28)), scans,
        tile_widths=(0, 5, 7),
    )
    x = _img(3, 20, 28, seed=13)
    got = np.asarray(dimfuse.apply_filter_fused(spec, x))
    want = scan_core.oracle_apply(spec, x).astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_transpose_chaining_clamp_non_square():
    spec = FilterSpec(
        "TCC", (Dim("y", 18), Dim("x", 24)),
        (
            Scan(0, True, 0.9, (0.6, 0.25)),
            Scan(1, False, 1.0, (0.5, 0.2)),
        ),
        border=BorderMode.CLAMP, tile_widths=(6, 8),
    )
    x = _img(18, 24, seed=14)
    got = np.asarray(dimfuse.apply_filter_fused(spec, x))
    want = scan_core.oracle_apply(spec, x).astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_rotation_chaining_3d_volume():
    """Trailing-3-dims rotation chaining (volumes): after three rotated
    passes the axis order must be restored exactly and match the oracle."""
    scans = (
        Scan(1, True, 1.0, (0.5, 0.2)),
        Scan(1, False, 1.0, (0.5, 0.2)),
        Scan(2, True, 1.0, (0.4,)),
        Scan(2, False, 1.0, (0.4,)),
        Scan(3, True, 0.9, (0.3, 0.1)),
    )
    spec = FilterSpec(
        "R3", (Dim("c", 2), Dim("z", 15), Dim("y", 21), Dim("x", 27)), scans,
        tile_widths=(0, 5, 7, 9),
    )
    x = _img(2, 15, 21, 27, seed=15)
    got = np.asarray(dimfuse.apply_filter_fused(spec, x))
    want = scan_core.oracle_apply(spec, x).astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_rotation_chaining_3d_clamp():
    spec = FilterSpec(
        "R3C", (Dim("z", 12), Dim("y", 18), Dim("x", 24)),
        (
            Scan(0, True, 1.0, (0.5,)),
            Scan(1, False, 1.0, (0.4,)),
            Scan(2, True, 0.9, (0.6, 0.2)),
        ),
        border=BorderMode.CLAMP, tile_widths=(6, 6, 8),
    )
    x = _img(12, 18, 24, seed=16)
    got = np.asarray(dimfuse.apply_filter_fused(spec, x))
    want = scan_core.oracle_apply(spec, x).astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_rotation_chaining_4d():
    """Four scanned trailing dims rotate through four passes and restore."""
    spec = FilterSpec(
        "R4",
        (Dim("b", 2), Dim("w", 10), Dim("z", 12), Dim("y", 14), Dim("x", 16)),
        (
            Scan(1, True, 1.0, (0.5,)),
            Scan(2, False, 1.0, (0.4,)),
            Scan(3, True, 1.0, (0.3, 0.1)),
            Scan(4, False, 1.0, (0.6,)),
        ),
        tile_widths=(0, 5, 6, 7, 8),
    )
    x = _img(2, 10, 12, 14, 16, seed=17)
    got = np.asarray(dimfuse.apply_filter_fused(spec, x))
    want = scan_core.oracle_apply(spec, x).astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("border", [BorderMode.ZERO, BorderMode.CLAMP])
def test_apply_filter_rotated_chain(border):
    """Inter-filter rotation chaining: an x-scan stage and a y-scan stage,
    each emitting rotated (Plan.rotate_emit semantics), compose to the same
    result as natural-layout sequential application — with both stages in
    lanes-contraction form (the DoG pipeline pattern)."""
    dims = (Dim("c", 2), Dim("y", 18), Dim("x", 24))
    sx = (Scan(2, True, 1.0, (0.5, 0.2)), Scan(2, False, 1.1, (0.4,)))
    sy = (Scan(1, True, 0.9, (0.6,)),)
    spec_x = FilterSpec("FX", dims, sx, border=border, tile_widths=(0, 6, 6))
    spec_y = FilterSpec("FY", dims, sy, border=border, tile_widths=(0, 6, 6))
    x = _img(2, 18, 24, seed=20)

    r1 = dimfuse.apply_filter_rotated(spec_x, x, rot_axes=2)      # (c, x, y)
    assert r1.shape == (2, 24, 18)
    r2 = dimfuse.apply_filter_rotated(spec_y, r1, rot_axes=2)     # (c, y, x)
    assert r2.shape == (2, 18, 24)

    want = np.asarray(x, np.float64)
    for s in sx + sy:
        want = scan_core.oracle_apply_scan(
            want, s.axis, s.causal, s.feedfwd, s.feedback, border
        )
    np.testing.assert_allclose(
        np.asarray(r2), want.astype(np.float32), rtol=1e-4, atol=1e-4
    )


def test_apply_filter_rotated_inplace_and_fallbacks():
    dims = (Dim("y", 6), Dim("x", 20))
    spec = FilterSpec(
        "F1", dims, (Scan(1, True, 1.0, (0.5,)),), tile_widths=(0, 5)
    )
    x = _img(6, 20, seed=21)
    # rot_axes=1: emit in place
    r = dimfuse.apply_filter_rotated(spec, x, rot_axes=1)
    want = _oracle_dim(x, spec.scans, BorderMode.ZERO)
    np.testing.assert_allclose(np.asarray(r), want, rtol=1e-4, atol=1e-4)

    # order > width → scan_core fallback must still honor the rotated emit
    spec_big = FilterSpec(
        "F2", (Dim("y", 6), Dim("x", 3)),
        (Scan(1, True, 1.0, (0.3, 0.2, 0.1, 0.05)),), tile_widths=(0, 4)
    )
    xb = _img(6, 3, seed=22)
    rb = dimfuse.apply_filter_rotated(spec_big, xb, rot_axes=2)
    wantb = _oracle_dim(xb, spec_big.scans, BorderMode.ZERO)
    np.testing.assert_allclose(
        np.asarray(rb), wantb.T, rtol=1e-4, atol=1e-4
    )

    # integer dtype routes through the exact lax.scan path, still rotated
    spec_i = FilterSpec(
        "FI", dims, (Scan(1, True, 1.0, (1.0,)),),
        dtype="int32", tile_widths=(0, 5),
    )
    xi = np.arange(120, dtype=np.int32).reshape(6, 20) % 7
    ri = dimfuse.apply_filter_rotated(spec_i, xi, rot_axes=2)
    wi = np.cumsum(xi, axis=1)
    np.testing.assert_array_equal(np.asarray(ri), wi.T)


def test_apply_filter_rotated_errors():
    dims = (Dim("y", 6), Dim("x", 20))
    two = FilterSpec(
        "F2D", dims,
        (Scan(0, True, 1.0, (0.5,)), Scan(1, True, 1.0, (0.5,))),
    )
    with pytest.raises(ValueError, match="single scanned dimension"):
        dimfuse.apply_filter_rotated(two, _img(6, 20), rot_axes=2)
    one = FilterSpec("F1D", dims, (Scan(1, True, 1.0, (0.5,)),))
    with pytest.raises(ValueError, match="last axis"):
        dimfuse.apply_filter_rotated(one, _img(20, 6), rot_axes=2)


def test_bf16_storage_fallback_keeps_f32_carries():
    """Prime-width clamp routes to the scan_core fallback; with bf16 storage
    the recurrence must still run with f32 carries (ADVICE r1: the bf16-carry
    fallback measured ~4-8% error vs the ~1% bf16-rounding contract)."""
    import jax.numpy as jnp

    spec = FilterSpec(
        "BFB", (Dim("y", 4), Dim("x", 509)),
        (Scan(1, True, 1.0, (0.5, 0.25)),),
        dtype="bfloat16", border=BorderMode.CLAMP, tile_widths=(0, 32),
    )
    x = _img(4, 509, seed=13)
    got = np.asarray(
        dimfuse.apply_filter_fused(spec, jnp.asarray(x, jnp.bfloat16)),
        dtype=np.float32,
    )
    want = _oracle_dim(x, list(spec.scans), BorderMode.CLAMP)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 0.02 * scale


def test_bf16_rotated_fallback_keeps_f32_carries():
    """Same contract through apply_filter_rotated's scan_core fallback."""
    import jax.numpy as jnp

    spec = FilterSpec(
        "BFR", (Dim("y", 4), Dim("x", 509)),
        (Scan(1, True, 1.0, (0.5, 0.25)),),
        dtype="bfloat16", border=BorderMode.CLAMP, tile_widths=(0, 32),
    )
    x = _img(4, 509, seed=14)
    got = np.asarray(
        dimfuse.apply_filter_rotated(
            spec, jnp.asarray(x, jnp.bfloat16), rot_axes=1
        ),
        dtype=np.float32,
    )
    want = _oracle_dim(x, list(spec.scans), BorderMode.CLAMP)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 0.02 * scale


@pytest.mark.parametrize(
    "mode,bound",
    [("f32x3", 1e-4), ("f32x4", 8e-5), ("f32x6", 1e-5)],
)
def test_compensated_split_precision_modes(mode, bound):
    """The compensated split-bf16 modes must hold their documented error
    bounds against the float64 oracle. On CPU the bf16 chunk einsums
    upcast-and-accumulate in f32 — the same arithmetic the tensor cores
    perform on bf16-exact operands — so the chunk representation error
    (the dominant term) is faithfully measured here; chip_smoke.py
    measures the grades on the card."""
    scans = [
        Scan(1, True, 0.9, (0.6, 0.25, -0.1)),
        Scan(1, False, 1.1, (0.5, 0.2, 0.05)),
    ]
    x = _img(64, 256, seed=7)
    got = np.asarray(
        dimfuse.fused_dim_pass(
            x, 1, scans, 32, BorderMode.CLAMP, matmul_precision=mode
        )
    )
    want = _oracle_dim(x, scans, BorderMode.CLAMP)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= bound * scale


def test_split_input_three_chunks_exact():
    """Three bf16 chunks must reconstruct f32 exactly (24 = 3x8 mantissa
    bits; each residual subtraction is exact)."""
    import jax.numpy as jnp

    x = jnp.asarray(_img(8, 128, seed=9))
    chunks = dimfuse._split_input(x, 3)
    back = sum(c.astype(jnp.float32) for c in chunks)
    assert np.array_equal(np.asarray(back), np.asarray(x))


@pytest.mark.parametrize("mode,bound",
                         [("px3", 1e-4), ("px4", 8e-5), ("px6", 2e-6)])
@pytest.mark.parametrize("rot_axes", [1, 2])
def test_pallas_completion_precision_modes(mode, bound, rot_axes):
    """The px3/px4/px6 grades hold their error bounds for both in-place and
    rotated emits (card parity: chip_smoke.py)."""
    import jax.numpy as jnp

    scans = [
        Scan(1, True, 0.9, (0.6, 0.25, -0.1)),
        Scan(1, False, 1.1, (0.5, 0.2, 0.05)),
    ]
    spec = FilterSpec(
        "PX", (Dim("y", 64), Dim("x", 256)), tuple(scans),
        tile_widths=(0, 128),  # T=128: the card's auto tile width
    )
    x = _img(64, 256, seed=7)
    got = np.asarray(
        dimfuse.apply_filter_rotated(
            spec, jnp.asarray(x), rot_axes=rot_axes,
            matmul_precision=mode,
        )
    )
    if rot_axes == 2:
        got = np.moveaxis(got, 0, 1)  # undo the rotated emit (y,x)->(x,y)
    want = _oracle_dim(x, scans, BorderMode.ZERO)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= bound * scale


@pytest.mark.parametrize("mode,bound", [("px3", 1e-4), ("px6", 2e-6)])
def test_px_rotated_leading_channel_per_slice_kernels(mode, bound):
    """Rotated emit with a leading (non-scanned) channel group — dog_sat's
    SAT2x/SAT2y geometry: oracle parity, no pallas_call in the traced
    program, and f32-grade gradients."""
    import jax
    import jax.numpy as jnp

    from chip_smoke import has_pallas_call

    scans = [Scan(2, True, 0.9, (0.6, 0.25, -0.1))]
    spec = FilterSpec(
        "CPX", (Dim("c", 2), Dim("y", 64), Dim("x", 256)), tuple(scans),
        tile_widths=(0, 0, 128),
    )
    x = _img(2, 64, 256, seed=11)

    def run(v):
        return dimfuse.apply_filter_rotated(
            spec, v, rot_axes=2, matmul_precision=mode)

    assert not has_pallas_call(jax.make_jaxpr(run)(jnp.asarray(x)))
    got = np.asarray(run(jnp.asarray(x)))
    assert got.shape == (2, 256, 64)  # rotated emit: (c, x, y)
    oracle_scans = [Scan(1, True, 0.9, (0.6, 0.25, -0.1))]  # axis within a slice
    want = np.stack([_oracle_dim(x[p], oracle_scans, BorderMode.ZERO).T
                     for p in range(2)])
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= bound * scale

    # gradients at f32 grade through the rotated emit
    ct = jnp.asarray(_img(2, 256, 64, seed=12) * 0.1)

    def loss(m):
        return jax.grad(lambda v: (dimfuse.apply_filter_rotated(
            spec, v, rot_axes=2, matmul_precision=m) * ct).sum()
        )(jnp.asarray(x))

    g_hi, g_px = loss("highest"), loss(mode)
    gs = float(jnp.abs(g_hi).max())
    assert float(jnp.abs(g_px - g_hi).max()) <= 1e-5 * gs



@pytest.mark.parametrize("border", [BorderMode.ZERO, BorderMode.CLAMP])
@pytest.mark.parametrize("mode,bound", [("px3", 1e-4), ("px6", 2e-6)])
def test_px_tails_chaining_two_dims(mode, bound, border):
    """The 2-D rotation chain at the px grades (T=128, both borders) must
    match the per-pass oracle to the mode's bound."""
    import jax.numpy as jnp

    scans = [
        Scan(1, True, 0.9, (0.6, 0.2)),
        Scan(0, False, 1.05, (0.4, 0.15)),
    ]
    spec = FilterSpec(
        "PXCHAIN", (Dim("y", 256), Dim("x", 384)), tuple(scans),
        tile_widths=(128, 128), border=border,
    )
    x = _img(256, 384, seed=13)
    got = np.asarray(
        dimfuse.apply_filter_fused(spec, jnp.asarray(x), matmul_precision=mode)
    )
    want = scan_core.oracle_apply(spec, x.astype(np.float64))
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= bound * scale


@pytest.mark.parametrize("border", [BorderMode.ZERO, BorderMode.CLAMP])
@pytest.mark.parametrize("mode,bound", [("px3", 1e-4), ("px6", 2e-6)])
def test_px_tails_chaining_leading_channel(mode, bound, border):
    """The 2-D px chain with a leading channel group (RGB pipelines): both
    rotated passes carry the channel axis as an einsum batch axis. Oracle
    parity per channel to the mode's bound."""
    import jax.numpy as jnp

    P = 3
    scans = [
        Scan(2, True, 0.9, (0.6, 0.2)),
        Scan(1, False, 1.05, (0.4, 0.15)),
    ]
    spec = FilterSpec(
        "PXCHAINC", (Dim("c", P), Dim("y", 256), Dim("x", 384)),
        tuple(scans), tile_widths=(0, 128, 128), border=border,
    )
    x = _img(P, 256, 384, seed=17)
    got = np.asarray(
        dimfuse.apply_filter_fused(spec, jnp.asarray(x), matmul_precision=mode)
    )

    want = scan_core.oracle_apply(spec, x.astype(np.float64))
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= bound * scale


def test_px_volume_leading_channel():
    """A 3-D volume under a leading channel batch (rot_axes=3, P>1) must
    hold f32 grade across all three rotated passes (dual-field volumes)."""
    import jax.numpy as jnp

    P = 2
    scans = [Scan(3, True, 0.9, (0.5,)), Scan(2, False, 1.05, (0.4,)),
             Scan(1, True, 1.0, (0.3,))]
    spec = FilterSpec(
        "VOLC", (Dim("c", P), Dim("z", 32), Dim("y", 64), Dim("x", 128)),
        tuple(scans), tile_widths=(0, 32, 64, 128),
    )
    x = _img(P, 32, 64, 128, seed=21)
    got = np.asarray(
        dimfuse.apply_filter_fused(spec, jnp.asarray(x),
                                   matmul_precision="px6")
    )
    want = scan_core.oracle_apply(spec, x.astype(np.float64))
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 2e-6 * scale


def test_px_tails_chaining_volume():
    """3-D px6 volume through the rotation chain (three rotated passes,
    mixed causality and orders) holds f32 grade vs the oracle, with no
    pallas_call in the traced program."""
    import jax
    import jax.numpy as jnp

    from chip_smoke import has_pallas_call

    scans = [
        Scan(2, True, 1.0, (0.5,)),
        Scan(1, True, 0.9, (0.4, 0.1)),
        Scan(0, False, 1.05, (0.3,)),
    ]
    spec = FilterSpec(
        "PXVOL", (Dim("z", 128), Dim("y", 256), Dim("x", 128)),
        tuple(scans), tile_widths=(128, 128, 128),
    )
    x = _img(128, 256, 128, seed=17)
    want = scan_core.oracle_apply(spec, x.astype(np.float64))
    scale = np.abs(want).max()

    def run(v):
        return dimfuse.apply_filter_fused(spec, v, matmul_precision="px6")

    assert not has_pallas_call(jax.make_jaxpr(run)(jnp.asarray(x)))
    got = np.asarray(run(jnp.asarray(x)))
    assert np.abs(got - want).max() <= 2e-6 * scale


@pytest.mark.parametrize("mode", ["px3", "px4"])
def test_pallas_completion_clamp_pad_variants(mode):
    """px modes with per-tile matrix variants: clamp border (exact tiling)
    and zero border with a non-dividing extent (pad projector)."""
    scans = [Scan(1, True, 1.0, (0.5, 0.25)), Scan(1, False, 1.1, (0.4,))]
    for border, w in [(BorderMode.CLAMP, 256), (BorderMode.ZERO, 250)]:
        x = _img(24, w, seed=11)
        got = np.asarray(
            dimfuse.fused_dim_pass(
                x, 1, scans, 128, border, matmul_precision=mode
            )
        )
        want = _oracle_dim(x, scans, border)
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= 1e-4 * scale


@pytest.mark.parametrize("mode", ["px3", "px6"])
def test_px_epilogue_fused_into_kernel(mode):
    """In px modes an elementwise epilogue rides the final completion
    einsum's emit; the result must equal the unfused combine."""
    import jax.numpy as jnp

    scans = [
        Scan(1, True, 0.9, (0.6, 0.2)),
        Scan(0, False, 1.05, (0.4, 0.15)),
    ]
    spec = FilterSpec(
        "PXEPI", (Dim("y", 256), Dim("x", 256)), tuple(scans),
        tile_widths=(128, 128),
    )
    x = _img(256, 256, seed=21)
    aux = _img(256, 256, seed=22)

    def combine(blur, image):
        return 2.0 * image - 0.5 * blur

    got = np.asarray(
        dimfuse.apply_filter_fused(
            spec, jnp.asarray(x), matmul_precision=mode,
            epilogue=combine, eaux=(jnp.asarray(aux),),
        )
    )
    plain = np.asarray(
        dimfuse.apply_filter_fused(spec, jnp.asarray(x),
                                   matmul_precision=mode)
    )
    np.testing.assert_allclose(got, 2.0 * aux - 0.5 * plain, rtol=0,
                               atol=1e-5 * np.abs(plain).max())


def test_bf16_storage_kernel_path_and_chaining():
    """bf16 storage mode (bf16 arrays between passes, one bf16 product per
    image matmul) holds the bf16 rounding bound and emits bf16."""
    import jax.numpy as jnp

    scans = [
        Scan(1, True, 0.9, (0.6, 0.2)),
        Scan(0, False, 1.05, (0.4, 0.15)),
    ]
    spec = FilterSpec(
        "BF16K", (Dim("y", 256), Dim("x", 256)), tuple(scans),
        tile_widths=(128, 128), dtype="bfloat16",
    )
    x = _img(256, 256, seed=23)

    y = dimfuse.apply_filter_fused(
        spec, jnp.asarray(x, jnp.bfloat16), matmul_precision="px6")
    assert y.dtype == jnp.bfloat16
    got = np.asarray(y.astype(jnp.float32))
    spec_f32 = FilterSpec("BF16K", spec.dims, spec.scans,
                          tile_widths=spec.tile_widths)
    want = scan_core.oracle_apply(spec_f32, x.astype(np.float64))
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 3e-2 * scale


def test_grad_through_kernel_paths_matches_highest():
    """jax.grad must flow through the px6 default (the split products'
    custom VJP transposes the HIGHEST einsum) and match the HIGHEST einsum
    path's gradient at f32 grade."""
    import jax
    import jax.numpy as jnp

    scans = [Scan(1, True, 0.9, (0.5,)), Scan(0, True, 1.0, (0.4,))]
    spec = FilterSpec("GR", (Dim("y", 256), Dim("x", 256)), tuple(scans),
                      tile_widths=(128, 128))
    x = jnp.asarray(_img(256, 256, seed=41) * 0.1)
    ct = jnp.asarray(_img(256, 256, seed=42) * 0.1)

    def loss(mode):
        return jax.grad(lambda v: (dimfuse.apply_filter_fused(
            spec, v, matmul_precision=mode) * ct).sum())(x)

    g_hi, g_px = loss("highest"), loss("px6")
    scale = float(jnp.abs(g_hi).max())
    assert float(jnp.abs(g_px - g_hi).max()) <= 1e-5 * scale


def test_banded_solve_blocks_structure_and_equivalence():
    """Decaying filters get a narrow block band (gaussian3: offsets
    {-1,0,1}); integrators (SAT) exceed the band cap and keep the dense
    matmul; the banded apply equals the dense solve to f32 grade."""
    import jax
    import jax.numpy as jnp

    from recfilter import iir

    w = iir.gaussian_weights(4.0, 3)
    scans = [Scan(1, True, w[0], tuple(w[1:])),
             Scan(1, False, w[0], tuple(w[1:]))]
    n, S = 64, 6
    m = dimfuse.prepare_dim_pass(scans, 128, n, False)
    CM = dimfuse.combined_solve_matrix(m, n)
    bands = dimfuse.banded_solve_blocks(CM, n, S)
    assert bands is not None and {d for d, _ in bands} <= {-2, -1, 0, 1, 2}

    braw = np.random.default_rng(5).standard_normal((7, n, S)) * 0.1
    got = np.asarray(dimfuse._banded_solve_apply(
        bands, jnp.asarray(braw, jnp.float32), jax.lax.Precision.HIGHEST))
    want = np.einsum("ts,ls->lt", CM, braw.reshape(7, n * S)).reshape(7, n, S)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())

    sat = [Scan(1, True, 1.0, (1.0,))]
    msat = dimfuse.prepare_dim_pass(sat, 128, n, False)
    CMs = dimfuse.combined_solve_matrix(msat, n)
    assert dimfuse.banded_solve_blocks(CMs, n, 1) is None


# ---------------------------------------------------------------------------
# Fused stencil consumers (round 3 — the reference's compute_at analog)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("start,end", [("zero", "clamp"), ("clamp", "zero"),
                                       ("zero", "zero")])
def test_stencil_kernel_path_matches_fallback(start, end):
    """A single-dimension pass with a stencil consumer (px6, T=128) must
    equal the XLA shifts applied after the plain pass, for every
    border-mode combination."""
    import jax.numpy as jnp

    scans = [Scan(1, True, 1.0, (2.0, -1.0))]  # 2nd-order integrator
    spec = FilterSpec("ST", (Dim("y", 64), Dim("x", 256)), tuple(scans),
                      tile_widths=(0, 128))
    x = _img(64, 256, seed=40) * 0.01
    taps = [(10, 0.25), (-1, -2.0), (-12, 1.0)]
    stencil = {"taps": taps, "start": start, "end": end}

    got = np.asarray(dimfuse.apply_filter_rotated(
        spec, jnp.asarray(x), rot_axes=2, matmul_precision="px6",
        stencil=stencil))
    plain = np.asarray(dimfuse.apply_filter_rotated(
        spec, jnp.asarray(x), rot_axes=2, matmul_precision="px6"))
    want = np.asarray(dimfuse.apply_stencil(
        jnp.asarray(plain), -2, taps, start, end))
    scale = np.abs(want).max() + 1e-30
    assert np.abs(got - want).max() <= 2e-6 * scale


def test_stencil_per_slice_kernel_and_grad():
    """Per-slice taps (leading channel axis, the DoG dual radius) match the
    per-slice shifts; jax.grad through the consumer holds f32 grade."""
    import jax
    import jax.numpy as jnp

    scans = [Scan(2, True, 1.0, (2.0, -1.0))]
    spec = FilterSpec("STC", (Dim("c", 2), Dim("y", 48), Dim("x", 256)),
                      tuple(scans), tile_widths=(0, 0, 128))
    x = _img(2, 48, 256, seed=41) * 0.01
    taps = [[(6, 1.0), (-1, -2.0), (-8, 1.0)],
            [(10, 1.0), (-1, -2.0), (-12, 1.0)]]
    stencil = {"taps": taps, "start": "zero", "end": "clamp"}

    def run(v, mode):
        return dimfuse.apply_filter_rotated(
            spec, v, rot_axes=2, matmul_precision=mode, stencil=stencil)

    got = np.asarray(run(jnp.asarray(x), "px6"))
    plain = np.asarray(dimfuse.apply_filter_rotated(
        spec, jnp.asarray(x), rot_axes=2, matmul_precision="highest"))
    want = np.stack([
        np.asarray(dimfuse.apply_stencil(
            jnp.asarray(plain[p]), -2, taps[p], "zero", "clamp"))
        for p in range(2)
    ])
    # The differencing consumer CANCELS the integrator's magnitude, so
    # px-grade error is relative to the PRODUCER's scale (|z|), not the
    # consumer's — the same amplification the unfused pipeline has.
    zscale = np.abs(plain).max() + 1e-30
    assert np.abs(got - want).max() <= 2e-5 * zscale

    ct = jnp.asarray(_img(2, 256, 48, seed=42))

    def loss(mode):
        return jax.grad(
            lambda v: (run(v, mode) * ct).sum())(jnp.asarray(x))

    g_px, g_hi = np.asarray(loss("px6")), np.asarray(loss("highest"))
    gs = np.abs(g_hi).max() + 1e-30
    assert np.abs(g_px - g_hi).max() <= 1e-5 * gs


def test_hierarchical_two_level_chain_rides_kernels():
    """Audio-scale tile counts route through the two-level supertile
    chain — supertile-local einsum passes, one combined supertile solve
    closes the chain — and match the oracle at f32 grade, incl. clamp,
    anticausal, and non-dividing extents."""
    import jax.numpy as jnp

    rng = np.random.default_rng(7)
    cases = [
        (500000, BorderMode.ZERO, True, 3, 50),
        (500001, BorderMode.CLAMP, False, 2, 40),
    ]
    for w, border, causal, order, tile in cases:
        x = (rng.standard_normal(w) * 0.1).astype(np.float32)
        fb = tuple([0.3, -0.1, 0.05][:order])
        s = Scan(0, causal, 0.9, fb)

        hier = []
        orig_h = dimfuse.hierarchical_dim_pass

        def spy_h(*a, **k):
            r = orig_h(*a, **k)
            hier.append(r is not None)
            return r

        dimfuse.hierarchical_dim_pass = spy_h
        try:
            got = np.asarray(dimfuse.fused_dim_pass(
                jnp.asarray(x), 0, [s], tile, border,
                matmul_precision="px6"))
        finally:
            dimfuse.hierarchical_dim_pass = orig_h
        assert hier == [True], (w, border)
        want = scan_core.oracle_apply_scan(
            x.astype(np.float64), 0, causal, 0.9, list(fb), border)
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= 2e-6 * scale, (w, border)


def test_hierarchical_gates_fall_back():
    """Beyond the provable range the associative path keeps serving:
    ΣK > 64 and > 512 supertiles (at ΣK ≤ 8; 4096 on the S>8 KS route,
    oracle-checked at 20M samples) return None; ΣK in 9..64 rides the
    Kogge–Stone level-2 chain (round-5: the reference's order-29 audio
    sweep is a first-class fast-path workload)."""
    import jax.numpy as jnp

    huge = Scan(0, True, 1.0, tuple([0.001] * 65))  # order 65 > 64 gate
    assert dimfuse.hierarchical_dim_pass(
        jnp.ones(200000, jnp.float32), 0, [huge], BorderMode.ZERO,
        "px6") is None
    big = Scan(0, True, 1.0, tuple([0.01] * 9))  # order 9: multi-slot route
    assert dimfuse.hierarchical_dim_pass(
        jnp.ones(200000, jnp.float32), 0, [big], BorderMode.ZERO,
        "px6") is not None
    s = Scan(0, True, 1.0, (0.5,))
    assert dimfuse.hierarchical_dim_pass(
        jnp.ones(1000, jnp.float32), 0, [s], BorderMode.ZERO,
        "px6") is None  # n_sup < 2
    assert dimfuse.hierarchical_dim_pass(
        jnp.ones(200000, jnp.float32), 0, [s], BorderMode.ZERO,
        "highest") is None  # HIGHEST keeps the einsum path
    # throughput mode rides the hierarchy too
    y = dimfuse.hierarchical_dim_pass(
        jnp.ones(200000, jnp.float32), 0, [s], BorderMode.ZERO, "default")
    assert y is not None


def test_hierarchical_high_order_chain_oracle():
    """Round-5 (VERDICT r4 #2): ΣK > 8 rides the hierarchical chain with a
    per-scan Kogge–Stone level-2 solve (no (n_sup·ΣK)² dense matrix) and
    banded level-1 solves — oracle-exact at f32 grade for high orders,
    clamp, anticausal, non-dividing extents, and mixed multi-scan
    cascades. Reference sweep: apps/audio/audio_filter_high_order.cpp
    orders 1..29, audio_filter_biquads.cpp counts 1..30."""
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    cases = [
        (500000, BorderMode.ZERO, True, 9),
        (500001, BorderMode.CLAMP, True, 16),
        (400003, BorderMode.CLAMP, False, 12),
    ]
    for w, border, causal, order in cases:
        x = (rng.standard_normal(w) * 0.1).astype(np.float32)
        fb = tuple(0.01 for _ in range(order))
        s = Scan(0, causal, 1.0, fb)
        y = dimfuse.hierarchical_dim_pass(
            jnp.asarray(x), 0, [s], border, "px6")
        assert y is not None, (w, order)
        want = scan_core.oracle_apply_scan(
            x.astype(np.float64), 0, causal, 1.0, list(fb), border)
        scale = np.abs(want).max()
        assert np.abs(np.asarray(y) - want).max() <= 2e-6 * scale, (
            w, border, order)
    # Mixed-causality cascade past the slot gate (S = 11, clamp + pad):
    # exercises the H couplings between Kogge–Stone chains.
    w = 300005
    x = (rng.standard_normal(w) * 0.1).astype(np.float32)
    scans = [Scan(0, True, 0.9, (0.2, -0.05, 0.01, 0.004)),
             Scan(0, False, 0.8, (0.3, 0.02, -0.01, 0.002)),
             Scan(0, True, 1.1, (0.15, 0.05, -0.02))]
    y = dimfuse.hierarchical_dim_pass(
        jnp.asarray(x), 0, scans, BorderMode.CLAMP, "px6")
    assert y is not None
    want = x.astype(np.float64)
    for s in scans:
        want = scan_core.oracle_apply_scan(
            want, 0, s.causal, s.feedfwd, list(s.feedback), BorderMode.CLAMP)
    scale = np.abs(want).max()
    assert np.abs(np.asarray(y) - want).max() <= 5e-6 * scale


def test_rows_route_gated_off_at_default_precision():
    """Non-last-axis single-dim filters take the moved-axis rotated pass
    (``_last_axis_pass_t``) at every grade — "default" and px6 alike —
    and match the oracle."""
    spec = FilterSpec(
        "RG", (Dim("y", 256), Dim("x", 256)),
        (Scan(0, True, 0.8, (0.4,)), Scan(0, False, 0.8, (0.4,))),
        tile_widths=(128, 128),
    )
    x = np.random.default_rng(5).standard_normal(
        (256, 256)).astype(np.float32)
    want = scan_core.oracle_apply(spec, x.astype(np.float64))
    scale = np.abs(want).max()
    calls = []
    orig = dimfuse._last_axis_pass_t

    def spy(*a, **k):
        calls.append(k.get("rot_axes"))
        return orig(*a, **k)

    dimfuse._last_axis_pass_t = spy
    try:
        for mode, bound in (("default", 1e-2), ("px6", 2e-6)):
            calls.clear()
            got = np.asarray(
                dimfuse.apply_filter_fused(spec, x, matmul_precision=mode))
            assert calls == [2], (mode, calls)
            assert np.abs(got - want).max() <= bound * scale, mode
    finally:
        dimfuse._last_axis_pass_t = orig
