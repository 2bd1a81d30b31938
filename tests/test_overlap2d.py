"""Full 2-D overlapped executor vs the oracle — cross-dimension carry fusion
(the analog of lib/split.cpp:1215-1633) must be exact."""

import numpy as np
import pytest

from recfilter import dimfuse, overlap2d, scan_core
from recfilter.spec import BorderMode, Dim, FilterSpec, Scan


def _img(*shape, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape).astype(np.float32)


def _oracle(spec, x):
    return scan_core.oracle_apply(spec, x).astype(np.float32)


def _spec(scans, border=BorderMode.ZERO, h=16, w=16, tiles=(4, 4)):
    return FilterSpec(
        "O2", (Dim("y", h), Dim("x", w)), tuple(scans),
        border=border, tile_widths=tiles,
    )


def test_sat_2d():
    spec = _spec(
        [Scan(1, True, 1.0, (1.0,)), Scan(0, True, 1.0, (1.0,))]
    )
    x = np.ones((16, 16), np.float32)
    got = np.asarray(overlap2d.apply_filter_overlap(spec, x))
    np.testing.assert_allclose(got, _oracle(spec, x), rtol=1e-5)


@pytest.mark.parametrize("border", [BorderMode.ZERO, BorderMode.CLAMP])
def test_gaussian_shape_both_dims(border):
    from recfilter import iir

    w3 = iir.gaussian_weights(2.0, 3)
    spec = _spec(
        [
            Scan(1, True, w3[0], tuple(w3[1:])),
            Scan(1, False, w3[0], tuple(w3[1:])),
            Scan(0, True, w3[0], tuple(w3[1:])),
            Scan(0, False, w3[0], tuple(w3[1:])),
        ],
        border=border, h=24, w=24, tiles=(8, 8),
    )
    x = _img(24, 24, seed=1)
    got = np.asarray(overlap2d.apply_filter_overlap(spec, x))
    np.testing.assert_allclose(got, _oracle(spec, x), rtol=1e-3, atol=1e-4)


def test_mixed_orders_and_counts():
    spec = _spec(
        [
            Scan(1, True, 1.0, (0.5, 0.25)),
            Scan(1, False, 1.0, (0.4,)),
            Scan(1, True, 0.9, (0.3, 0.1, -0.05)),
            Scan(0, False, 1.0, (0.6, 0.2)),
            Scan(0, True, 1.0, (0.2,)),
        ],
        h=20, w=20, tiles=(5, 5),
    )
    x = _img(20, 20, seed=2)
    got = np.asarray(overlap2d.apply_filter_overlap(spec, x))
    np.testing.assert_allclose(got, _oracle(spec, x), rtol=1e-4, atol=1e-4)


def test_non_dividing_both_axes():
    spec = _spec(
        [
            Scan(1, True, 1.0, (0.5, 0.25)),
            Scan(1, False, 1.0, (0.4, 0.1)),
            Scan(0, True, 1.0, (0.3, 0.15)),
            Scan(0, False, 1.0, (0.2,)),
        ],
        h=19, w=21, tiles=(5, 6),
    )
    x = _img(19, 21, seed=3)
    got = np.asarray(overlap2d.apply_filter_overlap(spec, x))
    np.testing.assert_allclose(got, _oracle(spec, x), rtol=1e-4, atol=1e-4)


def test_matches_dimfuse():
    spec = _spec(
        [
            Scan(1, True, 1.0, (0.5, 0.25)),
            Scan(0, False, 1.0, (0.4, 0.1)),
        ],
        h=16, w=16, tiles=(4, 4),
    )
    x = _img(16, 16, seed=4)
    got = np.asarray(overlap2d.apply_filter_overlap(spec, x))
    want = np.asarray(dimfuse.apply_filter_fused(spec, x))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_3d_pairs_then_single():
    dims = (Dim("z", 12), Dim("y", 12), Dim("x", 12))
    spec = FilterSpec(
        "O3", dims,
        (
            Scan(2, True, 1.0, (0.5, 0.25)),
            Scan(2, False, 1.0, (0.3,)),
            Scan(1, True, 1.0, (0.4, 0.1)),
            Scan(0, True, 1.0, (0.2,)),
        ),
        tile_widths=(4, 4, 4),
    )
    x = _img(12, 12, 12, seed=5)
    got = np.asarray(overlap2d.apply_filter_overlap(spec, x))
    np.testing.assert_allclose(got, _oracle(spec, x), rtol=1e-4, atol=1e-4)


def test_batch_axis_untouched():
    dims = (Dim("c", 3), Dim("y", 16), Dim("x", 16))
    spec = FilterSpec(
        "OB", dims,
        (
            Scan(2, True, 1.0, (0.5, 0.25)),
            Scan(1, True, 1.0, (0.4,)),
        ),
        tile_widths=(0, 4, 4),
    )
    x = _img(3, 16, 16, seed=6)
    got = np.asarray(overlap2d.apply_filter_overlap(spec, x))
    np.testing.assert_allclose(got, _oracle(spec, x), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("border", [BorderMode.ZERO, BorderMode.CLAMP])
def test_kernel_path_matches_xla_path(border):
    """The overlap backend's 5-touch cross-dimension pipeline must equal the
    shipping rotation-chained executor and the oracle."""
    from recfilter import iir

    w3 = iir.gaussian_weights(1.5, 3)
    spec = _spec(
        [
            Scan(1, True, w3[0], tuple(w3[1:])),
            Scan(1, False, w3[0], tuple(w3[1:])),
            Scan(0, True, w3[0], tuple(w3[1:])),
            Scan(0, False, w3[0], tuple(w3[1:])),
        ],
        border=border, h=24, w=24, tiles=(8, 8),
    )
    x = _img(24, 24, seed=7)
    got = np.asarray(overlap2d.apply_filter_overlap(spec, x))
    want = np.asarray(dimfuse.apply_filter_fused(
        spec, x, matmul_precision="highest"))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, _oracle(spec, x), rtol=1e-3, atol=1e-4)


def test_kernel_path_batch_axis():
    spec_scans = [
        Scan(1, True, 1.0, (0.5, 0.25)),
        Scan(2, False, 1.0, (0.4,)),
    ]
    dims = (Dim("c", 2), Dim("y", 16), Dim("x", 16))
    spec = FilterSpec("KB", dims, tuple(spec_scans), tile_widths=(0, 4, 4))
    x = _img(2, 16, 16, seed=8)
    got = np.asarray(overlap2d.apply_filter_overlap(spec, x))
    np.testing.assert_allclose(got, _oracle(spec, x), rtol=1e-4, atol=1e-4)


def test_kernel_path_non_dividing():
    spec = _spec(
        [
            Scan(1, True, 1.0, (0.5, 0.25)),
            Scan(0, False, 1.0, (0.4, 0.1)),
        ],
        h=19, w=21, tiles=(5, 6),
    )
    x = _img(19, 21, seed=9)
    got = np.asarray(overlap2d.apply_filter_overlap(spec, x))
    np.testing.assert_allclose(got, _oracle(spec, x), rtol=1e-4, atol=1e-4)


def test_fused_nd_pass_3d_matches_oracle():
    """3-D overlap: all three dimensions' carries from one read — mixed
    causality/orders, non-dividing extents — vs the float64 oracle."""
    import jax.numpy as jnp

    from recfilter import overlap2d, scan_core
    from recfilter.spec import Dim, FilterSpec, Scan

    spec = FilterSpec(
        "ND3",
        (Dim("z", 12), Dim("y", 21), Dim("x", 16)),
        (
            Scan(2, True, 1.0, (0.5, 0.2)),
            Scan(2, False, 0.9, (0.4,)),
            Scan(1, True, 1.0, (0.3,)),
            Scan(0, False, 1.05, (0.25, 0.1)),
        ),
        tile_widths=(4, 7, 8),
    )
    x = _img(12, 21, 16, seed=51)
    got = np.asarray(overlap2d.apply_filter_overlap(spec, jnp.asarray(x)))
    want = scan_core.oracle_apply(spec, x.astype(np.float64))
    np.testing.assert_allclose(got, want.astype(np.float32),
                               rtol=1e-4, atol=1e-4)


def test_fused_nd_pass_3d_clamp_and_routing():
    """Clamped 3-D filter through the n-D single-solve path (exact tiling);
    the routing must actually take fused_nd_pass, not the pairwise loop."""
    import jax.numpy as jnp

    from recfilter import overlap2d, scan_core
    from recfilter.spec import BorderMode, Dim, FilterSpec, Scan

    spec = FilterSpec(
        "ND3C",
        (Dim("z", 12), Dim("y", 16), Dim("x", 16)),
        (
            Scan(2, True, 1.0, (0.5,)),
            Scan(1, False, 0.9, (0.4, 0.1)),
            Scan(0, True, 1.0, (0.3,)),
        ),
        border=BorderMode.CLAMP,
        tile_widths=(4, 8, 8),
    )
    x = _img(12, 16, 16, seed=52)
    calls = []
    orig = overlap2d.fused_nd_pass

    def spy(*a, **k):
        r = orig(*a, **k)
        calls.append(r is not None)
        return r

    overlap2d.fused_nd_pass = spy
    try:
        got = np.asarray(overlap2d.apply_filter_overlap(spec, jnp.asarray(x)))
    finally:
        overlap2d.fused_nd_pass = orig
    assert calls == [True]
    want = scan_core.oracle_apply(spec, x.astype(np.float64))
    np.testing.assert_allclose(got, want.astype(np.float32),
                               rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# Split-bf16 (px) grades through the shipping 2-D executor
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("border", [BorderMode.ZERO, BorderMode.CLAMP])
def test_px_path_matches_oracle(border):
    """The px6 2-D executor must hold the f32 SNR bar vs the f64 oracle:
    compensated 6-product dots in both passes, HIGHEST solves."""
    from recfilter import iir

    w3 = iir.gaussian_weights(2.0, 3)
    spec = _spec(
        [
            Scan(1, True, w3[0], tuple(w3[1:])),
            Scan(1, False, w3[0], tuple(w3[1:])),
            Scan(0, True, w3[0], tuple(w3[1:])),
            Scan(0, False, w3[0], tuple(w3[1:])),
        ],
        border=border, h=128, w=256, tiles=(128, 128),
    )
    x = _img(128, 256, seed=20)
    got = dimfuse.apply_filter_fused(spec, x, matmul_precision="px6")
    want = scan_core.oracle_apply(spec, x.astype(np.float64))
    np.testing.assert_allclose(
        np.asarray(got), want.astype(np.float32), rtol=2e-5, atol=2e-6)


def test_px_path_routing_and_non_dividing():
    """apply_filter_fused with a px mode routes trailing-2-D filters through
    two rotated passes (zero border pads non-dividing extents)."""
    import jax.numpy as jnp

    spec = _spec(
        [
            Scan(1, True, 1.0, (0.5, 0.25)),
            Scan(0, False, 1.0, (0.4,)),
        ],
        h=130, w=250, tiles=(128, 128),
    )
    x = _img(130, 250, seed=21)
    calls = []
    orig = dimfuse._last_axis_pass_t

    def spy(*a, **k):
        calls.append(k.get("rot_axes"))
        return orig(*a, **k)

    dimfuse._last_axis_pass_t = spy
    try:
        got = np.asarray(dimfuse.apply_filter_fused(
            spec, jnp.asarray(x), matmul_precision="px6"))
    finally:
        dimfuse._last_axis_pass_t = orig
    assert calls == [2, 2]
    want = scan_core.oracle_apply(spec, x.astype(np.float64))
    np.testing.assert_allclose(got, want.astype(np.float32),
                               rtol=2e-5, atol=2e-6)


def test_px_path_batch_and_grad():
    """Leading batch axis rides the einsum batch; jax.grad flows through
    the split products' custom VJPs at f32 grade."""
    import jax
    import jax.numpy as jnp

    spec_scans = (
        Scan(2, True, 1.0, (0.5,)),
        Scan(1, True, 1.0, (0.4,)),
    )
    dims = (Dim("c", 2), Dim("y", 128), Dim("x", 128))
    spec = FilterSpec("PXB", dims, spec_scans, tile_widths=(0, 128, 128))
    x = _img(2, 128, 128, seed=22)

    def f(v):
        return jnp.sum(dimfuse.apply_filter_fused(
            spec, v, matmul_precision="px6") ** 2)

    got = np.asarray(dimfuse.apply_filter_fused(
        spec, jnp.asarray(x), matmul_precision="px6"))
    want = scan_core.oracle_apply(spec, x.astype(np.float64))
    np.testing.assert_allclose(got, want.astype(np.float32),
                               rtol=2e-5, atol=2e-6)

    g = np.asarray(jax.grad(f)(jnp.asarray(x)))

    def f_ref(v):
        return jnp.sum(scan_core.apply_filter(spec, v) ** 2)

    g_ref = np.asarray(jax.grad(f_ref)(jnp.asarray(x)))
    np.testing.assert_allclose(g, g_ref, rtol=1e-4, atol=1e-4)


def test_px_path_epilogue_fused_into_final_kernel():
    """At px6 an elementwise epilogue rides the final pass's emit,
    matching the unfused combine."""
    import jax.numpy as jnp

    spec = _spec(
        [
            Scan(1, True, 0.9, (0.6, 0.2)),
            Scan(0, False, 1.05, (0.4, 0.15)),
        ],
        h=128, w=256, tiles=(128, 128),
    )
    x = _img(128, 256, seed=30)
    aux = _img(128, 256, seed=31)

    def combine(blur, image):
        return 2.0 * image - 0.5 * blur

    got = np.asarray(dimfuse.apply_filter_fused(
        spec, jnp.asarray(x), matmul_precision="px6",
        epilogue=combine, eaux=(jnp.asarray(aux),),
    ))
    plain = np.asarray(dimfuse.apply_filter_fused(
        spec, jnp.asarray(x), matmul_precision="px6"))
    np.testing.assert_allclose(got, 2.0 * aux - 0.5 * plain, rtol=0,
                               atol=1e-5 * np.abs(plain).max())


def test_px_path_bf16_storage_mode():
    """bf16 storage (one plain bf16 product, half the image traffic of
    the f32 modes) holds the bf16 rounding bound and emits bf16."""
    import jax.numpy as jnp

    spec = _spec(
        [
            Scan(1, True, 0.9, (0.6, 0.2)),
            Scan(0, False, 1.05, (0.4, 0.15)),
        ],
        h=128, w=256, tiles=(128, 128),
    )
    import dataclasses
    spec = dataclasses.replace(spec, dtype="bfloat16")
    x = _img(128, 256, seed=33)

    y = dimfuse.apply_filter_fused(
        spec, jnp.asarray(x, jnp.bfloat16), matmul_precision="px6")
    assert y.dtype == jnp.bfloat16
    got = np.asarray(y.astype(jnp.float32))
    want = scan_core.oracle_apply(spec.with_dtype("float32")
                                  if hasattr(spec, "with_dtype") else
                                  dataclasses.replace(spec, dtype="float32"),
                                  x.astype(np.float64))
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 3e-2 * scale


def test_px_path_throughput_mode():
    """matmul_precision="default" (the throughput mode: XLA's own dot
    precision, TF32 on the GPU) holds its bound vs the oracle."""
    import jax.numpy as jnp

    spec = _spec(
        [
            Scan(1, True, 0.9, (0.6, 0.2)),
            Scan(0, False, 1.05, (0.4, 0.15)),
        ],
        h=128, w=256, tiles=(128, 128),
    )
    x = _img(128, 256, seed=35)

    got = np.asarray(dimfuse.apply_filter_fused(
        spec, jnp.asarray(x), matmul_precision="default"))
    want = scan_core.oracle_apply(spec, x.astype(np.float64))
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 3e-2 * scale


def _shift_np(f, off, ax):
    n = f.shape[ax]
    lo, hi = max(off, 0), max(-off, 0)
    pads = [(0, 0)] * f.ndim
    pads[ax] = (hi, lo)
    g = np.pad(f, pads, mode="edge" if off > 0 else "constant")
    sl = [slice(None)] * f.ndim
    sl[ax] = slice(lo, lo + n)
    return g[tuple(sl)]


def _stencil_np(y, taps_c):
    outs = []
    for taps in taps_c:
        acc = None
        for dy, dx, c in taps:
            t = _shift_np(_shift_np(y, dy, 0), dx, 1) * c
            acc = t if acc is None else acc + t
        outs.append(acc)
    return outs


def _corner_taps(B):
    s = 1.0 / float((2 * B + 1) ** 2)
    return [(B, B, s), (B, -B - 1, -s), (-B - 1, B, -s),
            (-B - 1, -B - 1, s)]


def test_fused_2d_stencil_consumer_vs_oracle():
    """stencil2d= applies a dual-radius 4-corner tap bank (DoG's SAT
    differencing, diff_gauss.cpp:29-38) to the executor's output; every
    region — tile edges, global borders — must match the f64 SAT+shift
    oracle."""
    import jax.numpy as jnp

    H, W = 256, 2560
    spec = _spec(
        [Scan(1, True, 1.0, (1.0,)), Scan(0, True, 1.0, (1.0,))],
        h=H, w=W, tiles=(128, 128),
    )
    x = _img(H, W, seed=40) * 0.01
    banks = [_corner_taps(5), _corner_taps(9)]
    out = dimfuse.apply_filter_fused(
        spec, jnp.asarray(x), matmul_precision="px6", stencil2d=banks)
    assert isinstance(out, tuple) and len(out) == 2
    sat = x.astype(np.float64).cumsum(1).cumsum(0)
    refs = _stencil_np(sat, banks)
    for got, want in zip(out, refs):
        scale = np.abs(want).max()
        err = np.abs(np.asarray(got, np.float64) - want)
        assert err.max() <= 2e-5 * scale
        # boundary regions specifically (lane-block edge, global edges)
        assert err[:, 1280 - 16:1280 + 16].max() <= 2e-5 * scale
        assert max(err[:16].max(), err[-16:].max(),
                   err[:, :16].max(), err[:, -16:].max()) <= 2e-5 * scale


def test_fused_2d_stencil_gradient():
    """The custom VJP (einsum + XLA-shift twin, zero halo cotangents)
    must give the true gradient of the stencil-consumer composite."""
    import jax
    import jax.numpy as jnp

    H = W = 128  # single tile: halos masked, degenerate gates
    spec = _spec(
        [Scan(1, True, 1.0, (0.8,)), Scan(0, True, 1.0, (0.7,))],
        h=H, w=W, tiles=(128, 128),
    )
    banks = [[(2, 1, 0.5), (-3, -1, -0.25), (0, 0, 1.0)]]
    x = _img(H, W, seed=41)

    def loss(v):
        out = dimfuse.apply_filter_fused(
            spec, v, matmul_precision="px6", stencil2d=banks)
        return jnp.sum(out[0] * jnp.cos(jnp.arange(W) / 7.0))

    g = np.asarray(jax.grad(loss)(jnp.asarray(x)))
    # numeric check on a few entries
    rng = np.random.default_rng(2)
    for _ in range(4):
        i, j = rng.integers(0, H), rng.integers(0, W)
        eps = 1e-2
        xp = x.copy(); xp[i, j] += eps
        xm = x.copy(); xm[i, j] -= eps
        num = (float(loss(jnp.asarray(xp))) - float(loss(jnp.asarray(xm)))) \
            / (2 * eps)
        assert abs(num - g[i, j]) <= 2e-2 * max(1.0, abs(num))


def test_fused_2d_stencil_fallback_matches():
    """Off-gate geometries (non-128 tiles) fall back to XLA shifts with
    identical semantics."""
    import jax.numpy as jnp

    H = W = 96
    spec = _spec(
        [Scan(1, True, 1.0, (1.0,)), Scan(0, True, 1.0, (1.0,))],
        h=H, w=W, tiles=(32, 32),
    )
    x = _img(H, W, seed=42) * 0.1
    banks = [_corner_taps(3)]
    out = dimfuse.apply_filter_fused(
        spec, jnp.asarray(x), matmul_precision="px6", stencil2d=banks)
    sat = x.astype(np.float64).cumsum(1).cumsum(0)
    want = _stencil_np(sat, banks)[0]
    err = np.abs(np.asarray(out[0], np.float64) - want)
    assert err.max() <= 2e-5 * np.abs(want).max()


def test_volume_rows_plus_2d_route():
    """Ds=3 volumes through three rotated passes — vs the oracle, both
    borders, including carry coupling across all three axes."""
    import jax.numpy as jnp

    Z, Y, W = 128, 128, 256
    x = _img(Z, Y, W, seed=50) * 0.1
    for border in (BorderMode.ZERO, BorderMode.CLAMP):
        spec = FilterSpec(
            "V3", (Dim("z", Z), Dim("y", Y), Dim("x", W)),
            scans=(
                Scan(2, True, 1.0, (0.6,)),
                Scan(2, False, 1.0, (0.6,)),
                Scan(1, True, 0.9, (0.5, 0.1)),
                Scan(0, True, 1.0, (0.4,)),
            ),
            border=border, tile_widths=(128, 128, 128),
        )
        got = np.asarray(dimfuse.apply_filter_fused(
            spec, jnp.asarray(x), tile_default=128,
            matmul_precision="px6"))
        want = scan_core.oracle_apply(spec, x.astype(np.float64))
        assert np.abs(got - want).max() <= 2e-6 * np.abs(want).max()


def test_volume_rows_route_chain_fallback():
    """Mixed tile widths per axis (non-128 y extent) on a volume."""
    import jax.numpy as jnp

    Z, Y, W = 128, 40, 128
    x = _img(Z, Y, W, seed=51) * 0.1
    spec = FilterSpec(
        "V3F", (Dim("z", Z), Dim("y", Y), Dim("x", W)),
        scans=(
            Scan(2, True, 1.0, (0.5,)),
            Scan(1, True, 1.0, (0.4,)),
            Scan(0, True, 1.0, (0.3,)),
        ),
        border=BorderMode.ZERO, tile_widths=(128, 32, 128),
    )
    got = np.asarray(dimfuse.apply_filter_fused(
        spec, jnp.asarray(x), tile_default=32, matmul_precision="px6"))
    want = scan_core.oracle_apply(spec, x.astype(np.float64))
    assert np.abs(got - want).max() <= 2e-6 * np.abs(want).max()


def test_rows_route_single_nonlast_axis():
    """Single-dimension scans OFF the last array axis (moved-axis rotated
    passes): clamp edge variants and mixed non-adjacent axis sets must
    match the oracle."""
    import jax.numpy as jnp

    x = _img(256, 384, seed=52) * 0.1
    for border in (BorderMode.ZERO, BorderMode.CLAMP):
        spec = FilterSpec(
            "R1", (Dim("y", 256), Dim("x", 384)),
            scans=(Scan(0, True, 1.0, (0.6,)), Scan(0, False, 0.9, (0.4,))),
            border=border, tile_widths=(128, 0),
        )
        got = np.asarray(dimfuse.apply_filter_fused(
            spec, jnp.asarray(x), tile_default=128,
            matmul_precision="px6"))
        want = scan_core.oracle_apply(spec, x.astype(np.float64))
        assert np.abs(got - want).max() <= 2e-6 * np.abs(want).max()
    v = _img(128, 64, 256, seed=53) * 0.1
    spec = FilterSpec(
        "R2", (Dim("z", 128), Dim("y", 64), Dim("x", 256)),
        scans=(Scan(0, True, 1.0, (0.5,)), Scan(2, True, 1.0, (0.3,))),
        border=BorderMode.ZERO, tile_widths=(128, 0, 128),
    )
    got = np.asarray(dimfuse.apply_filter_fused(
        spec, jnp.asarray(v), tile_default=128, matmul_precision="px6"))
    want = scan_core.oracle_apply(spec, v.astype(np.float64))
    assert np.abs(got - want).max() <= 2e-6 * np.abs(want).max()
