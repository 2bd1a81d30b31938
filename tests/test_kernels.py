"""Dimension-pass executors vs the oracle: the XLA routes (einsum backend)
that replaced the strip, stencil and completion kernels, at the shapes and
tolerances the kernels were held to."""

import numpy as np
import pytest

from recfilter import dimfuse, scan_core
from recfilter.spec import BorderMode, Dim, FilterSpec, Scan


def _img(*shape, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape).astype(np.float32)


def _run(spec, img):
    return np.asarray(dimfuse.apply_filter_fused(spec, img))


def _check(spec, img, rtol=1e-4, atol=1e-4):
    got = _run(spec, img)
    want = scan_core.oracle_apply(spec, img).astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def test_row_pass_single_causal():
    spec = FilterSpec(
        "K1", (Dim("y", 8), Dim("x", 16)),
        (Scan(1, True, 1.0, (0.5, 0.25)),), tile_widths=(0, 4),
    )
    _check(spec, _img(8, 16, seed=0))


def test_row_pass_causal_anticausal_third_order():
    spec = FilterSpec(
        "K2", (Dim("y", 8), Dim("x", 16)),
        (
            Scan(1, True, 0.9, (0.6, 0.25, -0.1)),
            Scan(1, False, 1.1, (0.5, 0.2, 0.05)),
        ),
        tile_widths=(0, 4),
    )
    _check(spec, _img(8, 16, seed=1))


def test_col_pass_single_causal():
    spec = FilterSpec(
        "K3", (Dim("y", 16), Dim("x", 8)),
        (Scan(0, True, 1.0, (0.5, 0.25)),), tile_widths=(4, 0),
    )
    _check(spec, _img(16, 8, seed=2))


def test_col_pass_causal_anticausal():
    spec = FilterSpec(
        "K4", (Dim("y", 16), Dim("x", 8)),
        (
            Scan(0, True, 1.0, (0.5, 0.25)),
            Scan(0, False, 1.0, (0.4, 0.2)),
        ),
        tile_widths=(4, 0),
    )
    _check(spec, _img(16, 8, seed=3))


def test_2d_sat():
    spec = FilterSpec(
        "SAT", (Dim("y", 16), Dim("x", 16)),
        (Scan(1, True, 1.0, (1.0,)), Scan(0, True, 1.0, (1.0,))),
        tile_widths=(4, 4),
    )
    img = np.ones((16, 16), dtype=np.float32)
    _check(spec, img, rtol=1e-5)


def test_2d_gaussian_shape_clamped():
    from recfilter import iir

    w = iir.gaussian_weights(1.5, 3)
    spec = FilterSpec(
        "G", (Dim("y", 24), Dim("x", 24)),
        (
            Scan(1, True, w[0], tuple(w[1:])),
            Scan(1, False, w[0], tuple(w[1:])),
            Scan(0, True, w[0], tuple(w[1:])),
            Scan(0, False, w[0], tuple(w[1:])),
        ),
        border=BorderMode.CLAMP,
        tile_widths=(8, 8),
    )
    _check(spec, _img(24, 24, seed=4), rtol=1e-3)


def test_non_dividing_zero_border():
    spec = FilterSpec(
        "ND", (Dim("y", 6), Dim("x", 19)),
        (
            Scan(1, True, 1.0, (0.5, 0.25)),
            Scan(1, False, 1.0, (0.4,)),
        ),
        tile_widths=(0, 5),
    )
    _check(spec, _img(6, 19, seed=5))


def test_non_dividing_clamp_falls_back():
    spec = FilterSpec(
        "NDC", (Dim("y", 6), Dim("x", 19)),
        (Scan(1, False, 1.0, (0.5,)),),
        border=BorderMode.CLAMP,
        tile_widths=(0, 5),
    )
    _check(spec, _img(6, 19, seed=6))


def test_3d_middle_axis():
    spec = FilterSpec(
        "M", (Dim("b", 3), Dim("y", 12), Dim("x", 8)),
        (Scan(1, True, 1.0, (0.5, 0.25)), Scan(1, False, 1.0, (0.3,))),
        tile_widths=(0, 4, 0),
    )
    _check(spec, _img(3, 12, 8, seed=7))


def test_matches_einsum_backend():
    from recfilter import tiling

    spec = FilterSpec(
        "X", (Dim("y", 16), Dim("x", 16)),
        (
            Scan(1, True, 1.0, (0.5, 0.25)),
            Scan(0, True, 1.0, (0.4, 0.1)),
            Scan(0, False, 1.0, (0.3,)),
        ),
        tile_widths=(4, 4),
    )
    img = _img(16, 16, seed=8)
    got = _run(spec, img)
    want = np.asarray(tiling.apply_filter(spec, img))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_stencil2d_kernel_matches_shift_oracle():
    """2-D stencil bank (XLA shifts, ``dimfuse.apply_stencil2d``) vs the
    app's separable pad/slice differencing: dual-radius 4-corner taps with
    mixed clamp/zero edge semantics, plus gradients."""
    import jax
    import jax.numpy as jnp

    from recfilter.apps.dog import _diff_xy

    rng = np.random.default_rng(44)
    H, W = 96, 160
    s = rng.standard_normal((H, W)).astype(np.float32)

    def taps(B):
        sc = 1.0 / float((2 * B + 1) ** 2)
        return [(B, B, sc), (B, -B - 1, -sc), (-B - 1, B, -sc),
                (-B - 1, -B - 1, sc)]

    got = dimfuse.apply_stencil2d(jnp.asarray(s), [taps(3), taps(7)])
    assert len(got) == 2
    want = np.stack([np.asarray(_diff_xy(jnp.asarray(s), B, W, H))
                     for B in (3, 7)])
    np.testing.assert_allclose(np.stack([np.asarray(g) for g in got]),
                               want, rtol=0, atol=1e-6)

    ct = jnp.asarray(rng.standard_normal((2, H, W)).astype(np.float32))

    def f(v):
        y = dimfuse.apply_stencil2d(v, [taps(3), taps(7)])
        return (jnp.stack(y) * ct).sum()

    def f_ref(v):
        y = jnp.stack([_diff_xy(v, B, W, H) for B in (3, 7)])
        return (y * ct).sum()

    g = np.asarray(jax.grad(f)(jnp.asarray(s)))
    g_ref = np.asarray(jax.grad(f_ref)(jnp.asarray(s)))
    np.testing.assert_allclose(g, g_ref, rtol=1e-5, atol=1e-5)


def test_tails_pass_mstack_accuracy_ladder():
    """The split-bf16 tails product (``dimfuse._split_einsum``) tracks each
    precision grade's expected error vs the HIGHEST einsum."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(4)
    q, n, T = 384, 3, 128
    x = jnp.asarray(rng.standard_normal((q, n, T)), jnp.float32)
    G = rng.standard_normal((8, T))
    G[6:] = 0.0
    ref = np.asarray(jnp.einsum(
        "st,qnt->qns", jnp.asarray(G, jnp.float32), x,
        precision=jax.lax.Precision.HIGHEST))
    scale = np.max(np.abs(ref))
    for nprod, tol in ((6, 1e-5), (3, 2e-3)):
        y = np.asarray(dimfuse._split_einsum(
            "st,qnt->qns", G, x, nprod, jnp.float32))
        assert np.max(np.abs(y - ref)) / scale < tol, nprod
    # one plain bf16 product: the bf16 rounding class
    y1 = np.asarray(jnp.einsum(
        "st,qnt->qns", jnp.asarray(G, jnp.bfloat16), x.astype(jnp.bfloat16),
        preferred_element_type=jnp.float32))
    assert np.max(np.abs(y1 - ref)) / scale < 2e-2


def test_multislot_kernels_oracle_and_grad():
    """Carries past ΣK=8 (order 13) through the full dimension pass vs the
    oracle at f32 grade, and jax.grad through the px6 split products (the
    custom VJP's HIGHEST transpose) vs the HIGHEST einsum path."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(9)
    order = 13
    fb = tuple(rng.uniform(-0.04, 0.04, order))
    s = Scan(1, True, 1.1, fb)
    x = (rng.standard_normal((16, 512)) * 0.1).astype(np.float32)

    got = np.asarray(dimfuse.fused_dim_pass(
        jnp.asarray(x), 1, [s], 128, BorderMode.ZERO,
        matmul_precision="px6"))
    want = scan_core.oracle_apply_scan(
        x.astype(np.float64), 1, True, 1.1, list(fb), BorderMode.ZERO)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 2e-6 * scale

    ct = jnp.asarray(rng.standard_normal(x.shape), jnp.float32)

    def loss(mode):
        return jax.grad(lambda v: (dimfuse.fused_dim_pass(
            v, 1, [s], 128, BorderMode.ZERO, matmul_precision=mode
        ) * ct).sum())(jnp.asarray(x))

    g_px, g_hi = np.asarray(loss("px6")), np.asarray(loss("highest"))
    gs = np.abs(g_hi).max() + 1e-30
    assert np.abs(g_px - g_hi).max() <= 1e-5 * gs
