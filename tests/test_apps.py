"""Application integration tests — the analogs of running each reference app
with its built-in oracle check at small sizes (SURVEY §4: apps double as
integration tests)."""

import numpy as np
import pytest

import recfilter as rf
from recfilter import iir, scan_core
from recfilter.apps import (
    audio_filter_biquads,
    audio_filter_high_order,
    bicubic,
    biquintic_cascaded,
    biquintic_overlapped,
    box,
    box_filter_3,
    box_filter_order_1,
    box_filter_order_2,
    difference_of_gaussians,
    gaussian_1xy_2xy,
    gaussian_3x_3y,
    gaussian_3xy,
    summed_table,
    unsharp_mask,
)
from recfilter.apps.gaussian import run_cascade


def test_summed_table_matches_oracle():
    w = 32
    F = summed_table(w, w, 8)
    img = rf.generate_random_image(w, w)
    out = np.asarray(F.realize(img))
    ref = scan_core.oracle_apply(F.spec, img)
    rf.CheckResult(ref, out)
    np.testing.assert_allclose(out, ref, rtol=1e-4)


def test_box1_matches_brute_force():
    w, B = 48, 3
    fn, _ = box_filter_order_1(w, w, B, 8)
    img = rf.generate_random_image(w, w, lo=0, hi=1, seed=1)
    pad = B + 2
    img[:pad] = img[-pad:] = 0
    img[:, :pad] = 0
    img[:, -pad:] = 0
    out = np.asarray(fn(img))
    ref = box.box_oracle(img, B, 1)
    np.testing.assert_allclose(out, ref, rtol=1e-3, atol=1e-4)


def test_box2_matches_brute_force():
    w, B = 48, 3
    fn, _ = box_filter_order_2(w, w, B, 8)
    img = rf.generate_random_image(w, w, lo=0, hi=1, seed=2)
    pad = 2 * (B + 1) + 1
    img[:pad] = img[-pad:] = 0
    img[:, :pad] = 0
    img[:, -pad:] = 0
    out = np.asarray(fn(img))
    ref = box.box_oracle(img, B, 2)
    # The reference's 2nd-order formula is undefined in the zero-padded
    # right/bottom margin (the 2nd-order integral keeps growing past the
    # data and index clamping truncates it) — compare the valid region,
    # as the reference's padding contract implies (box_filter.h:9-11).
    v = slice(0, w - pad)
    np.testing.assert_allclose(out[v, v], ref[v, v], rtol=1e-3, atol=1e-4)


def test_box3_composes():
    w, B = 48, 2
    fn = box_filter_3(w, w, B, 8)
    img = rf.generate_random_image(w, w, lo=0, hi=1, seed=3)
    pad = 3 * (B + 1) + 1
    img[:pad] = img[-pad:] = 0
    img[:, :pad] = 0
    img[:, -pad:] = 0
    out = np.asarray(fn(img))
    ref = box.box_oracle(img, B, 3)
    v = slice(0, w - pad)
    np.testing.assert_allclose(out[v, v], ref[v, v], rtol=1e-3, atol=1e-4)


def test_gaussian_3xy_matches_true_gaussian():
    """Tiled 3rd-order recursive Gaussian ≈ true Gaussian convolution
    (the reference's check via reference_gaussian, gaussian apps)."""
    w, sigma = 48, 3.0
    F = gaussian_3xy(w, w, 8, sigma)
    img = rf.generate_random_image(w, w, lo=0, hi=1, seed=4)
    out = np.asarray(F.realize(img))
    ref = iir.reference_gaussian(img, sigma)
    # recursive approximation: interior-pixel agreement to ~1%
    interior = (slice(8, -8), slice(8, -8))
    err = np.abs(out[interior] - ref[interior]).max()
    assert err < 2e-2, f"max abs err {err}"


def test_gaussian_3xy_rgb_matches_per_channel():
    """The RGB variant (leading channel axis, per-slice kernels + chained
    tails) must equal the 2-D filter applied to each channel plane."""
    from recfilter.apps import gaussian_3xy_rgb

    w, sigma = 48, 3.0
    chw = np.stack([
        rf.generate_random_image(w, w, lo=0, hi=1, seed=s) for s in (6, 7, 8)
    ])
    out = np.asarray(gaussian_3xy_rgb(w, w, 8, sigma=sigma).as_func()(chw))
    F2 = gaussian_3xy(w, w, 8, sigma)
    want = np.stack([np.asarray(F2.realize(chw[p])) for p in range(3)])
    np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-5)


def test_gaussian_cascade_variants_agree():
    w, sigma = 32, 2.0
    img = rf.generate_random_image(w, w, lo=0, hi=1, seed=5)
    out_3xy = np.asarray(gaussian_3xy(w, w, 8, sigma).realize(img))
    out_3x3y = np.asarray(
        run_cascade(gaussian_3x_3y(w, w, 8, sigma), img)
    )
    out_12 = np.asarray(run_cascade(gaussian_1xy_2xy(w, w, 8, sigma), img))
    # 3xy and 3x_3y are algebraically identical (scan grouping commutes)
    np.testing.assert_allclose(out_3x3y, out_3xy, rtol=1e-4, atol=1e-5)
    # 1+2 cascade equals 3rd order (weights3 composition identity,
    # lib/iir_coeff.cpp:150-159) — an interior identity: with clamped
    # borders the two factorizations handle edges differently.
    i = slice(6, -6)
    np.testing.assert_allclose(
        out_12[i, i], out_3xy[i, i], rtol=1e-2, atol=1e-3
    )


def test_bicubic_matches_oracle():
    w = 32
    F = bicubic(w, w, 8)
    img = rf.generate_random_image(w, w, lo=0, hi=1, seed=6)
    out = np.asarray(F.realize(img))
    ref = scan_core.oracle_apply(F.spec, img)
    np.testing.assert_allclose(out, ref.astype(np.float32), rtol=1e-3,
                               atol=1e-4)


def test_biquintic_variants_agree():
    w = 32
    img = rf.generate_random_image(w, w, lo=0, hi=1, seed=7)
    out_o = np.asarray(biquintic_overlapped(w, w, 8).realize(img))
    fc = biquintic_cascaded(w, w, 8)
    out_c = img
    for f in fc:
        out_c = f.realize(out_c)
    np.testing.assert_allclose(np.asarray(out_c), out_o, rtol=1e-3, atol=1e-4)
    ref = scan_core.oracle_apply(
        biquintic_overlapped(w, w, 8).spec, img
    )
    np.testing.assert_allclose(out_o, ref.astype(np.float32), rtol=1e-3,
                               atol=1e-4)


def test_unsharp_mask():
    w = 32
    fn = unsharp_mask(w, w, 8, sigma=2.0, weight=1.0)
    img = rf.generate_random_image(w, w, lo=0, hi=1, seed=8)
    out = np.asarray(fn(img))
    # oracle: (1+w)I - w*blur
    fc = gaussian_3x_3y(w, w, 8, 2.0)
    blur = img.astype(np.float64)
    for f in fc:
        blur = scan_core.oracle_apply(f.spec, blur)
    ref = 2.0 * img - blur
    np.testing.assert_allclose(out, ref, rtol=1e-3, atol=1e-3)


def test_unsharp_mask_fused_equals_naive():
    """The fused-epilogue variant (combine inside the last filter's
    completion matmul) must match the naive post-combine bit-for-bit on
    CPU — same arithmetic, different fusion point."""
    w = 40
    img = rf.generate_random_image(w, w, lo=0, hi=1, seed=9)
    a = np.asarray(unsharp_mask(w, w, 8, sigma=2.0)(img))
    b = np.asarray(unsharp_mask(w, w, 8, sigma=2.0, fused=False)(img))
    np.testing.assert_array_equal(a, b)


def test_unsharp_mask_route_gate():
    """USM's fused builder must take the merged fuse_cascade route (the
    combine as the merged filter's epilogue) at the px grades AND in
    throughput mode ("default"), and the staged epilogue only in the plain
    einsum grades: the staged route's combine cannot fuse into the last
    stage's rotation-restoring transposed-output einsum."""
    from recfilter import planner

    w = 32
    img = rf.generate_random_image(w, w, lo=0, hi=1, seed=8)
    fc = gaussian_3x_3y(w, w, 8, 2.0)
    blur = img.astype(np.float64)
    for f in fc:
        blur = scan_core.oracle_apply(f.spec, blur)
    ref = 2.0 * img - blur

    old = planner._DEFAULT_MATMUL_PRECISION[0]
    try:
        for mode, route, tol in [
            ("px6", "merged", 1e-3),
            ("default", "merged", 1e-2),
            ("highest", "staged", 1e-3),
        ]:
            planner.set_default_matmul_precision(mode)
            fn = unsharp_mask(w, w, 8, sigma=2.0, weight=1.0)
            assert fn.usm_route == route, (mode, fn.usm_route)
            np.testing.assert_allclose(
                np.asarray(fn(img)), ref, rtol=tol, atol=tol)
    finally:
        planner.set_default_matmul_precision(old)


def test_dog_matches_triple_box_oracle_interior():
    """DoG = box³(B1) - box³(B2) in the interior (borders are undefined by
    the apps' zeroed-margin contract, ``box_filter.h:9-11``; the tolerance
    reflects f32 cancellation in the dual-radius subtraction)."""
    from recfilter.apps.box import box_oracle

    w, B1, B2 = 160, 5, 9
    img = rf.generate_random_image(w, w, lo=0, hi=1, seed=21)
    pad = 2 * (B2 + 1) + 1
    img[:pad] = img[-pad:] = 0
    img[:, :pad] = 0
    img[:, -pad:] = 0
    fn = difference_of_gaussians(w, w, B1, B2, tile_width=16)
    got = np.asarray(fn(img))
    want = box_oracle(img, B1, 3) - box_oracle(img, B2, 3)
    m = 3 * (B2 + 1) + 3  # triple-box reach
    scale = np.max(np.abs(want)) + 1e-30
    np.testing.assert_allclose(
        got[m:-m, m:-m] / scale, want[m:-m, m:-m] / scale,
        rtol=0, atol=1e-2,
    )


def test_dog_fir_matches_triple_box_oracle_full_image():
    """FULL-image check, borders included, for the FIR variant.

    With the input margin zeroed wider than the pipeline's total reach
    (3·(B2+1) for three box stages), the banded tile-FIR path's clipped
    windows equal zero-fill convolution at EVERY pixel — including the
    tile-edge and array-edge paths, which the interior test above cannot
    see."""
    from recfilter.apps.box import box_oracle

    w, B1, B2 = 160, 5, 9
    img = rf.generate_random_image(w, w, lo=0, hi=1, seed=22)
    pad = 3 * (B2 + 1) + 2
    img[:pad] = img[-pad:] = 0
    img[:, :pad] = 0
    img[:, -pad:] = 0
    fn = difference_of_gaussians(w, w, B1, B2, tile_width=32,
                                 variant="fir")
    got = np.asarray(fn(img))
    want = box_oracle(img, B1, 3) - box_oracle(img, B2, 3)
    scale = np.max(np.abs(want)) + 1e-30
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=1e-2)


def test_dog_sat_matches_untiled_oracle_full_image():
    """FULL-image check, borders included, for the SAT variant.

    Near the far edge the clamped reads of the GROWING 2nd-order integral
    are not zero-fill convolution — they are the reference formulation's
    own clamp semantics (``diff_gauss.cpp:29-38`` x_clamp). So the border
    oracle is the same six-stage math run UNTILED in f64 (oracle scans +
    numpy clamped shifts); the test pins the tiled/rotated machinery to
    the definitional semantics at every pixel."""
    w, B1, B2 = 96, 3, 5
    img = rf.generate_random_image(w, w, lo=0, hi=1, seed=23)
    pad = 2 * (B2 + 1) + 1
    img[:pad] = img[-pad:] = 0
    img[:, :pad] = 0
    img[:, -pad:] = 0
    fn = difference_of_gaussians(w, w, B1, B2, tile_width=16,
                                 variant="sat")
    got = np.asarray(fn(img))

    def shift_clamped(f, off, ax):
        idx = np.clip(np.arange(f.shape[ax]) + off, 0, f.shape[ax] - 1)
        return np.take(f, idx, axis=ax)

    def diff_xy(f, B):
        g = shift_clamped(f, B, 0) - shift_clamped(f, -B - 1, 0)
        return (shift_clamped(g, B, 1) - shift_clamped(g, -B - 1, 1)) / (
            (2 * B + 1) ** 2
        )

    def ddiff(f, B, ax):
        n = float(2 * B + 1)
        return (
            shift_clamped(f, 2 * B, ax)
            - 2.0 * shift_clamped(f, -1, ax)
            + shift_clamped(f, -2 * B - 2, ax)
        ) / (n * n)

    v = img.astype(np.float64)
    s = v.cumsum(1).cumsum(0)
    g = []
    for B in (B1, B2):
        b = diff_xy(s, B)
        # coeff [1,2,-1] is the 2nd-order integrator == double cumsum
        s2x = b.cumsum(1).cumsum(1)
        b2 = ddiff(s2x, B, 1)
        s2y = b2.cumsum(0).cumsum(0)
        b3 = ddiff(s2y, B, 0)
        g.append(b3)
    want = g[0] - g[1]
    scale = np.max(np.abs(want)) + 1e-30
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=1e-2)


def test_dog_runs_and_is_finite():
    w = 64
    fn = difference_of_gaussians(w, w, B1=2, B2=4, tile_width=8)
    img = rf.generate_random_image(w, w, lo=0, hi=1, seed=9)
    pad = 11
    img[:pad] = img[-pad:] = 0
    img[:, :pad] = 0
    img[:, -pad:] = 0
    out = np.asarray(fn(img))
    assert out.shape == (w, w)
    assert np.isfinite(out).all()
    # DoG of a zero image is zero
    assert np.abs(np.asarray(fn(np.zeros_like(img)))).max() == 0.0


def test_audio_high_order_tiled_equals_nontiled():
    n, order = 5000, 5
    img = rf.generate_random_image(n, lo=0, hi=1, seed=10)
    coeff = [1.0] + [0.01] * order
    Ft = audio_filter_high_order(n, order, 100, tiled=True, coeff=coeff)
    Fn = audio_filter_high_order(n, order, 100, tiled=False, coeff=coeff)
    out_t = np.asarray(Ft.realize(img))
    out_n = np.asarray(Fn.realize(img))
    np.testing.assert_allclose(out_t, out_n, rtol=1e-4, atol=1e-5)


def test_audio_biquads_overlap_equals_cascade():
    """Overlapped n-biquad filter == running the biquad n times
    (the overlap_feedback_coeff identity, audio_filter_biquads.cpp)."""
    n, nb = 2000, 3
    img = rf.generate_random_image(n, lo=0, hi=1, seed=11)
    F = audio_filter_biquads(n, nb, 100, overlapped=True)
    out = np.asarray(F.realize(img))

    from recfilter.spec import Dim, FilterSpec, Scan

    one = FilterSpec(
        "bq", (Dim("x", n),), (Scan(0, True, 1.0, (0.01, 0.01)),)
    )
    ref = img.astype(np.float64)
    for _ in range(nb):
        ref = scan_core.oracle_apply(one, ref)
    np.testing.assert_allclose(out, ref.astype(np.float32), rtol=1e-3,
                               atol=1e-4)
