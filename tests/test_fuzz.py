"""Randomized spec fuzzing: every executor/precision vs the numpy oracle.

The property the whole engine must hold is oracle equivalence (at each
mode's documented grade) for EVERY expressible filter. Round 4 grew this
into a matrix sweep (VERDICT r3 #8): (order 1-4, scans 1-4, mixed
causality) x (clamp/zero) x (pad/exact tiling) x (rot/flat layouts) x
(P 1/3 leading channels) x precision modes x backends, plus 128-wide
tile shapes (the card's tile width), streaming chunkings, the
rotated-layout chain, banded FIR, and the integer limb executor.
Mirrors the reference's awkward-shape oracle doctrine
(``tests/test_generic_xy.cpp:49-113``).
"""

import numpy as np
import pytest

from recfilter import dimfuse, overlap2d, scan_core
from recfilter.spec import BorderMode, Dim, FilterSpec, Scan

# mode -> relative bound vs the f64 oracle (documented grades; "default"
# is XLA's own dot precision — TF32 on the GPU)
_MODE_BOUNDS = {
    "px6": 4e-6,
    "f32x6": 4e-6,
    "highest": 4e-6,
    "px3": 2e-4,
    "f32x3": 2e-4,
    "default": 5e-2,
}


def _rand_scans(rng, ndim, nscan=None, max_order=4):
    nscan = nscan or int(rng.integers(1, 5))
    scans = []
    for _ in range(nscan):
        axis = int(rng.integers(0, ndim))
        order = int(rng.integers(1, max_order))
        a = rng.uniform(-0.9, 0.9, size=order)
        a = a / max(1.0, 1.2 * np.abs(a).sum())
        scans.append(Scan(axis, bool(rng.integers(0, 2)),
                          float(rng.uniform(0.3, 1.4)),
                          tuple(float(v) for v in a)))
    return tuple(scans)


def _random_spec(rng, kernel_geometry=False, channels=1):
    if kernel_geometry:
        # 128-wide tiles (the card's auto tile width), n tiles, optional
        # pad
        ndim = 2
        extents = [int(rng.choice([128, 256, 131, 384]))
                   for _ in range(ndim)]
        tiles = (128, 128)
    else:
        ndim = int(rng.integers(1, 4))
        extents = [int(rng.integers(5, 40)) for _ in range(ndim)]
        tiles = tuple(int(rng.integers(2, 17)) for _ in range(ndim))
    if channels > 1:
        dims = (Dim("c", channels),) + tuple(
            Dim(f"d{i}", e) for i, e in enumerate(extents))
        tiles = (0,) + tiles
        scans = tuple(
            Scan(s.axis + 1, s.causal, s.feedfwd, s.feedback)
            for s in _rand_scans(rng, ndim))
    else:
        dims = tuple(Dim(f"d{i}", e) for i, e in enumerate(extents))
        scans = _rand_scans(rng, ndim)
    border = BorderMode.CLAMP if rng.integers(0, 2) else BorderMode.ZERO
    if border == BorderMode.CLAMP and any(e % t for e, t in
                                          zip(extents, tiles[-ndim:])):
        border = BorderMode.ZERO  # clamp requires exact tiling upstream
    return FilterSpec("Fz", dims, scans, border=border, tile_widths=tiles)


def _check(spec, x, got, bound, ctx=""):
    want = scan_core.oracle_apply(spec, x.astype(np.float64))
    scale = max(1.0, float(np.abs(want).max()))
    err = np.abs(np.asarray(got, np.float64) - want).max() / scale
    assert err <= bound, f"err={err:.3e} bound={bound} {ctx} spec={spec}"


@pytest.mark.parametrize("seed", range(24))
def test_fuzz_precision_backend_matrix(seed):
    """Five random configurations per seed across the precision-mode x
    backend x channels matrix on small awkward shapes (120 cases; the CI
    budget caps the count — each case is a fresh trace)."""
    rng = np.random.default_rng(1000 + seed)
    modes = list(_MODE_BOUNDS)
    for case in range(5):
        channels = 3 if rng.random() < 0.25 else 1
        spec = _random_spec(rng, channels=channels)
        x = rng.standard_normal(
            tuple(d.extent for d in spec.dims)).astype(np.float32)
        mode = modes[int(rng.integers(0, len(modes)))]
        backend = ["einsum", "overlap", "scan"][int(rng.integers(0, 3))]
        bound = _MODE_BOUNDS[mode]
        if backend == "einsum":
            got = dimfuse.apply_filter_fused(spec, x,
                                             matmul_precision=mode)
        elif backend == "overlap":
            got = overlap2d.apply_filter_overlap(spec, x)
        else:
            got = scan_core.apply_filter(spec, x)
            bound = 4e-6  # lax.scan runs true f32
        _check(spec, x, got, bound, ctx=f"mode={mode} backend={backend}")


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_kernel_geometry(seed):
    """128-wide tile shapes through the shipping executor: pad variants,
    P>1 channel groups, each precision grade."""
    rng = np.random.default_rng(2000 + seed)
    channels = 3 if seed % 3 == 0 else 1
    spec = _random_spec(rng, kernel_geometry=True, channels=channels)
    x = (rng.standard_normal(tuple(d.extent for d in spec.dims)) * 0.5
         ).astype(np.float32)
    mode = ["px6", "px3", "default"][seed % 3]
    got = dimfuse.apply_filter_fused(spec, x, matmul_precision=mode)
    _check(spec, x, got, _MODE_BOUNDS[mode], ctx=f"kernel mode={mode}")


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_integer_limbs(seed):
    """Random integer specs: bit-exact through the limb executor where
    its gate admits, bit-exact through the fallback otherwise."""
    rng = np.random.default_rng(3000 + seed)
    ndim = int(rng.integers(1, 3))
    extents = [int(rng.integers(8, 80)) for _ in range(ndim)]
    dims = tuple(Dim(f"d{i}", e) for i, e in enumerate(extents))
    scans = []
    for _ in range(int(rng.integers(1, 4))):
        axis = int(rng.integers(0, ndim))
        order = int(rng.integers(1, 3))
        fb = tuple(int(rng.integers(-2, 3)) for _ in range(order))
        scans.append(Scan(axis, bool(rng.integers(0, 2)),
                          int(rng.integers(1, 3)), fb))
    dtype = ["int32", "int16"][seed % 2]
    border = BorderMode.CLAMP if rng.integers(0, 2) else BorderMode.ZERO
    spec = FilterSpec(
        "FzInt", dims, tuple(scans), border=border, dtype=dtype,
        tile_widths=tuple(int(rng.integers(4, 17)) for _ in range(ndim)),
    )
    hi = 2 ** 14 if dtype == "int16" else 2 ** 28
    x = rng.integers(-hi, hi, size=tuple(extents)).astype(dtype)
    got = np.asarray(dimfuse.apply_filter_fused(spec, x))
    want = scan_core.oracle_apply(spec, x)
    np.testing.assert_array_equal(got, want, err_msg=f"spec={spec}")


@pytest.mark.parametrize("seed", range(10))
def test_random_streamed_matches_oracle(seed):
    """Streaming executor property: any chunking == in-core result."""
    from recfilter import streaming

    rng = np.random.default_rng(7000 + seed)
    spec = _random_spec(rng)
    x = rng.standard_normal(
        tuple(d.extent for d in spec.dims)
    ).astype(np.float32)
    axis = int(rng.integers(0, spec.ndim))
    chunk = int(rng.integers(3, max(4, spec.dims[axis].extent)))
    got = streaming.apply_filter_streamed(spec, x, chunk_axis=axis,
                                          chunk=chunk)
    _check(spec, x, got, 2e-4, ctx=f"chunk_axis={axis} chunk={chunk}")


@pytest.mark.parametrize("seed", range(10))
def test_random_rotated_chain_matches_oracle(seed):
    """Two single-dim filters chained through rotated layouts == natural."""
    rng = np.random.default_rng(8000 + seed)
    h, w = int(rng.integers(6, 30)), int(rng.integers(6, 30))
    dims = (Dim("y", h), Dim("x", w))
    border = BorderMode.CLAMP if rng.integers(0, 2) else BorderMode.ZERO

    def rand_scans(axis):
        out = []
        for _ in range(int(rng.integers(1, 3))):
            order = int(rng.integers(1, 4))
            a = rng.uniform(-0.9, 0.9, size=order)
            a = a / max(1.0, 1.2 * np.abs(a).sum())
            out.append(Scan(axis, bool(rng.integers(0, 2)),
                            float(rng.uniform(0.3, 1.4)),
                            tuple(float(v) for v in a)))
        return tuple(out)

    tiles = (int(rng.integers(2, 12)), int(rng.integers(2, 12)))
    fx = FilterSpec("fx", dims, rand_scans(1), border=border,
                    tile_widths=tiles)
    fy = FilterSpec("fy", dims, rand_scans(0), border=border,
                    tile_widths=tiles)
    x = rng.standard_normal((h, w)).astype(np.float32)

    r = dimfuse.apply_filter_rotated(fx, x, rot_axes=2)       # (x, y)
    r = dimfuse.apply_filter_rotated(fy, r, rot_axes=2)       # (y, x)

    want = x.astype(np.float64)
    for s in fx.scans + fy.scans:
        want = scan_core.oracle_apply_scan(
            want, s.axis, s.causal, s.feedfwd, s.feedback, border
        )
    want = want.astype(np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(
        np.asarray(r) / scale, want / scale, rtol=2e-4, atol=2e-4,
        err_msg=f"fx={fx} fy={fy}",
    )


@pytest.mark.parametrize("seed", range(15))
def test_random_fir_band_matches_oracle(seed):
    """Fuzz the banded-FIR pass: random taps (odd/even support, random
    signs/magnitudes), random extents/rows, every precision grade, both
    layouts — vs the f64 oracle."""
    import jax.numpy as jnp

    from recfilter import fir

    rng = np.random.default_rng(900 + seed)
    K = int(rng.integers(2, 60))
    taps = rng.standard_normal(K) * (10.0 ** rng.integers(-2, 2))
    L = int(rng.integers(130, 700))
    q = int(rng.integers(8, 40))
    x = rng.standard_normal((q, L)).astype(np.float32) * 0.1
    want = fir.fir_oracle(x, taps, 1)
    mode, bound = [("default", 3e-2), ("px3", 1e-3), ("px6", 1e-5)][seed % 3]
    rot = bool(rng.random() < 0.5)
    got = np.asarray(fir.fir_pass_last(
        jnp.asarray(x), taps, tile_width=128, emit_rot=rot,
        matmul_precision=mode))
    if rot:
        got = got.T
    scale_ref = max(np.abs(want).max(), 1e-6)
    assert np.abs(got - want).max() <= bound * scale_ref, (seed, mode)


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_integer_unit_class(seed):
    """Random unit-feedback integer specs (a=±1 and (1∓z)^k products) at
    awkward extents/axes — leading and trailing axes, and chained
    decompositions. Always bit-exact."""
    rng = np.random.default_rng(4000 + seed)
    ndim = int(rng.integers(1, 4))
    extents = [int(rng.integers(5, 97)) for _ in range(ndim)]
    dims = tuple(Dim(f"d{i}", e) for i, e in enumerate(extents))
    banks = [(1,), (-1,), (2, -1), (-2, -1), (0, 1)]
    scans = []
    for _ in range(int(rng.integers(1, 4))):
        scans.append(Scan(
            int(rng.integers(0, ndim)), bool(rng.integers(0, 2)),
            int(rng.integers(1, 4)),
            banks[int(rng.integers(0, len(banks)))],
        ))
    dtype = ["int32", "int16", "int8"][seed % 3]
    spec = FilterSpec(
        "FzUnit", dims, tuple(scans), dtype=dtype,
        tile_widths=tuple(int(rng.integers(4, 17)) for _ in range(ndim)),
    )
    hi = {"int32": 2 ** 28, "int16": 2 ** 14, "int8": 100}[dtype]
    x = rng.integers(-hi, hi, size=tuple(extents)).astype(dtype)
    got = np.asarray(dimfuse.apply_filter_fused(spec, x))
    want = scan_core.oracle_apply(spec, x)
    np.testing.assert_array_equal(got, want, err_msg=f"spec={spec}")


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_multislot_high_order(seed):
    """Carries past ΣK=8 — high-order carries at 128-wide tiles, the
    banded einsum solves, and the hierarchical Kogge–Stone chain — on
    random stable high-order specs vs the oracle at px6 grade."""
    import jax.numpy as jnp

    rng = np.random.default_rng(7000 + seed)
    # (a) 128-wide tiles, 2-D: one dim carries an order-9..19 scan
    w = int(rng.choice([256, 384, 512]))
    order = int(rng.integers(9, 20))
    a = rng.uniform(-1.0, 1.0, order)
    a = a / (1.3 * np.abs(a).sum())
    ax = int(rng.integers(0, 2))
    scans = [Scan(ax, bool(rng.integers(0, 2)),
                  float(rng.uniform(0.5, 1.2)), tuple(map(float, a)))]
    if rng.random() < 0.5:
        scans.append(Scan(1 - ax, True, 1.0, (0.4,)))
    border = BorderMode.CLAMP if rng.integers(0, 2) else BorderMode.ZERO
    spec = FilterSpec("Hz", (Dim("y", 256), Dim("x", w)), tuple(scans),
                      border=border, tile_widths=(128, 128))
    x = (rng.standard_normal((256, w)) * 0.1).astype(np.float32)
    got = dimfuse.apply_filter_fused(spec, x, matmul_precision="px6")
    _check(spec, x, got, 4e-6, ctx=f"multislot2d order={order}")
    # (b) the hierarchical chain at audio-ish scale (level-2 KS solve)
    n = int(rng.integers(120_000, 300_000))
    xb = (rng.standard_normal(n) * 0.1).astype(np.float32)
    s1 = Scan(0, bool(rng.integers(0, 2)), 1.0, tuple(map(float, a)))
    y = dimfuse.hierarchical_dim_pass(jnp.asarray(xb), 0, [s1], border,
                                      "px6")
    if y is not None:  # gates (tiny last segment etc.) may decline
        spec1 = FilterSpec("Hz1", (Dim("x", n),), (s1,), border=border)
        _check(spec1, xb, np.asarray(y), 4e-6,
               ctx=f"hier1d n={n} order={order}")


@pytest.mark.parametrize("seed", range(5))
def test_fuzz_seq_seeded_sharding(seed):
    """The Gdev sequence-sharded route on random 2-D specs over 2-/4-way
    seq meshes, both exchanges, vs the oracle."""
    import jax.numpy as jnp

    from recfilter.parallel import sharding
    from recfilter.planner import Plan

    rng = np.random.default_rng(8000 + seed)
    D = int(rng.choice([2, 4]))
    seq_axis = int(rng.integers(0, 2))
    if seq_axis == 1:
        ext = [256, int(rng.choice([128, 256])) * D]
    else:
        ext = [128 * D, int(rng.choice([256, 384]))]
    scans = []
    for axx in (0, 1):
        for _ in range(int(rng.integers(1, 3))):
            k = int(rng.integers(1, 4))
            a = rng.uniform(-0.9, 0.9, k)
            a = a / max(1.0, 1.3 * np.abs(a).sum())
            scans.append(Scan(axx, bool(rng.integers(0, 2)),
                              float(rng.uniform(0.5, 1.2)),
                              tuple(map(float, a))))
    spec = FilterSpec("SqF", (Dim("y", ext[0]), Dim("x", ext[1])),
                      tuple(scans), tile_widths=(128, 128))
    x = (rng.standard_normal(tuple(ext)) * 0.1).astype(np.float32)
    mesh = sharding.make_mesh((D,), ("seq",))
    exchange = ["gather", "ring"][int(rng.integers(0, 2))]
    got = np.asarray(sharding.sharded_apply_filter(
        spec, Plan(matmul_precision="px6"), mesh,
        jnp.asarray(x), seq_axis=seq_axis, exchange=exchange))
    _check(spec, x, got, 4e-6, ctx=f"seq D={D} ax={seq_axis} {exchange}")
