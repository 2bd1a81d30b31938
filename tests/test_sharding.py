"""Mesh sharding tests on the 8-virtual-device CPU mesh.

The capability the reference lacks (single-GPU only, SURVEY §2.6): data
parallelism over lines and sequence parallelism over the scan dimension with
order-k carry exchange. All results must match the single-device oracle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from recfilter import scan_core
from recfilter.parallel import sharding
from recfilter.planner import Plan
from recfilter.spec import BorderMode, Dim, FilterSpec, Scan

PLAN = Plan()


def _img(*shape, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape).astype(np.float32)


def _spec_2d(scans, tiles=(4, 4), border=BorderMode.ZERO, h=16, w=16):
    return FilterSpec(
        "SH", (Dim("y", h), Dim("x", w)), tuple(scans),
        border=border, tile_widths=tiles,
    )


@pytest.fixture(scope="module")
def devices():
    ds = jax.devices()
    assert len(ds) >= 8, "tests require 8 virtual CPU devices"
    return ds


def test_data_parallel_lines(devices):
    mesh = sharding.make_mesh((8,), ("data",))
    spec = _spec_2d(
        [Scan(1, True, 1.0, (0.5, 0.25)), Scan(1, False, 1.0, (0.4,))]
    )
    img = _img(16, 16, seed=0)
    got = np.asarray(
        sharding.sharded_apply_filter(spec, PLAN, mesh, img, data_axis=0)
    )
    want = scan_core.oracle_apply(spec, img).astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_seq_parallel_single_scan(devices, causal):
    mesh = sharding.make_mesh((4,), ("seq",))
    spec = _spec_2d([Scan(1, causal, 0.9, (0.6, 0.25, -0.1))], w=32)
    img = _img(16, 32, seed=1)
    got = np.asarray(
        sharding.sharded_apply_filter(spec, PLAN, mesh, img, seq_axis=1)
    )
    want = scan_core.oracle_apply(spec, img).astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_seq_parallel_multi_scan(devices):
    mesh = sharding.make_mesh((4,), ("seq",))
    spec = _spec_2d(
        [
            Scan(1, True, 1.0, (0.5, 0.25)),
            Scan(1, False, 1.0, (0.4, 0.2)),
            Scan(0, True, 1.0, (0.3,)),
        ],
        w=32,
    )
    img = _img(16, 32, seed=2)
    got = np.asarray(
        sharding.sharded_apply_filter(spec, PLAN, mesh, img, seq_axis=1)
    )
    want = scan_core.oracle_apply(spec, img).astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_data_and_seq_2d_mesh(devices):
    mesh = sharding.make_mesh((2, 4), ("data", "seq"))
    spec = _spec_2d(
        [Scan(1, True, 1.0, (0.5, 0.25)), Scan(0, True, 1.0, (0.4,))],
        w=32,
    )
    img = _img(16, 32, seed=3)
    got = np.asarray(
        sharding.sharded_apply_filter(
            spec, PLAN, mesh, img, data_axis=0, seq_axis=1
        )
    )
    want = scan_core.oracle_apply(spec, img).astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("causal", [True, False])
def test_seq_parallel_clamp_single_scan(devices, causal):
    """Clamped borders seq-shard: zero-border locals + rank-1 edge
    correction on the edge device (VERDICT r1 item 2)."""
    mesh = sharding.make_mesh((4,), ("seq",))
    spec = _spec_2d(
        [Scan(1, causal, 0.9, (0.6, 0.25))], border=BorderMode.CLAMP, w=32
    )
    img = _img(16, 32, seed=8)
    got = np.asarray(
        sharding.sharded_apply_filter(spec, PLAN, mesh, img, seq_axis=1)
    )
    want = scan_core.oracle_apply(spec, img).astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_seq_parallel_clamp_multi_scan(devices):
    """Gaussian-app shape: mixed causal/anticausal clamped scans on the
    sharded dim plus a scan on the unsharded dim."""
    mesh = sharding.make_mesh((4,), ("seq",))
    spec = _spec_2d(
        [
            Scan(1, True, 0.8, (0.5, 0.2)),
            Scan(1, False, 0.8, (0.5, 0.2)),
            Scan(0, True, 1.0, (0.3,)),
        ],
        border=BorderMode.CLAMP,
        w=32,
    )
    img = _img(16, 32, seed=9)
    got = np.asarray(
        sharding.sharded_apply_filter(spec, PLAN, mesh, img, seq_axis=1)
    )
    want = scan_core.oracle_apply(spec, img).astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_seq_parallel_clamp_integrator(devices):
    """Clamped integrator (non-decaying carries) across 8 devices — the
    hardest case for boundary accuracy."""
    mesh = sharding.make_mesh((8,), ("seq",))
    spec = _spec_2d(
        [Scan(1, True, 1.0, (1.0,)), Scan(1, False, 1.0, (0.5,))],
        border=BorderMode.CLAMP,
        w=64,
    )
    img = _img(8, 64, seed=10)
    got = np.asarray(
        sharding.sharded_apply_filter(spec, PLAN, mesh, img, seq_axis=1)
    )
    want = scan_core.oracle_apply(spec, img).astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_jitted_sharded_filter_gradient(devices):
    """The sharded filter is differentiable end-to-end (deconvolution-style
    training step — no reference analog)."""
    mesh = sharding.make_mesh((2, 2), ("data", "seq"))
    spec = _spec_2d([Scan(1, True, 1.0, (0.5,))], w=32)
    fn = sharding.make_sharded_filter(
        spec, PLAN, mesh, data_axis=0, seq_axis=1
    )
    img = _img(16, 32, seed=4)
    target = _img(16, 32, seed=5)

    def loss(z):
        return ((fn(z) - target) ** 2).mean()

    g = jax.grad(loss)(img)
    assert g.shape == img.shape
    assert np.isfinite(np.asarray(g)).all()
    # numerical check on one coordinate
    eps = 1e-3
    d = np.zeros_like(img)
    d[3, 17] = eps
    fd = (loss(img + d) - loss(img - d)) / (2 * eps)
    np.testing.assert_allclose(np.asarray(g)[3, 17], fd, rtol=2e-2, atol=1e-4)


def test_multichannel_audio_sharded(devices):
    """BASELINE.json config: multi-channel audio IIR, channels + time-blocks
    sharded across the mesh (channels=data, time=seq)."""
    mesh = sharding.make_mesh((2, 4), ("data", "seq"))
    n = 256
    spec = FilterSpec(
        "Audio", (Dim("c", 8), Dim("t", n)),
        (Scan(1, True, 1.0, (0.9, -0.45)),),
        tile_widths=(0, 16),
    )
    img = _img(8, n, seed=20)
    got = np.asarray(
        sharding.sharded_apply_filter(
            spec, PLAN, mesh, img, data_axis=0, seq_axis=1
        )
    )
    want = scan_core.oracle_apply(spec, img).astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_integer_data_parallel_exact(devices):
    """Integer specs shard over non-scanned axes through the exact
    scan_core path (ADVICE r1: the float round-trip truncated)."""
    mesh = sharding.make_mesh((8,), ("data",))
    spec = FilterSpec(
        "IntSAT", (Dim("y", 16), Dim("x", 16)),
        (Scan(1, True, 1, (1,)),),
        dtype="int32",
    )
    rng = np.random.default_rng(7)
    img = rng.integers(-50, 50, size=(16, 16), dtype=np.int32)
    got = np.asarray(
        sharding.sharded_apply_filter(spec, PLAN, mesh, img, data_axis=0)
    )
    want = scan_core.oracle_apply(spec, img)
    np.testing.assert_array_equal(got, want)


def test_integer_seq_parallel_raises(devices):
    mesh = sharding.make_mesh((4,), ("seq",))
    spec = FilterSpec(
        "IntSeq", (Dim("y", 16), Dim("x", 32)),
        (Scan(1, True, 1, (1,)),),
        dtype="int32",
    )
    img = np.ones((16, 32), dtype=np.int32)
    with pytest.raises(NotImplementedError):
        sharding.sharded_apply_filter(spec, PLAN, mesh, img, seq_axis=1)


def test_sharded_gaussian_3xy_matches_oracle(devices):
    """VERDICT r1 acceptance: the flagship clamped-border app seq-shards on
    the 8-device mesh and matches the oracle."""
    from recfilter.apps import gaussian

    mesh = sharding.make_mesh((8,), ("seq",))
    F = gaussian.gaussian_3xy(64, 16, tile_width=8, sigma=3.0)
    spec = F.spec
    img = _img(16, 64, seed=11)
    got = np.asarray(
        sharding.sharded_apply_filter(spec, PLAN, mesh, img, seq_axis=1)
    )
    want = scan_core.oracle_apply(spec, img).astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("causal", [True, False])
def test_ring_exchange_single_scan(devices, causal):
    """Kogge-Stone ppermute exchange matches the all_gather path."""
    mesh = sharding.make_mesh((8,), ("seq",))
    spec = _spec_2d([Scan(1, causal, 0.9, (0.6, 0.25, -0.1))], w=64)
    img = _img(16, 64, seed=30)
    got = np.asarray(
        sharding.sharded_apply_filter(
            spec, PLAN, mesh, img, seq_axis=1, exchange="ring"
        )
    )
    want = scan_core.oracle_apply(spec, img).astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_ring_exchange_multi_scan_clamp(devices):
    """ppermute exchange with H couplings and clamped borders."""
    mesh = sharding.make_mesh((4,), ("seq",))
    spec = _spec_2d(
        [
            Scan(1, True, 0.8, (0.5, 0.2)),
            Scan(1, False, 0.8, (0.5, 0.2)),
        ],
        border=BorderMode.CLAMP,
        w=32,
    )
    img = _img(16, 32, seed=31)
    got = np.asarray(
        sharding.sharded_apply_filter(
            spec, PLAN, mesh, img, seq_axis=1, exchange="ring"
        )
    )
    want = scan_core.oracle_apply(spec, img).astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_ring_exchange_integrator_sat(devices):
    """SAT carries (non-decaying) through the doubling chain."""
    mesh = sharding.make_mesh((8,), ("seq",))
    spec = _spec_2d(
        [Scan(1, True, 1.0, (1.0,)), Scan(0, True, 1.0, (1.0,))], w=64
    )
    img = _img(16, 64, seed=32)
    got = np.asarray(
        sharding.sharded_apply_filter(
            spec, PLAN, mesh, img, seq_axis=1, exchange="ring"
        )
    )
    want = scan_core.oracle_apply(spec, img).astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("exchange", ["gather", "ring"])
@pytest.mark.parametrize("w", [27, 61])
def test_seq_non_dividing_extent(devices, exchange, w):
    """Non-dividing seq extents zero-pad exactly (padded slots are
    zero-input samples in this algebra)."""
    mesh = sharding.make_mesh((4,), ("seq",))
    spec = _spec_2d(
        [Scan(1, True, 1.0, (0.5, 0.25)), Scan(1, False, 1.0, (0.4,))],
        tiles=(4, 4), w=w,
    )
    img = _img(8, w, seed=33)
    got = np.asarray(
        sharding.sharded_apply_filter(
            spec, PLAN, mesh, img, seq_axis=1, exchange=exchange
        )
    )
    want = scan_core.oracle_apply(spec, img).astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("causal", [True, False])
def test_seq_non_dividing_clamp(devices, causal):
    """Clamp + padding: the anticausal clamp edge sits before the pad."""
    mesh = sharding.make_mesh((4,), ("seq",))
    spec = _spec_2d(
        [Scan(1, causal, 0.9, (0.6, 0.25))],
        border=BorderMode.CLAMP, tiles=(4, 4), w=29,
    )
    img = _img(8, 29, seed=34)
    got = np.asarray(
        sharding.sharded_apply_filter(spec, PLAN, mesh, img, seq_axis=1)
    )
    want = scan_core.oracle_apply(spec, img).astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_data_non_dividing_extent(devices):
    mesh = sharding.make_mesh((8,), ("data",))
    spec = _spec_2d([Scan(1, True, 1.0, (0.5, 0.25))], h=13)
    img = _img(13, 16, seed=35)
    got = np.asarray(
        sharding.sharded_apply_filter(spec, PLAN, mesh, img, data_axis=0)
    )
    want = scan_core.oracle_apply(spec, img).astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_distributed_helpers(devices):
    """Single-process degradation of the pod entry points."""
    from recfilter.parallel import distributed

    assert distributed.initialize() in (False, True)
    mesh = distributed.pod_mesh(data=2, seq=4)
    assert mesh.shape == {"data": 2, "seq": 4}
    mesh = distributed.pod_mesh()  # auto-solve covers all devices
    assert int(np.prod(list(mesh.shape.values()))) == len(jax.devices())
    with pytest.raises(ValueError):
        distributed.pod_mesh(data=3, seq=5)


def test_host_sharded_io_roundtrip_and_filter(tmp_path):
    """Host-sharded IO: each shard load sees only its window (no process
    materializes the global array), the sharded array equals the source,
    a sharded filter runs on it directly, and the shard writeback
    reassembles exactly."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from recfilter.parallel import io as pio
    from recfilter.parallel.distributed import pod_mesh
    from recfilter.parallel.sharding import sharded_apply_filter
    from recfilter.planner import Plan
    from recfilter.spec import Dim, FilterSpec, Scan

    mesh = pod_mesh(data=2, seq=4)
    src = np.arange(64 * 96, dtype=np.float32).reshape(64, 96) * 1e-3
    f = tmp_path / "img.npy"
    np.save(f, src)

    windows = []
    mm = np.load(f, mmap_mode="r")
    got = pio.host_sharded_array(
        lambda idx: (windows.append(idx), np.array(mm[idx]))[1],
        src.shape, mesh, P("data", "seq"),
    )
    assert all(
        (w[0].stop - w[0].start, w[1].stop - w[1].start) == (32, 24)
        for w in windows
    )
    np.testing.assert_array_equal(np.asarray(got), src)

    got2 = pio.load_npy_sharded(str(f), mesh, P("data", "seq"))
    np.testing.assert_array_equal(np.asarray(got2), src)

    spec = FilterSpec(
        "IO", (Dim("y", 64), Dim("x", 96)),
        (Scan(1, True, 1.0, (0.5,)), Scan(1, False, 0.9, (0.4,))),
        tile_widths=(8, 8),
    )
    y = sharded_apply_filter(
        spec, Plan(), mesh, got, data_axis=0, seq_axis=1
    )
    from recfilter import scan_core

    want = scan_core.oracle_apply(spec, src.astype(np.float64))
    np.testing.assert_allclose(np.asarray(y), want.astype(np.float32),
                               rtol=1e-4, atol=1e-5)

    paths = pio.save_npy_sharded(y, str(tmp_path / "out"))
    back = pio.assemble_npy_shards(paths, y.shape)
    np.testing.assert_allclose(back, np.asarray(y), rtol=0, atol=0)


def test_data_parallel_shipping_executor_route_and_grade(devices):
    """With no sharded scan dimension, every device runs the COMPLETE
    shipping executor (``dimfuse.apply_filter_fused``) at the Plan's
    default precision. Pins BOTH the route and the numeric grade (px6 f32
    bound, not a loose rtol). Matches the single-execution-path contract
    of ``lib/recfilter.cpp:932-1016``."""
    from recfilter import dimfuse

    mesh = sharding.make_mesh((4,), ("data",))
    spec = FilterSpec(
        "Ship", (Dim("c", 8), Dim("y", 128), Dim("x", 128)),
        (
            Scan(1, True, 1.0, (0.8, -0.2)),
            Scan(1, False, 0.9, (0.5,)),
            Scan(2, True, 1.0, (0.4,)),
        ),
        tile_widths=(0, 128, 128),
    )
    img = _img(8, 128, 128, seed=40)

    taken = []
    orig = dimfuse.apply_filter_fused

    def spy(spec_, x, *a, **k):
        taken.append((x.shape, k.get("matmul_precision")))
        return orig(spec_, x, *a, **k)

    dimfuse.apply_filter_fused = spy
    try:
        got = np.asarray(
            sharding.sharded_apply_filter(
                spec, Plan(), mesh, img, data_axis=0
            )
        )
    finally:
        dimfuse.apply_filter_fused = orig
    # one local shard (8/4 channels) through the shipping executor at px6
    assert taken == [((2, 128, 128), "px6")], taken
    want = scan_core.oracle_apply(spec, img.astype(np.float64))
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 2e-6 * scale  # px6 true-f32 grade


def test_seq_sharded_px6_route_and_grade(devices):
    """Sequence-sharded local passes thread the Plan's precision mode into
    the local executors (not silently HIGHEST), and the end-to-end result
    holds the px6 f32 bound."""
    mesh = sharding.make_mesh((4,), ("seq",))
    spec = FilterSpec(
        "SeqShip", (Dim("y", 128), Dim("x", 512)),
        (
            Scan(1, True, 1.0, (0.8, -0.2)),
            Scan(1, False, 0.9, (0.5,)),
            Scan(0, True, 1.0, (0.4,)),
        ),
        tile_widths=(128, 128),
    )
    img = _img(128, 512, seed=41)

    from recfilter import dimfuse

    seen = []
    orig = sharding._local_apply_dim
    orig_f = dimfuse.apply_filter_fused
    grades = []

    def spy(*a, **k):
        seen.append(k.get("matmul_precision", "highest"))
        return orig(*a, **k)

    def spy_f(spec_, x, *a, **k):
        grades.append(k.get("matmul_precision"))
        return orig_f(spec_, x, *a, **k)

    sharding._local_apply_dim = spy
    dimfuse.apply_filter_fused = spy_f
    try:
        got = np.asarray(
            sharding.sharded_apply_filter(
                spec, Plan(), mesh, img, seq_axis=1
            )
        )
    finally:
        sharding._local_apply_dim = orig
        dimfuse.apply_filter_fused = orig_f
    # the whole local runs the shipping executor at px6, and the deferred
    # carry pass over the unsharded dim too
    assert grades == ["px6"], grades
    assert seen and all(p == "px6" for p in seen), seen
    want = scan_core.oracle_apply(spec, img.astype(np.float64))
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 4e-6 * scale  # px6 grade + exchange


@pytest.mark.parametrize("border", [BorderMode.ZERO, BorderMode.CLAMP])
def test_2d_sequence_sharding(devices, border):
    """VERDICT r3 #5: BOTH scan dimensions sharded (y-seq x x-seq mesh) —
    per-dimension carry exchanges over each dim's own mesh axis; the
    second dim's exchange consumes the first's completed values, so the
    corner coupling is exact. Matches the oracle incl. clamp."""
    mesh = sharding.make_mesh((2, 4), ("seq", "seq2"))
    spec = _spec_2d(
        [
            Scan(1, True, 1.0, (0.5, 0.25)),
            Scan(1, False, 0.9, (0.4,)),
            Scan(0, True, 1.0, (0.6, -0.2)),
            Scan(0, False, 0.8, (0.3,)),
        ],
        border=border, h=32, w=64, tiles=(4, 4),
    )
    img = _img(32, 64, seed=50)
    got = np.asarray(
        sharding.sharded_apply_filter(
            spec, PLAN, mesh, img, seq_axis=0, seq2_axis=1
        )
    )
    want = scan_core.oracle_apply(spec, img.astype(np.float64))
    np.testing.assert_allclose(got, want.astype(np.float32),
                               rtol=2e-4, atol=2e-4)


def test_2d_seq_plus_data_sharding_integrator(devices):
    """(2,2)-seq + data on one mesh; SAT carries (non-decaying) both dims;
    non-dividing extents on both scan axes."""
    mesh = sharding.make_mesh((2, 2, 2), ("data", "seq", "seq2"))
    spec = FilterSpec(
        "S2D", (Dim("c", 6), Dim("y", 27), Dim("x", 45)),
        (Scan(1, True, 1.0, (1.0,)), Scan(2, True, 1.0, (1.0,))),
        tile_widths=(0, 4, 4),
    )
    img = _img(6, 27, 45, seed=51)
    got = np.asarray(
        sharding.sharded_apply_filter(
            spec, PLAN, mesh, img, data_axis=0, seq_axis=1, seq2_axis=2
        )
    )
    want = scan_core.oracle_apply(spec, img.astype(np.float64))
    np.testing.assert_allclose(got, want.astype(np.float32),
                               rtol=2e-4, atol=2e-4)


def test_2d_seq_ring_exchange(devices):
    mesh = sharding.make_mesh((4, 2), ("seq", "seq2"))
    spec = _spec_2d(
        [Scan(0, True, 1.0, (0.7, -0.1)), Scan(1, False, 0.9, (0.5,))],
        h=64, w=32, tiles=(4, 4),
    )
    img = _img(64, 32, seed=52)
    got = np.asarray(
        sharding.sharded_apply_filter(
            spec, PLAN, mesh, img, seq_axis=0, seq2_axis=1, exchange="ring"
        )
    )
    want = scan_core.oracle_apply(spec, img.astype(np.float64))
    np.testing.assert_allclose(got, want.astype(np.float32),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("exchange", ["gather", "ring"])
@pytest.mark.parametrize("border", [BorderMode.ZERO, BorderMode.CLAMP])
def test_exchange_overlap_deferral(exchange, border):
    """The carry injection of a sharded scan dimension defers past later
    LOCAL dimension passes (exchange/compute overlap — the collective's
    result is consumed only at the end; every operator is linear, so the
    correction runs through the same local passes carry-sized). Must match
    the oracle, and the deferral must actually engage."""
    from recfilter.parallel import sharding as sh

    mesh = sh.make_mesh((4,), ("seq",))
    spec = FilterSpec(
        "OVL",
        (Dim("y", 24), Dim("x", 32)),
        (
            Scan(1, True, 1.0, (0.5, 0.2)),
            Scan(1, False, 0.9, (0.4,)),
            Scan(0, True, 1.0, (0.3, 0.1)),
        ),
        border=border,
        tile_widths=(4, 4),
    )
    x = np.random.default_rng(11).standard_normal((24, 32)).astype(np.float32)

    calls = []
    orig = sh._apply_seq_corr

    def spy(y, axis, Rsel, N):
        calls.append(axis)
        return orig(y, axis, Rsel, N)

    sh._apply_seq_corr = spy
    try:
        got = np.asarray(
            sh.sharded_apply_filter(
                spec, Plan(), mesh, jnp.asarray(x),
                seq_axis=1, exchange=exchange,
            )
        )
    finally:
        sh._apply_seq_corr = orig
    # one injection, after the y-dimension local pass (deferral engaged)
    assert calls == [1]
    want = scan_core.oracle_apply(spec, x.astype(np.float64))
    np.testing.assert_allclose(got, want.astype(np.float32),
                               rtol=2e-4, atol=2e-4)


def test_sharded_kernel_route_gradient(devices):
    """``jax.grad`` through the sharded SHIPPING executor (px6 split
    products inside shard_map) must compute. A jnp constant materialized
    inside the shard_map trace as a custom-VJP closure leaks a tracer into
    the linearized jaxpr ("No constant handler for DynamicJaxprTracer");
    the split constants therefore stay numpy (``dimfuse._split_einsum``).
    Pins grad availability AND its f32 grade vs the unsharded executor on
    both routes."""
    from recfilter import dimfuse

    spec = FilterSpec(
        "GradShip", (Dim("c", 8), Dim("y", 128), Dim("x", 128)),
        (Scan(1, True, 0.7, (0.3,)), Scan(2, True, 0.7, (0.3,))),
        tile_widths=(0, 128, 128),
    )
    img = jnp.asarray(_img(8, 128, 128, seed=60))

    def ref_loss(z):
        y = dimfuse.apply_filter_fused(spec, z, matmul_precision="px6")
        return (y ** 2).mean()

    g_ref = jax.grad(ref_loss)(img)
    scale = float(jnp.abs(g_ref).max())
    for kw, mesh in (
        ({"data_axis": 0}, sharding.make_mesh((4,), ("data",))),
        ({"seq_axis": 1}, sharding.make_mesh((4,), ("seq",))),
    ):
        fn = sharding.make_sharded_filter(
            spec, Plan(), mesh, **kw)
        g = jax.grad(lambda z: (fn(z) ** 2).mean())(img)
        assert float(jnp.abs(g - g_ref).max()) <= 4e-6 * scale, kw


def test_integer_data_parallel_unit_kernels(devices):
    """Data-parallel integer shards take the wrapping additive route
    inside shard_map (the same single-device unit route), bit-exact."""
    from recfilter import dimfuse

    spec = FilterSpec(
        "IntShip", (Dim("c", 8), Dim("y", 256), Dim("x", 256)),
        (Scan(1, True, 1, (1,)), Scan(2, True, 1, (2, -1))),
        dtype="int32", tile_widths=(0, 128, 128),
    )
    img = np.random.default_rng(70).integers(
        -2 ** 20, 2 ** 20, (8, 256, 256)).astype(np.int32)
    mesh = sharding.make_mesh((4,), ("data",))
    calls = []
    orig = dimfuse.int_unit_dim_pass

    def spy(x, units, axis):
        calls.append(axis)
        return orig(x, units, axis)

    dimfuse.int_unit_dim_pass = spy
    try:
        got = np.asarray(
            sharding.sharded_apply_filter(
                spec, Plan(), mesh, jnp.asarray(img),
                data_axis=0,
            )
        )
    finally:
        dimfuse.int_unit_dim_pass = orig
    assert calls and sorted(set(calls)) == [1, 2], calls
    want = scan_core.oracle_apply(spec, img)
    np.testing.assert_array_equal(got, np.asarray(want).astype(np.int32))


@pytest.mark.parametrize("exchange", ["gather", "ring"])
def test_seq_sharded_3touch_executor(devices, exchange):
    """2-D filters with one sequence-sharded scan dimension run their
    ENTIRE device-local work through the shipping executor
    (``apply_filter_fused`` spied), with the sharded dim's carries
    extracted straight from the input by the Gdev einsum and one deferred
    injection — oracle-exact at f32 grade, grad included."""
    from recfilter import dimfuse
    from recfilter.parallel import sharding as sh

    rng = np.random.default_rng(11)
    spec = FilterSpec(
        "S3T", (Dim("y", 256), Dim("x", 512)),
        (Scan(0, True, 1.0, (0.5, 0.2)), Scan(0, False, 0.9, (0.3,)),
         Scan(1, True, 0.8, (0.4,)), Scan(1, False, 0.8, (0.4,))),
        tile_widths=(128, 128),
    )
    x = rng.standard_normal((256, 512)).astype(np.float32)
    mesh = sh.make_mesh((4,), ("seq",))

    fcalls, kcalls = [], []
    orig_f = sh._seq_fused2d
    orig_k = dimfuse.apply_filter_fused

    def spy_f(*a, **k):
        r = orig_f(*a, **k)
        fcalls.append(r is not None)
        return r

    def spy_k(*a, **k):
        kcalls.append(1)
        return orig_k(*a, **k)

    sh._seq_fused2d = spy_f
    dimfuse.apply_filter_fused = spy_k
    try:
        fn = sh.make_sharded_filter(
            spec, Plan(matmul_precision="px6"), mesh,
            seq_axis=1, exchange=exchange)
        got = np.asarray(fn(jnp.asarray(x)))
    finally:
        sh._seq_fused2d = orig_f
        dimfuse.apply_filter_fused = orig_k
    assert fcalls == [True], fcalls  # fast path engaged
    assert kcalls, "locals must ride the shipping executor"
    want = scan_core.oracle_apply(spec, x.astype(np.float64))
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 5e-6 * scale

    g = jax.grad(lambda z: (fn(z) ** 2).mean())(jnp.asarray(x))
    g_ref = jax.grad(lambda z: (dimfuse.apply_filter_fused(
        spec, z, matmul_precision="px6") ** 2).mean())(jnp.asarray(x))
    gs = float(jnp.abs(g_ref).max())
    assert float(jnp.abs(g - g_ref).max()) <= 4e-6 * gs
