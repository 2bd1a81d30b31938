"""RecFilter builder API surface tests (reference parity checks)."""

import numpy as np
import pytest

import recfilter as rf
from recfilter import graph, scan_core


def _sat(w=16, t=4):
    x = rf.Dim("x", w)
    y = rf.Dim("y", w)
    F = rf.RecFilter("S")
    F[y, x] = np.ones((w, w), dtype=np.float32)
    F.add_filter(+x, [1.0, 1.0])
    F.add_filter(+y, [1.0, 1.0])
    F.split(x, t, y, t)
    return F, x, y


def test_define_shape_mismatch_raises():
    x = rf.Dim("x", 8)
    F = rf.RecFilter("F")
    with pytest.raises(ValueError):
        F[x] = np.ones(9, dtype=np.float32)


def test_add_filter_requires_definition():
    F = rf.RecFilter("F")
    with pytest.raises(RuntimeError):
        F.add_filter(+rf.Dim("x", 8), [1.0, 1.0])


def test_add_filter_unknown_dim_raises():
    x = rf.Dim("x", 8)
    z = rf.Dim("z", 8)
    F = rf.RecFilter("F")
    F[x] = np.ones(8, dtype=np.float32)
    with pytest.raises(ValueError):
        F.add_filter(+z, [1.0, 1.0])


def test_add_filter_needs_two_coeffs():
    x = rf.Dim("x", 8)
    F = rf.RecFilter("F")
    F[x] = np.ones(8, dtype=np.float32)
    with pytest.raises(ValueError):
        F.add_filter(+x, [1.0])


def test_bare_dim_is_causal():
    x = rf.Dim("x", 8)
    F = rf.RecFilter("F")
    F[x] = np.ones(8, dtype=np.float32)
    F.add_filter(x, [1.0, 1.0])
    assert F.spec.scans[0].causal


def test_split_dict_form():
    F, x, y = _sat()
    F.split({x: 8})
    assert F.spec.tile_widths == (4, 8)  # y stays, x updated


def test_define_from_callable():
    x = rf.Dim("x", 6)
    y = rf.Dim("y", 4)
    F = rf.RecFilter("Ramp")
    F[x, y] = lambda i, j: (i + 10 * j).astype(np.float32)
    assert F.spec.dims[0].extent == 6
    img = np.asarray(F._image)
    assert img[3, 2] == 23


def test_realize_and_func_stages():
    F, x, y = _sat()
    out = np.asarray(F.realize())
    ref = scan_core.oracle_apply(F.spec, np.ones((16, 16), np.float32))
    np.testing.assert_allclose(out, ref, rtol=1e-5)

    stages = graph.build_graph(F.spec)
    names = [s.name for s in stages]
    # reference naming scheme: Intra / CTail / Final per tiled scan
    assert any("Intra" in n for n in names)
    assert any("CTail" in n for n in names)
    # evaluating an internal stage works (RecFilter::func parity)
    final_x = [n for n in names if n.startswith("S_Final")][0]
    mid = np.asarray(F.func(final_x))
    ref_x = scan_core.oracle_apply_scan(
        np.ones((16, 16), np.float32), 1, True, 1.0, [1.0]
    )
    np.testing.assert_allclose(mid, ref_x, rtol=1e-5)


def test_print_functions_and_synopsis_and_code():
    F, _, _ = _sat()
    s = F.print_synopsis()
    assert "scan 0" in s
    fns = F.print_functions()
    assert "INTRA_N" in fns and "INTER" in fns
    code = F.print_hl_code()
    assert "add_filter" in code and "split" in code


def test_schedule_handles_record_and_map():
    F, _, _ = _sat()
    F.intra_schedule(1).compute_locally().unroll(F.inner_scan()).gpu_threads(
        F.inner(0), F.inner(1)
    ).gpu_blocks(F.outer(0), F.outer(1))
    F.inter_schedule().compute_globally().unroll(F.outer_scan())
    log = F.print_schedule()
    assert "compute_locally" in log and "gpu_threads" in log
    # compute_locally is a recorded no-op (XLA fuses the intra stages);
    # compute_globally on an inter schedule selects nothing either
    assert F.plan.backend == "auto"
    # Mapping report: every directive says what it did — a Plan knob, or
    # why XLA subsumes it. Never a silent no-op.
    assert "XLA fuses the intra-tile stages" in log
    assert "no-op" in log  # gpu_threads/gpu_blocks carry the reason
    assert "XLA owns the thread placement" in log
    F.intra_schedule(1).compute_globally()
    assert F.plan.backend == "einsum"
    assert "-> Plan.backend='einsum'" in F.print_schedule()
    with pytest.raises(RuntimeError):
        F.full_schedule()  # tiled filter has no full schedule


def test_cascade_legality():
    w = 8
    x = rf.Dim("x", w)
    F = rf.RecFilter("C")
    F[x] = np.ones(w, dtype=np.float32)
    F.add_filter(+x, [1.0, 0.5])
    F.add_filter(-x, [1.0, 0.4])
    # swapping opposite-causality scans in the same dim is illegal
    with pytest.raises(ValueError):
        F.cascade([1], [0])
    # dropping or duplicating a scan is illegal
    with pytest.raises(ValueError):
        F.cascade([0])
    with pytest.raises(ValueError):
        F.cascade([0, 1], [1])


def test_cascade_by_causality():
    w = 8
    x = rf.Dim("x", w)
    y = rf.Dim("y", w)
    F = rf.RecFilter("C")
    F[y, x] = np.ones((w, w), dtype=np.float32)
    F.add_filter(+x, [1.0, 0.5])
    F.add_filter(-x, [1.0, 0.4])
    F.add_filter(+y, [1.0, 0.3])
    fc = F.cascade_by_causality()
    assert len(fc) == 2
    assert all(s.causal for s in fc[0].spec.scans)
    assert not any(s.causal for s in fc[1].spec.scans)
    # chained realize reproduces the original
    out = np.asarray(fc[-1].realize())
    ref = scan_core.oracle_apply(F.spec, np.ones((w, w), np.float32))
    np.testing.assert_allclose(out, ref, rtol=1e-4)


def test_overlap_to_higher_order():
    """cascaded f1∘f2 == overlapped higher-order filter
    (tests/test_overlap_filter_order.cpp:20-42)."""
    w = 16
    img = rf.generate_random_image(w, lo=0, hi=1, seed=0)
    x1 = rf.Dim("x", w)
    A = rf.RecFilter("A")
    A[x1] = img
    A.add_filter(+x1, [1.0, 0.5])
    B = rf.RecFilter("B")
    B[x1] = img
    B.add_filter(+x1, [1.0, 0.3, -0.1])
    O = A.overlap_to_higher_order_filter(B)
    assert O.spec.scans[0].order == 3
    out_o = np.asarray(O.realize(img))
    mid = np.asarray(A.realize(img))
    out_c = np.asarray(B.realize(mid))
    np.testing.assert_allclose(out_o, out_c, rtol=1e-4, atol=1e-5)


def test_overlap_mismatch_raises():
    w = 16
    x1 = rf.Dim("x", w)
    A = rf.RecFilter("A")
    A[x1] = np.ones(w, np.float32)
    A.add_filter(+x1, [1.0, 0.5])
    B = rf.RecFilter("B")
    B[x1] = np.ones(w, np.float32)
    B.add_filter(-x1, [1.0, 0.3])
    with pytest.raises(ValueError):
        A.overlap_to_higher_order_filter(B)


def test_compile_jit_dumps_hlo(tmp_path):
    F, _, _ = _sat()
    path = tmp_path / "lowered.txt"
    fn = F.compile_jit(str(path))
    assert path.exists() and path.stat().st_size > 0
    out = fn(np.ones((16, 16), np.float32))
    assert np.asarray(out).shape == (16, 16)


def test_clamp_after_scans_raises():
    w = 8
    x = rf.Dim("x", w)
    F = rf.RecFilter("F")
    F[x] = np.ones(w, np.float32)
    F.add_filter(+x, [1.0, 0.5])
    with pytest.raises(RuntimeError):
        F.set_clamped_image_border()


def test_filter_under_vmap():
    """Filters compose with jax.vmap over a batch axis."""
    import jax

    F, _, _ = _sat()
    fn = F.as_func()
    batch = np.stack([np.ones((16, 16), np.float32) * (i + 1) for i in range(3)])
    out = np.asarray(jax.vmap(fn)(batch))
    ref0 = scan_core.oracle_apply(F.spec, batch[0])
    np.testing.assert_allclose(out[0], ref0, rtol=1e-4)
    np.testing.assert_allclose(out[2], 3 * ref0, rtol=1e-4)


def test_overlap_backend_through_api():
    F, _, _ = _sat()
    F.set_plan(backend="overlap")
    out = np.asarray(F.realize())
    ref = scan_core.oracle_apply(F.spec, np.ones((16, 16), np.float32))
    np.testing.assert_allclose(out, ref, rtol=1e-4)
    # the removed kernel backends are unknown names now
    for gone in ("overlap_k", "pallas"):
        F.set_plan(backend=gone)
        with pytest.raises(ValueError):
            F.realize()


def test_spec_json_roundtrip():
    from recfilter import spec_from_json, spec_to_json

    F, _, _ = _sat()
    text = spec_to_json(F.spec)
    back = spec_from_json(text)
    assert back == F.spec
    # a reloaded spec executes identically
    from recfilter import dimfuse

    img = np.ones((16, 16), np.float32)
    a = np.asarray(dimfuse.apply_filter_fused(F.spec, img))
    b = np.asarray(dimfuse.apply_filter_fused(back, img))
    np.testing.assert_array_equal(a, b)


def test_tuple_outputs_first_class():
    """Tuple definitions (Halide ``Tuple(expr, ...)``): every scan applies
    to each component; as_func takes/returns component tuples."""
    import jax.numpy as jnp
    from recfilter import RecFilter, Dim

    rng = np.random.default_rng(11)
    a = rng.standard_normal((12, 16)).astype(np.float32)
    b = rng.standard_normal((12, 16)).astype(np.float32)
    x, y = Dim("x", 16), Dim("y", 12)
    F = RecFilter("TupSAT")
    F[y, x] = (a, b)
    F.add_filter(+x, [1.0, 1.0])
    F.add_filter(+y, [1.0, 1.0])
    F.split(x, 4, y, 4)
    out = F.as_func()((a, b))
    assert isinstance(out, tuple) and len(out) == 2
    for comp, src in zip(out, (a, b)):
        want = src.cumsum(1).cumsum(0)
        np.testing.assert_allclose(np.asarray(comp), want, rtol=1e-4, atol=1e-3)
    # realize() uses the bound (stacked) tuple image
    r = F.realize()
    np.testing.assert_allclose(np.asarray(r[0]), out[0], rtol=1e-6)

    # spec JSON round-trips tuple_width
    from recfilter import spec_from_json, spec_to_json

    back = spec_from_json(spec_to_json(F.spec))
    assert back.tuple_width == 2

    # cascade_by_dimension preserves Tuple outputs
    fc = F.cascade_by_dimension()
    v = (a, b)
    for f in fc:
        v = f.as_func()(v)
    np.testing.assert_allclose(np.asarray(v[1]), out[1], rtol=1e-4, atol=1e-3)


def test_rotate_emit_survives_backend_fallback():
    """Plan.rotate_emit is a layout CONTRACT — it must hold even when the
    spec is untiled or integer-typed (backend fallback paths)."""
    from recfilter import RecFilter, Dim

    x, y = Dim("x", 8), Dim("y", 6)
    img = np.arange(48, dtype=np.float32).reshape(6, 8)
    F = RecFilter("RotFallback")
    F[y, x] = img  # untiled → resolve_backend would pick "scan"
    F.add_filter(+x, [1.0, 1.0])
    F.set_plan(rotate_emit=2)
    out = np.asarray(F.as_func()(img))
    assert out.shape == (8, 6)
    np.testing.assert_allclose(out, img.cumsum(1).T, rtol=1e-5)

    Fi = RecFilter("RotInt")
    Fi[y, x] = img.astype(np.int32)
    Fi.add_filter(+x, [1, 1])
    Fi.split(x, 4)
    Fi.set_plan(rotate_emit=2)
    outi = np.asarray(Fi.as_func()(img.astype(np.int32)))
    assert outi.shape == (8, 6)
    np.testing.assert_array_equal(outi, img.astype(np.int32).cumsum(1).T)


def test_as_func_epilogue_fuses_elementwise():
    """as_func(epilogue=...) — the combine lands inside the last dim pass
    (einsum backend) and must be exact on every path: tiled 2-D with
    non-dividing width (pad projector), rotated emit, and scan fallback."""
    from recfilter import RecFilter, Dim

    rng = np.random.default_rng(3)
    h, w = 24, 21  # 21 does not divide by 8 → pad path
    img = rng.standard_normal((h, w)).astype(np.float32)
    aux = rng.standard_normal((h, w)).astype(np.float32)

    x, y = Dim("x", w), Dim("y", h)
    F = RecFilter("EpiSAT")
    F[y, x] = img
    F.add_filter(+x, [1.0, 1.0])
    F.add_filter(+y, [1.0, 1.0])
    F.split(x, 8, y, 8)
    base = np.asarray(F.as_func()(img))
    out = np.asarray(F.as_func(lambda o, a: o * 0.5 + a)(img, aux))
    np.testing.assert_array_equal(out, base * 0.5 + aux)

    # rotated emit: aux must be supplied in the rotated (transposed) layout
    Fx = RecFilter("EpiRot")
    Fx[y, x] = img
    Fx.add_filter(+x, [1.0, 0.5])
    Fx.split(x, 8)
    Fx.set_plan(rotate_emit=2)
    base_r = np.asarray(Fx.as_func()(img))           # (w, h)
    auxr = rng.standard_normal((w, h)).astype(np.float32)
    out_r = np.asarray(Fx.as_func(lambda o, a: o - a)(img, auxr))
    np.testing.assert_array_equal(out_r, base_r - auxr)

    # integer / scan-backend fallback still applies the combine
    Fi = RecFilter("EpiInt")
    Fi[y, x] = img.astype(np.int32)
    Fi.add_filter(+x, [1, 1])
    outi = np.asarray(Fi.as_func(lambda o, a: o + a)(
        img.astype(np.int32), aux.astype(np.int32)))
    ref = img.astype(np.int32).cumsum(1) + aux.astype(np.int32)
    np.testing.assert_array_equal(outi, ref)


def test_fuse_cascade_equals_stage_composition():
    """fuse_cascade must equal running the cascade stage by stage — for
    both zero and clamped borders (per-scan border semantics make the
    merged scan list exactly the sequential composition)."""
    import jax.numpy as jnp
    import numpy as np

    from recfilter import api
    from recfilter.apps.gaussian import gaussian_3x_3y

    img = jnp.asarray(
        np.random.default_rng(7).standard_normal((96, 96)).astype(np.float32)
    )
    for tile in (16, 32):
        fc = gaussian_3x_3y(96, 96, tile)
        staged = img
        for f in fc:
            staged = f.as_func()(staged)
        fused = api.fuse_cascade(fc)(img)
        np.testing.assert_allclose(
            np.asarray(fused), np.asarray(staged), rtol=1e-5, atol=1e-5
        )


def test_fuse_cascade_validation():
    import numpy as np
    import pytest as _pytest

    from recfilter import api
    from recfilter.api import RecFilter
    from recfilter.spec import Dim

    x = Dim("x", 16)
    y = Dim("y", 16)
    a = RecFilter("A"); a[y, x] = np.zeros((16, 16), np.float32)
    a.add_filter(+x, [1.0, 0.5])
    b = RecFilter("B"); b[y, x] = np.zeros((16, 16), np.float32)
    b.set_clamped_image_border()
    b.add_filter(+y, [1.0, 0.5])
    with _pytest.raises(ValueError):
        api.fuse_cascade([a, b])  # border mismatch


def test_func_stages_match_shipping_executor():
    """VERDICT r2 #6: func("..CTail..") must equal the dimfuse combined
    N-solve for a tiled 2-scan filter, TDeps the H-coupling, and the last
    Final the shipping executor's output."""
    import jax.numpy as jnp

    from recfilter import dimfuse

    h, w, T = 24, 20, 5
    x = rf.Dim("x", w)
    y = rf.Dim("y", h)
    F = rf.RecFilter("DBG")
    img = np.random.default_rng(3).standard_normal((h, w)).astype(np.float32)
    F[y, x] = img
    F.add_filter(+x, [1.0, 0.5, 0.2])
    F.add_filter(-x, [0.9, 0.4])
    F.split(x, T)
    spec = F.spec
    scans = list(spec.scans)

    # hand-computed combined solve (the shipping algebra)
    n = w // T
    mats = dimfuse.prepare_dim_pass(scans, T, n, False)
    X = jnp.asarray(img).reshape(h, n, T)
    hi = __import__("jax").lax.Precision.HIGHEST
    braw = [
        jnp.einsum("os,ans->ano", jnp.asarray(g[0], jnp.float32), X,
                   precision=hi)
        for g in mats.G
    ]
    CM0 = jnp.asarray(mats.CM[0], jnp.float32)
    N0 = jnp.einsum("ls,ts->lt", braw[0].reshape(h, -1), CM0,
                    precision=hi).reshape(h, n, 2)
    got_ct0 = np.asarray(F.func("DBG_Intra_CTail_x_0"))
    np.testing.assert_allclose(np.asarray(N0), got_ct0, rtol=1e-5, atol=1e-6)

    # scan 1's TDeps is the H-coupling of scan 0's carries
    td = jnp.einsum("oj,anj->ano", jnp.asarray(mats.H[1][0][0], jnp.float32),
                    N0, precision=hi)
    got_td = np.asarray(F.func("DBG_Intra_TDeps_x_a1"))
    np.testing.assert_allclose(np.asarray(td), got_td, rtol=1e-5, atol=1e-6)

    # the last Final equals the shipping executor's output
    got_final = np.asarray(F.func("DBG_Final_x_a1"))
    want = np.asarray(F.as_func()(jnp.asarray(img)))
    np.testing.assert_allclose(got_final, want, rtol=1e-5, atol=1e-5)

    # graph carries the full reference stage vocabulary
    names = [s.name for s in rf.graph.build_graph(spec)]
    assert "DBG_Intra_TDeps_x_a1" in names
    assert "DBG_Deps_x_0" in names


def test_print_hl_code_replays_plan():
    """VERDICT r2 #9: the re-runnable dump reconstructs the Plan
    (backend/precision/rotate_emit), so a dumped program reproduces
    performance, not just semantics — round-trip re-executes with the
    same resolved backend and matches numerically."""
    import io
    import contextlib

    import jax.numpy as jnp

    w = 24
    x = rf.Dim("x", w)
    y = rf.Dim("y", w)
    F = rf.RecFilter("RT")
    img = np.random.default_rng(5).standard_normal((w, w)).astype(np.float32)
    F[y, x] = img
    F.add_filter(+x, [1.0, 0.5])
    F.add_filter(+y, [1.0, 0.4])
    F.split(x, 8, y, 8)
    F.set_plan(backend="overlap", matmul_precision="px3")
    with contextlib.redirect_stdout(io.StringIO()):
        code = F.print_hl_code()
    assert "set_plan(" in code and "backend='overlap'" in code \
        and "matmul_precision='px3'" in code
    ns = {"image": img}
    exec(code, ns)
    F2 = ns["F"]
    assert F2._plan.backend == "overlap"
    assert F2._plan.matmul_precision == "px3"
    np.testing.assert_allclose(
        np.asarray(F2.as_func()(jnp.asarray(img))),
        np.asarray(F.as_func()(jnp.asarray(img))),
        rtol=1e-5, atol=1e-5,
    )

    # a default-plan filter round-trips without any set_plan line
    G = rf.RecFilter("RT2")
    G[y, x] = img
    G.add_filter(+x, [1.0, 0.5])
    with contextlib.redirect_stdout(io.StringIO()):
        assert "set_plan" not in G.print_hl_code()


def test_compute_at_routes_to_fusion_machinery():
    """VERDICT r3 #6: ``compute_at(consumer, level)`` dispatches to the
    REAL fusion machinery — elementwise consumers become the executor
    epilogue (in-kernel combine), tap banks become stencil2d fusion, an
    outer level or a non-elementwise consumer composes under jit with the
    reason recorded. Matches ``lib/recfilter.cpp:507-573`` /
    ``apps/usm/unsharp_mask_optimized.cpp:61-71``."""
    import jax.numpy as jnp

    w = 64
    img = np.random.default_rng(3).standard_normal((w, w)).astype(np.float32)

    def build():
        x = rf.Dim("x", w)
        y = rf.Dim("y", w)
        F = rf.RecFilter("CA")
        F[y, x] = np.zeros((w, w), np.float32)
        wts = rf.gaussian_weights(3.0, 3)
        F.add_filter(+x, wts)
        F.add_filter(-x, wts)
        F.add_filter(+y, wts)
        F.add_filter(-y, wts)
        F.split(x, 16, y, 16)
        return F

    def combine(blur, image):
        return 2.0 * image - 1.0 * blur

    # USM-style elementwise consumer -> epilogue fusion (the fused route)
    F = build()
    fn = F.compute_at(combine)
    assert fn.fused_route == "epilogue"
    assert any("epilogue fusion" in line for line in F._schedule_log)
    got = np.asarray(fn(jnp.asarray(img), jnp.asarray(img)))
    want = 2.0 * img - scan_core.oracle_apply(
        F.spec, img.astype(np.float64)).astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)

    # inner level tags fuse; outer level tags force HBM materialization
    assert build().compute_at(combine, level="intra").fused_route \
        == "epilogue"
    f_outer = build().compute_at(combine, level="outer")
    assert f_outer.fused_route == "composed"
    np.testing.assert_allclose(
        np.asarray(f_outer(jnp.asarray(img), jnp.asarray(img))), want,
        rtol=2e-5, atol=2e-5)

    # non-elementwise consumer -> recorded jit composition
    F3 = build()
    f3 = F3.compute_at(lambda b: b.T)
    assert f3.fused_route == "composed"
    assert any("not provably elementwise" in line
               for line in F3._schedule_log)

    # 2-D tap bank -> stencil2d fusion (per-channel tuple out)
    f4 = build().compute_at([[(0, 0, 1.0), (1, 0, -1.0)]])
    assert f4.fused_route == "stencil2d"
    out = f4(jnp.asarray(img))
    assert isinstance(out, tuple) and out[0].shape == (w, w)

    # unknown level tags are rejected, not ignored
    with pytest.raises(ValueError):
        build().compute_at(combine, level="banana")


def test_compute_at_preserves_consumer_dtype_and_outer_bank():
    """Round-4 review fixes: (1) a dtype-changing elementwise consumer
    (comparison, cast) must NOT take the epilogue route — the fused
    executor emits in the filter's dtype, so ``consumer(filter(x))``
    semantics require jit composition; (2) a tap-bank consumer at an
    OUTER level composes (compute_root analog) instead of silently fusing
    in-kernel."""
    import jax.numpy as jnp

    w = 64
    img = np.random.default_rng(7).standard_normal((w, w)).astype(np.float32)

    def build():
        x = rf.Dim("x", w)
        y = rf.Dim("y", w)
        F = rf.RecFilter("CAdt")
        F[y, x] = np.zeros((w, w), np.float32)
        wts = rf.gaussian_weights(3.0, 3)
        F.add_filter(+x, wts)
        F.add_filter(+y, wts)
        F.split(x, 16, y, 16)
        return F

    # dtype-changing consumers route to composition and keep their dtype
    f_bool = build().compute_at(lambda b: b > 0.1)
    assert f_bool.fused_route == "composed"
    out = f_bool(jnp.asarray(img))
    assert out.dtype == jnp.bool_
    blur = scan_core.oracle_apply(
        build().spec, img.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(out), blur > 0.1)

    f_cast = build().compute_at(lambda b: b.astype(jnp.bfloat16))
    assert f_cast.fused_route == "composed"
    assert f_cast(jnp.asarray(img)).dtype == jnp.bfloat16

    # dtype-preserving consumers still fuse as the epilogue
    assert build().compute_at(lambda b: 2.0 * b).fused_route == "epilogue"

    # tap bank at an outer level: composed, same values as the fused route
    bank = [[(0, 0, 1.0), (1, 0, -1.0)]]
    f_fused = build().compute_at(bank)
    f_outer = build().compute_at(bank, level="outer")
    assert f_fused.fused_route == "stencil2d"
    assert f_outer.fused_route == "composed"
    a = np.asarray(f_fused(jnp.asarray(img))[0])
    b = np.asarray(f_outer(jnp.asarray(img))[0])
    np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-5)


def test_tuple_epilogue_linear_folds_and_staged():
    """Round-5 (VERDICT r4 #6): Tuple filters take epilogues. A LINEAR
    scalar combine (the DoG-style dual-component subtraction,
    ``apps/DoG/diff_gauss.cpp:84-110``) commutes with the filter and folds
    into the INPUT — one single-channel pass on the shipping executor, no
    separate combine stream; a nonlinear combine runs staged. Both match
    the component-wise oracle."""
    from recfilter import Dim, RecFilter, dimfuse, planner

    rng = np.random.default_rng(12)
    w = 256
    a = (rng.standard_normal((w, w)) * 0.1).astype(np.float32)
    b = (rng.standard_normal((w, w)) * 0.1).astype(np.float32)
    x, y = Dim("x", w), Dim("y", w)
    F = RecFilter("TupDoG")
    F[y, x] = (a, b)
    F.add_filter(+x, [0.8, 0.4])
    F.add_filter(+y, [0.8, 0.4])
    F.split(x, 128, y, 128)

    plain = F.as_func()((a, b))
    want = 2.0 * np.asarray(plain[0]) - 3.0 * np.asarray(plain[1])
    scale = np.abs(want).max()

    kcalls = []
    orig_k = dimfuse.apply_filter_fused

    def spy_k(spec, xx, *aa, **kk):
        kcalls.append(xx.shape)
        return orig_k(spec, xx, *aa, **kk)

    dimfuse.apply_filter_fused = spy_k
    old = planner._DEFAULT_MATMUL_PRECISION[0]
    try:
        planner.set_default_matmul_precision("px6")
        F2 = RecFilter("TupDoG2")
        F2[y, x] = (a, b)
        F2.add_filter(+x, [0.8, 0.4])
        F2.add_filter(+y, [0.8, 0.4])
        F2.split(x, 128, y, 128)
        fn = F2.as_func(epilogue=lambda u, v: 2.0 * u - 3.0 * v)
        assert fn.tuple_route == "linear-folded"
        got = np.asarray(fn((a, b)))
    finally:
        dimfuse.apply_filter_fused = orig_k
        planner.set_default_matmul_precision(old)
    # folded: ONE single-channel pass of the shipping executor
    assert kcalls == [(w, w)], kcalls
    assert got.shape == (w, w)
    assert np.abs(got - want).max() <= 5e-6 * scale

    # nonlinear combine: staged route, still correct
    fn_nl = F.as_func(epilogue=lambda u, v: u * v)
    assert fn_nl.tuple_route == "staged"
    got_nl = np.asarray(fn_nl((a, b)))
    want_nl = np.asarray(plain[0]) * np.asarray(plain[1])
    assert np.abs(got_nl - want_nl).max() <= 1e-5 * (
        np.abs(want_nl).max() + 1e-9)
