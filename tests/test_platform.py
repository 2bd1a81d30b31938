"""Platform entry points: the planner's per-platform choices, the compile
cache placement, the split-product rounding, and the gradient rule of the
split products."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from recfilter import dimfuse, planner
from recfilter.planner import Plan
from recfilter.spec import Dim, FilterSpec, Scan
from recfilter.utils import platform


@pytest.mark.parametrize("plat,extent,want", [
    ("gpu", 4096, 128), ("gpu", 100, 100), ("cpu", 4096, 32),
    ("cpu", 7, 7)])
def test_default_tile_width_per_platform(plat, extent, want):
    assert planner.default_tile_width(extent, plat) == want


@pytest.mark.parametrize("plat", ["rocm", "METAL", ""])
def test_default_tile_width_unknown_platform_is_an_error(plat):
    with pytest.raises(ValueError):
        planner.default_tile_width(4096, plat)


def test_auto_tile_width_reads_the_running_backend():
    assert jax.default_backend() == "cpu"
    assert planner.auto_tile_width(4096) == 32


@pytest.mark.parametrize("dtype,tiled,want", [
    ("float32", True, "einsum"), ("float32", False, "scan"),
    ("int32", True, "einsum"), ("int32", False, "scan")])
def test_resolve_backend_route(dtype, tiled, want):
    spec = FilterSpec("R", (Dim("x", 64),), (Scan(0, True, 1.0, (0.5,)),),
                      dtype=dtype, tile_widths=(16 if tiled else 0,))
    for plat in ("gpu", "cpu"):
        assert planner.resolve_backend(spec, Plan(), plat) == want


def test_compile_cache_follows_the_env_var(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    got = platform.configure_compile_cache(
        {"JAX_COMPILATION_CACHE_DIR": "/elsewhere/cache"})
    assert got == "/elsewhere/cache"
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_into_the_checkout():
    before = jax.config.jax_compilation_cache_dir
    try:
        got = platform.configure_compile_cache({})
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert got == os.path.join(repo, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
        # a fixed path: the same on every call
        assert platform.configure_compile_cache({}) == got
        with open(os.path.join(repo, ".gitignore")) as fh:
            assert ".jax_cache/" in fh.read().split()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_split_input_rounds_with_reduce_precision():
    """The chunk rounding must survive XLA's excess-precision folding of
    f32→bf16→f32 round trips: it is a reduce_precision, and the chunks
    reconstruct f32 exactly."""
    x = jnp.asarray(np.random.default_rng(3).standard_normal((16, 128)),
                    jnp.float32)
    jx = jax.make_jaxpr(lambda v: dimfuse._split_input(v, 3))(x)
    prims = [e.primitive.name for e in jx.jaxpr.eqns]
    assert prims.count("reduce_precision") == 2
    back = sum(c.astype(jnp.float32) for c in dimfuse._split_input(x, 3))
    assert np.array_equal(np.asarray(back), np.asarray(x))


@pytest.mark.parametrize("npasses", [3, 4, 6, 9])
def test_split_einsum_gradient_rule(npasses):
    """The split products' VJP is the exact (HIGHEST) transpose, whatever
    the forward product count: grad of <M·X, ct> is Mᵀ·ct."""
    rng = np.random.default_rng(npasses)
    M = rng.standard_normal((8, 32))
    X = jnp.asarray(rng.standard_normal((5, 32)), jnp.float32)
    ct = rng.standard_normal((5, 8))
    g = jax.grad(lambda v: (dimfuse._split_einsum(
        "os,as->ao", M, v, npasses, jnp.float32) * ct).sum())(X)
    want = ct @ M
    np.testing.assert_allclose(np.asarray(g), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
