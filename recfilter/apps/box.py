"""Iterated box filters via IIR integral images (``apps/box/box_filter.h``).

Order 1: summed-area table + 4-corner finite differencing
(``box_filter.h:21-103``). Order 2: 2nd-order integral image cascaded per
dimension, each followed by two finite-differencing passes
(``box_filter.h:105-225``). Higher iterations compose these: 3 = 1∘2
(``box_filter_3.cpp:37-41``), 6 = 2∘2∘2 (``box_filter_6.cpp:40-46``).

The pointwise differencing stages — Halide Funcs scheduled by hand in the
reference — are plain jnp expressions here; XLA fuses them into the
surrounding kernels for free.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..api import RecFilter
from ..iir import integral_image_coeff
from ..spec import Dim
from ..planner import auto_tile_width


def _shift_clamped(f, offset, axis):
    """f[..., i+offset, ...] with edge clamping — static pad+slice (XLA
    fuses the chain) instead of a gather.

    Negative offsets read toward the array start, where the apps' zeroed
    input margins (``box_filter.h:9-11``) make the integral-image values 0 —
    so the pad may be constant-0 there (constant pads fuse better than
    edge-mode). Positive offsets clamp to the far edge, whose integral
    values are real totals, so edge mode is required."""
    n = f.shape[axis]
    lo, hi = max(offset, 0), max(-offset, 0)
    pads = [(0, 0)] * f.ndim
    pads[axis] = (hi, lo)
    g = jnp.pad(f, pads, mode="edge" if offset > 0 else "constant")
    return jax.lax.slice_in_dim(g, lo, lo + n, axis=axis)


def box_filter_order_1(width: int, height: int, B: int, tile_width: int = 0,
                       variant: str = "auto"):
    """One box iteration: SAT + 4-corner differencing (``box_filter.h:21-103``).

    Returns (fn, sat_filter); ``fn(image)`` is jittable. ``variant="fir"``
    (default when the 2B+1 taps fit the tile band) runs the box directly as
    two banded tile-matmul passes — no SAT filter is built (second element
    is None).
    """
    if _box_variant(variant, B, 1, tile_width, width, height) == "fir":
        return _box_fir(width, height, B, 1, tile_width), None
    tile_width = tile_width or auto_tile_width(min(width, height))
    x = Dim("x", width)
    y = Dim("y", height)
    F = RecFilter("Box1_Sat")
    F[y, x] = np.zeros((height, width), dtype=np.float32)
    F.add_filter(x, [1.0, 1.0])
    F.add_filter(y, [1.0, 1.0])
    F.split(x, tile_width, y, tile_width)
    sat = F.as_func()
    norm = float((2 * B + 1) ** 2)

    def fn(image):
        f = sat(image)
        # D(x,y) = [f(x+B, y+B) - f(x+B, y-B-1) + f(x-B-1, y-B-1)
        #           - f(x-B-1, y+B)] / (2B+1)^2        (box_filter.h:36-39)
        # computed separably: the 4-corner stencil is (Dy∘Dx) with Dy/Dx
        # 2-tap differences — 4 padded terms instead of 6 (fewer ops for
        # XLA to fuse).
        g = _shift_clamped(f, B, 0) - _shift_clamped(f, -B - 1, 0)
        d = _shift_clamped(g, B, 1) - _shift_clamped(g, -B - 1, 1)
        return d / norm

    return fn, F


def box_filter_order_2(width: int, height: int, B: int, tile_width: int = 0):
    """Two box iterations: 2nd-order integral image + double differencing per
    dimension, cascaded x then y (``box_filter.h:105-225``).

    Returns (fn, (sat_x, sat_y)).
    """
    tile_width = tile_width or auto_tile_width(min(width, height))
    x = Dim("x", width)
    y = Dim("y", height)
    coeff = integral_image_coeff(2)

    # The two single-dimension integral stages chain ROTATED layouts
    # (Plan.rotate_emit, as in the DoG app): sat_x consumes (y, x) and
    # emits (x, y); sat_y finds its scan dim (y) on the last axis and emits
    # (y, x) — both stages run in lanes-contraction form with zero relayout
    # copies, and each double-differencing lands on axis 0.
    sat_x = RecFilter("Box2_Satx")
    sat_x[y, x] = np.zeros((height, width), dtype=np.float32)
    sat_x.add_filter(+x, coeff)
    sat_x.split_all_dimensions(tile_width)
    sat_x.set_plan(rotate_emit=2)

    sat_y = RecFilter("Box2_Saty")
    sat_y[y, x] = np.zeros((height, width), dtype=np.float32)
    sat_y.add_filter(+y, coeff)
    sat_y.split_all_dimensions(tile_width)
    sat_y.set_plan(rotate_emit=2)

    fx = sat_x.as_func()
    fy = sat_y.as_func()
    norm = float(2 * B + 1)

    def _double_diff(f, B, axis):
        # D1(x) = [f(x+B) - f(x-B-1)]/(2B+1) applied twice collapses to a
        # 3-tap stencil: D2(x) = [f(x+2B) - 2 f(x-1) + f(x-2B-2)]/(2B+1)^2
        # — one traversal instead of two (exact in the interior; borders
        # live in the zeroed margin the reference's contract requires,
        # box_filter.h:9-11).
        return (
            _shift_clamped(f, 2 * B, axis)
            - 2.0 * _shift_clamped(f, -1, axis)
            + _shift_clamped(f, -2 * B - 2, axis)
        ) / (norm * norm)

    def fn(image):
        # x: 2nd-order integral (rotated emit → (x, y)) then the fused
        # double differencing along x = axis 0 (box_filter.h:124-129)
        a = _double_diff(fx(image), B, 0)
        # y: same along the other dimension; rotated emit restores (y, x)
        # (box_filter.h:132-139)
        return _double_diff(fy(a), B, 0)

    return fn, (sat_x, sat_y)


def _box_fir(width, height, B, iterations, tile_width):
    """Iterated box as an FIR: the n-fold box is a (2nB+1)-tap FIR — two
    banded tile-matmul passes instead of 2n integral+differencing streams
    (see fir.py). Exact full-convolution (zero-pad) semantics — the
    reference's zeroed-margin contract (``box_filter.h:9-11``)."""
    from .. import fir

    taps = fir.box_taps(B, iterations)
    tw = tile_width or auto_tile_width(min(width, height))

    def fn(image):
        return fir.fir_separable_2d(
            image.astype(jnp.float32), [taps], tile_width=tw
        )

    return fn


def _box_variant(variant, B, iterations, tile_width, width, height):
    if variant != "auto":
        return variant
    tw = tile_width or auto_tile_width(min(width, height))
    return "fir" if 2 * iterations * B + 1 <= 2 * tw else "sat"


def box_filter_3(width: int, height: int, B: int, tile_width: int = 0,
                 variant: str = "auto"):
    """Three iterations = order-1 ∘ order-2 (``box_filter_3.cpp:37-41``);
    ``variant="fir"`` runs the equivalent 6B+1-tap FIR in two tile-matmul
    passes (the default when it fits the tile band)."""
    if _box_variant(variant, B, 3, tile_width, width, height) == "fir":
        return _box_fir(width, height, B, 3, tile_width)
    f1, _ = box_filter_order_1(width, height, B, tile_width)
    f2, _ = box_filter_order_2(width, height, B, tile_width)

    def fn(image):
        return f2(f1(image))

    return fn


def box_filter_6(width: int, height: int, B: int, tile_width: int = 0,
                 variant: str = "auto"):
    """Six iterations = order-2 ∘ order-2 ∘ order-2
    (``box_filter_6.cpp:40-46``); ``variant="fir"`` runs the equivalent
    12B+1-tap FIR in two tile-matmul passes."""
    if _box_variant(variant, B, 6, tile_width, width, height) == "fir":
        return _box_fir(width, height, B, 6, tile_width)
    f2a, _ = box_filter_order_2(width, height, B, tile_width)

    def fn(image):
        return f2a(f2a(f2a(image)))

    return fn


def box_oracle(image: np.ndarray, B: int, iterations: int) -> np.ndarray:
    """Brute-force iterated box blur with zero padding (test oracle)."""
    img = np.asarray(image, dtype=np.float64)
    norm = float((2 * B + 1) ** 2)
    for _ in range(iterations):
        h, w = img.shape
        padded = np.zeros((h + 2 * B, w + 2 * B))
        padded[B : B + h, B : B + w] = img
        out = np.zeros_like(img)
        for dy in range(-B, B + 1):
            for dx in range(-B, B + 1):
                out += padded[B + dy : B + dy + h, B + dx : B + dx + w]
        img = out / norm
    return img
