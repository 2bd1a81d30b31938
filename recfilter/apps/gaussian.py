"""Gaussian IIR blur — five tiling/cascading strategies (``apps/gaussian/``).

All use van Vliet–Young recursive Gaussian weights (``gaussian_weights``,
``lib/iir_coeff.cpp:162-177``) with clamped image borders:

  3xy          — one 3rd-order filter, all four scans overlapped
                 (``gaussian_filter_3xy.cpp:42-55``)
  3x_3y        — cascaded by dimension (``gaussian_filter_3x_3y.cpp:42-51``)
  1xy_2xy      — 1st-order + 2nd-order cascade (``gaussian_filter_1xy_2xy.cpp``)
  1xy_2x_2y    — 1st-order overlapped, then 2nd-order per dimension
  1xy_1xy_1xy  — three 1st-order cascades (iterated box-like)
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..api import RecFilter
from ..iir import gaussian_weights
from ..spec import Dim
from ..planner import auto_tile_width

SIGMA_DEFAULT = 5.0


def _base(name: str, width: int, height: int, dtype="float32"):
    x = Dim("x", width)
    y = Dim("y", height)
    F = RecFilter(name)
    F.set_clamped_image_border()
    F[y, x] = np.zeros((height, width), dtype=dtype)
    return F, x, y


def gaussian_3xy(width, height, tile_width=0, sigma=SIGMA_DEFAULT):
    """Single 3rd-order filter, 4 scans, fully tiled
    (``gaussian_filter_3xy.cpp:42-55``)."""
    tile_width = tile_width or auto_tile_width(min(width, height))
    W3 = gaussian_weights(sigma, 3)
    F, x, y = _base("Gaussian_3xy", width, height)
    F.add_filter(+x, W3)
    F.add_filter(-x, W3)
    F.add_filter(+y, W3)
    F.add_filter(-y, W3)
    F.split(x, tile_width, y, tile_width)
    return F


def gaussian_3xy_rgb(width, height, tile_width=0, channels=3,
                     sigma=SIGMA_DEFAULT):
    """Multi-channel :func:`gaussian_3xy`: channels ride a leading batch
    axis (the reference's demo carries RGB as a Halide Tuple,
    ``demo_gaussian_filter.cpp:57``); both rotated passes carry the
    channel axis as a batch axis of their einsums."""
    tile_width = tile_width or auto_tile_width(min(width, height))
    W3 = gaussian_weights(sigma, 3)
    c = Dim("c", channels)
    x = Dim("x", width)
    y = Dim("y", height)
    F = RecFilter("Gaussian_3xy_rgb")
    F.set_clamped_image_border()
    F[c, y, x] = np.zeros((channels, height, width), dtype="float32")
    F.add_filter(+x, W3)
    F.add_filter(-x, W3)
    F.add_filter(+y, W3)
    F.add_filter(-y, W3)
    F.split(x, tile_width, y, tile_width)
    return F


def gaussian_3x_3y(width, height, tile_width=0, sigma=SIGMA_DEFAULT) -> List[RecFilter]:
    """Cascade by dimension (``gaussian_filter_3x_3y.cpp:42-51``)."""
    tile_width = tile_width or auto_tile_width(min(width, height))
    F = gaussian_3xy(width, height, tile_width, sigma)
    fc = F.cascade_by_dimension()
    for f in fc:
        f.split_all_dimensions(tile_width)
    return fc


def gaussian_1xy_2xy(width, height, tile_width=0, sigma=SIGMA_DEFAULT) -> List[RecFilter]:
    """1st-order overlapped then 2nd-order overlapped
    (``gaussian_filter_1xy_2xy.cpp:44-58``)."""
    tile_width = tile_width or auto_tile_width(min(width, height))
    W1 = gaussian_weights(sigma, 1)
    W2 = gaussian_weights(sigma, 2)
    F, x, y = _base("Gaussian_1xy_2xy", width, height)
    F.add_filter(+x, W1)
    F.add_filter(-x, W1)
    F.add_filter(+y, W1)
    F.add_filter(-y, W1)
    F.add_filter(+x, W2)
    F.add_filter(-x, W2)
    F.add_filter(+y, W2)
    F.add_filter(-y, W2)
    fc = F.cascade([0, 1, 2, 3], [4, 5, 6, 7])
    for f in fc:
        f.split_all_dimensions(tile_width)
    return fc


def gaussian_1xy_2x_2y(width, height, tile_width=0, sigma=SIGMA_DEFAULT) -> List[RecFilter]:
    """1st-order overlapped, then 2nd-order x, then 2nd-order y."""
    tile_width = tile_width or auto_tile_width(min(width, height))
    W1 = gaussian_weights(sigma, 1)
    W2 = gaussian_weights(sigma, 2)
    F, x, y = _base("Gaussian_1xy_2x_2y", width, height)
    F.add_filter(+x, W1)
    F.add_filter(-x, W1)
    F.add_filter(+y, W1)
    F.add_filter(-y, W1)
    F.add_filter(+x, W2)
    F.add_filter(-x, W2)
    F.add_filter(+y, W2)
    F.add_filter(-y, W2)
    fc = F.cascade([0, 1, 2, 3], [4, 5], [6, 7])
    for f in fc:
        f.split_all_dimensions(tile_width)
    return fc


def gaussian_1xy_1xy_1xy(width, height, tile_width=0, sigma=SIGMA_DEFAULT) -> List[RecFilter]:
    """Three cascaded 1st-order filters ≈ 3rd-order Gaussian
    (the overlap identity behind ``weights3``, ``lib/iir_coeff.cpp:150-159``
    is only exact for 1∘2; this variant is the reference's approximation
    study)."""
    tile_width = tile_width or auto_tile_width(min(width, height))
    W1 = gaussian_weights(sigma, 1)
    F, x, y = _base("Gaussian_1xy_1xy_1xy", width, height)
    for _ in range(3):
        F.add_filter(+x, W1)
        F.add_filter(-x, W1)
        F.add_filter(+y, W1)
        F.add_filter(-y, W1)
    fc = F.cascade([0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11])
    for f in fc:
        f.split_all_dimensions(tile_width)
    return fc


def run_cascade(fc: List[RecFilter], image):
    """Realize a cascade chain on an input image."""
    out = image
    for f in fc:
        out = f.realize(out)
    return out
