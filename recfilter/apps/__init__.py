"""Application library: JAX rebuilds of every reference app (``apps/``).

Each builder returns a jittable ``fn(image) -> result`` plus (where useful)
the underlying RecFilter objects, so the same code backs the runnable
scripts in ``/apps``, the tests, and the benchmarks.
"""

from .summed_table import summed_table
from .box import box_filter_order_1, box_filter_order_2, box_filter_3, box_filter_6
from .gaussian import (
    gaussian_3xy,
    gaussian_3xy_rgb,
    gaussian_3x_3y,
    gaussian_1xy_2xy,
    gaussian_1xy_2x_2y,
    gaussian_1xy_1xy_1xy,
)
from .bspline import bicubic, biquintic_overlapped, biquintic_cascaded
from .usm import unsharp_mask
from .dog import difference_of_gaussians
from .audio import audio_filter_high_order, audio_filter_biquads

__all__ = [
    "summed_table",
    "box_filter_order_1",
    "box_filter_order_2",
    "box_filter_3",
    "box_filter_6",
    "gaussian_3xy",
    "gaussian_3xy_rgb",
    "gaussian_3x_3y",
    "gaussian_1xy_2xy",
    "gaussian_1xy_2x_2y",
    "gaussian_1xy_1xy_1xy",
    "bicubic",
    "biquintic_overlapped",
    "biquintic_cascaded",
    "unsharp_mask",
    "difference_of_gaussians",
    "audio_filter_high_order",
    "audio_filter_biquads",
]
