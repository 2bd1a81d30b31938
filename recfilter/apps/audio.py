"""Audio IIR filtering: 1-D high-order and overlapped-biquad filters
(``apps/audio/audio_filter_high_order.cpp``, ``audio_filter_biquads.cpp``).

The reference benchmarks these on CPU (10M samples, tile 1000, order sweeps).
Here the same builders run tiled on the GPU; channels ride a leading batch axis
(shardable over the mesh — the BASELINE.json multi-host audio config).
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..api import RecFilter
from ..iir import overlap_feedback_coeff
from ..spec import Dim


def audio_filter_high_order(
    num_samples: int,
    order: int,
    tile_width: int = 1000,
    tiled: bool = True,
    coeff=None,
) -> RecFilter:
    """Single causal scan of the given order
    (``audio_filter_high_order.cpp:40-76``; default dummy coefficients 0.01
    as in the reference's performance sweep)."""
    if coeff is None:
        coeff = [1.0] + [0.01] * order
    x = Dim("x", num_samples)
    F = RecFilter("R_tiled" if tiled else "R_nontiled")
    F[x] = np.zeros((num_samples,), dtype=np.float32)
    F.add_filter(+x, coeff)
    if tiled:
        F.split(x, tile_width)
    return F


def audio_filter_biquads(
    num_samples: int,
    num_biquads: int,
    tile_width: int = 1000,
    overlapped: bool = True,
) -> RecFilter:
    """``num_biquads`` cascaded 2nd-order sections, overlapped into a single
    higher-order filter via z-domain polynomial multiplication
    (``audio_filter_biquads.cpp:47-90``, ``overlap_feedback_coeff``)."""
    b = [0.01, 0.01]
    fb: List[float] = list(b)
    for _ in range(num_biquads - 1):
        fb = overlap_feedback_coeff(fb, b)
    coeff = [1.0] + fb
    x = Dim("x", num_samples)
    F = RecFilter("Biquads")
    F[x] = np.zeros((num_samples,), dtype=np.float32)
    F.add_filter(+x, coeff)
    if overlapped:
        F.split(x, tile_width)
    return F
