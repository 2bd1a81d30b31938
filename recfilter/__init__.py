"""recfilter — n-D recursive (IIR) filter engine in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of mit-gfx/recfilter
(the Halide overlapped-tiling DSL of Nehab et al. 2011): causal/anticausal
recursive scans of arbitrary order over n-D arrays, tiled into per-tile
tensor-core matmuls plus a closed-form cross-tile carry solve, and mesh
sharding (data + sequence parallel) across GPUs.

Public surface mirrors the reference's ergonomics (``lib/recfilter.h``):

    import recfilter as rf

    x = rf.Dim("x", 4096); y = rf.Dim("y", 4096)
    F = rf.RecFilter("SAT")
    F[x, y] = image                      # F(x,y) = image(x,y)
    F.add_filter(+x, [1.0, 1.0])
    F.add_filter(+y, [1.0, 1.0])
    F.split(x, 32, y, 32)
    out = F.realize()
"""

from .utils.platform import configure_compile_cache

configure_compile_cache()

from .spec import (BorderMode, Dim, DimAndCausality, FilterSpec, Scan,
                   spec_from_json, spec_to_json)
from .iir import (
    gaussian_weights,
    integral_image_coeff,
    overlap_feedback_coeff,
    gaussian_box_filter,
    gaussian,
    gauss_derivative,
    gauss_integral,
    reference_gaussian,
)
from .api import RecFilter
from .planner import Plan, set_default_matmul_precision
from .utils.args import Arguments
from .utils.testing import (
    CheckResult,
    CheckResultVerbose,
    generate_random_image,
)

RecFilterDim = Dim  # reference name alias (lib/recfilter.h:68)
RecFilterDimAndCausality = DimAndCausality  # (lib/recfilter.h:98)

__all__ = [
    "RecFilter",
    "Plan",
    "set_default_matmul_precision",
    "RecFilterDim",
    "RecFilterDimAndCausality",
    "Dim",
    "DimAndCausality",
    "FilterSpec",
    "Scan",
    "BorderMode",
    "spec_to_json",
    "spec_from_json",
    "gaussian_weights",
    "integral_image_coeff",
    "overlap_feedback_coeff",
    "gaussian_box_filter",
    "gaussian",
    "gauss_derivative",
    "gauss_integral",
    "reference_gaussian",
    "Arguments",
    "CheckResult",
    "CheckResultVerbose",
    "generate_random_image",
]

__version__ = "0.1.0"
