"""Unsharp mask: Gaussian blur cascade + pointwise combine (``apps/usm/``).

naive    — blur then a separately computed pointwise stage
           (``unsharp_mask_naive.cpp``): the combine is its own elementwise
           HBM stream after the last filter pass.
optimized — the cascade stages AND the pointwise combine fuse into one
           executor; in the reference this is a hand ``compute_at`` into
           the consumer's GPU blocks (``unsharp_mask_optimized.cpp:61-71``);
           here ``api.fuse_cascade`` merges the cascade back into a single
           filter (rotation chaining spans the former stage boundaries) and
           the combine rides the final completion matmul as an EPILOGUE
           (XLA dot-output fusion) — no extra full-size stream.
"""

from __future__ import annotations

import functools

import jax

from ..api import fuse_cascade
from .gaussian import gaussian_3x_3y


def _tag_route(fn, route: str):
    """Attach the route tag via a thin wrapper instead of mutating the
    ``jax.jit`` object: attribute assignment on the C++ PjitFunction has
    differed across jaxlib versions (advisor r4). The wrapper stays
    jittable and delegates to the already-jitted callable."""
    @functools.wraps(fn)
    def wrapper(image):
        return fn(image)

    wrapper.usm_route = route
    return wrapper


def unsharp_mask(
    width: int,
    height: int,
    tile_width: int = 0,
    sigma: float = 5.0,
    weight: float = 1.0,
    fused: bool = True,
):
    """Return jittable ``fn(image) -> sharpened`` (``unsharp_mask_*.cpp``)."""
    fc = gaussian_3x_3y(width, height, tile_width, sigma)

    # USM(x,y) = (1+w)*I(x,y) - w*Blur(x,y)  (unsharp_mask_optimized.cpp:55-56)
    def combine(blur, image):
        return (1.0 + weight) * image - weight * blur

    if fused:
        # The px grades and throughput mode merge the cascade into one
        # rotation-chained filter with the combine as its epilogue (the
        # staged epilogue's combine cannot fuse into the last stage's
        # rotation-restoring transposed-output einsum, so the blur would
        # materialize); the plain einsum grades (high/highest/f32x*) keep
        # the staged epilogue. Gate on the built filters' OWN plan (what
        # the executor will actually run).
        mp = fc[0].plan.matmul_precision
        if mp.startswith("px") or mp == "default":
            fn = fuse_cascade(fc, epilogue=combine)
            return _tag_route(jax.jit(lambda image: fn(image, image)),
                              "merged")

        fns = [f.as_func() for f in fc[:-1]]
        last = fc[-1].as_func(epilogue=combine)

        def pipeline(image):
            b = image
            for fn in fns:
                b = fn(b)
            return last(b, image)

        return _tag_route(jax.jit(pipeline), "staged")

    fns = [f.as_func() for f in fc]

    def pipeline(image):
        b = image
        for fn in fns:
            b = fn(b)
        return combine(b, image)

    return pipeline
