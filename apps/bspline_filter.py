#!/usr/bin/env python
"""B-spline prefilter benchmarks (``apps/bspline/*.cpp``)."""

import argparse
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from recfilter.utils.platform import apply_platform_env

apply_platform_env()

import recfilter as rf
from recfilter import scan_core
from recfilter.apps import bspline


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--variant", default="bicubic",
                   choices=["bicubic", "biquintic", "biquintic_cascaded"])
    p.add_argument("--width", "-w", type=int, default=4096)
    p.add_argument("--tile", "-t", type=int, default=0,
                   help="tile width (0 = auto: planner.default_tile_width)")
    p.add_argument("--iter", "-i", type=int, default=1)
    p.add_argument("--nocheck", action="store_true")
    ns = p.parse_args()

    w = ns.width
    image = rf.generate_random_image(w, w, lo=0, hi=1, seed=3)

    if ns.variant == "bicubic":
        filters = [bspline.bicubic(w, w, ns.tile)]
    elif ns.variant == "biquintic":
        filters = [bspline.biquintic_overlapped(w, w, ns.tile)]
    else:
        filters = bspline.biquintic_cascaded(w, w, ns.tile)

    out = image
    for f in filters:
        out = f.realize(out)
    import jax

    jax.block_until_ready(out)
    filters[-1].profile(ns.iter)

    if not ns.nocheck and w <= 256:
        ref = image
        for f in filters:
            ref = scan_core.oracle_apply(f.spec, ref)
        print(rf.CheckResult(ref, np.asarray(out)))


if __name__ == "__main__":
    main()
