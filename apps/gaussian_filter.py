#!/usr/bin/env python
"""Gaussian IIR blur benchmarks — all five tiling strategies
(``apps/gaussian/*.cpp``). Select with --variant."""

import argparse
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from recfilter.utils.platform import apply_platform_env

apply_platform_env()

import recfilter as rf
from recfilter import scan_core
from recfilter.apps import gaussian as G


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--variant", default="3xy",
                   choices=["3xy", "3x_3y", "1xy_2xy", "1xy_2x_2y",
                            "1xy_1xy_1xy"])
    p.add_argument("--width", "-w", type=int, default=4096)
    p.add_argument("--tile", "-t", type=int, default=0,
                   help="tile width (0 = auto: planner.default_tile_width)")
    p.add_argument("--iter", "-i", type=int, default=1)
    p.add_argument("--sigma", type=float, default=5.0)
    p.add_argument("--nocheck", action="store_true")
    ns = p.parse_args()

    w = ns.width
    image = rf.generate_random_image(w, w, lo=0, hi=1, seed=1)

    build = {
        "3xy": lambda: [G.gaussian_3xy(w, w, ns.tile, ns.sigma)],
        "3x_3y": lambda: G.gaussian_3x_3y(w, w, ns.tile, ns.sigma),
        "1xy_2xy": lambda: G.gaussian_1xy_2xy(w, w, ns.tile, ns.sigma),
        "1xy_2x_2y": lambda: G.gaussian_1xy_2x_2y(w, w, ns.tile, ns.sigma),
        "1xy_1xy_1xy": lambda: G.gaussian_1xy_1xy_1xy(w, w, ns.tile, ns.sigma),
    }[ns.variant]
    fc = build()

    for f in fc:
        f.set_image(image)
    out = G.run_cascade(fc, image)

    import jax

    jax.block_until_ready(out)
    fc[-1].profile(ns.iter)

    if not ns.nocheck and w <= 256:
        ref = image
        for f in fc:
            ref = scan_core.oracle_apply(f.spec, ref)
        print(rf.CheckResult(ref, np.asarray(out)))


if __name__ == "__main__":
    main()
