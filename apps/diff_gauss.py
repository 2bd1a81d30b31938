#!/usr/bin/env python
"""Difference-of-Gaussians benchmark (``apps/DoG/diff_gauss.cpp``)."""

import argparse
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from recfilter.utils.platform import apply_platform_env

apply_platform_env()

import recfilter as rf
from recfilter.apps import difference_of_gaussians
from recfilter.utils import timing


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--width", "-w", type=int, default=4096)
    p.add_argument("--tile", "-t", type=int, default=0,
                   help="tile width (0 = auto: planner.default_tile_width)")
    p.add_argument("--iter", "-i", type=int, default=1)
    p.add_argument("--B1", type=int, default=5)
    p.add_argument("--B2", type=int, default=9)
    p.add_argument("--nocheck", action="store_true")
    ns = p.parse_args()

    import jax
    import jax.numpy as jnp

    w = ns.width
    pad = 2 * (max(ns.B1, ns.B2) + 1) + 1
    image = rf.generate_random_image(w, w, lo=0, hi=1, seed=5)
    image[:pad] = 0
    image[-pad:] = 0
    image[:, :pad] = 0
    image[:, -pad:] = 0

    fn = difference_of_gaussians(w, w, ns.B1, ns.B2, ns.tile)
    img = jnp.asarray(image)
    jax.block_until_ready(fn(img))
    t0 = time.perf_counter()
    out = None
    for _ in range(ns.iter):
        out = fn(img)
    jax.block_until_ready(out)
    ms = (time.perf_counter() - t0) * 1000
    print(f"DoG: {ms:.3f} ms, "
          f"{timing.throughput(ms, w * w * ns.iter):.2f} MiP/s")

    if not ns.nocheck:
        # Oracle: DoG = box³(B1) − box³(B2), valid in the interior (borders
        # live in the zeroed margin, ``box_filter.h:9-11``); relative to the
        # output peak, reflecting f32 cancellation in the dual-radius
        # subtraction (``apps/DoG/diff_gauss.cpp`` checks the same way via
        # CheckResult).
        import numpy as np

        from recfilter.apps.box import box_oracle

        got = np.asarray(out)
        want = box_oracle(image, ns.B1, 3) - box_oracle(image, ns.B2, 3)
        m = 3 * (max(ns.B1, ns.B2) + 1) + 3
        scale = float(np.max(np.abs(want))) + 1e-30
        err = np.abs(got - want)[m:-m, m:-m] / scale
        print("Checking difference ... ")
        print(f"Max relative error = {100 * err.max():e} %")
        print(f"Mean relative error = {100 * err.mean():e} %")


if __name__ == "__main__":
    main()
