#!/usr/bin/env python
"""Iterated box filter benchmarks (``apps/box/box_filter_{1,3,6}.cpp``)."""

import argparse
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from recfilter.utils.platform import apply_platform_env

apply_platform_env()

import recfilter as rf
from recfilter.apps import box


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--iterations-of-box", type=int, default=1, choices=[1, 3, 6])
    p.add_argument("--width", "-w", type=int, default=4096)
    p.add_argument("--tile", "-t", type=int, default=0,
                   help="tile width (0 = auto: planner.default_tile_width)")
    p.add_argument("--iter", "-i", type=int, default=1)
    p.add_argument("--radius", "-B", type=int, default=5)
    p.add_argument("--nocheck", action="store_true")
    ns = p.parse_args()

    w, B = ns.width, ns.radius
    nb = ns.iterations_of_box
    # zero-pad borders as the reference does (box_filter_3.cpp:25-33)
    pad = nb * (B + 1) + 1
    image = rf.generate_random_image(w, w, lo=0, hi=1, seed=2)
    image[:pad] = 0
    image[-pad:] = 0
    image[:, :pad] = 0
    image[:, -pad:] = 0

    import jax

    if nb == 1:
        fn, _ = box.box_filter_order_1(w, w, B, ns.tile)
    elif nb == 3:
        fn = box.box_filter_3(w, w, B, ns.tile)
    else:
        fn = box.box_filter_6(w, w, B, ns.tile)
    jfn = jax.jit(fn)

    img = jax.numpy.asarray(image)
    jax.block_until_ready(jfn(img))
    t0 = time.perf_counter()
    out = None
    for _ in range(ns.iter):
        out = jfn(img)
    jax.block_until_ready(out)
    ms = (time.perf_counter() - t0) * 1000
    from recfilter.utils import timing

    print(f"box{nb}: {ms:.3f} ms, "
          f"{timing.throughput(ms, w * w * ns.iter):.2f} MiP/s")

    if not ns.nocheck and w <= 256:
        ref = box.box_oracle(image, B, nb)
        print(rf.CheckResult(ref, np.asarray(out)))


if __name__ == "__main__":
    main()
