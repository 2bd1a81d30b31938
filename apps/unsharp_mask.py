#!/usr/bin/env python
"""Unsharp mask benchmark (``apps/usm/unsharp_mask_{naive,optimized}.cpp``)."""

import argparse
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from recfilter.utils.platform import apply_platform_env

apply_platform_env()

import recfilter as rf
from recfilter.apps import unsharp_mask
from recfilter.utils import timing


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--width", "-w", type=int, default=4096)
    p.add_argument("--tile", "-t", type=int, default=0,
                   help="tile width (0 = auto: planner.default_tile_width)")
    p.add_argument("--iter", "-i", type=int, default=1)
    p.add_argument("--naive", action="store_true",
                   help="unfused variant (unsharp_mask_naive.cpp)")
    ns = p.parse_args()

    import jax
    import jax.numpy as jnp

    w = ns.width
    image = jnp.asarray(rf.generate_random_image(w, w, lo=0, hi=1, seed=4))
    fn = unsharp_mask(w, w, ns.tile, fused=not ns.naive)

    jax.block_until_ready(fn(image))
    t0 = time.perf_counter()
    out = image
    for _ in range(ns.iter):
        out = fn(out)
    jax.block_until_ready(out)
    ms = (time.perf_counter() - t0) * 1000
    print(f"usm: {ms:.3f} ms, "
          f"{timing.throughput(ms, w * w * ns.iter):.2f} MiP/s")


if __name__ == "__main__":
    main()
