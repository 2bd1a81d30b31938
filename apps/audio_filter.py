#!/usr/bin/env python
"""Audio IIR benchmarks: order sweep + biquad sweep, tiled vs non-tiled
(``apps/audio/audio_filter_high_order.cpp``, ``audio_filter_biquads.cpp``).

Emits ``<order>\\t<ms_naive>\\t<ms_tiled>`` lines and perflog files like the
reference (``audio_filter_high_order.cpp:82-88``).
"""

import argparse
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from recfilter.utils.platform import apply_platform_env

apply_platform_env()

import recfilter as rf
from recfilter.apps import audio_filter_biquads, audio_filter_high_order
from recfilter.utils.timing import Log, throughput


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--mode", default="high_order",
                   choices=["high_order", "biquads"])
    p.add_argument("--samples", type=int, default=10_000_000)
    p.add_argument("--tile", type=int, default=1000)
    p.add_argument("--iter", "-i", type=int, default=20)
    p.add_argument("--max-order", type=int, default=30)
    ns = p.parse_args()

    n = ns.samples
    log_naive = Log(f"audio_{ns.mode}.nontiled.perflog")
    log_tiled = Log(f"audio_{ns.mode}.tiled.perflog")

    for order in range(1, ns.max_order, 2):
        if ns.mode == "high_order":
            Fn = audio_filter_high_order(n, order, ns.tile, tiled=False)
            Ft = audio_filter_high_order(n, order, ns.tile, tiled=True)
        else:
            Fn = audio_filter_biquads(n, order, ns.tile, overlapped=False)
            Ft = audio_filter_biquads(n, order, ns.tile, overlapped=True)

        image = rf.generate_random_image(n, lo=0, hi=1, seed=6)
        Fn.set_image(image)
        Ft.set_image(image)
        ms_naive = Fn.profile(ns.iter)
        ms_tiled = Ft.profile(ns.iter)

        log_naive.write(
            f"{order}\t{ms_naive:.3f}\t{throughput(ms_naive, n*ns.iter):.2f}\n"
        )
        log_tiled.write(
            f"{order}\t{ms_tiled:.3f}\t{throughput(ms_tiled, n*ns.iter):.2f}\n"
        )
        print(f"{order}\t{ms_naive:.3f}\t{ms_tiled:.3f}")


if __name__ == "__main__":
    main()
