#!/usr/bin/env python
"""Audio IIR order/biquad sweep on the current device (reference:
``apps/audio/audio_filter_high_order.cpp:38-93`` — 10M samples, tile 1000,
filter order 1..29 and biquad count 1..30 on CPU).

Each order is a distinct jit program, so the default sweep hits a
representative subset; ``--full`` runs the reference's complete ranges.

    python scripts/audio_sweep.py
    python scripts/audio_sweep.py --samples 1000000 --orders 1,2,4  # smoke

Writes ``audio_sweep.perflog`` rows: kind order ms msamples_s.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from recfilter.utils.platform import apply_platform_env

apply_platform_env()

import numpy as np

SUBSET = [1, 2, 3, 4, 6, 8, 12, 16, 24, 29]


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--samples", type=int, default=10_000_000)
    p.add_argument("--tile", type=int, default=1000)
    p.add_argument("--orders", default=None,
                   help="comma list; default = representative subset")
    p.add_argument("--full", action="store_true",
                   help="reference ranges: orders 1..29, biquads 1..30")
    p.add_argument("--kinds", default="high_order,biquads")
    p.add_argument("--perflog", default="audio_sweep.perflog")
    p.add_argument("--precision", default="default",
                   help="matmul precision mode (as scripts/time_app.py)")
    ns = p.parse_args()

    import jax.numpy as jnp

    from bench import slope_ms_per_iter
    from recfilter import apps, planner

    planner.set_default_matmul_precision(ns.precision)

    if ns.orders:
        orders = [int(s) for s in ns.orders.split(",")]
    elif ns.full:
        orders = list(range(1, 30))
    else:
        orders = SUBSET

    x = jnp.asarray(
        np.random.default_rng(0).standard_normal((ns.samples,)) * 0.01,
        jnp.float32,
    )
    msamp = ns.samples / 1e6
    rows = []
    for kind in ns.kinds.split(","):
        for order in orders:
            if kind == "biquads" and order > 30:
                continue
            if kind == "high_order":
                F = apps.audio_filter_high_order(ns.samples, order, ns.tile)
                fn = F.as_func()
            else:
                F = apps.audio_filter_biquads(ns.samples, order, ns.tile)
                fn = F.as_func()

            # dummy-coefficient filters have gain > 1 — keep the loop bounded
            ms = slope_ms_per_iter(fn, x, scale=1e-3, per_body=2)
            row = {
                "kind": kind,
                "order": order,
                "ms": round(ms, 4),
                "msamples_s": round(msamp / ms * 1000.0, 1),
            }
            rows.append(row)
            print(json.dumps(row), flush=True)

    with open(ns.perflog, "w") as f:
        f.write("# kind order ms msamples_s\n")
        for r in rows:
            f.write(f"{r['kind']} {r['order']} {r['ms']} {r['msamples_s']}\n")


if __name__ == "__main__":
    main()
