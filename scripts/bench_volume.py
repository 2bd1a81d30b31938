#!/usr/bin/env python
"""3-D volumetric benchmark: 3rd-order Gaussian IIR on a 256^3 volume.

Exercises the n-D rotation-chaining executor (all three dims scanned as
the trailing axis group — see ``dimfuse._last_axis_pass_t``). Slope-timed
via ``bench.slope_ms_per_iter``; ``--precision`` picks the grade.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from recfilter.utils.platform import apply_platform_env

apply_platform_env()

import numpy as np


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--size", "-n", type=int, default=256)
    p.add_argument("--tile", "-t", type=int, default=128)
    p.add_argument("--sigma", type=float, default=5.0)
    p.add_argument("--precision", default="px6")
    ns = p.parse_args()

    import jax
    import jax.numpy as jnp

    import recfilter as rf
    from recfilter import dimfuse
    from recfilter.spec import Dim, FilterSpec, Scan

    n = ns.size
    wts = rf.gaussian_weights(ns.sigma, 3)
    b0, a = float(wts[0]), tuple(float(v) for v in wts[1:])
    scans = []
    for ax in range(3):
        scans.append(Scan(ax, True, b0, a))
        scans.append(Scan(ax, False, b0, a))
    spec = FilterSpec(
        "Gaussian3D", (Dim("z", n), Dim("y", n), Dim("x", n)),
        tuple(scans), tile_widths=(ns.tile,) * 3,
    )

    def fn(v):
        return dimfuse.apply_filter_fused(spec, v,
                                          matmul_precision=ns.precision)

    from bench import slope_ms_per_iter

    img = jnp.asarray(
        np.random.default_rng(0).standard_normal((n, n, n)) * 0.01,
        jnp.float32,
    )
    t0 = time.time()
    ms = slope_ms_per_iter(fn, img, per_body=4)
    print(f"measured (incl. compile {time.time() - t0:.0f}s)", file=sys.stderr)
    print(json.dumps({
        "metric": f"gaussian3_vol{n}_gvox_s",
        "value": round(n ** 3 / ms / 1e9 * 1e3, 2),
        "unit": "Gvox/s",
        "ms_per_iter": round(ms, 3),
        "precision": ns.precision,
        "device": jax.devices()[0].device_kind,
    }))


if __name__ == "__main__":
    main()
