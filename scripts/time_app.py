#!/usr/bin/env python
"""Slope-time any app pipeline on the current device (one JSON line each).

The per-app analog of ``bench.py``: iterations run inside one jitted
``lax.fori_loop`` with a traced trip count and the per-iteration time is the
slope between two trip counts (see bench.py's docstring).

Apps with integrator stages (SAT, box, DoG) grow without bound when
iterated on their own output, so those use the scaled loop body
(``make_loop(scale=...)`` — fuses into the loop carry, no extra stream).

    python scripts/time_app.py sat gaussian3 dog          # named apps
    python scripts/time_app.py --all -w 4096
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from recfilter.utils.platform import apply_platform_env

apply_platform_env()

import numpy as np


def _apps(w, h, tile):
    """name -> (build() -> jittable fn, loop-body scale)."""
    from recfilter import apps

    def sat():
        return apps.summed_table(w, h, tile).as_func()

    def gaussian3():
        return apps.gaussian_3xy(w, h, tile).as_func()

    def gaussian_cascaded():
        fc = apps.gaussian_3x_3y(w, h, tile)
        fns = [f.as_func() for f in fc]

        def fn(v):
            for f in fns:
                v = f(v)
            return v

        return fn

    def gaussian_cascaded_fused():
        from recfilter.api import fuse_cascade

        return fuse_cascade(apps.gaussian_3x_3y(w, h, tile))

    def gaussian3_rgb():
        return apps.gaussian_3xy_rgb(w, h, tile).as_func()

    def bicubic():
        return apps.bicubic(w, h, tile).as_func()

    def biquintic():
        return apps.biquintic_overlapped(w, h, tile).as_func()

    def box1():
        return apps.box_filter_order_1(w, h, 5, tile)[0]

    def box3():
        return apps.box_filter_3(w, h, 5, tile)

    def box3_sat():
        return apps.box_filter_3(w, h, 5, tile, variant="sat")

    def usm():
        return apps.unsharp_mask(w, h, tile)

    def usm_naive():
        import jax

        return jax.jit(apps.unsharp_mask(w, h, tile, fused=False))

    def dog():
        return apps.difference_of_gaussians(w, h, 5, 9, tile)

    def dog_sat():
        return apps.difference_of_gaussians(w, h, 5, 9, tile, variant="sat")

    # Backend-comparison variants (VERDICT r1 #6): same gaussian_3xy filter
    # through each executor so the bench table carries a measured decision.
    def _gaussian3_backend(backend):
        F = apps.gaussian_3xy(w, h, tile)
        F.set_plan(backend=backend)
        return F.as_func()

    def gaussian3_pallas():
        return _gaussian3_backend("pallas")

    def gaussian3_overlap():
        return _gaussian3_backend("overlap")

    def gaussian3_overlap_k():
        return _gaussian3_backend("overlap_k")

    # Every app gets a scale: unit-DC-gain pipelines (gaussian) would
    # survive without one, but e.g. bicubic's DC gain is ~11.5 per
    # application and USM's ~2 — any gain > 1 overflows over a slope
    # window. A fused scalar multiply is free (gaussian3 measured equal
    # with scale=None and scale=0.5).
    return {
        "sat": (sat, 1e-7),
        "gaussian3": (gaussian3, 0.5),
        "gaussian_cascaded": (gaussian_cascaded, 0.5),
        "gaussian_cascaded_fused": (gaussian_cascaded_fused, 0.5),
        # RGB: 4th element = leading input dims (channels); Mpix counts
        # every processed plane pixel.
        "gaussian3_rgb": (gaussian3_rgb, 0.5, True, (3,)),
        "bicubic": (bicubic, 1e-2),
        "biquintic": (biquintic, 1e-2),
        "box1": (box1, 1e-7),
        "box3": (box3, 1e-7),
        "box3_sat": (box3_sat, 1e-7),
        "usm": (usm, 1e-2),
        "usm_naive": (usm_naive, 1e-2),
        "dog": (dog, 1e-7),
        "dog_sat": (dog_sat, 1e-7),
        # not in --all: backend-comparison variants (run by name)
        "gaussian3_pallas": (gaussian3_pallas, 0.5, False),
        "gaussian3_overlap": (gaussian3_overlap, 0.5, False),
        "gaussian3_overlap_k": (gaussian3_overlap_k, 0.5, False),
    }


def main():
    p = argparse.ArgumentParser()
    p.add_argument("apps", nargs="*", help="app names (see --list)")
    p.add_argument("--all", action="store_true")
    p.add_argument("--list", action="store_true")
    p.add_argument("--width", "-w", type=int, default=4096)
    p.add_argument("--tile", "-t", type=int, default=0)
    p.add_argument(
        "--precision", default="default",
        choices=["default", "high", "highest", "f32x3", "f32x4",
                 "f32x6", "px3", "px4", "px6"],
        help="matmul precision (default = throughput mode, like bench.py)",
    )
    ns = p.parse_args()

    registry = _apps(ns.width, ns.width, ns.tile)
    if ns.list:
        print(" ".join(registry))
        return
    names = (
        [k for k, v in registry.items() if len(v) == 2 or v[2]]
        if ns.all
        else ns.apps
    )
    if not names:
        p.error("no apps given (use --all or --list)")

    import jax.numpy as jnp

    from bench import slope_ms_per_iter
    from recfilter import planner

    planner.set_default_matmul_precision(ns.precision)

    img = jnp.asarray(
        np.random.default_rng(0).standard_normal((ns.width, ns.width)) * 0.01,
        jnp.float32,
    )
    for name in names:
        entry = registry[name]
        build, scale = entry[:2]
        lead = entry[3] if len(entry) > 3 else ()
        mpix = int(np.prod(lead, dtype=np.int64)) * ns.width * ns.width / 1e6 \
            if lead else ns.width * ns.width / 1e6
        inp = img if not lead else jnp.asarray(
            np.random.default_rng(0).standard_normal(
                tuple(lead) + (ns.width, ns.width)) * 0.01,
            jnp.float32,
        )
        fn = build()
        # The loop scale now applies once per BODY (see bench.make_loop);
        # within a body the compositions run unscaled. The double-integral
        # composites grow fastest per application — cap their unscaled
        # composition depth so f32 iterates cannot overflow mid-body.
        pb = 2 if name in ("dog_sat", "box3_sat") else 4
        ms = slope_ms_per_iter(fn, inp, scale=scale, per_body=pb)
        print(
            json.dumps(
                {
                    "metric": f"{name}_{ns.width}_mpix_s",
                    "value": round(mpix / ms * 1000.0, 1),
                    "unit": "Mpix/s",
                    "ms_per_iter": round(ms, 4),
                }
            ),
            flush=True,
        )


if __name__ == "__main__":
    main()
