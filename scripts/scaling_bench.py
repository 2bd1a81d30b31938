#!/usr/bin/env python
"""Scaling-efficiency benchmark: samples/s at mesh sizes 1..N.

BASELINE.md target: ≥85% samples/s scaling efficiency at N devices. One
process drives every GPU of the host (one process per card: each JAX
process reserves most of a card's memory); on the virtual CPU mesh
(RECFILTER_PLATFORM=cpu RECFILTER_CPU_DEVICES=8) it exercises the sharded
program without a card.

Methodology: batch of images data-parallel over the mesh (+ optional seq
sharding of the scan dim), slope-timed inside one jit.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from recfilter.utils.platform import apply_platform_env

apply_platform_env()


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--width", "-w", type=int, default=512)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=1,
                   help="sequence-parallel factor over the scan dim")
    p.add_argument("--mode", default="data",
                   choices=["data", "seq", "seq2d", "int"],
                   help="which route to sweep: data-parallel (default), "
                        "pure sequence sharding of the x scan dim, 2-D "
                        "sequence sharding (both scan dims), or the "
                        "integer unit-scan route (data-parallel)")
    ns = p.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from recfilter import iir
    from recfilter.parallel import sharding
    from recfilter.planner import Plan
    from recfilter.spec import Dim, FilterSpec, Scan

    ndev = len(jax.devices())
    w = ns.width
    wts = iir.gaussian_weights(3.0, 3)
    if ns.mode == "int":
        spec = FilterSpec(
            "ScaleInt",
            (Dim("b", ns.batch), Dim("y", w), Dim("x", w)),
            (Scan(2, True, 1, (1,)), Scan(1, True, 1, (1,))),
            dtype="int32",
            tile_widths=(0, 32, 32),
        )
        img = jnp.asarray(np.random.default_rng(0).integers(
            -2 ** 16, 2 ** 16, (ns.batch, w, w)), jnp.int32)
    else:
        spec = FilterSpec(
            "Scale",
            (Dim("b", ns.batch), Dim("y", w), Dim("x", w)),
            (
                Scan(2, True, wts[0], tuple(wts[1:])),
                Scan(2, False, wts[0], tuple(wts[1:])),
                Scan(1, True, wts[0], tuple(wts[1:])),
                Scan(1, False, wts[0], tuple(wts[1:])),
            ),
            tile_widths=(0, 32, 32),
        )
        img = jnp.asarray(
            np.random.default_rng(0).standard_normal((ns.batch, w, w)) * 0.01,
            dtype=jnp.float32,
        )
    plan = Plan()

    def rate_for(d):
        if ns.mode == "seq":
            mesh = sharding.make_mesh((d,), ("seq",))
            kw = dict(seq_axis=2)
        elif ns.mode == "seq2d":
            dy = 2 if d >= 4 else 1
            dx = d // dy
            mesh = sharding.make_mesh((dy, dx), ("seq", "seq2"))
            kw = dict(seq_axis=1, seq2_axis=2)
        else:  # data / int
            mesh = sharding.make_mesh(
                (d, ns.seq) if ns.seq > 1 else (d,),
                ("data", "seq") if ns.seq > 1 else ("data",),
            )
            kw = dict(data_axis=0,
                      seq_axis=2 if ns.seq > 1 else None)
        fn = sharding.make_sharded_filter(spec, plan, mesh, **kw)

        @jax.jit
        def loop(x, n):
            def body(i, v):
                return fn(v)

            out = jax.lax.fori_loop(0, n, body, x)
            return out[0, 0, 0]

        float(loop(img, jnp.int32(1)))
        ts = []
        for n in (2, 12):
            t0 = time.perf_counter()
            float(loop(img, jnp.int32(n)))
            ts.append((time.perf_counter() - t0) * 1000)
        per = max((ts[1] - ts[0]) / 10, 1e-9)
        return ns.batch / (per / 1000.0)  # samples (images) per second

    if ns.mode in ("seq", "seq2d"):
        sizes = [d for d in (1, 2, 4, 8) if d <= ndev and w % d == 0]
    else:
        sizes = [d for d in (1, 2, 4, 8, 16, 32)
                 if d * max(ns.seq, 1) <= ndev and ns.batch % d == 0]
    base = None
    cpu = jax.default_backend() == "cpu"
    print(f"devices available: {ndev}  (platform {jax.default_backend()})")
    if cpu:
        print(
            "NOTE: virtual CPU devices share physical cores. Per-device "
            "compute does NOT scale here, so the 'efficiency vs d x ideal' "
            "column is not meaningful; the meaningful CPU-mesh "
            "number is 'speedup' (same global batch, 1 -> d devices): the "
            "sharded program beating the single-device program bounds the "
            "collective/carry-exchange overhead from above."
        )
    import json as _json

    col = "speedup_vs_1dev" if cpu else "efficiency"
    for d in sizes:
        r = rate_for(d)
        if base is None:
            base = r
        val = r / base if cpu else r / (base * d)
        print(
            _json.dumps(
                {
                    "mesh_data": d,
                    "seq": ns.seq,
                    "samples_s": round(r, 2),
                    col: round(val, 3),
                }
            ),
            flush=True,
        )


if __name__ == "__main__":
    main()
