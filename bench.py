"""Headline timing: 3rd-order Gaussian IIR blur on a 4K image, one GPU.

Prints the card (name and power limit, from nvidia-smi) and ONE JSON line
with the device kind JAX reports and the per-application time of the
shipping default grade (px6) and of throughput mode ("default" = TF32 on
the GPU). Refuses to run on any backend but the GPU.

Timing: iterations run INSIDE one jitted ``lax.fori_loop`` chaining each
output into the next input, a scalar reduction is fetched to force
execution, and the per-iteration time is the SLOPE between two iteration
counts — dispatch and fetch constants cancel. The chained loop adds one
full-image loop-carry copy per body, amortized by composing several
applications per body (``per_body``).
"""

import json
import sys
import time

import numpy as np


def _build_filter(h, w, sigma=5.0, tile=128):
    import recfilter as rf

    wts = rf.gaussian_weights(sigma, 3)
    x = rf.Dim("x", w)
    y = rf.Dim("y", h)
    F = rf.RecFilter("GaussianIIR")
    F[y, x] = np.zeros((h, w), dtype=np.float32)
    F.add_filter(+x, wts)
    F.add_filter(-x, wts)
    F.add_filter(+y, wts)
    F.add_filter(-y, wts)
    F.split(x, tile, y, tile)
    return F


def make_loop(fn, scale=None, per_body=1):
    """One jitted chained-iteration loop; the trip count is a traced argument
    so a single compile serves every measurement point.

    ``scale`` (a tiny float, e.g. 1e-7) bounds pipelines that GROW when
    iterated on their own output (integrator stages — SAT, the box/DoG
    double integrals — or rounding-noise amplification in throughput mode):
    the body output is multiplied by ``scale**per_body`` ONCE per loop body,
    so iterates stay bounded or underflow to zero for any trip count (zeros
    cost the same bandwidth as data); per body it fuses into the while-loop
    carry copy the harness already pays. Within one body the compositions
    run unscaled; per_body <= 4 keeps even the 4K SAT iterates within f32
    range.

    ``per_body`` composes fn that many times per loop body: XLA inserts one
    full-size loop-carry copy per while-loop iteration (a production
    single-dispatch call never pays it), so composing k applications per
    body amortizes the artifact to 1/k. The trip count still means BODY
    iterations — divide the slope by k."""
    import jax

    body_scale = None if scale is None else float(scale) ** per_body

    @jax.jit
    def loop(x, n):
        def body(i, v):
            for _ in range(per_body):
                v = fn(v)
            return v if body_scale is None else body_scale * v

        out = jax.lax.fori_loop(0, n, body, x)
        first = out[(0,) * out.ndim]
        last = out[(-1,) * out.ndim]
        return first + last

    return loop


def slope_ms_per_iter(fn, img, min_window_ms=80.0, repeats=3, scale=None,
                      per_body=1):
    """ms per application of fn, from the slope between two trip counts
    (dispatch/fetch constants cancel).

    The trip-count spread is sized so the extra device time dwarfs host
    jitter (≥ ``min_window_ms``), and the median of ``repeats`` slopes is
    returned."""
    import jax.numpy as jnp

    loop = make_loop(fn, scale=scale, per_body=per_body)
    float(loop(img, jnp.int32(1)))  # warm up + compile

    def timed(n):
        t0 = time.perf_counter()
        s = float(loop(img, jnp.int32(n)))
        dt = (time.perf_counter() - t0) * 1000.0
        assert np.isfinite(s), "benchmark produced non-finite output"
        return dt

    # Rough estimate to size the window.
    rough = max((timed(64) - timed(2)) / 62.0, 1e-4)
    spread = int(min(max(min_window_ms / rough, 50), 20000))
    slopes = []
    for _ in range(repeats):
        t1, t2 = timed(2), timed(2 + spread)
        slopes.append((t2 - t1) / spread)
    return max(float(np.median(slopes)) / per_body, 1e-6)


def main():
    import subprocess

    import jax
    import jax.numpy as jnp

    from recfilter.utils import timing

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    print(f"[bench] card {card.strip()}", file=sys.stderr)
    if jax.default_backend() != "gpu":
        raise SystemExit(f"bench: backend {jax.default_backend()!r}, not gpu")

    h = w = 4096
    from recfilter.planner import auto_tile_width

    T = auto_tile_width(w)
    fn = _build_filter(h, w, tile=T).as_func()
    F_fast = _build_filter(h, w, tile=T)
    F_fast.set_plan(matmul_precision="default")
    fn_fast = F_fast.as_func()
    img = jnp.asarray(
        np.random.default_rng(0).standard_normal((h, w)) * 0.01,
        dtype=jnp.float32,
    )
    # The headline Gaussian is a stable low-pass (iterates on its own
    # output decay), so it needs no loop scale and tolerates any per_body.
    ms = slope_ms_per_iter(fn, img, per_body=8)
    ms_fast = slope_ms_per_iter(fn_fast, img, per_body=8)
    pixels = h * w
    d = jax.devices()[0]
    print(json.dumps({
        "metric": "gaussian_iir_4k_mpix_s",
        "value": round(timing.mpix_per_sec(ms, pixels), 1),
        "unit": "Mpix/s",
        "ms_per_iter": round(ms, 4),
        "precision_mode": "px6",
        "tile": T,
        "throughput_mode_ms_per_iter": round(ms_fast, 4),
        "device": {"platform": d.platform, "kind": d.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
