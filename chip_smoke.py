#!/usr/bin/env python3
"""Bring-up check of the filter engine on an NVIDIA GPU.

    python chip_smoke.py               # every one-card phase, one process
    python chip_smoke.py --four-cards  # only the sharded four-card phase

Drives the public entry points (``RecFilter`` → ``split`` → ``as_func`` under
``jax.jit``, and the app builders) at full size on the card, compares each
route with the repo's plain references (the float64 loop-nest oracle
``scan_core.oracle_apply``, numpy cumulative sums, the float64 FIR oracle,
the analytic adjoint) and checks that no traced program holds a
``pallas_call``. Prints the card's name and power limit first, one line per
phase (shape, grade, max relative error against its bound, median
wall-clock ms over a few calls after warm-up), and as its last line one
JSON object with the device JAX reports. Any failed check raises, so the
script exits non-zero; so does a run where JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from typing import Callable, Tuple

import numpy as np

FULL = dict(img=4096, big=8192, vol=256, audio=10_000_000, grad=1024,
            dog_sat=256, mesh_img=4096)
TINY = dict(img=256, big=384, vol=32, audio=300_000, grad=128, dog_sat=256,
            mesh_img=128)

SIGMA = 5.0


def card_lines() -> list:
    """``name, power.limit`` of every card, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def require_gpu(backend: str) -> None:
    """Refuse any backend but the GPU: there is no CPU fallback."""
    if backend != "gpu":
        raise SystemExit(
            f"chip_smoke: JAX backend is {backend!r}, not 'gpu'; no result")


def result_line(devices) -> str:
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def has_pallas_call(jaxpr) -> bool:
    """True when ``jaxpr`` (a ClosedJaxpr or Jaxpr) or any sub-jaxpr holds
    a ``pallas_call``."""
    jx = getattr(jaxpr, "jaxpr", jaxpr)
    for eqn in jx.eqns:
        if eqn.primitive.name == "pallas_call":
            return True
        for v in eqn.params.values():
            subs = v if isinstance(v, (list, tuple)) else (v,)
            for sub in subs:
                if hasattr(sub, "eqns") or hasattr(getattr(sub, "jaxpr", None),
                                                   "eqns"):
                    if has_pallas_call(sub):
                        return True
    return False


def rel_err(got, want) -> float:
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all(), "non-finite output"
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-300))


@dataclasses.dataclass
class Phase:
    """One route: ``build()`` returns ``(fn, args, check)``; ``check(out)``
    returns ``(err, bound)``."""

    name: str
    grade: str
    build: Callable[[], Tuple[Callable, tuple, Callable]]


# ---------------------------------------------------------------------------
# Builders (all through the public API)
# ---------------------------------------------------------------------------


def _gauss_filter(h, w, border_clamp=False, dtype="float32"):
    import recfilter as rf
    from recfilter.planner import auto_tile_width

    T = auto_tile_width(min(h, w))
    wts = rf.gaussian_weights(SIGMA, 3)
    x, y = rf.Dim("x", w), rf.Dim("y", h)
    F = rf.RecFilter("GaussianIIR")
    if border_clamp:
        F.set_clamped_image_border()
    F[y, x] = np.zeros((h, w), dtype=dtype)
    F.add_filter(+x, wts)
    F.add_filter(-x, wts)
    F.add_filter(+y, wts)
    F.add_filter(-y, wts)
    F.split(x, T, y, T)
    return F


def _img(shape, seed, lo=None):
    rng = np.random.default_rng(seed)
    if lo is None:
        return rng.standard_normal(shape).astype(np.float32)
    return rng.uniform(lo, 1.0, shape).astype(np.float32)


def _oracle(spec, x):
    from recfilter import scan_core

    return scan_core.oracle_apply(spec, np.asarray(x, np.float64))


def gaussian_phases(n, grades):
    """The headline pipeline at ``n``² for each ``(grade, bound)``; the
    phases share one input and one oracle evaluation."""
    memo = {}

    def data():
        if not memo:
            F = _gauss_filter(n, n)
            memo["x"] = _img((n, n), seed=1)
            memo["want"] = _oracle(F.spec, memo["x"])
        return memo["x"], memo["want"]

    def phase(grade, bound):
        def build():
            import jax
            import jax.numpy as jnp

            F = _gauss_filter(n, n)
            F.set_plan(matmul_precision=grade)
            x, want = data()
            return (jax.jit(F.as_func()), (jnp.asarray(x),),
                    lambda y: (rel_err(y, want), bound))

        return Phase(f"gaussian3_{n}", grade, build)

    return [phase(g, b) for g, b in grades]


def phase_sat_int32(n):
    def build():
        import jax
        import jax.numpy as jnp

        import recfilter as rf
        from recfilter.planner import auto_tile_width

        T = auto_tile_width(n)
        x, y = rf.Dim("x", n), rf.Dim("y", n)
        F = rf.RecFilter("SAT_int32")
        F[y, x] = np.zeros((n, n), dtype=np.int32)
        F.add_filter(+x, [1, 1])
        F.add_filter(+y, [1, 1])
        F.split(x, T, y, T)
        img = np.random.default_rng(2).integers(
            -2 ** 20, 2 ** 20, (n, n)).astype(np.int32)
        # wrap semantics: the int32 result equals the exact sum mod 2^32
        want = img.astype(np.int64).cumsum(1).cumsum(0) & 0xFFFFFFFF

        def check(out):
            got = np.asarray(out).astype(np.int64) & 0xFFFFFFFF
            return float(np.count_nonzero(got != want)), 0.0

        return jax.jit(F.as_func()), (jnp.asarray(img),), check

    return Phase(f"sat_int32_{n}", "exact", build)


def phase_sat_f32(n):
    def build():
        import jax
        import jax.numpy as jnp

        import recfilter as rf
        from recfilter.planner import auto_tile_width

        T = auto_tile_width(n)
        x, y = rf.Dim("x", n), rf.Dim("y", n)
        F = rf.RecFilter("SAT_f32")
        F[y, x] = np.zeros((n, n), dtype=np.float32)
        F.add_filter(+x, [1.0, 1.0])
        F.add_filter(+y, [1.0, 1.0])
        F.split(x, T, y, T)
        img = _img((n, n), seed=3, lo=0.0)
        want = img.astype(np.float64).cumsum(1).cumsum(0)
        return (jax.jit(F.as_func()), (jnp.asarray(img),),
                lambda y: (rel_err(y, want), 1e-5))

    return Phase(f"sat_f32_{n}", "px6", build)


def _box3_oracle(img, B):
    from recfilter import fir

    taps = fir.box_taps(B, 3)
    return fir.fir_oracle(fir.fir_oracle(img, taps, 1), taps, 0)


def phase_box3(n, B=5):
    def build():
        import jax
        import jax.numpy as jnp

        from recfilter.apps import box

        img = _img((n, n), seed=4, lo=0.0)
        want = _box3_oracle(img, B)
        return (jax.jit(box.box_filter_3(n, n, B)), (jnp.asarray(img),),
                lambda y: (rel_err(y, want), 1e-5))

    return Phase(f"box3_{n}", "px6", build)


def phase_dog(n, variant, bound, B1=5, B2=9):
    """DoG = box³(B1) − box³(B2). The "sat" variant (the reference's own
    integral-image formulation) holds only in the interior, and its f32
    cancellation grows with the image area (integral values ~ w²), so it
    is checked on the interior of a small image; the default "fir" variant
    holds everywhere at any size."""
    def build():
        import jax.numpy as jnp

        from recfilter.apps.dog import difference_of_gaussians

        img = _img((n, n), seed=5)
        # zeroed margins, as the reference app does (diff_gauss.cpp:57-66)
        pad = 2 * (max(B1, B2) + 1) + 1
        img[:pad] = img[-pad:] = 0
        img[:, :pad] = img[:, -pad:] = 0
        want = _box3_oracle(img, B1) - _box3_oracle(img, B2)
        m = 3 * (max(B1, B2) + 1) + 3 if variant == "sat" else 0
        inner = (slice(m, n - m),) * 2
        scale = np.abs(want).max()

        def check(y):
            y = np.asarray(y, np.float64)
            assert np.isfinite(y).all(), "non-finite output"
            return float(np.abs(y - want)[inner].max() / scale), bound

        fn = difference_of_gaussians(n, n, B1, B2, variant=variant)
        return fn, (jnp.asarray(img),), check

    return Phase(f"dog_{variant}_{n}", "px6", build)


def phase_usm(n, weight=1.0):
    def build():
        import jax.numpy as jnp

        from recfilter.apps import gaussian
        from recfilter.apps.usm import unsharp_mask

        img = _img((n, n), seed=6, lo=0.0)
        blur = img.astype(np.float64)
        for f in gaussian.gaussian_3x_3y(n, n, sigma=SIGMA):
            blur = _oracle(f.spec, blur)
        want = (1.0 + weight) * img - weight * blur
        fn = unsharp_mask(n, n, sigma=SIGMA, weight=weight, fused=True)
        return fn, (jnp.asarray(img),), lambda y: (rel_err(y, want), 1e-5)

    return Phase(f"usm_fused_{n}", "px6", build)


def phase_volume(n):
    def build():
        import jax
        import jax.numpy as jnp

        import recfilter as rf
        from recfilter.planner import auto_tile_width

        T = auto_tile_width(n)
        wts = rf.gaussian_weights(SIGMA, 3)
        z, y, x = rf.Dim("z", n), rf.Dim("y", n), rf.Dim("x", n)
        F = rf.RecFilter("Gaussian3D")
        F[z, y, x] = np.zeros((n, n, n), dtype=np.float32)
        for d in (x, y, z):
            F.add_filter(+d, wts)
            F.add_filter(-d, wts)
        F.split(x, T, y, T, z, T)
        vol = _img((n, n, n), seed=7)
        want = _oracle(F.spec, vol)
        return (jax.jit(F.as_func()), (jnp.asarray(vol),),
                lambda v: (rel_err(v, want), 1e-5))

    return Phase(f"volume_gaussian3_{n}^3", "px6", build)


def phase_audio(n, order=2):
    def build():
        import jax
        import jax.numpy as jnp
        from scipy.signal import lfilter

        from recfilter.apps.audio import audio_filter_high_order

        F = audio_filter_high_order(n, order, tile_width=1000)
        sig = _img((n,), seed=8, lo=0.0)
        coeff = [1.0] + [0.01] * order
        # the difference equation y[i] = x[i] + Σ a_j y[i-j], zero state
        want = lfilter([coeff[0]], [1.0] + [-a for a in coeff[1:]],
                       sig.astype(np.float64))
        return (jax.jit(F.as_func()), (jnp.asarray(sig),),
                lambda y: (rel_err(y, want), 1e-5))

    return Phase(f"audio_order{order}_{n}", "px6", build)


def _transposed_spec(spec):
    """The adjoint of a zero-border filter: the scans in reverse order with
    causality flipped (the transpose of a causal scan is the anticausal
    scan with the same coefficients)."""
    from recfilter.spec import Scan

    return dataclasses.replace(spec, scans=tuple(
        Scan(s.axis, not s.causal, s.feedfwd, s.feedback)
        for s in reversed(spec.scans)))


def phase_grad(n):
    def build():
        import jax
        import jax.numpy as jnp

        F = _gauss_filter(n, n)
        fwd = F.as_func()
        x = _img((n, n), seed=9)
        ct = _img((n, n), seed=10)
        want = _oracle(_transposed_spec(F.spec), ct)
        ctj = jnp.asarray(ct)
        fn = jax.jit(jax.grad(lambda v: (fwd(v) * ctj).sum()))
        return fn, (jnp.asarray(x),), lambda g: (rel_err(g, want), 1e-5)

    return Phase(f"grad_gaussian3_{n}", "px6", build)


def phase_learnable(n):
    def build():
        import jax
        import jax.numpy as jnp
        import optax

        import recfilter as rf
        from recfilter import learnable
        from recfilter.planner import auto_tile_width

        F = _gauss_filter(n, n)
        L = learnable.LearnableRecFilter(F.spec,
                                         tile_width=auto_tile_width(n))
        params = L.init_params()
        x = _img((n, n), seed=11)
        # target: the same filter class at another sigma
        wt = rf.gaussian_weights(SIGMA / 2, 3)
        tspec = dataclasses.replace(F.spec, scans=tuple(
            dataclasses.replace(s, feedfwd=float(wt[0]),
                                feedback=tuple(float(c) for c in wt[1:]))
            for s in F.spec.scans))
        target = jnp.asarray(_oracle(tspec, x), jnp.float32)
        opt = optax.adam(1e-5)

        def loss_fn(p, v):
            return ((L.apply(p, v) - target) ** 2).mean()

        def step(p, s, v):
            loss, g = jax.value_and_grad(loss_fn)(p, v)
            upd, s = opt.update(g, s, p)
            return optax.apply_updates(p, upd), s, loss

        def run(p, v):
            s = opt.init(p)
            p1, s1, l0 = step(p, s, v)
            _, _, l1 = step(p1, s1, v)
            return jnp.stack([l0, l1])

        def check(losses):
            l0, l1 = (float(v) for v in np.asarray(losses))
            assert np.isfinite([l0, l1]).all(), (l0, l1)
            # the step must lower the loss: report the ratio, bound 1
            return l1 / l0, 1.0 - 1e-9

        return jax.jit(run), (params, jnp.asarray(x)), check

    return Phase(f"learnable_step_{n}", "highest", build)


def one_card_phases(sz) -> list:
    n, nb = sz["img"], sz["big"]
    return [
        # "default" leaves the dots to XLA: TF32 on the card (measured
        # 6.7e-3 and 9.9e-3 on two calls; XLA's autotuned choice varies)
        *gaussian_phases(n, [("px6", 1e-5), ("default", 3e-2)]),
        *gaussian_phases(nb, [("px6", 1e-5)]),
        phase_sat_int32(n),
        phase_sat_f32(n),
        phase_box3(n),
        phase_dog(n, "fir", 1e-5),
        phase_dog(sz["dog_sat"], "sat", 1e-2),
        phase_usm(n),
        phase_volume(sz["vol"]),
        phase_audio(sz["audio"]),
        phase_grad(sz["grad"]),
        phase_learnable(sz["grad"]),
    ]


# ---------------------------------------------------------------------------
# Four cards: the sharded training step and its references
# ---------------------------------------------------------------------------


def four_card_phases(n: int, devices) -> list:
    """Sharded routes on a 4-device mesh, each against the same function
    on one device and against the oracle (and its gradient against the
    one-device gradient)."""

    def build_dataseq():
        import jax
        import jax.numpy as jnp
        import optax

        from recfilter.parallel import sharding
        from recfilter.planner import Plan

        F = _gauss_filter(n, n, border_clamp=True)
        mesh = sharding.make_mesh((2, 2), ("data", "seq"), devices)
        plan = Plan()
        one = F.as_func()
        x = _img((n, n), seed=12)
        target = jnp.asarray(_img((n, n), seed=13))
        want = _oracle(F.spec, x)
        opt = optax.sgd(1e-2)

        def run(z):
            outs = []
            for exchange in ("gather", "ring"):
                fwd = sharding.make_sharded_filter(
                    F.spec, plan, mesh, data_axis=0, seq_axis=1,
                    exchange=exchange)

                def loss_fn(p, fwd=fwd):
                    return ((fwd(p) - target) ** 2).mean()

                loss, g = jax.value_and_grad(loss_fn)(z)
                upd, _ = opt.update(g, opt.init(z))
                outs.append((fwd(z), g, optax.apply_updates(z, upd), loss))
            g1 = jax.grad(lambda p: ((one(p) - target) ** 2).mean())(z)
            return outs, one(z), g1

        def check(res):
            outs, y1, g1 = res
            errs = []
            for y, g, z2, loss in outs:
                assert np.isfinite(float(loss))
                assert np.isfinite(np.asarray(z2)).all()
                errs += [rel_err(y, want), rel_err(y, y1), rel_err(g, g1)]
            errs.append(rel_err(y1, want))
            return max(errs), 1e-5

        return jax.jit(run), (jnp.asarray(x),), check

    def build_seq2():
        import jax
        import jax.numpy as jnp

        from recfilter.parallel import sharding
        from recfilter.planner import Plan

        F = _gauss_filter(n, n, border_clamp=True)
        mesh = sharding.make_mesh((2, 2), ("seq", "seq2"), devices)
        fwd = sharding.make_sharded_filter(F.spec, Plan(), mesh,
                                           seq_axis=0, seq2_axis=1)
        one = F.as_func()
        x = _img((n, n), seed=14)
        want = _oracle(F.spec, x)

        def run(z):
            g = jax.grad(lambda q: (fwd(q) ** 2).mean())(z)
            g1 = jax.grad(lambda q: (one(q) ** 2).mean())(z)
            return fwd(z), one(z), g, g1

        def check(res):
            y, y1, g, g1 = res
            return max(rel_err(y, want), rel_err(y, y1),
                       rel_err(g, g1)), 1e-5

        return jax.jit(run), (jnp.asarray(x),), check

    def build_data_px():
        import jax
        import jax.numpy as jnp

        import recfilter as rf
        from recfilter.parallel import sharding
        from recfilter.planner import Plan, auto_tile_width

        T = auto_tile_width(n)
        wts = rf.gaussian_weights(SIGMA, 3)
        c, y, x = rf.Dim("c", 4), rf.Dim("y", n), rf.Dim("x", n)
        F = rf.RecFilter("GaussianBatch")
        F[c, y, x] = np.zeros((4, n, n), dtype=np.float32)
        for d in (x, y):
            F.add_filter(+d, wts)
            F.add_filter(-d, wts)
        F.split(x, T, y, T)
        mesh = sharding.make_mesh((4,), ("data",), devices)
        fwd = sharding.make_sharded_filter(
            F.spec, Plan(matmul_precision="px6"), mesh, data_axis=0)
        one = F.as_func()
        img = _img((4, n, n), seed=15)
        want = _oracle(F.spec, img)

        def run(z):
            return fwd(z), one(z)

        def check(res):
            yk, y1 = res
            return max(rel_err(yk, want), rel_err(yk, y1)), 1e-5

        return jax.jit(run), (jnp.asarray(img),), check

    return [Phase(f"sharded_data_seq_train_{n}", "px6", build_dataseq),
            Phase(f"sharded_seq2d_{n}", "px6", build_seq2),
            Phase(f"sharded_data_px6_4x{n}", "px6", build_data_px)]


# ---------------------------------------------------------------------------
# Running
# ---------------------------------------------------------------------------


def _block(tree):
    import jax

    return jax.block_until_ready(tree)


def run_phase(phase: Phase, card: str, reps: int = 5) -> dict:
    import jax

    fn, args, check = phase.build()
    assert not has_pallas_call(jax.make_jaxpr(fn)(*args)), (
        f"{phase.name}: pallas_call in the traced program")
    out = _block(fn(*args))  # compile + first run
    err, bound = check(out)
    assert err <= bound, f"{phase.name}: error {err:.3e} > bound {bound:.1e}"
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _block(fn(*args))
        times.append((time.perf_counter() - t0) * 1e3)
    shape = tuple(np.shape(args[-1]))
    rec = dict(phase=phase.name, shape=shape, grade=phase.grade, err=err,
               bound=bound, ms=float(np.median(times)), card=card)
    print(f"[phase] {phase.name} shape={shape} grade={phase.grade} "
          f"err={err:.3e} bound={bound:.1e} median_ms={rec['ms']:.3f} "
          f"card={card}", flush=True)
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the sharded four-card phase")
    ns = p.parse_args(argv)

    cards = card_lines()
    for ln in cards:
        print(f"[card] {ln}", flush=True)

    import jax

    require_gpu(jax.default_backend())
    card = cards[0]
    if ns.four_cards:
        devices = jax.devices()
        if len(devices) < 4:
            raise SystemExit(f"--four-cards needs 4 GPUs, found {len(devices)}")
        phases = four_card_phases(FULL["mesh_img"], devices[:4])
        devices = devices[:4]
    else:
        phases = one_card_phases(FULL)
        devices = jax.devices()[:1]
    for ph in phases:
        run_phase(ph, card)
    print(result_line(devices))
    return 0


if __name__ == "__main__":
    sys.exit(main())
