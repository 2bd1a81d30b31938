"""Untiled scan executors: the numpy oracle and the `lax.scan` reference path.

Two independent implementations of the filter semantics defined by
``RecFilter::add_filter`` (``lib/recfilter.cpp:264-392``):

* ``oracle_apply_scan`` / ``oracle_apply`` — plain numpy loops, the
  definitional oracle. Mirrors the brute-force loop-nest references the
  reference's tests compare against (e.g. ``tests/test_generic_xy.cpp:56-109``).

* ``apply_scan`` / ``apply_filter`` — jittable, ``jax.lax.scan``-based,
  sequential along the scan axis but vectorized across all other axes. This is
  the "untiled" executor, the analog of realizing the filter without
  ``split()`` (``full_schedule`` path, ``lib/recfilter.cpp:396-403``). It is
  the correctness anchor the tiled engine is tested against, and the execution
  path for integer dtypes (where the reference casts coefficients into the
  image type, ``lib/recfilter.cpp:324-341``).

Scan semantics (causal):
    v[x] = b0·v[x] + Σ_j a_j · v[x-(j+1)]       updated in place, x ascending
with zero border (out-of-range taps contribute 0 — the ``select(rx>j, …, 0)``
in the reference) or clamped border (out-of-range taps clamp to index 0 of the
in-place array). Anticausal is the exact mirror (x ↦ w-1-x).
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .spec import BorderMode, FilterSpec, Scan


# ---------------------------------------------------------------------------
# numpy oracle
# ---------------------------------------------------------------------------


def oracle_apply_scan(
    v: np.ndarray,
    axis: int,
    causal: bool,
    feedfwd: float,
    feedback: Sequence[float],
    border: str = BorderMode.ZERO,
) -> np.ndarray:
    """Apply one scan with plain numpy loops (definitional oracle)."""
    # scanned axis first and C-contiguous: every step reads and writes one
    # contiguous slab of lines
    v = np.moveaxis(np.asarray(v), axis, 0)
    if not causal:
        v = v[::-1]
    moved = v.shape
    out = np.ascontiguousarray(v).reshape(moved[0], -1).copy()
    vin = out.copy()
    w = out.shape[0]
    a = list(feedback)
    k = len(a)
    clamp = border == BorderMode.CLAMP
    for x in range(w):
        acc = feedfwd * vin[x]
        for j in range(k):
            if x - j - 1 >= 0:
                acc = acc + a[j] * out[x - j - 1]
            elif clamp:
                # out[0] has not been stored yet when x == 0, so this
                # reads the pre-update value there — exactly Halide's
                # evaluate-RHS-before-store semantics.
                acc = acc + a[j] * out[0]
        out[x] = acc
    out = out.reshape(moved)
    if not causal:
        out = out[::-1]
    return np.moveaxis(out, 0, axis)


def oracle_apply(spec: FilterSpec, x: np.ndarray) -> np.ndarray:
    """Apply every scan of ``spec`` in definition order with the numpy oracle."""
    x = np.asarray(x)
    dtype = np.dtype(spec.dtype)
    if np.issubdtype(dtype, np.integer):
        x = x.astype(dtype)
        for s in spec.scans:
            ff = dtype.type(s.feedfwd)
            fb = [dtype.type(c) for c in s.feedback]
            x = oracle_apply_scan(x, s.axis, s.causal, ff, fb, spec.border)
        return x
    x = x.astype(np.float64)
    for s in spec.scans:
        x = oracle_apply_scan(
            x, s.axis, s.causal, s.feedfwd, s.feedback, spec.border
        )
    return x.astype(dtype)


# ---------------------------------------------------------------------------
# lax.scan executor
# ---------------------------------------------------------------------------


def _scan_last_axis(x, feedfwd, feedback, clamp: bool, init_state=None):
    """Causal scan along the last axis of ``x`` (any leading batch dims).

    State is the shift register s[j] = y[x-1-j] (k most recent outputs,
    nearest first). With zero init this reproduces the zero-border
    ``select(rx>j, …, 0)`` exactly. For clamped borders the first k outputs
    are peeled off and unrolled (k is tiny and static), after which the
    steady-state recurrence needs no clamping.

    ``init_state`` ((k, *batch), same shift-register convention) seeds the
    recurrence with real incoming outputs instead of zeros — the exact
    (dtype-preserving) continuation used by the streaming executor across
    chunks; mutually exclusive with ``clamp`` (a mid-sequence chunk has no
    border).
    """
    k = len(feedback)
    w = x.shape[-1]
    dtype = x.dtype
    a = [jnp.asarray(c, dtype=dtype) for c in feedback]
    b0 = jnp.asarray(feedfwd, dtype=dtype)

    if init_state is not None:
        assert not clamp, "init_state seeds a mid-sequence chunk (no border)"
        xs = jnp.moveaxis(x, -1, 0)

        def step_c(s, u):
            y = b0 * u
            for j in range(k):
                y = y + a[j] * s[j]
            s = (
                jnp.concatenate([y[None], s[:-1]], axis=0)
                if k > 1
                else y[None]
            )
            return s, y

        _, ys_c = jax.lax.scan(step_c, init_state.astype(dtype), xs)
        return jnp.moveaxis(ys_c, 0, -1)

    # Peel the first min(k, w) outputs when clamping (taps reach off-edge).
    n_peel = min(k, w) if clamp else 0
    ys = []
    for xx in range(n_peel):
        acc = b0 * x[..., xx]
        for j in range(k):
            idx = xx - j - 1
            if idx >= 0:
                acc = acc + a[j] * ys[idx]
            elif xx == 0:
                acc = acc + a[j] * x[..., 0]  # pre-update site value
            else:
                acc = acc + a[j] * ys[0]
        ys.append(acc)

    if n_peel >= w:
        return jnp.stack(ys, axis=-1)

    if n_peel:
        init = jnp.stack([ys[n_peel - 1 - j] for j in range(k)], axis=0)
    else:
        init = jnp.zeros((k,) + x.shape[:-1], dtype=dtype)

    xs = jnp.moveaxis(x[..., n_peel:], -1, 0)  # (steps, *batch)

    def step(s, u):
        y = b0 * u
        for j in range(k):
            y = y + a[j] * s[j]
        s = jnp.concatenate([y[None], s[:-1]], axis=0) if k > 1 else y[None]
        return s, y

    _, tail = jax.lax.scan(step, init, xs)
    tail = jnp.moveaxis(tail, 0, -1)
    if n_peel:
        return jnp.concatenate([jnp.stack(ys, axis=-1), tail], axis=-1)
    return tail


def apply_scan(
    x,
    axis: int,
    causal: bool,
    feedfwd,
    feedback,
    border: str = BorderMode.ZERO,
):
    """Jittable single-scan application along ``axis`` (any array rank)."""
    x = jnp.moveaxis(x, axis, -1)
    if not causal:
        x = jnp.flip(x, axis=-1)
    y = _scan_last_axis(x, feedfwd, feedback, border == BorderMode.CLAMP)
    if not causal:
        y = jnp.flip(y, axis=-1)
    return jnp.moveaxis(y, -1, axis)


@partial(jax.jit, static_argnums=0)
def apply_filter(spec: FilterSpec, x):
    """Untiled executor: all scans of ``spec`` in order via lax.scan."""
    dtype = jnp.dtype(spec.dtype)
    if jnp.issubdtype(dtype, jnp.integer):
        x = x.astype(dtype)
        for s in spec.scans:
            ff = np.dtype(spec.dtype).type(s.feedfwd)
            fb = [np.dtype(spec.dtype).type(c) for c in s.feedback]
            x = apply_scan(x, s.axis, s.causal, ff, fb, spec.border)
        return x
    compute = jnp.float32 if dtype in (jnp.bfloat16, jnp.float16) else dtype
    x = x.astype(compute)
    for s in spec.scans:
        x = apply_scan(x, s.axis, s.causal, s.feedfwd, s.feedback, spec.border)
    return x.astype(dtype)
