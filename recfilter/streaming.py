"""Out-of-core streaming execution: filter images larger than device memory.

No reference analog — the reference realizes whole buffers on one GPU
(``RecFilter::realize``, ``lib/recfilter.cpp:984-989``). Here the host array
streams through the device in chunks along one axis, and the cross-chunk
coupling uses the SAME overlapped-tiling algebra the executors use across
tiles (SURVEY §5.7), applied one level up:

  * groups scanning any non-chunk axis are embarrassingly chunk-parallel —
    each chunk runs the normal fused dimension pass;
  * a scan along the chunk axis runs per chunk with zero incoming state,
    then adds the incoming-carry response ``RN @ N`` (state matrix against
    the neighbor chunk's boundary values) — a rank-k correction — and the
    chunk's own boundary values become the next chunk's carry. Causal scans
    sweep forward, anticausal scans sweep backward; scan order is preserved
    (same-axis scans of opposite causality do not commute at borders).

Chunks move host↔device once per sweep; with ``k`` scans on the chunk axis
the image streams ``k+1`` times (once for all non-chunk groups, once per
chunk-axis scan) — the unavoidable cost of out-of-core operation.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import dimfuse, coeffs, scan_core
from .spec import BorderMode, FilterSpec


def _chunk_slices(n: int, chunk: int, min_last: int = 1):
    """Chunk [0, n) into runs of ``chunk``; a final run shorter than
    ``min_last`` (the max scan order — the carry must fit) merges into its
    predecessor."""
    sl = [slice(i, min(i + chunk, n)) for i in range(0, n, chunk)]
    if len(sl) > 1 and (sl[-1].stop - sl[-1].start) < min_last:
        sl[-2:] = [slice(sl[-2].start, n)]
    return sl


def apply_filter_streamed(
    spec: FilterSpec,
    image: np.ndarray,
    chunk_axis: int = 0,
    chunk: int = 1024,
    tile_default: int = 32,
    matmul_precision: str = "highest",
) -> np.ndarray:
    """Run ``spec`` over a host-resident array in device-sized chunks.

    ``image`` is a numpy (or memory-mapped) array; the result is written to
    a fresh host array of the same shape. ``chunk_axis`` picks the streamed
    dimension and ``chunk`` the number of lines per device round trip.
    """
    dtype = jnp.dtype(spec.dtype)
    if jnp.issubdtype(dtype, jnp.integer):
        return _apply_filter_streamed_int(spec, image, chunk_axis, chunk)
    chunk_axis = chunk_axis % spec.ndim  # scans_by_axis keys are non-negative
    if spec.tuple_width:
        spec = spec.stacked()
        chunk_axis = chunk_axis + 1
    clamp = spec.border == BorderMode.CLAMP
    tiles = spec.tile_widths or (0,) * spec.ndim
    groups = spec.scans_by_axis()

    kmax = max(
        (spec.scans[i].order for i in groups.get(chunk_axis, [])), default=1
    )
    if chunk < kmax:
        raise ValueError(
            f"chunk ({chunk}) must be >= the max scan order on the chunk "
            f"axis ({kmax}): the cross-chunk carry needs k boundary lines"
        )
    out = np.array(image, dtype=spec.dtype, copy=True)
    slices = _chunk_slices(out.shape[chunk_axis], chunk, min_last=kmax)

    def take(sl):
        idx = [slice(None)] * out.ndim
        idx[chunk_axis] = sl
        return tuple(idx)

    # --- non-chunk axes: embarrassingly chunk-parallel fused passes -------
    other = [(ax, ids) for ax, ids in groups.items() if ax != chunk_axis]
    if other:

        @jax.jit
        def run_other(x):
            for ax, ids in other:
                x = dimfuse.fused_dim_pass(
                    x, ax, [spec.scans[i] for i in ids],
                    tiles[ax] or tile_default, spec.border,
                    matmul_precision=matmul_precision,
                )
            return x

        for sl in slices:
            out[take(sl)] = np.asarray(run_other(jnp.asarray(out[take(sl)])))

    # --- chunk-axis scans: one carry-chained sweep per scan ---------------
    for sid in groups.get(chunk_axis, []):
        s = spec.scans[sid]
        k = s.order
        T = tiles[chunk_axis] or tile_default
        order = slices if s.causal else slices[::-1]

        # Per-chunk-length constants: RN (incoming-carry response, natural
        # order — see dimfuse._scan_base_mats) per distinct chunk length.
        def mats_for(c):
            R = coeffs.state_matrix(s.feedback, c)
            if s.causal:
                return R @ coeffs.antidiagonal(k)
            return R[::-1, :]

        import functools

        @functools.partial(jax.jit, static_argnums=(2,))
        def sweep_chunk(x, N, first):
            # zero-state local scan over this chunk (itself tiled inside);
            # only the direction-first chunk sees the clamp border
            xm = jnp.moveaxis(x, chunk_axis, -1)
            y = dimfuse.fused_dim_pass(
                xm, xm.ndim - 1, [s], T,
                spec.border if first else BorderMode.ZERO,
                matmul_precision=matmul_precision,
            )
            RN = jnp.asarray(mats_for(x.shape[chunk_axis]), y.dtype)
            # cross-chunk carry correction at the pass's matmul precision
            # (full-magnitude across chunks for integral-image filters; a
            # TF32 dot would round it to ~3 digits)
            y = y + jnp.einsum(
                "ck,...k->...c", RN, N,
                precision=dimfuse._matmul_precision(
                    y.dtype, None, matmul_precision
                ),
            )
            tail = y[..., -k:] if s.causal else y[..., :k]
            return jnp.moveaxis(y, -1, chunk_axis), tail

        lead_shape = tuple(
            d for i, d in enumerate(out.shape) if i != chunk_axis
        )
        N = jnp.zeros(lead_shape + (k,), dtype=spec.dtype)
        for j, sl in enumerate(order):
            x = jnp.asarray(out[take(sl)])
            y, N = sweep_chunk(x, N, clamp and j == 0)
            out[take(sl)] = np.asarray(y)

    return out


def _apply_filter_streamed_int(
    spec: FilterSpec, image: np.ndarray, chunk_axis: int, chunk: int
) -> np.ndarray:
    """Exact integer streaming: the float path's rank-k carry CORRECTION
    would round through floats, so integer chunks instead seed the next
    chunk's ``lax.scan`` with the real shift-register state (the previous
    chunk's last k outputs) — bit-exact, same as the unstreamed scan path."""
    chunk_axis = chunk_axis % spec.ndim
    if spec.tuple_width:
        spec = spec.stacked()
        chunk_axis = chunk_axis + 1
    clamp = spec.border == BorderMode.CLAMP
    groups = spec.scans_by_axis()
    kmax = max(
        (spec.scans[i].order for i in groups.get(chunk_axis, [])), default=1
    )
    if chunk < kmax:
        raise ValueError(
            f"chunk ({chunk}) must be >= the max scan order on the chunk "
            f"axis ({kmax}): the cross-chunk carry needs k boundary lines"
        )
    ity = np.dtype(spec.dtype).type
    out = np.array(image, dtype=spec.dtype, copy=True)
    slices = _chunk_slices(out.shape[chunk_axis], chunk, min_last=kmax)

    def take(sl):
        idx = [slice(None)] * out.ndim
        idx[chunk_axis] = sl
        return tuple(idx)

    other = [(ax, ids) for ax, ids in groups.items() if ax != chunk_axis]
    if other:

        @jax.jit
        def run_other(x):
            for ax, ids in other:
                for i in ids:
                    s = spec.scans[i]
                    x = scan_core.apply_scan(
                        x, ax, s.causal, ity(s.feedfwd),
                        [ity(c) for c in s.feedback], spec.border,
                    )
            return x

        for sl in slices:
            out[take(sl)] = np.asarray(run_other(jnp.asarray(out[take(sl)])))

    for sid in groups.get(chunk_axis, []):
        s = spec.scans[sid]
        k = s.order
        ff = ity(s.feedfwd)
        fb = [ity(c) for c in s.feedback]
        order = slices if s.causal else slices[::-1]

        import functools

        @functools.partial(jax.jit, static_argnums=(2,))
        def sweep_chunk(x, state, first, s=s, ff=ff, fb=fb, k=k):
            xm = jnp.moveaxis(x, chunk_axis, -1)
            if not s.causal:
                xm = jnp.flip(xm, axis=-1)
            y = scan_core._scan_last_axis(
                xm, ff, fb, clamp and first,
                init_state=None if first else state,
            )
            # next chunk's shift register: s[j] = y[end-1-j]
            st = jnp.stack([y[..., -1 - j] for j in range(k)], axis=0)
            if not s.causal:
                y = jnp.flip(y, axis=-1)
            return jnp.moveaxis(y, -1, chunk_axis), st

        state = None
        for j, sl in enumerate(order):
            x = jnp.asarray(out[take(sl)])
            y, state = sweep_chunk(x, state, j == 0)
            out[take(sl)] = np.asarray(y)

    return out
