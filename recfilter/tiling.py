"""Overlapped-tiling engine: blocked IIR scans as pure matmuls.

Rebuild of the reference's tiling transformation
(``lib/split.cpp:1850-2080`` and the term builders it calls). Where the
reference mechanically rewrites Halide loop nests into a DAG of generated
functions (Intra/Tail/CTail/Deps/Final, ``lib/split.cpp:20-30``), here the
same algebra is expressed directly as array programs:

    reshape w → (n, T)                                     # tile
    b_t   = P·B · x_t            (k×T matmul)              # local tails
            ≙ create_intra_tile_term + extract_tails_from_each_scan
              (``lib/split.cpp:503-665``, ``:256-499``)
    s_prev = M · b               (one (n·k)² matmul)       # completed carries
            ≙ create_complete_tail_term's sequential tile loop
              (``lib/split.cpp:743-867``) — here a single precomputed
              block-Toeplitz matmul (see coeffs.carry_chain_matrix)
    y_t   = [R | B] · [s_prev_t ; x_t]   (T×(T+k) matmul)  # completion
            ≙ create_final_residual_term + add_residuals_to_final_result
              (``lib/split.cpp:1008-1130``, ``:1647-1780``)

Everything maps onto matmuls; there is no sequential device code at all in
this backend. Mixed causality needs no anti-diagonal bookkeeping
(``lib/split.cpp:164-178``) because anticausal scans are evaluated as
flip∘causal∘flip, which XLA fuses into the surrounding copies.

Scans are applied in definition order; same-dimension scans cascade through
this pass one at a time (legal per ``lib/reorder.cpp:28-176``). The fused
multi-scan single-read path lives in ``recfilter.dimfuse``.
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from . import coeffs
from .spec import BorderMode, FilterSpec


def _compute_dtype(dtype) -> jnp.dtype:
    """Accumulation dtype: never carry in bf16 (float sensitivity of the
    tiled algebra — geometric growth/decay of W powers)."""
    dtype = jnp.dtype(dtype)
    if dtype in (jnp.bfloat16, jnp.float16):
        return jnp.dtype(jnp.float32)
    return dtype


def tiled_scan_matrices(
    feedfwd: float,
    feedback: Sequence[float],
    tile_width: int,
    num_tiles: int,
    clamp_border: bool,
):
    """Precompute (host, float64→caller casts) the four static matrices of one
    blocked scan: B, B_first (border variant), PB tails extractor rows,
    [R|B] completion matrix, and the carry-chain solve matrix M."""
    T, k = int(tile_width), len(tuple(feedback))
    B = coeffs.impulse_matrix(feedfwd, feedback, T, clamp_border=False)
    B_first = (
        coeffs.impulse_matrix(feedfwd, feedback, T, clamp_border=True)
        if clamp_border
        else B
    )
    P = coeffs.tail_projector(T, k)
    R = coeffs.state_matrix(feedback, T)
    M = coeffs.carry_chain_matrix(feedback, T, num_tiles, prev=True)
    RB = np.concatenate([R, B], axis=1)  # (T, k+T)
    return {
        "B": B,
        "B_first": B_first,
        "PB": P @ B,
        "PB_first": P @ B_first,
        "RB": RB,
        "M": M,
    }


def blocked_scan_last_axis(
    x,  # (L, w) — batch lines × scan axis
    feedfwd: float,
    feedback: Sequence[float],
    tile_width: int,
    clamp_border: bool,
    return_intermediates: bool = False,
):
    """One causal blocked scan along the last axis of a 2-D array.

    Width need not divide the tile: input is zero-padded at the end, which is
    semantics-preserving for a causal scan (padding never feeds back into
    in-range outputs) — the reference instead requires divisibility
    (``lib/split.cpp:1908-1916``); padding is the shape-static JAX equivalent.
    """
    L, w = x.shape
    T = int(min(tile_width, w))
    n = -(-w // T)
    pad = n * T - w
    k = len(tuple(feedback))
    cdt = _compute_dtype(x.dtype)

    mats = tiled_scan_matrices(feedfwd, feedback, T, n, clamp_border)
    RB = jnp.asarray(mats["RB"], dtype=cdt)
    PB = jnp.asarray(mats["PB"], dtype=cdt)
    M = jnp.asarray(mats["M"], dtype=cdt)

    xt = x.astype(cdt)
    if pad:
        xt = jnp.pad(xt, ((0, 0), (0, pad)))
    xt = xt.reshape(L, n, T)

    # Local (incomplete) tails of every tile: b = PB @ x_t.
    b = jnp.einsum("kt,lnt->lnk", PB, xt, preferred_element_type=cdt,
                   precision=jax.lax.Precision.HIGHEST)
    if clamp_border:
        PBf = jnp.asarray(mats["PB_first"], dtype=cdt)
        b0 = jnp.einsum("kt,lt->lk", PBf, xt[:, 0], preferred_element_type=cdt,
                   precision=jax.lax.Precision.HIGHEST)
        b = b.at[:, 0, :].set(b0)

    # Incoming completed state of every tile in one matmul.
    s_prev = jnp.einsum(
        "ls,ts->lt", b.reshape(L, n * k), M,
        precision=jax.lax.Precision.HIGHEST,
    ).reshape(L, n, k)

    # Completion: y_t = R @ s_prev_t + B @ x_t as a single fused matmul.
    z = jnp.concatenate([s_prev, xt], axis=-1)  # (L, n, k+T)
    y = jnp.einsum("tz,lnz->lnt", RB, z, preferred_element_type=cdt,
                   precision=jax.lax.Precision.HIGHEST)
    if clamp_border:
        Bf = jnp.asarray(mats["B_first"], dtype=cdt)
        y0 = jnp.einsum("ts,ls->lt", Bf, xt[:, 0], preferred_element_type=cdt,
                   precision=jax.lax.Precision.HIGHEST)
        y = y.at[:, 0, :].set(y0)  # s_prev_0 == 0, so no R term for tile 0

    y = y.reshape(L, n * T)
    if pad:
        y = y[:, :w]
    y = y.astype(x.dtype)
    if return_intermediates:
        # Stage outputs matching the synthesized graph (see graph.build_graph):
        # Intra ≙ local tails b, CTail ≙ incoming completed carries s_prev.
        return y, {"intra_tails": b, "ctail": s_prev}
    return y


def tiled_apply_scan(
    x,
    axis: int,
    causal: bool,
    feedfwd: float,
    feedback: Sequence[float],
    tile_width: int,
    border: str = BorderMode.ZERO,
):
    """Apply one blocked scan along ``axis`` of an arbitrary-rank array."""
    x = jnp.moveaxis(x, axis, -1)
    shape = x.shape
    if not causal:
        x = jnp.flip(x, axis=-1)
    flat = x.reshape(-1, shape[-1])
    y = blocked_scan_last_axis(
        flat, feedfwd, feedback, tile_width, border == BorderMode.CLAMP
    )
    y = y.reshape(shape)
    if not causal:
        y = jnp.flip(y, axis=-1)
    return jnp.moveaxis(y, -1, axis)


@partial(jax.jit, static_argnums=0)
def apply_filter(spec: FilterSpec, x):
    """Tiled executor: every scan of ``spec`` as a blocked matmul pass.

    Untiled dimensions (tile width 0) fall back to the lax.scan core.
    """
    from . import scan_core

    dtype = jnp.dtype(spec.dtype)
    if jnp.issubdtype(dtype, jnp.integer):
        # Integer images: exact arithmetic via the scan core (reference casts
        # coefficients into the image type, ``lib/recfilter.cpp:324-341``).
        return scan_core.apply_filter(spec, x)

    cdt = _compute_dtype(dtype)
    x = x.astype(cdt)
    tiles = spec.tile_widths or (0,) * spec.ndim
    for s in spec.scans:
        T = tiles[s.axis]
        if T and T > 0:
            x = tiled_apply_scan(
                x, s.axis, s.causal, s.feedfwd, s.feedback, T, spec.border
            )
        else:
            x = scan_core.apply_scan(
                x, s.axis, s.causal, s.feedfwd, s.feedback, spec.border
            )
    return x.astype(dtype)
