"""Banded tile-FIR executor: small-support separable FIR banks as matmuls.

The reference computes iterated box filters as IIR integral images followed
by finite-differencing streams (``apps/box/box_filter.h:21-225``,
``apps/DoG/diff_gauss.cpp:72-110``), each stage its own pass over memory.

For the small supports these apps actually use (an n-times-iterated box of
radius B is an FIR with K = 2nB+1 taps; K = 55 for DoG's B2 = 9), the
matmul formulation is direct: tile the scanned axis by T and apply the
banded Toeplitz operator as one T×T matmul per tile plus two narrow
edge-strip matmuls against the neighbouring tiles — 2 image touches per
axis total, all FLOPs in tensor-core products, zero pointwise streams. Multi-channel banks
(DoG's dual radius) ride the same einsums, and the final cross-channel
difference contracts away inside the last matmul for free.

Border semantics are zero-padding — exactly the apps' contract (the
reference zero-pads its input margins before filtering,
``apps/DoG/diff_gauss.cpp:57-66``, ``apps/box/box_filter.h:9-11``), so
unlike the SAT-based path this one matches the brute-force oracle at every
pixel, not just the interior.

Layout chaining mirrors dimfuse: each pass contracts over lanes (the tiled
axis must be last) and can emit rotated so a following pass on the other
dimension again finds its axis last — no inter-pass relayouts.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from . import dimfuse
from . import planner
from .planner import auto_tile_width


def box_taps(B: int, iterations: int) -> np.ndarray:
    """Taps of an ``iterations``-times iterated, zero-padded box of radius
    B — the FIR equivalent of the reference's iterated integral-image
    pipelines (``apps/box/box_filter_3.cpp:37-41``). Exact in float64:
    the taps are small integers / (2B+1)^n. Support 2·n·B+1, centered."""
    one = np.ones(2 * B + 1, np.float64) / float(2 * B + 1)
    taps = one
    for _ in range(iterations - 1):
        taps = np.convolve(taps, one)
    return taps


def fir_oracle(x: np.ndarray, taps: np.ndarray, axis: int) -> np.ndarray:
    """float64 zero-padded correlation oracle: out[i] = Σ_t taps[t]·x[i+t-P]
    with P = (K-1)//2 … the centered convention `fir_pass_last` implements."""
    x = np.asarray(x, np.float64)
    taps = np.asarray(taps, np.float64)
    K = len(taps)
    P = (K - 1) // 2
    out = np.zeros_like(x)
    for t in range(K):
        src = np.take(
            np.pad(x, [(P, K - 1 - P) if a == axis % x.ndim else (0, 0)
                       for a in range(x.ndim)]),
            range(t, t + x.shape[axis]), axis=axis)
        out += taps[t] * src
    return out


def _align_taps(taps) -> np.ndarray:
    """Stack per-channel taps of differing support into one (C, K) array
    with centers aligned (zero taps are free — they only widen the band)."""
    rows = [np.asarray(t, np.float64).ravel() for t in taps]
    Pmax = max((len(t) - 1) // 2 for t in rows)
    Qmax = max(len(t) - 1 - (len(t) - 1) // 2 for t in rows)
    out = np.zeros((len(rows), Pmax + Qmax + 1), np.float64)
    for c, t in enumerate(rows):
        p = (len(t) - 1) // 2
        out[c, Pmax - p : Pmax - p + len(t)] = t
    return out


def _band_mats(taps: np.ndarray, T: int):
    """(W0, Wm, Wp): T×T main block plus the narrow neighbour-strip blocks
    of the banded Toeplitz operator out[o] = Σ_t taps[t]·x[o+t-P].

    Wm (T×P) multiplies the LAST P lanes of the previous tile; Wp (T×Q) the
    FIRST Q lanes of the next tile (P/Q = left/right halfwidths). Requires
    the support to fit within one tile on each side (P, Q ≤ T)."""
    taps = np.asarray(taps, np.float64)
    K = len(taps)
    P = (K - 1) // 2
    Q = K - 1 - P
    if P > T or Q > T:
        raise ValueError(
            f"FIR support ({K} taps) exceeds tile width {T}; use the IIR "
            f"integral-image pipeline for large radii")
    W0 = np.zeros((T, T), np.float64)
    Wm = np.zeros((T, max(P, 1)), np.float64)
    Wp = np.zeros((T, max(Q, 1)), np.float64)
    for o in range(T):
        for t in range(K):
            g = o + t - P  # global input lane relative to this tile's start
            if 0 <= g < T:
                W0[o, g] = taps[t]
            elif g < 0:
                Wm[o, P + g] = taps[t]  # lane T-P+ (P+g) of previous tile
            else:
                Wp[o, g - T] = taps[t]  # lane g-T of next tile
    return W0, Wm, Wp, P, Q


def _shift_tiles(S, back: bool):
    """Shift the tile axis (-2) so out-tile i sees its neighbour's strip:
    ``back`` pulls from tile i-1 (prepend a zero tile), else from i+1."""
    zeros = jnp.zeros_like(jax.lax.slice_in_dim(S, 0, 1, axis=S.ndim - 2))
    if back:
        return jnp.concatenate(
            [zeros, jax.lax.slice_in_dim(S, 0, S.shape[-2] - 1,
                                         axis=S.ndim - 2)], axis=S.ndim - 2)
    return jnp.concatenate(
        [jax.lax.slice_in_dim(S, 1, S.shape[-2], axis=S.ndim - 2), zeros],
        axis=S.ndim - 2)


def fir_pass_last(
    x,
    taps,
    *,
    tile_width: int = 0,
    bank: bool = False,
    contract: bool = False,
    emit_rot: bool = False,
    matmul_precision: str | None = None,
    matmul_dtype=None,
):
    """Apply a centered zero-padded FIR along the LAST axis via tile matmuls.

    ``taps``: (K,) plain 1→1; ``bank=True``: (C, K) — C output channels from
    one input, a leading channel axis appears; ``contract=True``: (C, K) with
    x carrying a leading channel axis that is SUMMED AWAY (signs folded into
    the taps — DoG's final difference is free here). ``emit_rot`` emits the
    output with the last two spatial axes swapped straight out of the einsum
    (rotation chaining, as dimfuse._last_axis_pass_t).

    Precision follows the Plan conventions: "highest"/"high"/"default" set
    the einsum precision; the compensated split-bf16 grades (px3/px4/px6,
    f32x3/f32x4/f32x6 — dimfuse._split_einsum) share one operand split
    across the main and both edge-strip matmuls; matmul_dtype="bfloat16"
    runs one bf16 product.
    """
    assert not (bank and contract)
    if matmul_precision is None:  # follow the process-wide Plan default
        matmul_precision = planner._DEFAULT_MATMUL_PRECISION[0]
    if isinstance(taps, (list, tuple)):
        taps = _align_taps(taps)  # ragged per-channel supports OK
    taps = np.atleast_2d(np.asarray(taps, np.float64))  # (C, K)
    C = taps.shape[0]
    L = x.shape[-1]
    T = tile_width or auto_tile_width(L)
    T = min(T, L)
    pad = (-L) % T
    n = (L + pad) // T

    mats = [_band_mats(t, T) for t in taps]
    W0 = np.stack([m[0] for m in mats])  # (C, T, T)
    Wm = np.stack([m[1] for m in mats])
    Wp = np.stack([m[2] for m in mats])
    P, Q = mats[0][3], mats[0][4]

    cdt = jnp.float32 if x.dtype not in (jnp.bfloat16, jnp.float16) else x.dtype
    acc = jnp.float32
    mmd = jnp.bfloat16 if matmul_dtype in ("bfloat16", jnp.bfloat16) else None

    prec = dimfuse._matmul_precision(cdt, mmd, matmul_precision)
    nsp = dimfuse._split_passes(cdt, mmd, matmul_precision)

    X = x.astype(cdt)
    if pad:
        cfg = [(0, 0)] * X.ndim
        cfg[-1] = (0, pad)
        X = jnp.pad(X, cfg)
    Xt = X.reshape(X.shape[:-1] + (n, T))

    # Einsum index plumbing. Spatial batch axes of the tiled input become
    # letters a, b, …; the tiled axis is (n, s)→(n, o).
    nbatch = Xt.ndim - 2 - (1 if contract else 0)
    batch = "abdefg"[:nbatch]
    lhs_b = ("c" if contract else "") + batch
    out_c = "c" if bank else ""
    if emit_rot:
        if nbatch < 1:
            raise ValueError("emit_rot needs a batch axis to rotate with")
        out = out_c + batch[:-1] + "no" + batch[-1]
    else:
        out = out_c + batch + "no"

    def one(Wfull, strips, width):
        eq = f"cow,{lhs_b}nw->{out}"
        if not (bank or contract):
            eq = eq.replace("cow", "ow")
            Wfull = Wfull[0]
        if nsp:
            return dimfuse._split_einsum(eq, Wfull, strips, nsp, acc)
        M = jnp.asarray(np.asarray(Wfull), dtype=mmd if mmd is not None else cdt)
        V = strips.astype(M.dtype)
        return jnp.einsum(eq, M, V, preferred_element_type=acc, precision=prec)

    # _split_einsum now takes the raw operand and splits internally (so
    # its custom VJP can transpose the exact einsum); the shift/slice forms
    # are shared by both precision branches.
    main_in = Xt
    prev_in = _shift_tiles(Xt[..., T - P:], True)
    next_in = _shift_tiles(Xt[..., :Q], False)

    Y = one(W0, main_in, T)
    if P:
        Y = Y + one(Wm, prev_in, P)
    if Q:
        Y = Y + one(Wp, next_in, Q)
    Y = Y.astype(x.dtype if jnp.issubdtype(x.dtype, jnp.floating) else cdt)

    # Collapse (n, o) back to the spatial extent and crop the zero pad.
    if emit_rot:
        # out = (*batch[:-1], n, o, last_batch): tiled axis now at -3/-2.
        shp = Y.shape[:-3] + (n * T, Y.shape[-1])
        Y = Y.reshape(shp)
        if pad:
            Y = jax.lax.slice_in_dim(Y, 0, L, axis=Y.ndim - 2)
    else:
        Y = Y.reshape(Y.shape[:-2] + (n * T,))
        if pad:
            Y = jax.lax.slice_in_dim(Y, 0, L, axis=Y.ndim - 1)
    return Y


def fir_separable_2d(
    image,
    taps_x,
    taps_y=None,
    signs=None,
    *,
    tile_width: int = 0,
    matmul_precision: str | None = None,
    matmul_dtype=None,
):
    """C-channel separable FIR bank over a 2-D image with a signed
    cross-channel reduction: out = Σ_c signs[c] · (taps_y[c] ⊗ taps_x[c]) * I.

    The x pass fans 1→C channels and emits rotated ((C, w, h)); the y pass
    then finds y on lanes, applies the per-channel y taps with the signs
    folded in, contracts the channel axis away inside its einsum, and emits
    rotated back to (h, w). Two HBM round-trips total — the differencing,
    channel stacking, and final subtraction of the SAT formulation all
    vanish into the matmuls. DoG = signs (+1, −1) over the two box³ radii
    (``apps/DoG/diff_gauss.cpp:84-110``); a plain iterated box is C = 1.
    """
    if isinstance(taps_x, (list, tuple)):
        taps_x = _align_taps(taps_x)
    taps_x = np.atleast_2d(np.asarray(taps_x, np.float64))
    if taps_y is None:
        taps_y = taps_x
    elif isinstance(taps_y, (list, tuple)):
        taps_y = _align_taps(taps_y)
    taps_y = np.atleast_2d(np.asarray(taps_y, np.float64))
    C = taps_x.shape[0]
    signs = np.ones(C) if signs is None else np.asarray(signs, np.float64)
    kw = dict(tile_width=tile_width, matmul_precision=matmul_precision,
              matmul_dtype=matmul_dtype)

    v = fir_pass_last(image, taps_x, bank=(C > 1), emit_rot=True, **kw)
    return fir_pass_last(v, taps_y * signs[:, None], contract=(C > 1),
                         emit_rot=True, **kw)
