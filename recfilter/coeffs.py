"""Closure-matrix algebra for overlapped tiling.

Rebuild of the reference's host-side dense matrix kit
(``lib/coefficients.cpp:8-128``): the T×T per-tile impulse-response matrix
(``matrix_B``), the T×k incoming-state propagation matrix (``matrix_R``), and
their products that drive the cross-tile carry recurrence
(``tail_weights``, ``lib/split.cpp:152-203``).

The key departure from the reference: these matrices are not merely used to
*derive* scalar weights baked into generated code — they ARE the compute. An
intra-tile scan of width T is evaluated as ``B @ x`` on the tensor cores,
the incoming-state correction as ``R @ s``, and the whole cross-tile carry
recurrence collapses into ONE matmul with a precomputed block-Toeplitz matrix
of W powers (`carry_chain_matrix`). Nothing on the device is sequential.

All precomputation here is float64 numpy (host, trace-time), cast to the
execution dtype at use — strictly more accurate than the reference's float32
host math while remaining bit-compatible in spirit.

A native C++ fast path for these builders lives in ``native/recfilter_host.cpp``
(loaded via ctypes in ``recfilter.utils.native``); numpy is the fallback
and the source of truth for tests.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence, Tuple

import numpy as np

USE_NATIVE = True  # prefer the C++ host library when built


def _native():
    if not USE_NATIVE:
        return None
    from .utils import native

    return native if native.available() else None


def impulse_matrix(
    feedfwd: float,
    feedback: Sequence[float],
    tile_width: int,
    clamp_border: bool = False,
) -> np.ndarray:
    """B ∈ R^{T×T}: zero-incoming-state scan of a tile is ``y = B @ x``.

    ``B[y, x]`` is the response at output position ``y`` to a unit input at
    position ``x``. Lower triangular. With ``clamp_border`` the out-of-range
    taps of the first positions clamp to index 0 — only the globally-first
    tile of a scan uses this variant, matching ``matrix_B``
    (``lib/coefficients.cpp:8-49``) and the first/last-tile-only clamping in
    ``lib/split.cpp:625-654``.
    """
    nat = _native()
    if nat is not None:
        return nat.impulse_matrix(feedfwd, feedback, tile_width, clamp_border)
    a = np.asarray(feedback, dtype=np.float64)
    k = a.shape[0]
    T = int(tile_width)
    B = float(feedfwd) * np.eye(T, dtype=np.float64)
    for y in range(T):
        for j in range(k):
            if y - j - 1 >= 0:
                B[y] += a[j] * B[y - j - 1]
            elif clamp_border:
                # Tap falls off the front edge. We implement the semantics the
                # reference's generated Halide update actually realizes
                # (``lib/recfilter.cpp:329-339``, in-place serial order): at
                # y == 0 the clamped tap reads the pre-update site, i.e. the
                # raw input x[0]; at y >= 1 it reads the already-updated
                # output y[0], i.e. row 0 of B. (The reference's host-side
                # ``matrix_B`` model at ``lib/coefficients.cpp:39`` credits
                # the raw input in both cases — a discrepancy with its own
                # realized filter for order >= 2 that its test suite never
                # exercises; we keep oracle and tiled path consistent.)
                if y == 0:
                    B[y, 0] += a[j]
                else:
                    B[y] += a[j] * B[0]
    return B


def state_matrix(
    feedback: Sequence[float],
    tile_width: int,
) -> np.ndarray:
    """R ∈ R^{T×k}: response of a tile to incoming state, ``y += R @ s``.

    ``s[j]`` is the scan value at position ``-1-j`` relative to the tile start
    (the previous tile's last ``k`` outputs, nearest first). ``R[y, j]`` is the
    response at in-tile position ``y`` to ``s[j] == 1``. Transposed layout of
    ``matrix_R`` (``lib/coefficients.cpp:51-83``): ``R[y, j] == C(j, y)``.

    Feedforward does not apply to state contributions (state enters through
    the feedback taps only), matching the reference.
    """
    nat = _native()
    if nat is not None:
        return nat.state_matrix(feedback, tile_width)
    a = np.asarray(feedback, dtype=np.float64)
    k = a.shape[0]
    T = int(tile_width)
    R = np.zeros((T, k), dtype=np.float64)
    for y in range(T):
        if y < k:
            for x in range(k):
                if x + y < k:
                    R[y, x] = a[x + y]
        for j in range(k):
            if y - j - 1 >= 0:
                R[y] += a[j] * R[y - j - 1]
    return R


def tail_projector(tile_width: int, order: int) -> np.ndarray:
    """P ∈ R^{k×T}: extracts outgoing state from a completed tile, s' = P @ y.

    ``s'[j] = y[T-1-j]`` — the tile's last ``k`` outputs, nearest-to-boundary
    first, so that the next tile's ``R @ s'`` lines up. Plays the role of the
    tail extraction in ``extract_tails_from_each_scan``
    (``lib/split.cpp:256-499``).
    """
    T, k = int(tile_width), int(order)
    P = np.zeros((k, T), dtype=np.float64)
    for j in range(k):
        P[j, T - 1 - j] = 1.0
    return P


def tail_weight_matrix(feedback: Sequence[float], tile_width: int) -> np.ndarray:
    """W = P @ R ∈ R^{k×k}: carry propagation across one tile.

    The cross-tile recurrence is ``s_t = W @ s_{t-1} + tail(B @ x_t)`` — the
    matrix form of the reference's completed-tail update
    (``lib/split.cpp:833-845``) whose weights come from ``tail_weights``
    (``lib/split.cpp:152-203``).
    """
    k = len(tuple(feedback))
    R = state_matrix(feedback, tile_width)
    return tail_projector(tile_width, k) @ R


def antidiagonal(size: int) -> np.ndarray:
    """Anti-diagonal (flip) matrix — ``matrix_antidiagonal``
    (``lib/coefficients.cpp:119-128``). Used when composing carries between
    scans of opposite causality."""
    return np.eye(size, dtype=np.float64)[::-1].copy()


@lru_cache(maxsize=256)
def _carry_chain_cached(
    feedback: Tuple[float, ...], tile_width: int, num_tiles: int, prev: bool
) -> np.ndarray:
    nat = _native()
    if nat is not None:
        return nat.carry_chain_matrix(feedback, tile_width, num_tiles, prev)
    k = len(feedback)
    n = int(num_tiles)
    W = tail_weight_matrix(feedback, tile_width)
    # powers[d] = W^d
    powers = [np.eye(k, dtype=np.float64)]
    for _ in range(n):
        powers.append(W @ powers[-1])
    M = np.zeros((n, k, n, k), dtype=np.float64)
    for t in range(n):
        for i in range(t + 1):
            d = t - i
            if prev:
                # s_prev_t = s_{t-1} = sum_{i<t} W^{t-1-i} b_i
                if i < t:
                    M[t, :, i, :] = powers[d - 1]
            else:
                M[t, :, i, :] = powers[d]
    return M.reshape(n * k, n * k)


def carry_chain_matrix(
    feedback: Sequence[float],
    tile_width: int,
    num_tiles: int,
    prev: bool = True,
) -> np.ndarray:
    """Block lower-triangular matrix solving the whole carry recurrence at once.

    With local tails ``b_i = P @ B @ x_i`` stacked into a length ``n*k``
    vector, the *incoming* state of every tile is ``s_prev = M @ b``
    (``prev=True``; ``M[t,i] = W^{t-1-i}`` for ``i < t``), or the *completed*
    state ``s = M @ b`` (``prev=False``; ``M[t,i] = W^{t-i}``).

    This replaces the reference's sequential tile loop over ``outer_rdom``
    (``lib/split.cpp:1963``, update at ``lib/split.cpp:833-845``) with a single
    (n·k)×(n·k) matmul — log-free, scan-free, one tensor-core product. For stable filters
    ``W^d`` decays geometrically so the matrix is numerically benign; for the
    summed-area table (W = [[1]]) it is the all-ones lower triangle, i.e. an
    exact prefix sum.
    """
    return _carry_chain_cached(
        tuple(float(c) for c in feedback), int(tile_width), int(num_tiles), bool(prev)
    )


def matrix_mult(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """Host-side matmul, parity shim for ``matrix_mult``
    (``lib/coefficients.cpp:95-117``)."""
    return np.asarray(A, dtype=np.float64) @ np.asarray(B, dtype=np.float64)


def matrix_transpose(A: np.ndarray) -> np.ndarray:
    """Parity shim for ``matrix_transpose`` (``lib/coefficients.cpp:85-93``)."""
    return np.asarray(A, dtype=np.float64).T.copy()
