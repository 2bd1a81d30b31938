"""Differentiable recursive filters: traced coefficients, trainable by grad.

No reference analog — the reference bakes float coefficients into generated
code at metaprogramming time (``lib/recfilter.cpp:353-372``). Here the same
blocked algebra is rebuilt with *traced* coefficient tensors:

  * the impulse matrix B and state matrix R are constructed inside the trace
    with ``lax.scan`` recurrences over rows (differentiable w.r.t. b0, a);
  * the cross-tile carry recurrence runs as ``jax.lax.associative_scan`` over
    affine pairs (W, b) — log-depth, no host-precomputed W powers.

This turns any RecFilter into a trainable layer (IIR deconvolution,
coefficient fitting, learned separable blurs — the S5/Mamba-style linear
recurrence layer specialized to image filtering). Used by
``LearnableRecFilter`` and tested by fitting coefficients with optax.
"""

from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from .spec import BorderMode, FilterSpec

# An f32 dot with no precision runs in TF32 on the GPU (about three decimal
# digits); every f32 matmul in the learnable executors requests HIGHEST so
# training optimizes the same filter production inference evaluates.
_PREC = jax.lax.Precision.HIGHEST


def impulse_matrix_jnp(feedfwd, feedback, tile_width: int, clamp: bool = False):
    """Traced-coefficient twin of ``coeffs.impulse_matrix``.

    ``feedback`` is a (k,) jnp vector; returns (T, T). Rows built by a
    ``lax.scan`` over output positions with the last-k rows as carry.
    """
    a = jnp.asarray(feedback)
    k = a.shape[0]
    T = int(tile_width)
    eye = jnp.eye(T)

    def step(carry, e_y):
        rows, row0, y = carry
        row = feedfwd * e_y
        for j in range(k):
            valid = rows[j]  # row y-j-1 (zeros if off the top)
            if clamp:
                # off-the-top taps read: raw input e_0 at y==0, else row 0
                off = jnp.where(y == 0, eye[0], row0)
                tap = jnp.where(y - j - 1 >= 0, valid, off)
            else:
                tap = valid  # zero-init carry realizes the zero border
            row = row + a[j] * tap
        rows = jnp.concatenate([row[None], rows[:-1]], axis=0)
        row0 = jnp.where(y == 0, row, row0)
        return (rows, row0, y + 1), row

    init = (jnp.zeros((k, T)), jnp.zeros(T), jnp.asarray(0))
    _, B = jax.lax.scan(step, init, eye)
    return B


def state_matrix_jnp(feedback, tile_width: int):
    """Traced-coefficient twin of ``coeffs.state_matrix``: (T, k)."""
    a = jnp.asarray(feedback)
    k = a.shape[0]
    T = int(tile_width)
    # Initial direct contributions: row y gets a[x+y] at column x (x+y < k).
    idx = jnp.arange(k)[None, :] + jnp.arange(T)[:, None]  # (T, k)
    direct = jnp.where(idx < k, a[jnp.clip(idx, 0, k - 1)], 0.0)

    def step(rows, d_y):
        row = d_y
        for j in range(k):
            row = row + a[j] * rows[j]
        rows = jnp.concatenate([row[None], rows[:-1]], axis=0)
        return rows, row

    _, R = jax.lax.scan(step, jnp.zeros((k, k)), direct)
    return R


def blocked_scan_learnable(
    x,  # (L, w)
    feedfwd,
    feedback,  # (k,) traced
    tile_width: int,
    clamp: bool = False,
):
    """Causal blocked scan with traced coefficients.

    Same algebra as ``tiling.blocked_scan_last_axis`` but every static matrix
    is rebuilt inside the trace and the carry chain runs as an
    ``associative_scan`` over (W, b) affine pairs.
    """
    L, w = x.shape
    a = jnp.asarray(feedback)
    k = a.shape[0]
    T = int(min(tile_width, w))
    n = -(-w // T)
    pad = n * T - w

    B = impulse_matrix_jnp(feedfwd, a, T, clamp=False)
    R = state_matrix_jnp(a, T)
    # P·B rows (reversed last k) and W = P·R without materializing P.
    PB = B[T - 1 - jnp.arange(k), :]  # (k, T)
    W = R[T - 1 - jnp.arange(k), :]  # (k, k)

    xt = x
    if pad:
        xt = jnp.pad(xt, ((0, 0), (0, pad)))
    xt = xt.reshape(L, n, T)

    b = jnp.einsum("kt,lnt->nlk", PB, xt, precision=_PREC)  # (n, L, k) tile-major for the scan
    if clamp:
        Bf = impulse_matrix_jnp(feedfwd, a, T, clamp=True)
        PBf = Bf[T - 1 - jnp.arange(k), :]
        b = b.at[0].set(jnp.einsum("kt,lt->lk", PBf, xt[:, 0], precision=_PREC))

    # Completed states via associative scan over affine maps s ↦ W s + b_t.
    A_stack = jnp.broadcast_to(W, (n, k, k))

    def combine_pairs(c1, c2):
        A1, b1 = c1
        A2, b2 = c2
        A = jnp.einsum("n...ij,n...jk->n...ik", A2, A1, precision=_PREC)
        bb = jnp.einsum("n...ij,n...lj->n...li", A2, b1, precision=_PREC) + b2
        return A, bb

    _, s = jax.lax.associative_scan(combine_pairs, (A_stack, b), axis=0)
    # incoming state of tile t is the completed state of tile t-1
    s_prev = jnp.concatenate([jnp.zeros_like(s[:1]), s[:-1]], axis=0)

    y = jnp.einsum("ts,lns->lnt", B, xt, precision=_PREC) + jnp.einsum(
        "tk,nlk->lnt", R, s_prev, precision=_PREC
    )
    if clamp:
        y = y.at[:, 0].set(jnp.einsum("ts,ls->lt", Bf, xt[:, 0], precision=_PREC))

    y = y.reshape(L, n * T)
    if pad:
        y = y[:, :w]
    return y


def apply_scan_learnable(
    x, axis: int, causal: bool, feedfwd, feedback,
    tile_width: int = 32, border: str = BorderMode.ZERO,
):
    """Differentiable single-scan application along ``axis``."""
    x = jnp.moveaxis(x, axis, -1)
    shape = x.shape
    if not causal:
        x = jnp.flip(x, axis=-1)
    y = blocked_scan_learnable(
        x.reshape(-1, shape[-1]), feedfwd, feedback, tile_width,
        clamp=border == BorderMode.CLAMP,
    )
    y = y.reshape(shape)
    if not causal:
        y = jnp.flip(y, axis=-1)
    return jnp.moveaxis(y, -1, axis)


def fir_apply(x, taps, causal: bool, axis: int = -1):
    """Differentiable FIR along ``axis``: ``u[i] = Σ_m taps[m]·x[i∓m]``
    (− for causal, + for anticausal), zero beyond the borders.

    ``taps`` is a traced (M+1,) vector — the numerator polynomial B(z) of a
    full IIR transfer function B(z)/A(z). The reference supports only the
    scalar b₀ (``lib/recfilter.cpp:321-342``); numerator taps extend the
    learnable filters to true deconvolution model classes."""
    taps = jnp.asarray(taps)
    M = taps.shape[0]
    x = jnp.moveaxis(x, axis, -1)
    w = x.shape[-1]
    u = taps[0] * x
    for m in range(1, M):
        pads = [(0, 0)] * (x.ndim - 1) + [(m, 0) if causal else (0, m)]
        lo = 0 if causal else m
        shifted = jax.lax.slice_in_dim(
            jnp.pad(x, pads), lo, lo + w, axis=-1
        )
        u = u + taps[m] * shifted
    return jnp.moveaxis(u, -1, axis)


def _dim_mats_learnable(params, T: int, pad_slots: int = 0,
                        clamp_edges: tuple = ()):
    """Traced-coefficient twin of ``dimfuse.prepare_dim_pass`` for ONE tile
    variant: per-scan (B, RN, rows) in dimfuse's natural-order carry
    convention, composed into Btot / Rhat / G-rows / H couplings with jnp
    matmuls (tiny T×T work, traced once).

    ``pad_slots`` builds the LAST-tile variant: each scan's B is projected
    B·Z so trailing zero-pad positions stay algebraically zero between scans
    (a causal scan would otherwise propagate real values into the pad that a
    later scan must not see — same contract as dimfuse's pad projector).

    ``clamp_edges`` ⊆ {"first", "last"} marks which global image edges this
    tile touches for a CLAMP border: a causal scan is clamped at the first
    tile, an anticausal one at the last (the anti-diagonal flip moves the
    clamped edge to the tile end — ``dimfuse._scan_base_mats`` analog of the
    reference's first/last-tile selects, ``lib/split.cpp:625-654``)."""
    Z = None
    if pad_slots:
        z = np.ones(T, dtype=np.float32)
        z[T - pad_slots :] = 0.0
        Z = jnp.asarray(z)
    base = []
    for causal, b0, a in params:
        a = jnp.asarray(a)
        k = int(a.shape[0])
        use_clamp = ("first" in clamp_edges and causal) or (
            "last" in clamp_edges and not causal
        )
        B = impulse_matrix_jnp(b0, a, T, clamp=use_clamp)
        R = state_matrix_jnp(a, T)
        W = R[::-1][:k]  # P @ R (tail_weight_matrix): carry across one tile
        if causal:
            RN = R[:, ::-1]  # R @ J_k: natural ascending last-k prev carry
            sel = lambda M, k=k: M[T - k :]
        else:
            B = B[::-1, ::-1]
            RN = R[::-1, :]
            sel = lambda M, k=k: M[:k]
        if Z is not None:
            # B @ Z with diagonal Z, applied in natural orientation (the
            # pad sits at the array end regardless of scan direction)
            B = B * Z[None, :]
        base.append((B, RN, sel, W, k, bool(causal)))

    m = len(base)
    Rhat = [[None] * m for _ in range(m)]
    G, H = [None] * m, [[None] * m for _ in range(m)]
    acc = jnp.eye(T)
    Btot = acc
    for i, (B, RN, sel, _, _, _) in enumerate(base):
        for j in range(i):
            Rhat[i][j] = jnp.matmul(B, Rhat[i - 1][j], precision=_PREC)
        Rhat[i][i] = RN
        acc = jnp.matmul(B, acc, precision=_PREC)
        Btot = acc
        G[i] = sel(acc)
        for j in range(i):
            H[i][j] = sel(jnp.matmul(B, Rhat[i - 1][j], precision=_PREC))
    return base, G, H, Btot, Rhat[m - 1]


def _chain_solve_learnable(b, W, k: int, causal: bool):
    """Natural-order cross-tile solve with a traced W (≙
    ``dimfuse._chain_solve_assoc``): ``b`` is (L, n, k) local tails, returns
    the incoming vectors N of the same shape.

    Image-scale tile counts (n ≤ 128) run a DENSE solve from traced W
    powers — the in-graph twin of the static path's
    ``combined_solve_matrix`` — rather than an associative scan: the
    scan's interleave steps emit interior pads on (n, L, k) operands
    whose minor dim is k≈3, and its backward pass is dominated by those
    pads. One (t,u,i,j)×(L,u,j) einsum instead. Audio-scale n keeps
    the log-depth scan (the dense (n,n,k,k) matrix grows as n²)."""
    n = b.shape[1]
    if causal:
        bt = b[:, :, ::-1]  # J_k b
    else:
        bt = jnp.flip(b, axis=1)
    if n <= 128:
        P = [jnp.eye(k, dtype=W.dtype)]
        for _ in range(n - 1):
            P.append(jnp.einsum("ij,jk->ik", W, P[-1], precision=_PREC))
        P = jnp.stack(P)  # (n, k, k): P[d] = W^d
        idx = np.zeros((n, n), np.int32)
        mask = np.zeros((n, n), np.float32)
        for t in range(n):
            for u in range(t):
                idx[t, u] = t - u - 1
                mask[t, u] = 1.0
        M = P[jnp.asarray(idx)] * jnp.asarray(mask)[..., None, None]
        s_prev = jnp.einsum("tuij,luj->lti", M, bt, precision=_PREC)
        return s_prev[:, :, ::-1] if causal else jnp.flip(s_prev, axis=1)
    A = jnp.broadcast_to(W, (n,) + W.shape)
    bt_n = jnp.moveaxis(bt, 1, 0)  # (n, L, k)
    _, s = jax.lax.associative_scan(
        lambda c1, c2: (
            jnp.einsum("nij,njk->nik", c2[0], c1[0], precision=_PREC),
            jnp.einsum("nij,nlj->nli", c2[0], c1[1], precision=_PREC) + c2[1],
        ),
        (A, bt_n),
        axis=0,
    )
    s = jnp.moveaxis(s, 0, 1)
    s_prev = jnp.concatenate([jnp.zeros_like(s[:, :1]), s[:, :-1]], axis=1)
    return s_prev[:, :, ::-1] if causal else jnp.flip(s_prev, axis=1)


def fused_dim_learnable(x, params, tile_width: int, clamp: bool = False):
    """All scans of one dimension with TRACED coefficients in one fused pass
    — the differentiable twin of ``dimfuse.fused_dim_pass``.

    ``x`` is (..., w) with the scan dimension last; ``params`` is a list of
    ``(causal, b0, a)`` with traced ``b0``/``a``. Same structure as the
    static path: one stacked-G einsum for all local tails, per-scan
    associative-scan solves with H-coupling corrections, one completion
    matmul + carry injections. CLAMP borders use first/last-tile matrix
    variants (≙ ``lib/split.cpp:625-654``) and require a tile width dividing
    ``w`` (the clamped edge must sit at a tile boundary); raises ValueError
    when no divisor ≥ the max order exists — callers fall back to the
    per-scan blocked path."""
    shape = x.shape
    w = shape[-1]
    kmax = max(int(jnp.asarray(a).shape[0]) for _, _, a in params)
    if w < kmax:
        raise ValueError(
            f"scan order {kmax} exceeds dimension width {w}"
        )
    T = int(min(max(tile_width, kmax), w))
    n = -(-w // T)
    pad = n * T - w
    if clamp and pad:
        # The last-tile clamp variant assumes the image edge at the tile
        # end, so clamp needs T | w (dimfuse._plan_tiles analog).
        for t in range(T, kmax - 1, -1):
            if w % t == 0:
                T, n, pad = t, w // t, 0
                break
        else:
            raise ValueError(
                f"no tile width in [{kmax}, {T}] divides w={w} (clamp)"
            )
    X = x.reshape(-1, w)
    if pad:
        X = jnp.pad(X, ((0, 0), (0, pad)))
    X = X.reshape(X.shape[0], n, T)

    base, G, H, Btot, Rhat = _dim_mats_learnable(params, T)
    # Per-tile overrides: (tile index, mats) for the tiles whose matrices
    # differ from the interior — first/last for clamp, last for padding.
    overrides = []
    if clamp:
        if n == 1:
            overrides.append((0, _dim_mats_learnable(
                params, T, clamp_edges=("first", "last"))))
        else:
            overrides.append((0, _dim_mats_learnable(
                params, T, clamp_edges=("first",))))
            overrides.append((n - 1, _dim_mats_learnable(
                params, T, pad_slots=pad, clamp_edges=("last",))))
    elif pad:
        overrides.append((n - 1, _dim_mats_learnable(params, T, pad_slots=pad)))

    N = [None] * len(base)
    for i, (_, _, _, W, k, causal) in enumerate(base):
        b = jnp.einsum("kt,lnt->lnk", G[i], X, precision=_PREC)
        for j in range(i):
            b = b + jnp.einsum("ko,lno->lnk", H[i][j], N[j], precision=_PREC)
        for t, (_, Gv, Hv, _, _) in overrides:
            bl = jnp.einsum("kt,lt->lk", Gv[i], X[:, t], precision=_PREC)
            for j in range(i):
                bl = bl + jnp.einsum("ko,lo->lk", Hv[i][j], N[j][:, t],
                                     precision=_PREC)
            b = b.at[:, t].set(bl)
        N[i] = _chain_solve_learnable(b, W, k, causal)

    Y = jnp.einsum("ts,lns->lnt", Btot, X, precision=_PREC)
    for j in range(len(base)):
        Y = Y + jnp.einsum("tk,lnk->lnt", Rhat[j], N[j], precision=_PREC)
    for t, (_, _, _, Btv, Rhv) in overrides:
        yl = jnp.einsum("ts,ls->lt", Btv, X[:, t], precision=_PREC)
        for j in range(len(base)):
            yl = yl + jnp.einsum("tk,lk->lt", Rhv[j], N[j][:, t],
                                 precision=_PREC)
        Y = Y.at[:, t].set(yl)
    Y = Y.reshape(Y.shape[0], n * T)
    if pad:
        Y = Y[:, :w]
    return Y.reshape(shape)


class LearnableRecFilter:
    """A RecFilter whose coefficients are a trainable pytree.

    ``init_params()`` extracts {scan_i: {"b0": (), "a": (k,)}} from the
    FilterSpec (plus {"b": (fir_taps+1,)} numerator taps when ``fir_taps``
    is set — b replaces b0); ``apply(params, x)`` runs the filter
    differentiably. Works under jit/grad/vmap and inside shard_map.

    ``fused=True`` (default) groups same-dimension scans into one fused
    traced-coefficient pass: since all scans and FIRs along one axis are LTI
    and commute, the numerator FIRs apply first (composed two-sided stencil)
    and every IIR runs inside ``fused_dim_learnable`` — the training-time
    analog of the production dimfuse executor. CLAMP borders use first/
    last-tile matrix variants (so training parity covers the clamped
    Gaussian apps); only when no tile width divides the extent (clamp with
    prime-ish width) does an axis fall back to the per-scan blocked path.
    """

    def __init__(self, spec: FilterSpec, tile_width: int = 32,
                 fir_taps: int = 0, fused: bool = True):
        self.spec = spec
        self.tile_width = tile_width
        self.fir_taps = int(fir_taps)
        self.fused = fused

    def init_params(self) -> Dict[str, Dict[str, jnp.ndarray]]:
        out = {}
        for i, s in enumerate(self.spec.scans):
            p = {"a": jnp.asarray(s.feedback, dtype=jnp.float32)}
            if self.fir_taps:
                b = np.zeros(self.fir_taps + 1, dtype=np.float32)
                b[0] = s.feedfwd
                p["b"] = jnp.asarray(b)
            else:
                p["b0"] = jnp.asarray(s.feedfwd, dtype=jnp.float32)
            out[f"scan{i}"] = p
        return out

    def _scan_param(self, params, i):
        p = params[f"scan{i}"]
        if "b" in p:
            return p["b"], p["a"]
        return jnp.reshape(p["b0"], (1,)), p["a"]

    def apply(self, params, x):
        """Model semantics: per scanned axis (cross-axis LTI ops commute
        exactly), all numerator FIRs apply first in scan order, then all IIR
        scans in scan order. (Mixed-causality FIR/IIR pairs do not commute
        at finite borders, so FIR placement is part of the model class
        definition — identical in the fused and per-scan paths.) FIRs
        always zero-extend beyond the borders."""
        x = x.astype(jnp.float32)
        clamp = self.spec.border == BorderMode.CLAMP
        for axis, ids in self.spec.scans_by_axis().items():
            pl = []
            for i in ids:
                b, a = self._scan_param(params, i)
                causal = self.spec.scans[i].causal
                if b.shape[0] > 1:
                    x = fir_apply(x, b, causal, axis)
                    b0 = jnp.asarray(1.0)
                else:
                    b0 = b[0]
                pl.append((causal, b0, a))
            ym = None
            if self.fused:
                xm = jnp.moveaxis(x, axis, -1)
                try:
                    ym = fused_dim_learnable(
                        xm, pl, self.tile_width, clamp=clamp
                    )
                except ValueError:
                    ym = None  # clamp with no dividing tile width
            if ym is not None:
                x = jnp.moveaxis(ym, -1, axis)
            else:
                for causal, b0, a in pl:
                    x = apply_scan_learnable(
                        x, axis, causal, b0, a,
                        tile_width=self.tile_width, border=self.spec.border,
                    )
        return x
