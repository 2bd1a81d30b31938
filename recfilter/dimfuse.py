"""Fused per-dimension executor: all scans of a dimension in 3 image touches.

This is the generalization of the reference's 3-phase tiled execution
(intra kernels → sequential CTail kernel → final kernel,
``lib/recfilter.cpp:991-1016``), extended to ANY number of same-dimension
scans of mixed causality in a FIXED number of passes — the role of the
reference's hardest code, the cross-scan tail-dependency algebra
(``create_tail_residual_term`` ``lib/split.cpp:912-1004`` and
``add_prev_dimension_residual_to_tails`` ``:1215-1633``) — but derived as
plain matrix identities instead of IR rewrites:

Per tile t (natural orientation; anticausal scans carry anti-diagonal
transforms J·B·J, J·R baked into their matrices host-side):

    y⁰ = x_t
    yⁱ = B_i y^{i-1} + RN_i Nⁱ_t                   (scan i completion)

with Nⁱ the solved incoming carries. Expanding:

    yⁱ = Btot_i x_t + Σ_{j≤i} Rhat_{i,j} Nʲ_t
    bⁱ_t = G_i x_t + Σ_{j<i} H_{i,j} Nʲ_t          (local tails of scan i)

    Btot_i   = B_i···B_1
    Rhat_{i,j} = (B_i···B_{j+1}) RN_j,  Rhat_{i,i} = RN_i
    G_i      = Sel_iᵀ Btot_i
    H_{i,j}  = Sel_iᵀ B_i Rhat_{i-1,j}

and Nⁱ = CM_i · stack(bⁱ) solves each scan's cross-tile recurrence with one
small precomputed block-Toeplitz matmul. Execution per dimension:

    pass A (parallel einsum): read X → all bⁱ (tiny, K/T of the data)
    solve   (tiny matmuls):   Nⁱ, sequenced over scans only (m ≤ 4)
    pass B (parallel einsum): read X → Y via one fused (T, T+Σk) matmul

No sequential device code, no latency chains — every large op is an
independent batched matmul. Clamped borders change the matrices of the
globally-first/last tile only (``lib/split.cpp:625-654``); those tiles get
per-tile matrix variants, selected by a static index stack.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from . import coeffs
from .spec import BorderMode, FilterSpec, Scan


# ---------------------------------------------------------------------------
# Host-side matrix preparation
# ---------------------------------------------------------------------------


def _scan_base_mats(s: Scan, T: int, clamp: bool):
    """Direction-transformed (natural orientation) per-scan matrices."""
    k = s.order
    B = coeffs.impulse_matrix(s.feedfwd, s.feedback, T)
    Bf = (
        coeffs.impulse_matrix(s.feedfwd, s.feedback, T, clamp_border=True)
        if clamp
        else B
    )
    R = coeffs.state_matrix(s.feedback, T)
    Jk = coeffs.antidiagonal(k)
    Sel = np.zeros((T, k))
    if s.causal:
        RN = R @ Jk  # corr from natural (ascending last-k) prev carry
        for j in range(k):
            Sel[T - k + j, j] = 1.0
    else:
        B = B[::-1, ::-1].copy()
        Bf = Bf[::-1, ::-1].copy()
        RN = R[::-1, :]
        for j in range(k):
            Sel[j, j] = 1.0
    return B, Bf, RN, Sel


def _chain_matrix(s: Scan, T: int, n: int) -> np.ndarray:
    """CM (n·k × n·k): stacked natural local tails b → stacked natural
    incoming vectors N (corr_t = RN · N_t). Direction folded in."""
    k = s.order
    W = coeffs.tail_weight_matrix(s.feedback, T)
    Jk = coeffs.antidiagonal(k)
    powers = [np.eye(k)]
    for _ in range(n):
        powers.append(W @ powers[-1])
    C = np.zeros((n, k, n, k))
    for t in range(n):
        if s.causal:
            for i in range(t):
                C[t, :, i, :] = Jk @ powers[t - 1 - i] @ Jk
        else:
            for i in range(t + 1, n):
                C[t, :, i, :] = powers[i - 1 - t]
    return C.reshape(n * k, n * k)


def pad_rows8(G: np.ndarray) -> np.ndarray:
    """Zero-pad a stacked-G row axis to >= 8 so XLA lowers the contraction
    as a dot rather than a broadcast+reduce chain with one full-size
    stream per row (used by dimfuse and overlap2d)."""
    if G.shape[1] >= 8:
        return G
    pad = np.zeros((G.shape[0], 8 - G.shape[1], G.shape[2]))
    return np.concatenate([G, pad], axis=1)


def combined_solve_matrix(mats: "DimPassMats", n: int) -> np.ndarray:
    """Fold every scan's chain solve AND the cross-scan H-couplings into one
    (n·ΣK × n·ΣK) matrix: N_cat = CMfull · b_raw_cat (interleaved per-tile
    layout, matching the stacked-G tails and concatenated Rhat).

    The per-scan system is block-triangular:
        N_i = CM_i (b_i^raw + Σ_{j<i} Hblk_{ij} N_j)
    so CMfull rows build up scan by scan — one device matmul replaces the
    per-scan solve/correction op chain (dispatch overhead dominates the
    small ops on this stack)."""
    m = len(mats.orders)
    S = sum(mats.orders)
    if m == 1:
        # Single scan: the embedding E is the identity and CMfull is the
        # scan's own chain matrix — skip the O((n·k)³) matmul (high-order
        # audio builds n=256/k=29 here: 0.4 TFLOP of float64 saved per
        # trace).
        return np.asarray(mats.CM[0])
    offs = np.cumsum([0] + mats.orders)
    rows: list = [None] * m  # rows[i]: (n*k_i, n*S) mapping braw_cat → N_i

    def hblk(i, j):
        Hs = mats.H[i][j]
        ki, kj = mats.orders[i], mats.orders[j]
        out = np.zeros((n * ki, n * kj))
        for t in range(n):
            Ht = Hs[t if Hs.shape[0] > 1 else 0]
            out[t * ki : (t + 1) * ki, t * kj : (t + 1) * kj] = Ht
        return out

    for i in range(m):
        ki = mats.orders[i]
        E = np.zeros((n * ki, n * S))
        for t in range(n):
            E[t * ki : (t + 1) * ki,
              t * S + offs[i] : t * S + offs[i] + ki] = np.eye(ki)
        acc = E
        for j in range(i):
            acc = acc + hblk(i, j) @ rows[j]
        rows[i] = mats.CM[i] @ acc

    full = np.zeros((n * S, n * S))
    for i in range(m):
        ki = mats.orders[i]
        for t in range(n):
            full[t * S + offs[i] : t * S + offs[i] + ki, :] = rows[i][
                t * ki : (t + 1) * ki, :
            ]
    return full


def banded_solve_blocks(CMfull: np.ndarray, n: int, S: int,
                        tol: float = 1e-9, max_band: int = 16):
    """Block-banded form of the combined solve matrix, or None.

    Tile-to-tile carry influence decays like |pole|^T per tile, so for
    stable (non-integrator) filters the (n·S)² chain matrix is effectively
    block-banded with a handful of non-negligible diagonals — and the dense
    solve matmul grows as O(n²·lines) = O(W³) on images. Returns [(offset d, blocks (n, S, S))] where block
    t maps tile t-d's raw tails into tile t's carries; offsets whose
    largest block falls below ``tol``·max are dropped (≤ f32 noise).
    Integrators (poles on the unit circle: SAT, boxes) decay nowhere —
    their band exceeds ``max_band`` and the caller keeps the dense matmul.
    """
    CM = np.asarray(CMfull).reshape(n, S, n, S)
    norms = np.abs(CM).max(axis=(1, 3))  # (n_to, n_from)
    scale = float(norms.max())
    if scale == 0.0:
        return [(0, np.zeros((n, S, S)))]
    offsets = []
    for d in range(-(n - 1), n):
        diag = [norms[t, t - d] for t in range(max(0, d), min(n, n + d))]
        if diag and max(diag) > tol * scale:
            offsets.append(d)
    # Banded only at large tile counts: at small n the per-offset shift
    # ops cost more than the small dense matmul. Integrators' band is as
    # wide as n — always dense.
    if n < 64 or len(offsets) > min(max_band, n // 4):
        return None
    out = []
    for d in offsets:
        blocks = np.zeros((n, S, S))
        for t in range(n):
            i = t - d
            if 0 <= i < n:
                blocks[t] = CM[t, :, i, :]
        out.append((d, blocks))
    return out


def _banded_solve_apply(bands, braw, prec):
    """Banded combined solve on natural-layout tails (..., n, S):
    N_t = Σ_d B_d[t] · b_{t−d} — one tiny einsum per band offset instead
    of the dense (n·S)² solve matrix (220 MB at n=256/S=29, the audio
    order-29 sweep). The shifted operands are slices of ONE padded copy
    of b, which XLA fuses into the consuming einsum."""
    n = braw.shape[-2]
    dmax = max(max(d for d, _ in bands), 0)
    dmin = min(min(d for d, _ in bands), 0)
    pads = [(0, 0)] * braw.ndim
    pads[-2] = (dmax, -dmin)
    bpad = jnp.pad(braw, pads) if dmax or dmin else braw
    N = None
    for d, blocks in bands:
        shifted = (bpad if (dmax - d == 0 and bpad.shape[-2] == n)
                   else jax.lax.slice_in_dim(bpad, dmax - d, dmax - d + n,
                                             axis=-2))
        t = jnp.einsum("nab,...nb->...na", jnp.asarray(blocks, jnp.float32),
                       shifted, preferred_element_type=jnp.float32,
                       precision=prec)
        N = t if N is None else N + t
    return N


@dataclasses.dataclass
class DimPassMats:
    """Per-dimension fused-pass matrices (numpy, trace-time constants).

    ``G[i]`` is (n, k_i, T); ``H[i][j]`` is (n, k_i, k_j); ``CM[i]`` is
    (n·k_i, n·k_i); ``Btot`` is (n, T, T); ``Rhat[j]`` is (n, T, k_j).
    The ``n`` axis carries the edge-tile variants (clamp); for zero borders
    every tile is identical and the n axis is collapsed to 1.
    """

    orders: List[int]
    G: List[np.ndarray]
    H: List[List[np.ndarray]]
    CM: List[np.ndarray]
    Btot: np.ndarray
    Rhat: List[np.ndarray]
    uniform: bool  # True → n axis collapsed (no per-tile variants)


def prepare_dim_pass(
    scans: Sequence[Scan], T: int, n: int, clamp: bool, pad_slots: int = 0,
    build_cm: bool = True,
) -> DimPassMats:
    m = len(scans)
    base = [_scan_base_mats(s, T, clamp) for s in scans]

    # Pad projector for the last tile: ``pad_slots`` trailing positions are
    # zero padding, and a causal scan propagates real values into them — a
    # later scan must see zeros there (the zero-border contract). Replacing
    # B with B·Z for the last tile zeroes those slots algebraically between
    # scans; on the raw input x the pad is genuinely zero, so the extra Z
    # before B_1 is harmless.
    Z = np.eye(T)
    if pad_slots:
        Z[np.arange(T - pad_slots, T), np.arange(T - pad_slots, T)] = 0.0

    # Distinct tile variants: interior, first, last (first==last when n==1).
    def mats_for_tile(t: int):
        out = []
        for s, (B, Bf, RN, Sel) in zip(scans, base):
            edge = (t == 0) if s.causal else (t == n - 1)
            Bt = Bf if (clamp and edge) else B
            if pad_slots and t == n - 1:
                Bt = Bt @ Z
            out.append((Bt, RN, Sel))
        return out

    # Representative tile indices to build: interior (a middle tile when one
    # exists) plus the tiles whose matrices differ — globally-first/last for
    # clamp (lib/split.cpp:625-654), last for padding.
    if not clamp and not pad_slots:
        tiles = [0]
    else:
        special = set()
        if clamp:
            special |= {0, n - 1}
        if pad_slots:
            special.add(n - 1)
        interior = {t for t in range(n) if t not in special}
        tiles = sorted(special | ({min(interior)} if interior else set()))

    per_tile = {t: mats_for_tile(t) for t in tiles}

    def build(tile_mats):
        Btot_i = [None] * m
        Rhat_i = [[None] * m for _ in range(m)]
        G = [None] * m
        H = [[None] * m for _ in range(m)]
        acc = np.eye(T)
        for i, (B, RN, Sel) in enumerate(tile_mats):
            for j in range(i):
                Rhat_i[i][j] = B @ Rhat_i[i - 1][j]
            Rhat_i[i][i] = RN
            acc = B @ acc
            Btot_i[i] = acc
            G[i] = Sel.T @ acc
            for j in range(i):
                H[i][j] = Sel.T @ (B @ Rhat_i[i - 1][j])
        return G, H, Btot_i[m - 1], Rhat_i[m - 1]

    built = {t: build(mats) for t, mats in per_tile.items()}

    uniform = not clamp and not pad_slots
    if uniform:
        G1, H1, Btot1, Rhat1 = built[0]
        return DimPassMats(
            orders=[s.order for s in scans],
            G=[g[None] for g in G1],
            H=[[h[None] if h is not None else None for h in row] for row in H1],
            CM=[_chain_matrix(s, T, n) if build_cm else None for s in scans],
            Btot=Btot1[None],
            Rhat=[r[None] for r in Rhat1],
            uniform=True,
        )

    interior_reps = [t for t in tiles if t not in (0, n - 1)] or [tiles[0]]
    interior_t = interior_reps[0]

    def stack(select):
        rows = []
        for t in range(n):
            key = t if t in built else interior_t
            rows.append(select(built[key]))
        return np.stack(rows)

    G = [stack(lambda b, i=i: b[0][i]) for i in range(m)]
    H = [
        [
            (stack(lambda b, i=i, j=j: b[1][i][j]) if j < i else None)
            for j in range(m)
        ]
        for i in range(m)
    ]
    Btot = stack(lambda b: b[2])
    Rhat = [stack(lambda b, j=j: b[3][j]) for j in range(m)]
    return DimPassMats(
        orders=[s.order for s in scans],
        G=G,
        H=H,
        CM=[_chain_matrix(s, T, n) if build_cm else None for s in scans],
        Btot=Btot,
        Rhat=Rhat,
        uniform=False,
    )


# ---------------------------------------------------------------------------
# Device-side passes
# ---------------------------------------------------------------------------

def _matmul_precision(cdt, mmd, choice: str = "highest"):
    """XLA precision for the f32 dots of a grade. On the GPU an f32 dot
    with no precision runs in TF32 (about three decimal digits — far off
    the float32 SNR bound the oracle suite guarantees); HIGHEST is true
    FP32. Only the "default" grade (and the bf16 modes) leave the choice
    to XLA; every other grade pins the carry solves and injections — tiny
    FLOPs, error-dominant — to HIGHEST."""
    if mmd is not None or cdt in (jnp.bfloat16, jnp.float16):
        return None
    return {
        "highest": jax.lax.Precision.HIGHEST,
        "high": jax.lax.Precision.HIGH,
        # Compensated split-bf16 modes: the image-sized matmuls run as
        # explicit hi/lo bf16 products (_split_einsum); everything ELSE
        # (carry solves, injections — tiny FLOPs, error-dominant) stays
        # at true-f32 HIGHEST.
        "f32x6": jax.lax.Precision.HIGHEST,
        "f32x4": jax.lax.Precision.HIGHEST,
        "f32x3": jax.lax.Precision.HIGHEST,
        # Drop-free 3x3 mode (integer-exact limb passes): ALL nine chunk
        # products — no term of any magnitude is dropped, so integer
        # operands < 2^23 flow through in exact f32 arithmetic end to end.
        "f32x9": jax.lax.Precision.HIGHEST,
        # px grades: the compensated split products of f32x3/f32x4/f32x6
        # (the names of the shipping default ladder).
        "px3": jax.lax.Precision.HIGHEST,
        "px4": jax.lax.Precision.HIGHEST,
        "px6": jax.lax.Precision.HIGHEST,
        "default": None,
    }[choice]


def _split_passes(cdt, mmd, choice: str) -> int:
    """Number of single-pass bf16 products for the compensated modes.

    0 disables the split path (bf16 storage/matmul modes, or the plain
    precision choices). The split applies only to f32 compute with no
    bf16 matmul_dtype override. The px grades map to the same product
    counts as the f32x grades.
    """
    if mmd is not None or cdt != jnp.float32:
        return 0
    return {"f32x3": 3, "f32x4": 4, "f32x6": 6, "f32x9": 9,
            "px3": 3, "px4": 4, "px6": 6}.get(choice, 0)


def _split_chunks(npasses: int) -> int:
    """Chunks per operand for a pass budget: 2 for f32x3/f32x4, 3 for f32x6."""
    return 3 if npasses >= 6 else 2


def _split_input(X, nchunks: int = 2):
    """Exact bf16 chunk decomposition of f32 data: X = Σ chunks, chunk i
    carrying mantissa bits [8i, 8i+8). Two chunks represent X to ~2^-17
    relative; three chunks are EXACT (bf16 keeps 8 of f32's 24 mantissa
    bits, and each residual subtraction is exact in f32). Reading (hi, lo)
    costs the same memory traffic as reading X in f32.

    The rounding is ``lax.reduce_precision``, not a bf16 round trip: XLA's
    GPU simplifier may fold ``convert(convert(x, bf16), f32)`` to ``x``
    (excess precision is allowed by default), which would zero every
    residual chunk and leave a one-product bf16 result."""
    chunks = []
    rem = X
    for _ in range(nchunks - 1):
        c = jax.lax.reduce_precision(rem, exponent_bits=8, mantissa_bits=7)
        chunks.append(c.astype(jnp.bfloat16))
        rem = rem - c
    chunks.append(rem.astype(jnp.bfloat16))
    return tuple(chunks)


def _split_const(M, nchunks: int = 2):
    """Trace-time bf16 chunk split of a matrix constant (free at runtime);
    computed from float64 so three chunks carry the full f32 mantissa."""
    import ml_dtypes

    M64 = np.asarray(M, np.float64)
    chunks = []
    rem = M64
    for _ in range(nchunks):
        c = rem.astype(np.float32).astype(ml_dtypes.bfloat16)
        chunks.append(c)
        rem = rem - c.astype(np.float64)
    return tuple(chunks)


def _split_einsum(eq, M, X, npasses, acc):
    """Compensated f32 matmul from bf16 tensor-core products.

    With M = Σ Mi and X = Σ Xj (each chunk bf16-exact, and every bf16
    product exact in the f32 accumulator), the product sums the
    largest ``npasses`` cross terms Mi·Xj in f32 (term magnitude level is
    i+j, each level down ~2^-8):

      3 passes: levels 0,1          (drops ~2^-16 — max rel err ~2e-5)
      4 passes: + M1·X1             (representation-limited, ~2^-17)
      6 passes: 3-chunk operands, levels 0,1,2   (drops ~2^-24 — true f32)

    This is XLA's own HIGH/HIGHEST decomposition done by hand — but applied
    ONLY to the image-sized completion matmuls, with the operand splits
    shared across all of a pass's einsums instead of re-split per dot, and
    with the carry solves kept at true-f32 HIGHEST. f32x6 matches the
    float32 SNR bar of the reference's CheckResult
    (``lib/recfilter.h:793-855``); f32x3/f32x4 trade ~2e-5 worst-case
    relative error for 3-4 products instead of 6.

    Terms are summed smallest level first to minimise accumulation rounding.

    Takes the RAW f32 operand ``X`` and splits it internally (XLA CSE
    merges the identical split chains of a pass's G/B einsums under jit).
    Differentiation does NOT flow through the bf16 chunk casts — that loses
    ~2^-8 on the cotangent (measured 3.8e-3 grad error) — a custom VJP
    transposes the mathematically-equivalent HIGHEST einsum instead, so
    gradients are f32-grade regardless of the forward product count.
    """
    nc = _split_chunks(npasses)
    Ms = _split_const(M, nc)
    if npasses >= 9:
        # Drop-free: all nine products (exact integer arithmetic for
        # operands < 2^23 — see apply_filter_int_exact).
        idx = [(2, 2), (1, 2), (2, 1), (0, 2), (1, 1), (2, 0),
               (0, 1), (1, 0), (0, 0)]
    elif npasses >= 6:
        idx = [(0, 2), (1, 1), (2, 0), (0, 1), (1, 0), (0, 0)]
    elif npasses >= 4:
        idx = [(1, 1), (0, 1), (1, 0), (0, 0)]
    else:
        idx = [(0, 1), (1, 0), (0, 0)]

    def _run(X):
        Xs = _split_input(X, nc)
        out = None
        for i, j in idx:
            t = jnp.einsum(eq, jnp.asarray(Ms[i]), Xs[j],
                           preferred_element_type=acc)
            out = t if out is None else out + t
        return out

    # NUMPY on purpose: a jnp constant materialized here (inside whatever
    # trace is active — e.g. a shard_map body) leaks into the bwd jaxpr as
    # a tracer-lifted constant and breaks the outer jit's transpose
    # ("No constant handler for DynamicJaxprTracer"); a numpy closure is
    # lifted fresh when the bwd itself is traced.
    Mf = np.asarray(M, np.dtype(acc))

    # The op is linear in X, so its VJP is the explicitly transposed
    # HIGHEST einsum (the M,out->X contraction) and needs NO residuals.
    # (A nested jax.vjp of the reference einsum here fails the same way
    # under shard_map+jit, and the explicit form is what it computes.)
    lhs, osub = eq.split("->")
    msub, xsub = lhs.split(",")
    teq = f"{msub},{osub}->{xsub}"

    f = jax.custom_vjp(_run)
    f.defvjp(
        lambda X: (_run(X), None),
        lambda _, ct: (jnp.einsum(teq, Mf, ct, preferred_element_type=acc,
                                  precision=jax.lax.Precision.HIGHEST),),
    )
    return f(X)


def _retile_aux(a, Ydtype, nat_axis, pad, tile_shape):
    """Reshape an epilogue aux array from the pass's natural output layout
    into the completion matmul's tile layout: pad the scanned axis like the
    pass input, then reshape to ``tile_shape`` (which splits that axis into
    (n, T) at the right spot).

    Applying an ELEMENTWISE epilogue in the tile layout lets XLA fuse it
    into the dot's output instead of spending a separate full-size HBM
    stream on it — the analog of the reference's ``compute_at`` fusion
    of a pointwise consumer into the filter's last kernel
    (``apps/usm/unsharp_mask_optimized.cpp:61-71``). The epilogue must be
    position-independent (pure elementwise over same-shape arrays)."""
    a = jnp.asarray(a).astype(Ydtype)
    if pad:
        cfg = [(0, 0)] * a.ndim
        cfg[nat_axis] = (0, pad)
        a = jnp.pad(a, cfg)
    return a.reshape(tile_shape)


def _plan_tiles(w: int, tile_width: int, kmax: int, clamp: bool):
    """Resolve (T, n, pad) for one dimension, or None when the blocked
    algebra cannot apply (order exceeds any legal tile; clamp with no exact
    divisor — see fused_dim_pass)."""
    T = int(min(max(tile_width, kmax), w))
    n = -(-w // T)
    pad = n * T - w
    # Zero padding at the end is exact for ZERO borders in both directions.
    # For CLAMP the globally-last tile's matrices assume the edge sits at
    # the tile's end, so clamp requires T | w; fall back to a divisor.
    if clamp and pad:
        for cand in range(T, kmax - 1, -1):
            if w % cand == 0:
                T, n, pad = cand, w // cand, 0
                break
    if T < kmax or (clamp and pad):
        return None
    return T, n, pad


# Above this tile count the block-Toeplitz chain matmul (quadratic in n) is
# replaced by a log-depth associative scan over (W, b) affine pairs — the
# ``jax.lax.associative_scan`` form of the carry recurrence (SURVEY §5.7).
_CHAIN_MATMUL_MAX_TILES = 256


def _chain_solve_assoc(b, scan: Scan, T: int, em, last: bool):
    """Solve one scan's cross-tile recurrence with an associative scan.

    ``b`` is (a, n, k[, t]) natural local tails; returns N of the same shape
    (the natural incoming vector consumed by RN). Equivalent to
    ``b_stacked @ CM.T`` (see ``_chain_matrix``) for any n.
    """
    k = scan.order
    hi = jax.lax.Precision.HIGHEST
    W = em(coeffs.tail_weight_matrix(scan.feedback, T))
    Jk = em(coeffs.antidiagonal(k))
    n = b.shape[1]
    jk_eq = "ij,anj->ani" if last else "ij,anjb->anib"
    mv_eq = "nij,naj->nai" if last else "nij,najb->naib"

    if scan.causal:
        # s_t = W s_{t-1} + Jk b_t ;  N_t = Jk s_{t-1}
        bt = jnp.einsum(jk_eq, Jk, b, precision=hi)
    else:
        # reversed order: run the same recurrence over reversed tiles with
        # identity converters (see _chain_matrix's anticausal branch)
        bt = jnp.flip(b, axis=1)

    A = jnp.broadcast_to(W, (n,) + W.shape)

    # associative_scan carries the tile axis at position 0 of each leaf
    bt_n_first = jnp.moveaxis(bt, 1, 0)  # (n, a, k[, t])
    _, s = jax.lax.associative_scan(
        lambda c1, c2: (
            jnp.einsum("nij,njk->nik", c2[0], c1[0], precision=hi),
            jnp.einsum(mv_eq, c2[0], c1[1], precision=hi) + c2[1],
        ),
        (A, bt_n_first),
        axis=0,
    )
    s = jnp.moveaxis(s, 0, 1)  # (a, n, k[, t])
    s_prev = jnp.concatenate([jnp.zeros_like(s[:, :1]), s[:, :-1]], axis=1)

    if scan.causal:
        return jnp.einsum(jk_eq, Jk, s_prev, precision=hi)
    return jnp.flip(s_prev, axis=1)


def fused_dim_pass(
    x,
    axis: int,
    scans: Sequence[Scan],
    tile_width: int,
    border: str = BorderMode.ZERO,
    compute_dtype=jnp.float32,
    matmul_dtype=None,
    matmul_precision: str = "highest",
    epilogue=None,
    eaux=(),
):
    """Apply all ``scans`` (same dimension) to ``x`` along ``axis``.

    ``matmul_dtype=jnp.bfloat16`` casts the LARGE matmuls' inputs (X, B, G)
    to bf16 with f32 accumulation — the carry solves and injections stay in
    ``compute_dtype``. ~1e-3 relative input rounding for several-fold
    tensor-core throughput.

    ``epilogue(out, *eaux)`` — optional elementwise combine applied in the
    completion matmul's tile layout (see _retile_aux); eaux arrays share
    the pass's natural output shape."""
    clamp = border == BorderMode.CLAMP
    w = x.shape[axis]
    kmax = max(s.order for s in scans)
    plan = _plan_tiles(w, tile_width, kmax, clamp)

    # The blocked algebra needs the order-k carry to fit inside one tile,
    # and clamp needs exact tiling (no divisor ≥ kmax exists for prime-ish
    # widths) — route such cases to the lax.scan core. Carries always run
    # in f32 (never the bf16 storage dtype) — same contract as
    # scan_core.apply_filter.
    if plan is None:
        from . import scan_core

        xs = x if x.dtype == jnp.float32 else x.astype(jnp.float32)
        for s in scans:
            xs = scan_core.apply_scan(
                xs, axis, s.causal, s.feedfwd, s.feedback, border
            )
        if epilogue is not None:
            xs = epilogue(xs, *(jnp.asarray(a).astype(xs.dtype) for a in eaux))
        return xs.astype(x.dtype)

    T, n, pad = plan
    # Audio-scale tile counts: the two-level supertile chain (falls
    # through when its gates do not hold).
    if (n > _CHAIN_MATMUL_MAX_TILES and epilogue is None
            and compute_dtype == jnp.float32 and matmul_dtype is None):
        yh = hierarchical_dim_pass(x, axis, list(scans), border,
                                   matmul_precision)
        if yh is not None:
            return yh
    # Scan axes within reach of the trailing group route through the
    # lanes-contraction form: move the scan axis last (one relayout for
    # non-last axes; free for the last) and emit rotated back into place —
    # free in the completion matmuls' output ordering. The direct "ansb"
    # einsums below contract over a non-minor axis, which XLA lowers as
    # convolutions.
    if x.ndim >= 2 and x.ndim - axis <= 6:
        xm = jnp.moveaxis(x, axis, -1) if axis != x.ndim - 1 else x
        # the rotated emit puts the scan axis straight back at ``axis``
        # (so the FINAL natural layout equals x's — eaux pass through)
        return _last_axis_pass_t(
            xm, scans, plan, clamp, compute_dtype, matmul_dtype,
            rot_axes=x.ndim - axis, matmul_precision=matmul_precision,
            epilogue=epilogue, eaux=eaux,
        )
    mats = prepare_dim_pass(
        scans, T, n, clamp, pad_slots=pad,
        build_cm=n <= _CHAIN_MATMUL_MAX_TILES,
    )
    m = len(scans)
    cdt = compute_dtype

    if pad:
        pads = [(0, 0)] * x.ndim
        pads[axis] = (0, pad)
        x = jnp.pad(x, pads)

    shape = x.shape
    lead = int(np.prod(shape[:axis], dtype=np.int64)) if axis else 1
    trail = (
        int(np.prod(shape[axis + 1 :], dtype=np.int64))
        if axis + 1 < len(shape)
        else 1
    )
    # When the scan axis is the last array axis, keep the contracted axis in
    # the lane dimension and emit (a, n, out) — a trailing axis of size 1
    # would put every array on a single vector lane.
    last = trail == 1
    if last:
        X = x.reshape(lead, n, T).astype(cdt)
    else:
        X = x.reshape(lead, n, T, trail).astype(cdt)

    def em(M):  # matrix constant in compute dtype
        return jnp.asarray(M, dtype=cdt)

    mmd = matmul_dtype
    # Accumulate matmuls in f32 even when storage/compute is bf16.
    acc = jnp.float32 if cdt in (jnp.bfloat16, jnp.float16) else cdt
    prec = _matmul_precision(cdt, mmd, matmul_precision)
    nsp = _split_passes(cdt, mmd, matmul_precision)

    def tile_mat_apply(Mstack, V, vdim_in, fast=False):
        """einsum over the tile axis: Mstack (n|1, out, in) × V.

        ``fast`` ops (the T-wide B/G matmuls on image-sized data) may run
        with bf16 inputs when matmul_dtype requests it, or as compensated
        hi/lo bf16 splits in the f32x3/f32x4 modes; carry-sized ops always
        stay in the compute dtype. Accumulation is always f32."""
        M0 = np.asarray(Mstack)
        if nsp and (fast and V is X or nsp >= 9):
            if M0.shape[0] == 1:
                eq = "os,ans->ano" if last else "os,ansb->anob"
                return _split_einsum(eq, M0[0], V, nsp, acc)
            eq = "nos,ans->ano" if last else "nos,ansb->anob"
            return _split_einsum(eq, M0, V, nsp, acc)
        dt = mmd if (fast and mmd is not None) else cdt
        M = jnp.asarray(M0, dtype=dt)
        Vc = V.astype(dt)
        if M.shape[0] == 1:
            eq = "os,ans->ano" if last else "os,ansb->anob"
            return jnp.einsum(eq, M[0], Vc, preferred_element_type=acc,
                              precision=prec)
        eq = "nos,ans->ano" if last else "nos,ansb->anob"
        return jnp.einsum(eq, M, Vc, preferred_element_type=acc,
                          precision=prec)

    # --- pass A: all local tails in ONE read of X -------------------------
    # (the raw G_i·x terms are independent of the solves; stacking the G
    # rows turns m reads of X into one; rows are zero-padded to >= 8 so XLA
    # lowers the contraction as a dot — below 8 output rows it emits a
    # broadcast+reduce chain costing one full-size stream per row)
    Gcat = pad_rows8(
        np.concatenate([np.asarray(g) for g in mats.G], axis=1))
    braw = tile_mat_apply(Gcat, X, T, fast=True)  # (a, n, >=ΣK, b)
    offs = np.cumsum([0] + mats.orders)

    S = int(sum(mats.orders))
    if braw.shape[2] != S:
        braw = (
            braw[:, :, :S] if last else braw[:, :, :S, :]
        )
    if n <= _CHAIN_MATMUL_MAX_TILES:
        # --- every scan's solve + H-couplings as ONE matmul ---------------
        # (per-op dispatch overhead dominates carry-sized work on this
        # stack; see combined_solve_matrix)
        CM_np = combined_solve_matrix(mats, n)
        if nsp >= 9:
            # integer-exact mode: drop-free solve
            if last:
                Ncat = _split_einsum(
                    "ts,ls->lt", CM_np, braw.astype(acc).reshape(lead, n * S),
                    nsp, acc,
                ).reshape(lead, n, S)
            else:
                bl = braw.astype(acc).reshape(lead, n * S, trail)
                Ncat = _split_einsum(
                    "ts,asb->atb", CM_np, bl, nsp, acc,
                ).reshape(lead, n, S, trail)
        elif last:
            bands = banded_solve_blocks(CM_np, n, S)
            if bands is not None:
                Ncat = _banded_solve_apply(
                    bands, braw.astype(acc), jax.lax.Precision.HIGHEST)
            else:
                CMfull = jnp.asarray(CM_np, dtype=acc)
                Ncat = jnp.einsum(
                    "ls,ts->lt", braw.astype(acc).reshape(lead, n * S),
                    CMfull, preferred_element_type=acc, precision=prec,
                ).reshape(lead, n, S)
        else:
            CMfull = jnp.asarray(CM_np, dtype=acc)
            bl = braw.astype(acc).reshape(lead, n * S, trail)
            Ncat = jnp.einsum(
                "ts,asb->atb", CMfull, bl, preferred_element_type=acc,
                precision=prec,
            ).reshape(lead, n, S, trail)
        # --- pass B: one completion matmul + one carry injection ----------
        Rcat = np.concatenate([np.asarray(r) for r in mats.Rhat], axis=2)
        Y = tile_mat_apply(mats.Btot, X, T, fast=True)
        Y = Y + tile_mat_apply(Rcat, Ncat.astype(cdt), S)
    else:
        # --- large tile counts: log-depth associative scan per scan -------
        # (the (n·k)² chain matrix would be quadratic in n; audio-scale
        # 1-D filters have n ~ 10^4 tiles)
        N = [None] * m
        for i in range(m):
            if last:
                b = braw[:, :, offs[i] : offs[i + 1]]
            else:
                b = braw[:, :, offs[i] : offs[i + 1], :]
            for j in range(i):
                b = b + tile_mat_apply(mats.H[i][j], N[j], mats.orders[j])
            N[i] = _chain_solve_assoc(b, scans[i], T, em, last)
        Y = tile_mat_apply(mats.Btot, X, T, fast=True)
        for j in range(m):
            Y = Y + tile_mat_apply(mats.Rhat[j], N[j], mats.orders[j])

    if epilogue is not None:
        tshape = (lead, n, T) if last else (lead, n, T, trail)
        Y = epilogue(Y, *(_retile_aux(a, Y.dtype, axis, pad, tshape)
                          for a in eaux))
    y = Y.reshape(shape[:axis] + (n * T,) + shape[axis + 1 :])
    if pad:
        y = jax.lax.slice_in_dim(y, 0, w, axis=axis)
    return y





def _shift_mode(y, off: int, axis: int, mode: str):
    """y shifted by ``off`` along ``axis``: pad (edge for "clamp",
    zeros for "zero") + slice — the stencil fallback's building block."""
    n = y.shape[axis]
    lo, hi = max(off, 0), max(-off, 0)
    pads = [(0, 0)] * y.ndim
    pads[axis] = (hi, lo)
    g = jnp.pad(y, pads, mode="edge" if mode == "clamp" else "constant")
    return jax.lax.slice_in_dim(g, lo, lo + n, axis=axis)


def apply_stencil(y, axis: int, taps, start: str = "zero",
                  end: str = "clamp"):
    """Shifted-tap consumer y[i] = Σ c_k·y[i+d_k] along ``axis`` with
    border modes per direction."""
    out = None
    for d, c in taps:
        t = y if d == 0 else _shift_mode(y, d, axis, end if d > 0 else start)
        t = float(c) * t
        out = t if out is None else out + t
    return out


def _stencil_taps_for(stencil, slice_idx=None):
    """Resolve the taps list: shared ``[(off, coeff), ...]`` or per-slice
    ``[[(off, coeff), ...], ...]`` (leading channel groups — DoG's dual
    radius)."""
    taps = stencil["taps"]
    per_slice = (bool(taps) and isinstance(taps[0], (list, tuple))
                 and bool(taps[0])
                 and isinstance(taps[0][0], (list, tuple)))
    if per_slice:
        return taps[0 if slice_idx is None else slice_idx]
    return taps


def _stencil_fallback(y, stencil, axis: int):
    """Apply a (possibly per-slice) stencil with plain XLA shifts — the
    stencil consumer of a single-dimension pass.
    Per-slice taps index the FIRST array axis (negative ``axis`` stays
    valid under that slicing)."""
    taps = stencil["taps"]
    start = stencil.get("start", "zero")
    end = stencil.get("end", "clamp")
    per_slice = (bool(taps) and isinstance(taps[0], (list, tuple))
                 and bool(taps[0])
                 and isinstance(taps[0][0], (list, tuple)))
    if not per_slice:
        return apply_stencil(y, axis, taps, start, end)
    return jnp.stack([
        apply_stencil(y[p], axis, _stencil_taps_for(stencil, p), start, end)
        for p in range(y.shape[0])
    ])


def _last_axis_pass_t(x, scans, plan, clamp, cdt, mmd, rot_axes,
                      matmul_precision: str = "highest",
                      epilogue=None, eaux=(), stencil=None):
    """One dimension pass along the LAST axis, optionally emitting the result
    with the trailing ``rot_axes`` axes rotated one step: the scanned axis
    moves to position ``-rot_axes`` and the other trailing axes shift right.

    The rotated emission rides the completion matmuls' output ordering (free
    in the dot epilogue), so chaining ``D`` of these processes all ``D``
    trailing dimensions entirely in lanes-contraction form with no
    standalone relayout copy between passes, and after ``D`` passes the axis
    order is restored exactly — the transpose-chaining executor used by
    :func:`apply_filter_fused` for images (D=2) and volumes (D=3).

    ``rot_axes=1`` emits in place (no rotation). ``stencil`` applies a
    shifted-tap consumer (XLA shifts) to the pass output before
    ``epilogue``.
    """
    T, n, pad = plan
    m = len(scans)
    mats = prepare_dim_pass(
        scans, T, n, clamp, pad_slots=pad,
        build_cm=n <= _CHAIN_MATMUL_MAX_TILES,
    )
    if pad:
        pads = [(0, 0)] * x.ndim
        pads[-1] = (0, pad)
        x = jnp.pad(x, pads)

    shape = x.shape
    nrow = max(rot_axes - 1, 1)          # distinct row axes kept in einsums
    rows = shape[-1 - nrow : -1]         # trailing row-axis sizes
    rl = "qruvw"[:nrow]                  # einsum letters for the row axes
    lead = shape[: -1 - nrow]
    P = int(np.prod(lead, dtype=np.int64)) if lead else 1
    PR = P * int(np.prod(rows, dtype=np.int64))
    X = x.reshape((P,) + tuple(rows) + (n, T)).astype(cdt)
    acc = jnp.float32 if cdt in (jnp.bfloat16, jnp.float16) else cdt
    prec = _matmul_precision(cdt, mmd, matmul_precision)
    nsp = _split_passes(cdt, mmd, matmul_precision)
    hi = jax.lax.Precision.HIGHEST
    if rot_axes >= 2 and P > 1 and nsp < 9:
        # Rotated passes with a leading channel/batch group: the
        # transposed-output einsums cannot fuse the split chunk products,
        # so every chunk product would round-trip device memory; run the
        # equivalent-grade HIGHEST dots instead. (nsp=9 is the
        # integer-exact mode: exactness overrides — drop-free splits stay.)
        nsp = 0

    def apply(Mstack, V, fast=False, out_t=False):
        out = f"pno{rl}" if out_t else f"p{rl}no"
        M0 = np.asarray(Mstack)
        if nsp and (fast and V is X or nsp >= 9):
            if M0.shape[0] == 1:
                return _split_einsum(f"os,p{rl}ns->{out}", M0[0], V, nsp, acc)
            return _split_einsum(f"nos,p{rl}ns->{out}", M0, V, nsp, acc)
        dt = mmd if (fast and mmd is not None) else cdt
        M = jnp.asarray(M0, dtype=dt)
        Vc = V.astype(dt)
        if M.shape[0] == 1:
            return jnp.einsum(
                f"os,p{rl}ns->{out}", M[0], Vc, preferred_element_type=acc,
                precision=prec,
            )
        return jnp.einsum(
            f"nos,p{rl}ns->{out}", M, Vc, preferred_element_type=acc,
            precision=prec,
        )

    S = int(sum(mats.orders))
    Gcat = pad_rows8(np.concatenate([np.asarray(g) for g in mats.G], axis=1))
    braw = apply(Gcat, X, fast=True)[..., :S]  # (P, *rows, n, S)

    if n <= _CHAIN_MATMUL_MAX_TILES:
        CM_np = combined_solve_matrix(mats, n)
        if nsp >= 9:
            # integer-exact mode: the solve must be drop-free too
            Ncat = _split_einsum(
                "ts,ls->lt", CM_np, braw.astype(acc).reshape(PR, n * S),
                nsp, acc,
            ).reshape((P,) + tuple(rows) + (n, S))
        else:
            bands = banded_solve_blocks(CM_np, n, S)
            if bands is not None:
                Ncat = _banded_solve_apply(bands, braw.astype(acc), hi)
            else:
                CMfull = jnp.asarray(CM_np, dtype=acc)
                Ncat = jnp.einsum(
                    "ls,ts->lt", braw.astype(acc).reshape(PR, n * S), CMfull,
                    preferred_element_type=acc, precision=prec,
                ).reshape((P,) + tuple(rows) + (n, S))
    else:
        # associative fallback per scan (audio-scale) — reuse the 4-axis
        # solver by treating the row axes as the batch axis
        offs = np.cumsum([0] + mats.orders)
        Ns = []
        for i in range(m):
            b = braw[..., offs[i] : offs[i + 1]].reshape(PR, n, -1)
            for j in range(i):
                prev = Ns[j].reshape(PR, n, -1)
                Hs = jnp.asarray(np.asarray(mats.H[i][j]), dtype=cdt)
                corr = (
                    jnp.einsum("oj,anj->ano", Hs[0], prev, precision=hi)
                    if Hs.shape[0] == 1
                    else jnp.einsum("noj,anj->ano", Hs, prev, precision=hi)
                )
                b = b + corr
            Ns.append(
                _chain_solve_assoc(b, scans[i], T, lambda M: jnp.asarray(M, acc), True)
                .reshape((P,) + tuple(rows) + (n, -1))
            )
        Ncat = jnp.concatenate(Ns, axis=-1)

    Rcat = np.concatenate([np.asarray(r) for r in mats.Rhat], axis=2)
    rot = rot_axes >= 2
    Y = apply(mats.Btot, X, fast=True, out_t=rot)
    Y = Y + apply(Rcat, Ncat.astype(cdt), out_t=rot)

    if epilogue is not None and stencil is None:
        # Natural output layout: rot → lead + (nT,) + rows (scanned axis at
        # len(lead)); in-place → lead + rows + (nT,).
        if rot:
            nat_ax, tshape = len(lead), (P, n, T) + tuple(rows)
        else:
            nat_ax, tshape = -1, (P,) + tuple(rows) + (n, T)
        Y = epilogue(Y, *(_retile_aux(a, Y.dtype, nat_ax, pad, tshape)
                          for a in eaux))

    if rot:
        y = Y.reshape(lead + (n * T,) + tuple(rows))
        if pad:
            y = jax.lax.slice_in_dim(y, 0, n * T - pad, axis=-1 - nrow)
    else:
        y = Y.reshape(lead + tuple(rows) + (n * T,))
        if pad:
            y = jax.lax.slice_in_dim(y, 0, n * T - pad, axis=-1)
    if stencil is not None:
        # stencil before epilogue (the consumer-order contract)
        y = _stencil_fallback(y, stencil, (-1 - nrow) if rot else -1)
        if epilogue is not None:
            y = epilogue(y, *(jnp.asarray(a).astype(y.dtype) for a in eaux))
    return y


def dim_pass_stages(x, axis: int, scans: Sequence[Scan], tile_width: int,
                    border: str = BorderMode.ZERO):
    """Every internal stage value of one fused dimension pass, computed
    from the SHIPPING executor's matrices (prepare_dim_pass /
    combined-solve algebra) — the debugging surface behind
    ``RecFilter.func(name)`` (``lib/recfilter.h:296-302``).

    Returns a dict with per-scan lists (i indexes ``scans``):

      * ``intra[i]``  — raw local tails G_i·x, shape lead + (n, k_i)
        (the reference's Intra/Intra_Tail terms, ``lib/split.cpp:256-499``)
      * ``tdeps[i]``  — cross-scan residual Σ_{j<i} H_ij·N_j onto scan i's
        tails (``create_tail_residual_term``, ``lib/split.cpp:912-1004``)
      * ``ctail[i]``  — completed carries N_i (the natural incoming
        vectors; ``create_complete_tail_term``, ``lib/split.cpp:743-867``)
      * ``deps[i]``   — per-tile injection residual Rhat_i·N_i in image
        layout lead + (n, T) (``create_final_residual_term``,
        ``lib/split.cpp:1008-1130``)
      * ``final[i]``  — the image after scans 0..i of this dimension
        (x's shape; the prefix scans[:i+1] completion)

    ``lead`` are x's other axes (scanned axis moved last). Raises when the
    dimension is untileable (order exceeds any legal tile / clamp with no
    divisor) — stage views are defined by the tiled algebra.
    """
    clamp = border == BorderMode.CLAMP
    w = x.shape[axis]
    kmax = max(s.order for s in scans)
    plan = _plan_tiles(w, tile_width, kmax, clamp)
    if plan is None:
        raise ValueError(
            "dimension not tileable; per-stage view undefined (the "
            "executor would route this case to the lax.scan core)"
        )
    T, n, pad = plan
    if pad:
        pads = [(0, 0)] * x.ndim
        pads[axis] = (0, pad)
        x = jnp.pad(x, pads)
    xm = jnp.moveaxis(x, axis, -1).astype(jnp.float32)
    lead = xm.shape[:-1]
    X = xm.reshape(lead + (n, T))
    hi = jax.lax.Precision.HIGHEST

    def ap(Mstack, V):
        M = np.asarray(Mstack, np.float64)
        Mn = jnp.asarray(
            M[np.minimum(np.arange(n), M.shape[0] - 1)], jnp.float32)
        return jnp.einsum("nos,...ns->...no", Mn, V,
                          preferred_element_type=jnp.float32, precision=hi)

    mats = prepare_dim_pass(scans, T, n, clamp, pad_slots=pad)
    m = len(scans)
    out = {"intra": [], "tdeps": [], "ctail": [], "deps": [], "final": []}
    N = []
    for i in range(m):
        k = scans[i].order
        b = ap(mats.G[i], X)
        td = jnp.zeros_like(b)
        for j in range(i):
            td = td + ap(mats.H[i][j], N[j])
        bi = b + td
        CM = jnp.asarray(mats.CM[i], jnp.float32)
        lines = bi.reshape(-1, n * k)
        Ni = jnp.einsum("ls,ts->lt", lines, CM,
                        preferred_element_type=jnp.float32,
                        precision=hi).reshape(lead + (n, k))
        N.append(Ni)
        out["intra"].append(b)
        out["tdeps"].append(td)
        out["ctail"].append(Ni)
        out["deps"].append(ap(mats.Rhat[i], Ni))
        # the prefix scans[:i+1] completion IS the image after scan i
        mp = mats if i == m - 1 else prepare_dim_pass(
            scans[: i + 1], T, n, clamp, pad_slots=pad)
        y = ap(mp.Btot, X)
        for j in range(i + 1):
            y = y + ap(mp.Rhat[j], N[j])
        y = jnp.moveaxis(y.reshape(lead + (n * T,)), -1, axis)
        if pad:
            y = jax.lax.slice_in_dim(y, 0, w, axis=axis)
        out["final"].append(y)
    return out


# ---------------------------------------------------------------------------
# Hierarchical two-level chain: tiles -> supertiles (VERDICT r3 #4)
# ---------------------------------------------------------------------------


def _chain_prefix_axis(b, scan: Scan, seg: int, D: int, prec):
    """In-chip Kogge–Stone carry-chain solve over a supertile ARRAY axis:
    ``parallel.sharding._ks_chain`` with zero-filled jnp shifts along axis
    -2 of ``b`` (..., D, k) in place of ``ppermute`` (the zero fill IS the
    zero-state boundary condition). log₂(D) einsum steps against k×k
    transfer powers — no (D·k)² matrix at any point. Returns the natural
    incoming vectors N (..., D, k) consumed by the Rcat correction."""
    k = scan.order
    W = coeffs.tail_weight_matrix(scan.feedback, seg)
    Jk = np.asarray(coeffs.antidiagonal(k))

    def mat(M):
        return jnp.asarray(np.asarray(M), jnp.float32)

    def shift(a, s):
        # causal: recv_d = a_{d-s}; anticausal: recv_d = a_{d+s}
        z = jnp.zeros_like(a[..., :s, :])
        if scan.causal:
            return jnp.concatenate([z, a[..., : D - s, :]], axis=-2)
        return jnp.concatenate([a[..., s:, :], z], axis=-2)

    if scan.causal:
        # u_d = Jk b_d; inclusive s_d = Σ_{i≤d} W^{d-i} u_i; N_d = Jk s_{d-1}
        u = jnp.einsum("ij,...j->...i", mat(Jk), b, precision=prec,
                       preferred_element_type=jnp.float32)
    else:
        # natural order IS W-order; inclusive from the right; N_d = s_{d+1}
        u = b
    s_ = u
    sh = 1
    Wp = np.asarray(W, np.float64).copy()
    while sh < D:
        s_ = s_ + jnp.einsum("ij,...j->...i", mat(Wp), shift(s_, sh),
                             precision=prec,
                             preferred_element_type=jnp.float32)
        sh *= 2
        Wp = Wp @ Wp
    s_prev = shift(s_, 1)
    if scan.causal:
        return jnp.einsum("ij,...j->...i", mat(Jk), s_prev, precision=prec,
                          preferred_element_type=jnp.float32)
    return s_prev


def hierarchical_dim_pass(x, axis: int, scans: Sequence[Scan], border: str,
                          matmul_precision: str):
    """Audio-scale dimension pass via a TWO-LEVEL chain so n ~ 10^4 tile
    counts run dense 256-tile combined solves instead of the associative
    scan's log-depth chain of tiny dots.

    Level 1: reshape the scan axis into (n_sup, seg) supertiles of
    seg = 256·128 samples and run each scan's zero-state local pass with
    the supertile axis as LINES — the tile matmuls get real line counts
    (lead·n_sup) instead of the 1-D signal's skinny batch, and every
    supertile's chain solves densely at n = 256 tiles. Level 2: one
    (n_sup·ΣK)² combined solve over the supertile boundary carries — the
    device-level exchange algebra (``parallel.sharding``) applied at the
    in-chip level, with the same clamp rank-1 edge corrections and pad
    projector — then a rank-ΣK correction closes every supertile.

    The internal tile width is 128 regardless of the caller's (the blocked
    algebra's result is tile-invariant). Returns None when a gate fails
    (ΣK > 64, > 512 supertiles ≈ 16.7M samples at ΣK ≤ 8 — the S>8
    Kogge–Stone route runs to 4096 ≈ 134M — tiny effective
    last segment, precision other than px/default) — callers keep the
    associative-scan
    path. Reference headline workload:
    ``apps/audio/audio_filter_high_order.cpp:38-93``.
    """
    S = int(sum(s.order for s in scans))
    kmax = max(s.order for s in scans)
    # ΣK ≤ 8: dense (n_sup·ΣK)² combined solve. Past 8, the dense matrix grows quadratically in
    # n_sup·ΣK (315 MB at 10M samples / order 29), so level 2 switches to
    # per-scan Kogge–Stone transfer chains over the supertile axis — the
    # in-chip analog of parallel.sharding._ks_chain — and level-1 locals
    # ride the banded einsum solve. Covers the reference's full audio
    # sweep (orders 1..29, biquads 1..30 → overlapped order ≤ 60:
    # apps/audio/audio_filter_high_order.cpp:38-93).
    if S > 64:
        return None
    # The px grades and throughput mode ("default") take the supertile
    # chain; the XLA-precision grades keep the associative path.
    if matmul_precision not in ("px3", "px4", "px6", "default"):
        return None
    w = x.shape[axis]
    T = 128
    seg = _CHAIN_MATMUL_MAX_TILES * T  # 256 tiles: the dense-solve max
    n_sup = -(-w // seg)
    # The dense (n_sup·S)² level-2 solve caps at 512 supertiles (~16.7M
    # samples); the S>8 Kogge–Stone route has no quadratic term and runs
    # to 4096 supertiles (~134M samples) — log₂ shift/einsum steps on
    # carry-sized arrays only.
    if n_sup < 2 or n_sup > (512 if S <= 8 else 4096):
        return None
    pad = n_sup * seg - w
    if seg - pad <= kmax + 1:
        return None
    clamp = border == BorderMode.CLAMP

    from .parallel import sharding as _sh

    xm = jnp.moveaxis(x, axis, -1) if axis != x.ndim - 1 else x
    lead = xm.shape[:-1]
    if pad:
        xm = jnp.pad(xm, [(0, 0)] * (xm.ndim - 1) + [(0, pad)])
    y = xm.reshape(lead + (n_sup, seg)).astype(jnp.float32)

    cs = []
    for s in scans:
        k = s.order
        if clamp:
            e_seg = 0 if s.causal else n_sup - 1
            e_pos = 0 if s.causal else seg - 1 - pad
            x_edge = y[..., e_seg, e_pos][..., None, None]
        y = fused_dim_pass(y, y.ndim - 1, [s], T, BorderMode.ZERO,
                           matmul_precision=matmul_precision)
        if clamp:
            v = _sh._clamp_col(s, seg if s.causal else seg - pad, total=seg)
            vj = jnp.asarray(v, y.dtype)
            upd = y[..., e_seg, :] + vj * x_edge[..., 0, :]
            y = y.at[..., e_seg, :].set(upd)
        if pad:
            y = y.at[..., n_sup - 1, seg - pad:].set(0.0)
        c = y[..., seg - k:] if s.causal else y[..., :k]
        cs.append(c)
    ccat = jnp.concatenate(cs, axis=-1)  # (..., n_sup, S)

    orders, H, CMs, Rcats = _sh._segment_exchange_mats(
        scans, seg, n_sup, clamp, pad, build_cm=S <= 8)
    hi = jax.lax.Precision.HIGHEST
    if S <= 8:
        CMfull = _sh._combined_solve(orders, H, CMs, n_sup)  # (n_sup·S)²
        N = jnp.einsum(
            "ts,...s->...t", jnp.asarray(CMfull, jnp.float32),
            ccat.reshape(lead + (n_sup * S,)),
            preferred_element_type=jnp.float32, precision=hi,
        ).reshape(lead + (n_sup, S))
    else:
        # Per-scan Kogge–Stone chains over the supertile ARRAY axis: only
        # k×k transfer powers as constants (vs the (n_sup·S)² dense
        # matrix); cross-scan H couplings injected scan by scan, exactly
        # as the device-level ring route does (_seq_solve_ring).
        offs2 = np.cumsum([0] + orders)
        Ns = []
        for i, s in enumerate(scans):
            b = ccat[..., offs2[i]:offs2[i + 1]]
            for j in range(i):
                Hs = np.asarray(H[i][j])  # (1|n_sup, k_i, k_j)
                eq = ("ok,...nk->...no" if Hs.shape[0] == 1
                      else "nok,...nk->...no")
                Hm = Hs[0] if Hs.shape[0] == 1 else Hs
                b = b + jnp.einsum(eq, jnp.asarray(Hm, jnp.float32), Ns[j],
                                   preferred_element_type=jnp.float32,
                                   precision=hi)
            Ns.append(_chain_prefix_axis(b, s, seg, n_sup, hi))
        N = jnp.concatenate(Ns, axis=-1)

    # Rank-S correction: interior columns on every supertile, plus edge
    # deltas on the globally-first/last supertiles under clamp/pad.
    Rint = Rcats[0 if Rcats.shape[0] == 1 else 1]
    y = y + jnp.einsum("ts,...ns->...nt", jnp.asarray(Rint, jnp.float32), N,
                       preferred_element_type=jnp.float32, precision=hi)
    if Rcats.shape[0] == 3:
        for sel, si in ((0, 0), (2, n_sup - 1)):
            dR = np.asarray(Rcats[sel]) - np.asarray(Rint)
            corr = jnp.einsum(
                "ts,...s->...t", jnp.asarray(dR, jnp.float32),
                N[..., si, :], preferred_element_type=jnp.float32,
                precision=hi)
            y = y.at[..., si, :].add(corr)

    y = y.reshape(lead + (n_sup * seg,))
    if pad:
        y = jax.lax.slice_in_dim(y, 0, w, axis=-1)
    if axis != x.ndim - 1:
        y = jnp.moveaxis(y, -1, axis)
    return y.astype(x.dtype)


# ---------------------------------------------------------------------------
# Exact tiled integer execution (VERDICT r3 #3)
# ---------------------------------------------------------------------------


def _int_cast_scans(spec: FilterSpec):
    """Coefficients cast into the image type, as the reference does
    (``lib/recfilter.cpp:324-341``) and as the integer oracle does
    (scan_core.oracle_apply / apply_filter): int16 coeffs wrap at int16.
    Returns float-valued Scans with exactly-integral coefficients, or None
    if a cast coefficient cannot be held exactly in float64 (never for
    itemsize <= 4)."""
    t = np.dtype(spec.dtype).type
    out = []
    for s in spec.scans:
        ff = float(int(t(s.feedfwd)))
        fb = tuple(float(int(t(c))) for c in s.feedback)
        out.append(Scan(s.axis, s.causal, ff, fb))
    return out


def _int_abs_gain(scans, extent: int, border: str) -> float:
    """Worst-case growth of one dimension pass: ∏ over the dim's scans of
    ``Σ|h_s| (+ max|clamp column|)`` — the entrywise-absolute operator norm
    ‖ |B_m|⋯|B_1| ‖_∞ bound, from each scan's SIGNED impulse response
    (float64). Every intermediate of the blocked algebra — tails, carries,
    corrections, AND every partial sum inside its dots — is an entry (or
    partial sum) of a product of per-scan impulse blocks with {0,1}
    projections, so entrywise |∏ B_s| ≤ ∏ |B_s| bounds them all. (An
    abs-COEFFICIENT cascade is exponentially loose for signed feedbacks
    like box2's (2,-1), whose signed operator grows only polynomially.)

    Clamp: B_clamp = B + v·e_edgeᵀ is rank-1 off the zero-border operator
    (see parallel.sharding._clamp_col), so Σ|B_clamp| ≤ Σ|h| + max|v|."""
    from . import scan_core

    g = 1.0
    for s in scans:
        e = np.zeros((extent, 1), np.float64)
        e[0 if s.causal else extent - 1, 0] = 1.0
        h = scan_core.oracle_apply_scan(
            e, 0, s.causal, s.feedfwd, list(s.feedback), BorderMode.ZERO
        )
        gs = float(np.abs(h).sum())
        if border == BorderMode.CLAMP:
            hc = scan_core.oracle_apply_scan(
                e, 0, s.causal, s.feedfwd, list(s.feedback), BorderMode.CLAMP
            )
            gs += float(np.abs(hc - h).max())
        g *= max(gs, 1.0)
        if not np.isfinite(g) or g >= 2 ** 23:
            return float("inf")
    return g


def _int_limbs(v, lb: int, nl: int):
    """Split int32 ``v`` into ``nl`` signed limbs of ``lb`` bits:
    v = Σ limb_i · 2^(lb·i) exactly (two's complement low-bits with borrow
    propagation — no intermediate overflow)."""
    half = jnp.int32(1 << (lb - 1))
    mask = jnp.int32((1 << lb) - 1)
    out = []
    for _ in range(nl - 1):
        low = v & mask
        limb = (low ^ half) - half  # sign-extended low lb bits
        out.append(limb)
        v = (v >> lb) + (low >= half).astype(jnp.int32)
    out.append(v)
    return out


def unit_scans_of(scan) -> list | None:
    """Decompose an (image-type-cast) scan into chained unit scans
    ``[(f, ±1, causal), ...]`` for :func:`int_unit_dim_pass`, else None.

    Order 1 with feedback ±1 maps directly. Higher orders qualify when
    the feedback polynomial 1 − Σ aⱼ zʲ factors as (1−z)^m (1+z)^(k−m) —
    all-±1 roots, e.g. (2, −1) = double integration — each factor is one
    chained cumulative sum. Checked by exact integer reconstruction, not
    root-finding. The feed-forward tap must be a single integer; it rides
    the first factor."""
    fb = np.asarray(scan.feedback, np.float64).reshape(-1)
    ff = np.asarray(scan.feedfwd, np.float64).reshape(-1)
    if ff.shape != (1,):
        return None
    if ff[0] != np.round(ff[0]) or not (-(2 ** 31) <= ff[0] < 2 ** 31):
        return None
    k = fb.shape[0]
    if not 1 <= k <= 8 or np.any(fb != np.round(fb)):
        return None
    # want poly(z) = 1 - a1 z - ... - ak z^k == (1-z)^m (1+z)^(k-m)
    target = np.concatenate([[1.0], -fb])
    f, causal = int(ff[0]), bool(scan.causal)
    for m in range(k + 1):
        poly = np.array([1.0])
        for _ in range(m):
            poly = np.convolve(poly, [1.0, -1.0])
        for _ in range(k - m):
            poly = np.convolve(poly, [1.0, 1.0])
        if np.array_equal(poly, target):
            out = ([(1, 1, causal)] * m + [(1, -1, causal)] * (k - m))
            out[0] = (f, out[0][1], causal)  # the tap rides ONE factor
            return out
    return None


def int_unit_dim_pass(x, units, axis: int):
    """Chained unit scans ``[(f, ±1, causal), ...]`` along ``axis`` of an
    integer array, in wrapping int32 arithmetic — exact modulo 2^32 by
    construction (and modulo 2^k for narrower image types, by ring
    homomorphism), with no gain gate:

        a = +1:  y = cumsum(f·x)              (suffix sum when anticausal)
        a = −1:  y_i = f·x_i − y_{i∓1}  ⇒  y = D · cumsum(D · f·x),
                 D = diag((−1)^i)             (global parity along the axis)
    """
    x = jnp.asarray(x).astype(jnp.int32)
    E = x.shape[axis]
    parity = None
    for f, sgn, causal in units:
        v = x if f == 1 else x * jnp.int32(f)
        if sgn == 1:
            x = jax.lax.cumsum(v, axis=axis, reverse=not causal)
            continue
        if parity is None:
            shp = [1] * x.ndim
            shp[axis] = E
            parity = jnp.asarray(1 - 2 * (np.arange(E) % 2),
                                 jnp.int32).reshape(shp)
        x = parity * jax.lax.cumsum(parity * v, axis=axis,
                                    reverse=not causal)
    return x


def apply_filter_int_exact(spec: FilterSpec, x, tile_default: int = 32):
    """Integer filters through the TILED executor, bit-exact vs the integer
    oracle (modular wrap semantics), by mantissa-limb decomposition:

    Per scanned dimension, split the int32 accumulator into signed limbs
    small enough that the limb pass's worst-case magnitude (limb range ×
    the entry-abs cascade gain) stays under 2^22; run each limb through
    the tiled dimension pass in the drop-free ``f32x9`` mode — 3-chunk
    bf16 splits represent any integer < 2^24 exactly (every chunk is
    itself an integer), chunk products are exact bf16×bf16→f32, f32
    partial sums below 2^24 are exact, and ALL NINE chunk products are
    kept in every image matmul, carry solve, and injection (6-product
    schemes like px6/HIGHEST drop the low cross terms, whose sums grow
    past ±0.5 at large gains — measured as off-by-one at box2 scale) —
    then recombine with wrapping shifts (mod 2^32 ≡ per-step wrap at the
    image type, by ring homomorphism). The reference runs integers through
    its ONE tiled pipeline by casting coefficients into the image type
    (``lib/recfilter.cpp:324-341``, ``tests/test_type_invariance.cpp:17-63``);
    this is that, with matmuls in place of the scalar loop.

    Returns None when exactness is not provable (itemsize > 4, or a
    dimension's gain leaves < 2 limb bits) — callers fall back to the
    sequential lax.scan core.
    """
    dtype = np.dtype(spec.dtype)
    if dtype.itemsize > 4:
        return None
    scans = _int_cast_scans(spec)
    groups = spec.scans_by_axis()
    # Per-dim gate first (no partial work on fallback).
    #
    # Fast route per dimension: if EVERY scan of the dim is unit-feedback
    # (order 1, a = ±1, one integral tap — the SAT/integral-image class)
    # and the border is ZERO, the whole dim runs wrapping int32 cumulative
    # sums (exact mod 2^32 by construction — no gain gate at all). Otherwise the limb route: a
    # dim whose scan cascade's combined gain leaves < 2 limb bits is
    # split into consecutive scan chunks with limb recombination between
    # (each chunk is its own exact mod-2^32 linear pass).
    plan_dims = []
    xi = jnp.asarray(x).astype(jnp.int32)
    bits = dtype.itemsize * 8

    def _limb_chunks(ax, ids, bits_in):
        """Chunked limb plan for one dim, or None past the provable gate.
        Returns (plan_entries, bits_out)."""
        chunk, gc = [], 1.0
        chunks = []
        for i in ids:
            gi = _int_abs_gain([scans[i]], xi.shape[ax], spec.border)
            if not np.isfinite(gi) or gi >= 2 ** 21:
                return None
            if chunk and gc * gi >= 2 ** 21:
                chunks.append((chunk, gc))
                chunk, gc = [], 1.0
            chunk.append(i)
            gc *= gi
        chunks.append((chunk, gc))
        out, b = [], bits_in
        for chunk, gc in chunks:
            lg = max(int(np.ceil(np.log2(gc))), 0)
            lb = 23 - lg
            if lb < 2:
                return None
            nl = -(-min(b, 32) // lb)
            out.append(("limb", tuple(chunk), lb, nl))
            b = min(b + lg, 32)
        return out, b

    for ax, ids in groups.items():
        unit = (
            [unit_scans_of(scans[i]) for i in ids]
            if spec.border == BorderMode.ZERO else [None]
        )
        if all(u is not None for u in unit):
            flat = [u for us in unit for u in us]
            plan_dims.append((ax, [("unit", flat)]))
            bits = 32  # wrapped values occupy the full word downstream
            continue
        plan = _limb_chunks(ax, ids, bits)
        if plan is None:
            return None
        plan_dims.append((ax, plan[0]))
        bits = plan[1]

    tiles = spec.tile_widths or (0,) * spec.ndim
    for ax, routes in plan_dims:
        if routes[0][0] == "unit":
            xi = int_unit_dim_pass(xi, routes[0][1], ax)
            continue
        for route in routes:
            _, ids, lb, nl = route
            sc = [scans[i] for i in ids]
            T = min(tiles[ax] or tile_default, xi.shape[ax])
            kmax = max(s.order for s in sc)
            p = _plan_tiles(xi.shape[ax], T, kmax,
                            spec.border == BorderMode.CLAMP)
            if p is not None and p[1] > _CHAIN_MATMUL_MAX_TILES:
                # the associative audio-scale solver is not drop-free audited
                return None
            limbs = _int_limbs(xi, lb, nl)
            acc = None
            for i, limb in enumerate(limbs):
                y = fused_dim_pass(
                    limb.astype(jnp.float32), ax, sc, T, spec.border,
                    matmul_precision="f32x9",
                )
                yi = jnp.round(y).astype(jnp.int32)
                acc = yi if acc is None else acc + (yi << jnp.int32(lb * i))
            xi = acc
    return xi.astype(jnp.dtype(spec.dtype))


def apply_stencil2d(y, taps_c):
    """Per-channel 2-D shifted-tap banks ``[[(dy, dx, coeff), ...], ...]``
    over the TRAILING two axes of ``y``: positive offsets clamp at the far
    edges, negative offsets read zero (the SAT-differencing contract,
    ``apps/DoG/diff_gauss.cpp:29-38``). Plain pad/slice shifts, which XLA
    fuses into one loop per channel. Always returns a tuple of per-channel
    arrays."""
    nd = y.ndim
    outs = []
    for taps in taps_c:
        acc = None
        for dy, dx, coeff in taps:
            t = y
            for off, ax in ((int(dy), nd - 2), (int(dx), nd - 1)):
                if off == 0:
                    continue
                n = t.shape[ax]
                lo, hi = max(off, 0), max(-off, 0)
                pads = [(0, 0)] * nd
                pads[ax] = (hi, lo)
                t = jnp.pad(t, pads, mode="edge" if off > 0 else "constant")
                t = jax.lax.slice_in_dim(t, lo, lo + n, axis=ax)
            t = t * float(coeff)
            acc = t if acc is None else acc + t
        outs.append(acc)
    return tuple(outs)


def apply_filter_fused(spec: FilterSpec, x, tile_default: int = 32,
                       matmul_dtype=None, matmul_precision: str = "highest",
                       epilogue=None, eaux=(), stencil2d=None):
    """Whole-filter executor: one fused pass per scanned dimension.

    ``epilogue(out, *eaux)`` — optional elementwise combine fused into the
    LAST dimension pass's completion matmul (eaux arrays share the filter's
    output shape/layout); the analog of the reference's ``compute_at``
    of a pointwise consumer into the filter's final kernel
    (``apps/usm/unsharp_mask_optimized.cpp:61-71``).

    ``stencil2d`` — per-channel 2-D shifted-tap consumer banks
    ``[[(dy, dx, coeff), ...], ...]`` over the trailing two axes (border
    semantics per :func:`apply_stencil2d`), applied to the filter output.
    Returns a TUPLE of per-channel arrays. Mutually exclusive with
    ``epilogue``."""
    from . import scan_core

    if stencil2d is not None and (epilogue is not None or eaux):
        raise ValueError("stencil2d is mutually exclusive with epilogue")

    dtype = jnp.dtype(spec.dtype)
    if jnp.issubdtype(dtype, jnp.integer):
        y = apply_filter_int_exact(spec, x, tile_default)
        if y is None:
            y = scan_core.apply_filter(spec, x)
        if epilogue is not None:
            y = epilogue(y, *eaux)
        if stencil2d is not None:
            return apply_stencil2d(y, stencil2d)
        return y
    if dtype == jnp.bfloat16:
        # bf16 storage between passes (half the memory traffic), bf16
        # matmul operands, f32 accumulation and carry solves.
        cdt = jnp.bfloat16
        matmul_dtype = jnp.bfloat16
    else:
        cdt = jnp.float32 if dtype == jnp.float16 else dtype
    x = x.astype(cdt)
    tiles = spec.tile_widths or (0,) * spec.ndim
    groups = spec.scans_by_axis()
    nd = x.ndim
    clamp = spec.border == BorderMode.CLAMP

    # Rotation-chaining path: the scanned dims are the trailing D>=2
    # array axes. Process the LAST axis first (cross-dim scans commute) and
    # emit with the trailing-D group rotated one step, so the next scanned
    # dim lands on the last axis; after D passes the axis order is restored
    # exactly. Every pass contracts over the minor axis and no standalone
    # relayout copy sits between the passes (D=2: images; D=3: volumes).
    Ds = len(groups)
    if 2 <= Ds <= 5 and set(groups) == set(range(nd - Ds, nd)):
        order = [nd - 1 - i for i in range(Ds)]
        plans = {}
        for ax in order:
            sc = [spec.scans[i] for i in groups[ax]]
            plans[ax] = _plan_tiles(
                x.shape[ax],
                tiles[ax] or tile_default,
                max(s.order for s in sc),
                clamp,
            )
        if all(p is not None for p in plans.values()):
            # After D rotated passes the axis order is restored, so the last
            # pass's natural output layout equals the input's — eaux arrays
            # in the filter's own layout fuse straight into its emit.
            for i, ax in enumerate(order):
                final = i == len(order) - 1
                x = _last_axis_pass_t(
                    x, [spec.scans[j] for j in groups[ax]], plans[ax], clamp,
                    cdt, matmul_dtype, rot_axes=Ds,
                    matmul_precision=matmul_precision,
                    epilogue=epilogue if final else None,
                    eaux=eaux if final else (),
                )
            if stencil2d is not None:
                return apply_stencil2d(x.astype(dtype), stencil2d)
            return x.astype(dtype)

    axes = list(groups)
    for axis in axes:
        ids = groups[axis]
        T = tiles[axis] or tile_default
        final = axis == axes[-1]
        x = fused_dim_pass(
            x,
            axis,
            [spec.scans[i] for i in ids],
            T,
            spec.border,
            compute_dtype=cdt,
            matmul_dtype=matmul_dtype,
            matmul_precision=matmul_precision,
            epilogue=epilogue if final else None,
            eaux=eaux if final else (),
        )
    if stencil2d is not None:
        return apply_stencil2d(x.astype(dtype), stencil2d)
    return x.astype(dtype)


def apply_filter_rotated(
    spec: FilterSpec,
    x,
    rot_axes: int = 2,
    tile_default: int = 32,
    matmul_dtype=None,
    matmul_precision: str = "highest",
    epilogue=None,
    eaux=(),
    stencil=None,
):
    """Layout-chained executor for SINGLE-dimension filters.

    The input ``x`` must carry the spec's (one) scanned dimension as its
    LAST array axis — whatever that dimension's nominal position in the spec
    — and the result is emitted with the trailing ``rot_axes`` axes rotated
    one step (the scanned axis lands at position ``-rot_axes``). The rotated
    emission rides the completion matmuls' output ordering, so it costs
    nothing; chaining two such filters (x-scan then y-scan) runs BOTH in the
    fast lanes-contraction form with no relayout copy in between and
    restores the natural axis order — inter-filter rotation chaining, the
    pipeline-level analog of what :func:`apply_filter_fused` does internally
    for multi-dimension filters. Used by the DoG app, whose reference
    pipeline interleaves single-dimension integral stages with pointwise
    differencing (``apps/DoG/diff_gauss.cpp:72-110``).

    ``rot_axes=1`` emits in place (scanned axis stays last).

    ``epilogue(out, *eaux)`` — optional elementwise combine fused into the
    pass's emit; eaux arrays must be given in the ROTATED output layout.

    ``stencil`` — optional shifted-tap consumer fused into the pass
    (``{"taps": [(offset, coeff), ...], "start": "zero"|"clamp",
    "end": "zero"|"clamp"}``; taps may be a per-slice list-of-lists over
    the leading axis). Offsets address the SCANNED axis of the filter
    output and run as XLA shifts on the pass output (the analog of the
    reference's ``compute_at`` of a stencil consumer,
    ``lib/recfilter.cpp:507-573``). The stencil applies BEFORE any
    ``epilogue``.
    """
    groups = spec.scans_by_axis()
    if len(groups) != 1:
        raise ValueError(
            "apply_filter_rotated requires a single scanned dimension; "
            f"{spec.name} scans {len(groups)}"
        )
    if not 1 <= rot_axes <= min(x.ndim, 6):
        raise ValueError(f"rot_axes {rot_axes} out of range for ndim {x.ndim}")
    (axis,) = groups
    ids = groups[axis]
    scans = [spec.scans[i] for i in ids]
    dtype = jnp.dtype(spec.dtype)

    def emit_rotated(y):  # fallback paths: pay the transpose explicitly
        return y if rot_axes == 1 else jnp.moveaxis(y, -1, -rot_axes)

    if jnp.issubdtype(dtype, jnp.integer):
        from . import scan_core

        for s in scans:
            x = scan_core.apply_scan(
                x, x.ndim - 1, s.causal, s.feedfwd, s.feedback, spec.border
            )
        y = emit_rotated(x)
        if stencil is not None:
            y = _stencil_fallback(y, stencil, -rot_axes)
        if epilogue is not None:
            y = epilogue(y, *eaux)
        return y

    if dtype == jnp.bfloat16:
        cdt = jnp.bfloat16
        matmul_dtype = jnp.bfloat16
    else:
        cdt = jnp.float32 if dtype == jnp.float16 else dtype
    x = x.astype(cdt)

    if x.shape[-1] != spec.dims[axis].extent:
        raise ValueError(
            f"last axis has {x.shape[-1]} elements, spec dim "
            f"{spec.dims[axis].name} expects {spec.dims[axis].extent}"
        )
    tiles = spec.tile_widths or (0,) * spec.ndim
    T = tiles[axis] or tile_default
    if x.ndim == 1:  # rot_axes is necessarily 1; the plain pass is the fast form
        if stencil is not None:
            y1 = fused_dim_pass(
                x, 0, scans, T, spec.border, compute_dtype=cdt,
                matmul_dtype=matmul_dtype, matmul_precision=matmul_precision,
            )
            y1 = _stencil_fallback(y1, stencil, -1)
            if epilogue is not None:
                y1 = epilogue(y1, *eaux)
            return y1.astype(dtype)
        return fused_dim_pass(
            x, 0, scans, T, spec.border, compute_dtype=cdt,
            matmul_dtype=matmul_dtype, matmul_precision=matmul_precision,
            epilogue=epilogue, eaux=eaux,
        ).astype(dtype)
    clamp = spec.border == BorderMode.CLAMP
    kmax = max(s.order for s in scans)
    plan = _plan_tiles(x.shape[-1], T, kmax, clamp)
    if plan is None:
        from . import scan_core

        # f32 carries even in bf16-storage mode (scan_core contract)
        xs = x if x.dtype == jnp.float32 else x.astype(jnp.float32)
        for s in scans:
            xs = scan_core.apply_scan(
                xs, x.ndim - 1, s.causal, s.feedfwd, s.feedback, spec.border
            )
        y = emit_rotated(xs)
        if stencil is not None:
            y = _stencil_fallback(y, stencil, -rot_axes)
        if epilogue is not None:
            y = epilogue(y, *(jnp.asarray(a).astype(y.dtype) for a in eaux))
        return y.astype(dtype)

    y = _last_axis_pass_t(
        x, scans, plan, clamp, cdt, matmul_dtype,
        rot_axes=rot_axes, matmul_precision=matmul_precision,
        epilogue=epilogue, eaux=eaux, stencil=stencil,
    )
    return y.astype(dtype)
