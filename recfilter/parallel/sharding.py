"""Multi-chip execution: mesh planning and carry-exchange sequence parallelism.

The reference is single-device (no NCCL/MPI anywhere; SURVEY §2.6) — this
module is the capability it lacks:

  * **data parallelism** — lines/channels/batch sharded over a mesh axis;
    scans never cross lines, so no communication at all.
  * **sequence parallelism over the scan dimension** — the overlapped-tiling
    algebra applied at pod scale: each device runs its local blocked scans
    with zero incoming state, devices exchange only their order-k boundary
    carries (k·lines floats — tiny vs the data), and a rank-k correction
    completes the local segments. This is ``lib/split.cpp``'s tile algebra
    with "tile" = "device segment" and the carry recurrence solved from an
    ``all_gather`` of carries (one NCCL collective) instead of a serial
    loop. All of a dimension's scans share ONE exchange: the cross-scan
    couplings (dimfuse's G/H identities) are folded into a combined
    device-level solve matrix, so an m-scan dimension costs one collective,
    not m.

Everything is built on ``shard_map`` over a ``jax.sharding.Mesh`` so the same
code runs on the GPUs of one host (all joined to all by NVLink, so the mesh
follows the algorithm alone) or on the 8-virtual-device CPU mesh used in
tests.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from .. import coeffs
from ..planner import Plan
from ..spec import BorderMode, FilterSpec


def make_mesh(
    shape: Sequence[int], axis_names: Sequence[str], devices=None
) -> Mesh:
    """Build a Mesh from the first prod(shape) available devices."""
    devices = devices if devices is not None else jax.devices()
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError(
            f"mesh shape {tuple(shape)} needs {n} devices, have {len(devices)}"
        )
    arr = np.array(devices[:n]).reshape(tuple(shape))
    return Mesh(arr, tuple(axis_names))


def _local_apply_dim(x, spec, axis, scan_ids, tile_width, backend,
                     border: Optional[str] = None,
                     matmul_precision: str = "highest"):
    """Device-local dimension pass with the chosen backend.

    ``border`` overrides ``spec.border`` — the sequence-sharded clamp path
    runs zero-border locals on every device and injects the clamp response
    as a rank-1 correction on the edge device only.

    ``matmul_precision`` threads the Plan's precision mode into the local
    einsum passes, so device-local work runs the SAME shipping
    executor grade as the single-chip path (VERDICT r3 #2 — one execution
    path however the filter is launched, ``lib/recfilter.cpp:932-1016``).
    """
    from .. import dimfuse, scan_core

    border = spec.border if border is None else border
    if backend == "einsum" and tile_width:
        return dimfuse.fused_dim_pass(
            x, axis, [spec.scans[i] for i in scan_ids], tile_width, border,
            matmul_precision=matmul_precision,
        )
    for i in scan_ids:
        s = spec.scans[i]
        x = scan_core.apply_scan(
            x, s.axis, s.causal, s.feedfwd, s.feedback, border
        )
    return x


# ---------------------------------------------------------------------------
# Combined per-dimension exchange: one collective for all of a dim's scans
# ---------------------------------------------------------------------------


def _apply_scan_cols(M: np.ndarray, scan, border: str) -> np.ndarray:
    """Apply ``scan`` down the columns of a (seg, q) block — host-side, used
    to evolve segment-level correction columns. The clamped scan is the
    linear map Bf, so clamped evolution of a correction column is just the
    clamped scan applied to it."""
    from .. import scan_core

    return scan_core.oracle_apply_scan(
        M, 0, scan.causal, scan.feedfwd, list(scan.feedback), border
    )


def _clamp_col(scan, eff: int, total: int = 0) -> np.ndarray:
    """v = (Bf − B)·e_edge: the segment-level clamp response column.

    Every clamp contribution is proportional to the edge sample (row 0 of
    the impulse matrix has a single nonzero column), so Bf − B = v·e_edgeᵀ
    is rank-1 and the clamped local pass equals the zero-border local pass
    plus ``v ⊗ x[edge]`` — the device-level form of the first/last-tile
    matrix variants in ``lib/split.cpp:625-654``.

    ``eff`` is the effective (unpadded) length; with ``total > eff`` the
    column zero-extends over the padded slots of a non-dividing segment.
    """
    from .. import scan_core

    e = np.zeros((eff, 1), dtype=np.float64)
    e[0 if scan.causal else eff - 1, 0] = 1.0
    vc = _apply_scan_cols(e, scan, BorderMode.CLAMP)
    vz = _apply_scan_cols(e, scan, BorderMode.ZERO)
    v = (vc - vz)[:, 0]
    if total > eff:
        v = np.concatenate([v, np.zeros(total - eff)])
    return v


def _evolve_cols(M: np.ndarray, scan, clamp_edge: bool, eff: int):
    """Evolve correction columns through one scan, clamped at the effective
    edge when ``clamp_edge``: Bf·M = B·M + v ⊗ M[edge] (rank-1 identity)."""
    out = _apply_scan_cols(M, scan, BorderMode.ZERO)
    if clamp_edge:
        v = _clamp_col(scan, eff, total=M.shape[0])
        edge = 0 if scan.causal else eff - 1
        out = out + v[:, None] * M[edge]
    return out


def _segment_exchange_mats(scans, seg: int, D: int, clamp: bool = False,
                           pad: int = 0, build_cm: bool = True):
    """Device-level matrices for the carry exchange — the dimfuse algebra
    with "tile" = "device segment", built column-wise (never a seg×seg
    matrix): per-scan natural correction columns Rhat (seg, k_i) evolved
    through the later scans, cross-scan couplings H, and per-scan chain
    matrices.

    With ``clamp``, the globally-first/last devices get distinct variants:
    correction columns evolve through the CLAMPED scan on the scan's edge
    device (Bf = B + v·e₀ᵀ, so the clamped evolution carries exactly the
    edge response of the incoming corrections). ``pad`` is the zero padding
    on the globally-last device (non-dividing extents); padded slots behave
    exactly like zero-input samples, so only the clamp edge position moves.

    Returns ``(orders, H, CMs, Rcats)``: ``H[i][j]`` is (1|D, k_i, k_j);
    ``CMs[i]`` is the (D·k_i)² chain matrix; ``Rcats`` is stacked
    (1|3, seg, ΣK) — [first, interior, last] under clamp.
    """
    from .. import dimfuse

    m = len(scans)
    orders = [s.order for s in scans]

    def build(dev):
        # dev: 0 (globally first), None (interior), D-1 (globally last)
        eff = seg - pad if dev == D - 1 else seg
        cols = [None] * m  # RN_i evolved through scans applied so far
        H = [[None] * m for _ in range(m)]
        for i, s in enumerate(scans):
            k = s.order
            R = coeffs.state_matrix(s.feedback, seg)
            Jk = coeffs.antidiagonal(k)
            RN = R @ Jk if s.causal else R[::-1, :]
            edge = (dev == 0) if s.causal else (dev is not None and dev == D - 1)

            def proj(M):
                # Pad projector (dimfuse's Z at device level): zero the
                # padded slots between scans so a later scan sees the
                # zero-border contract there, matching the runtime zeroing
                # in _seq_local_cascade.
                if dev == D - 1 and pad:
                    M = M.copy()
                    M[eff:, :] = 0.0
                return M

            for j in range(i):
                evolved = proj(_evolve_cols(cols[j], s, clamp and edge, eff))
                if s.causal:
                    H[i][j] = evolved[seg - k :, :]  # (k_i, k_j)
                else:
                    H[i][j] = evolved[:k, :]
                cols[j] = evolved
            cols[i] = proj(RN)
        Rcat = np.concatenate(cols, axis=1)  # (seg, ΣK)
        return H, Rcat

    # The per-scan (D·k)² chain matrices feed the dense combined solve
    # only; the Kogge–Stone routes (ring, and the in-chip hierarchical
    # chain past ΣK=8) solve via k×k transfer matrices instead and skip
    # this quadratic-in-D host build.
    CMs = ([dimfuse._chain_matrix(s, seg, D) for s in scans]
           if build_cm else None)

    if not clamp and not pad:
        H1, Rcat = build(None)
        H = [
            [(H1[i][j][None] if j < i else None) for j in range(m)]
            for i in range(m)
        ]
        return orders, H, CMs, Rcat[None]

    built = {0: build(0), None: build(None), D - 1: build(D - 1)}

    def h_stack(i, j):
        return np.stack(
            [built[d if d in (0, D - 1) else None][0][i][j] for d in range(D)]
        )

    H = [
        [(h_stack(i, j) if j < i else None) for j in range(m)]
        for i in range(m)
    ]
    Rcats = np.stack(
        [built[0][1], built[None][1], built[D - 1][1]]
    )  # (3, seg, ΣK): [first, interior, last]
    return orders, H, CMs, Rcats


def _combined_solve(orders, H, CMs, D: int) -> np.ndarray:
    """Fold the per-scan chains + H couplings into one (D·ΣK)² matrix."""
    from .. import dimfuse

    class _Shim:
        pass

    shim = _Shim()
    shim.orders = orders
    shim.H = H
    shim.CM = CMs
    return dimfuse.combined_solve_matrix(shim, D)


def _seq_local_cascade(y, axis, spec, scan_ids, tile_width, D, name, backend,
                       pad: int = 0,
                       matmul_precision: str = "highest"):
    """Zero-state local cascade on each device, scan by scan, collecting the
    natural boundary carries. Clamped borders run zero-border locals plus
    the rank-1 edge correction ``v ⊗ y_pre[edge]`` on the scan's edge device
    (see :func:`_clamp_col`); the carries then match the clamped G-tails the
    exchange matrices expect. ``pad`` is the zero padding on the last device
    (the anticausal clamp edge sits before it). Returns (y, ccat)."""
    scans = [spec.scans[i] for i in scan_ids]
    seg = y.shape[axis]
    clamp = spec.border == BorderMode.CLAMP
    d = jax.lax.axis_index(name)

    cs = []
    for idx, s in zip(scan_ids, scans):
        if clamp:
            edge_pos = 0 if s.causal else seg - 1 - pad
            x_edge = jax.lax.slice_in_dim(y, edge_pos, edge_pos + 1, axis=axis)
        y = _local_apply_dim(y, spec, axis, [idx], tile_width, backend,
                             border=BorderMode.ZERO,
                             matmul_precision=matmul_precision)
        if clamp:
            v = _clamp_col(s, seg if s.causal else seg - pad, total=seg)
            vshape = [1] * y.ndim
            vshape[axis] = seg
            vj = jnp.asarray(v, dtype=y.dtype).reshape(vshape)
            edge_dev = 0 if s.causal else D - 1
            mask = (d == edge_dev).astype(y.dtype)
            y = y + mask * vj * x_edge
        if pad:
            # Pad projector: a scan propagates real values into the padded
            # slots of the last device; zero them so the next scan sees the
            # zero-border contract there (matches _segment_exchange_mats).
            vshape = [1] * y.ndim
            vshape[axis] = seg
            keep = np.ones(seg)
            keep[seg - pad :] = 0.0
            keepj = jnp.asarray(keep, dtype=y.dtype).reshape(vshape)
            last = (d == D - 1).astype(y.dtype)
            y = y * (1.0 - last) + y * last * keepj
        ym = jnp.moveaxis(y, axis, -1)
        k = s.order
        c = ym[..., seg - k :] if s.causal else ym[..., :k]
        cs.append(c)
    return y, jnp.concatenate(cs, axis=-1)  # (..., S) natural, scan-ordered


def _select_rcat(Rcats: np.ndarray, D: int, d, dtype):
    """Pick this device's final-correction columns: (1|3, seg, ΣK) stacked as
    [first, interior, last] under clamp, a single shared block otherwise."""
    R = jnp.asarray(Rcats, dtype=dtype)
    if R.shape[0] == 1:
        return R[0]
    sel = jnp.where(d == 0, 0, jnp.where(d == D - 1, 2, 1))
    return jax.lax.dynamic_index_in_dim(R, sel, axis=0, keepdims=False)


def _seq_solve_gather(y, axis, spec, scan_ids, tile_width, D, name,
                      backend, pad: int = 0,
                      matmul_precision: str = "highest"):
    """Local cascade + one ``all_gather`` + combined solve; returns
    ``(y_local, Rsel, N)`` with the correction NOT yet applied (N is the
    carry-sized solved state, (..., S) with ``axis`` moved last) — callers
    either inject immediately (:func:`_apply_seq_corr`) or defer the
    injection past later local dimension passes (exchange/compute
    overlap, see ``sharded_apply_filter``)."""
    scans = [spec.scans[i] for i in scan_ids]
    seg = y.shape[axis]
    clamp = spec.border == BorderMode.CLAMP
    orders, H, CMs, Rcats = _segment_exchange_mats(scans, seg, D, clamp, pad)
    CMfull = _combined_solve(orders, H, CMs, D)
    S = int(sum(orders))

    y, ccat = _seq_local_cascade(y, axis, spec, scan_ids, tile_width, D,
                                 name, backend, pad,
                                 matmul_precision=matmul_precision)

    allc = jax.lax.all_gather(ccat, name, axis=0)  # (D, ..., S)
    d = jax.lax.axis_index(name)
    CM = jnp.asarray(CMfull, dtype=y.dtype)  # (D·S, D·S)
    # this device's row block maps ALL devices' raw carries to its N vector
    rows = jax.lax.dynamic_slice_in_dim(CM, d * S, S, axis=0)  # (S, D·S)
    flat = jnp.moveaxis(allc, 0, -2)  # (..., D, S)
    flat = flat.reshape(flat.shape[:-2] + (D * S,))
    # carry solves at true f32: an f32 dot with no precision runs in TF32 on
    # the GPU, and the error does not decay at segment boundaries for
    # integrators
    prec = jax.lax.Precision.HIGHEST
    N = jnp.einsum("sz,...z->...s", rows, flat, precision=prec)
    Rsel = _select_rcat(Rcats, D, d, y.dtype)
    return y, Rsel, N


def _apply_seq_corr(y, axis, Rsel, N):
    """Inject a solved carry correction: y += Rsel·N along ``axis``."""
    corr = jnp.einsum("tk,...k->...t", Rsel, N,
                      precision=jax.lax.Precision.HIGHEST)
    ym = jnp.moveaxis(y, axis, -1) + corr
    return jnp.moveaxis(ym, -1, axis)


def _seq_dim_pass_combined(y, axis, spec, scan_ids, tile_width, D, name,
                           backend, pad: int = 0):
    """All of one dimension's scans with a SINGLE carry exchange.

    Each device runs the zero-state local cascade scan by scan, recording
    every scan's natural boundary carry along the way; one ``all_gather``
    moves the stacked carries; the combined device-level solve and a single
    rank-ΣK correction complete all scans at once.
    """
    y, Rsel, N = _seq_solve_gather(y, axis, spec, scan_ids, tile_width, D,
                                   name, backend, pad)
    return _apply_seq_corr(y, axis, Rsel, N)


def _ks_chain(b, scan, seg: int, D: int, name: str, prec):
    """Distributed carry-chain solve via log₂(D) ``ppermute`` doubling steps
    (Kogge–Stone prefix over the mesh axis).

    ``b`` is this device's natural local tail (..., k). The chain weight
    ``W^{2^j}`` for each doubling step is a trace-time constant — the hop
    length is static — so only the k-vector states move over the wire:
    O(k·lines·log D) total traffic per device vs the all_gather's
    O(D·ΣK·lines). Devices outside a step's source range receive ppermute's
    zero fill, which is exactly the zero-state boundary condition.
    Returns the natural incoming vector N (..., k) consumed by RN.
    """
    k = scan.order
    W = coeffs.tail_weight_matrix(scan.feedback, seg)
    Jk = np.asarray(coeffs.antidiagonal(k))

    if scan.causal:
        # u_d = Jk b_d ; inclusive s_d = Σ_{i≤d} W^{d-i} u_i ; N_d = Jk s_{d-1}
        u = jnp.einsum("ij,...j->...i", jnp.asarray(Jk, b.dtype), b,
                       precision=prec)
        down = False  # prefix flows 0 → D-1
    else:
        # natural order IS W-order; inclusive from the right; N_d = s_{d+1}
        u = b
        down = True  # prefix flows D-1 → 0

    def perm_for(shift):
        if down:
            return [(d, d - shift) for d in range(shift, D)]
        return [(d, d + shift) for d in range(D - shift)]

    s = u
    shift = 1
    Wp = W.copy()
    while shift < D:
        recv = jax.lax.ppermute(s, name, perm_for(shift))
        s = s + jnp.einsum("ij,...j->...i", jnp.asarray(Wp, b.dtype), recv,
                           precision=prec)
        shift *= 2
        Wp = Wp @ Wp
    s_prev = jax.lax.ppermute(s, name, perm_for(1))  # exclusive shift

    if scan.causal:
        return jnp.einsum("ij,...j->...i", jnp.asarray(Jk, b.dtype), s_prev,
                          precision=prec)
    return s_prev


def _seq_solve_ring(y, axis, spec, scan_ids, tile_width, D, name,
                    backend, pad: int = 0,
                    matmul_precision: str = "highest"):
    """Local cascade + Kogge–Stone ``ppermute`` chains; returns
    ``(y_local, Rsel, N)`` with the correction not yet applied (see
    :func:`_seq_solve_gather`)."""
    scans = [spec.scans[i] for i in scan_ids]
    seg = y.shape[axis]
    clamp = spec.border == BorderMode.CLAMP
    orders, H, CMs, Rcats = _segment_exchange_mats(scans, seg, D, clamp, pad,
                                                   build_cm=False)
    offs = np.cumsum([0] + orders)

    y, ccat = _seq_local_cascade(y, axis, spec, scan_ids, tile_width, D,
                                 name, backend, pad,
                                 matmul_precision=matmul_precision)
    d = jax.lax.axis_index(name)
    prec = jax.lax.Precision.HIGHEST

    Ns = []
    for i, s in enumerate(scans):
        b = ccat[..., offs[i] : offs[i + 1]]
        for j in range(i):
            Hs = jnp.asarray(H[i][j], dtype=y.dtype)  # (1|D, k_i, k_j)
            Hsel = (
                Hs[0] if Hs.shape[0] == 1
                else jax.lax.dynamic_index_in_dim(Hs, d, 0, keepdims=False)
            )
            b = b + jnp.einsum("ok,...k->...o", Hsel, Ns[j], precision=prec)
        Ns.append(_ks_chain(b, s, seg, D, name, prec))
    Ncat = jnp.concatenate(Ns, axis=-1)
    Rsel = _select_rcat(Rcats, D, d, y.dtype)
    return y, Rsel, Ncat


def _seq_gdev(scans, seg: int) -> np.ndarray:
    """(ΣK, seg): every scan's natural device-boundary carry rows of the
    zero-state local cascade, composed back onto the INPUT — the
    device-level twin of dimfuse's stacked-G pass-A rows (G_i =
    Sel_i·B_i⋯B_1). Row r of scan i's block reads the value the cascade's
    intermediate y_i would have at the boundary slot, so ``Gdev·x`` equals
    :func:`_seq_local_cascade`'s ccat WITHOUT materializing any
    intermediate — one skinny einsum on the raw input instead.

    Built by applying the TRANSPOSED scans (operator transpose of a
    zero-border scan = the same taps run in the opposite direction) to
    boundary indicator columns, innermost scan last. Zero border only —
    the clamp variants keep the cascade path."""
    from .. import scan_core

    rows = []
    for i, s in enumerate(scans):
        k = s.order
        E = np.zeros((seg, k), np.float64)
        if s.causal:
            E[seg - k:, :] = np.eye(k)
        else:
            E[:k, :] = np.eye(k)
        M = E
        for j in range(i, -1, -1):
            sj = scans[j]
            M = scan_core.oracle_apply_scan(
                M, 0, not sj.causal, sj.feedfwd, list(sj.feedback),
                BorderMode.ZERO)
        rows.append(np.asarray(M).T)  # (k_i, seg)
    return np.concatenate(rows, axis=0)


def _seq_fused2d(y, spec, groups, shard_of, tiles, exchange, mp: str, pads):
    """Sequence-sharded local work on the SHIPPING executor, or None when a
    gate fails.

    Structure (all operators linear; the two dims' zero-state locals are
    tensor-product operators and commute):

        true = L2(L1(x) + R·N(x))  =  fused2d_local(x) + R·L2(N(x))

    so each device runs the COMPLETE shipping executor on its shard
    (``dimfuse.apply_filter_fused``), the sharded dim's raw carries come
    from ONE skinny ``Gdev·x`` einsum on the input (:func:`_seq_gdev`), the
    existing gather/ring exchange solves them, the carry-sized N runs the
    unsharded dim's local pass (the standard deferral), and one rank-ΣK
    injection closes the device. Reference doctrine: one execution path
    however launched (``lib/recfilter.cpp:932-1016``).

    Gates: 2-D float filter, scans on the trailing two axes, exactly ONE
    of them sharded, zero border, no pad on the sharded axis (non-dividing
    extents keep the cascade path whose pad projector is exact)."""
    from .. import dimfuse

    if spec.border != BorderMode.ZERO or y.dtype != jnp.float32:
        return None
    if len(groups) != 2:
        return None
    axes = [ax for ax, _ in groups]
    nd = y.ndim
    if sorted(axes) != [nd - 2, nd - 1]:
        return None
    sharded = [(gi, ax) for gi, (ax, _) in enumerate(groups)
               if shard_of.get(ax, (None, 1))[1] > 1]
    if len(sharded) != 1:
        return None
    gi_sh, ax_sh = sharded[0]
    if pads.get(ax_sh, 0):
        return None
    name, D = shard_of[ax_sh]
    ids_sh = groups[gi_sh][1]
    scans_sh = [spec.scans[i] for i in ids_sh]
    seg = y.shape[ax_sh]
    if min(s.order for s in scans_sh) >= seg:
        return None
    (ax_loc, ids_loc), = [g for g in groups if g[0] != ax_sh]

    use_ring = exchange == "ring" or (exchange == "auto" and D > 8)
    orders, H, CMs, Rcats = _segment_exchange_mats(
        scans_sh, seg, D, clamp=False, pad=0, build_cm=not use_ring)
    S = int(sum(orders))
    hi = jax.lax.Precision.HIGHEST
    d = jax.lax.axis_index(name)

    def solve_ccat(ccat):
        """Device-level carry exchange: natural tails (..., S) → this
        device's incoming natural vectors (..., S)."""
        if use_ring:
            offs = np.cumsum([0] + orders)
            Ns = []
            for i, s in enumerate(scans_sh):
                b = ccat[..., offs[i]:offs[i + 1]]
                for j in range(i):
                    Hs = jnp.asarray(H[i][j], jnp.float32)
                    b = b + jnp.einsum("ok,...k->...o", Hs[0], Ns[j],
                                       precision=hi)
                Ns.append(_ks_chain(b, s, seg, D, name, hi))
            return jnp.concatenate(Ns, axis=-1)
        CMfull = _combined_solve(orders, H, CMs, D)
        allc = jax.lax.all_gather(ccat, name, axis=0)  # (D, ..., S)
        CM = jnp.asarray(CMfull, jnp.float32)
        rows_blk = jax.lax.dynamic_slice_in_dim(CM, d * S, S, axis=0)
        flat = jnp.moveaxis(allc, 0, -2)
        flat = flat.reshape(flat.shape[:-2] + (D * S,))
        return jnp.einsum("sz,...z->...s", rows_blk, flat, precision=hi)

    # Raw device carries straight from the input (one skinny einsum), full
    # shipping executor zero-state, deferred injection.
    Gdev = _seq_gdev(scans_sh, seg)
    ym = jnp.moveaxis(y, ax_sh, -1)
    Gp = dimfuse.pad_rows8(Gdev[None])[0]
    ccat = jnp.einsum("st,...t->...s", jnp.asarray(Gp, jnp.float32), ym,
                      preferred_element_type=jnp.float32,
                      precision=hi)[..., :S]
    N = solve_ccat(ccat)

    # (the collective above is already in flight — XLA's scheduler
    # overlaps it with the executor's compute)
    y_loc = dimfuse.apply_filter_fused(spec, y, matmul_precision=mp)

    # Deferral: the carry-sized N runs the unsharded dim's local pass
    # (its layout dropped the sharded axis, so the axis index shifts).
    nax = ax_loc if ax_loc < ax_sh else ax_loc - 1
    T = tiles[ax_loc] or 32
    N = _local_apply_dim(N, spec, nax, ids_loc, min(T, N.shape[nax]),
                         "einsum", matmul_precision=mp)
    Rsel = _select_rcat(Rcats, D, d, y_loc.dtype)
    return _apply_seq_corr(y_loc.astype(jnp.float32), ax_sh, Rsel, N)


def _seq_dim_pass_ring(y, axis, spec, scan_ids, tile_width, D, name,
                       backend, pad: int = 0):
    """All of one dimension's scans with ``ppermute`` carry exchanges.

    The pod-scale alternative to :func:`_seq_dim_pass_combined`: per scan,
    a Kogge–Stone doubling chain moves only order-k states between
    neighbors-at-distance-2^j (log₂ D messages of O(k·lines) each) instead
    of all-gathering every device's carries. Cross-scan H couplings and the
    final Rcat correction are identical; each scan's chain consumes the
    previous scans' solved states locally.
    """
    y, Rsel, Ncat = _seq_solve_ring(y, axis, spec, scan_ids, tile_width, D,
                                    name, backend, pad)
    return _apply_seq_corr(y, axis, Rsel, Ncat)


def sharded_apply_filter(
    spec: FilterSpec,
    plan: Plan,
    mesh: Mesh,
    x,
    data_axis: Optional[int] = None,
    seq_axis: Optional[int] = None,
    data_name: str = "data",
    seq_name: str = "seq",
    backend: Optional[str] = None,
    exchange: str = "auto",
    seq2_axis: Optional[int] = None,
    seq2_name: str = "seq2",
):
    """Run the filter on a mesh: lines over ``data_name``, the scan dimension
    over ``seq_name`` (either may be absent).

    ``seq2_axis`` shards a SECOND scan dimension over ``seq2_name`` — the
    device-level form of the 2-D overlapped tiling (SURVEY §2.6's pod
    mapping): each dimension pass runs its own carry exchange over its own
    mesh axis, and the second dimension's exchange consumes the first's
    completed values, so the cross-dimension coupling ("corner" terms) is
    exact by sequential composition — the same H-algebra composition the
    tile-level engine uses, one level up.

    ``data_axis``/``seq_axis`` are array-axis indices into ``x``. Extents
    need not divide the mesh axis: non-dividing axes are zero-padded (exact
    — padded slots behave as zero-input samples in this algebra) and the
    result is sliced back.

    ``exchange`` picks the carry-exchange strategy for sharded scan
    dimensions: ``"gather"`` (one ``all_gather`` + combined solve — minimal
    latency at small D), ``"ring"`` (Kogge–Stone ``ppermute`` doubling —
    O(k·log D) traffic, the pod-scale path), or ``"auto"`` (ring when the
    axis has more than 8 devices).

    Device-local work runs the SHIPPING executor at the Plan's precision
    mode: with no sharded scan dimension the whole local filter goes
    through ``dimfuse.apply_filter_fused``, and sequence-sharded passes
    thread ``plan.matmul_precision`` into their local einsum passes —
    one execution path however the filter is launched, matching
    ``lib/recfilter.cpp:932-1016`` (VERDICT r3 #2). ``backend=None``
    resolves from the Plan.
    """
    from .. import planner as _planner

    if backend is None:
        backend = _planner.resolve_backend(spec, plan, jax.default_backend())
    mp = plan.matmul_precision
    scanned = {s.axis for s in spec.scans}
    int_dtype = jnp.issubdtype(jnp.dtype(spec.dtype), jnp.integer)
    if int_dtype and (seq_axis in scanned or seq2_axis in scanned):
        # The carry-exchange correction is float math; integer specs are
        # exact only through the scan_core path. Shard lines/batch instead.
        raise NotImplementedError(
            "sharding a scanned dimension of an integer-dtype filter is not "
            "supported (the carry correction is float); shard over "
            "non-scanned (line/batch) axes, which run the exact integer path"
        )

    ndim = x.ndim
    pspec = [None] * ndim
    shard_of = {}  # array axis -> (mesh axis name, size)
    if data_axis is not None:
        pspec[data_axis] = data_name
        shard_of[data_axis] = (data_name, mesh.shape[data_name])
    if seq_axis is not None:
        pspec[seq_axis] = seq_name
        shard_of[seq_axis] = (seq_name, mesh.shape[seq_name])
    if seq2_axis is not None:
        if seq2_axis in shard_of:
            raise ValueError("seq2_axis duplicates another sharded axis")
        pspec[seq2_axis] = seq2_name
        shard_of[seq2_axis] = (seq2_name, mesh.shape[seq2_name])
    pspec = P(*pspec)

    if exchange not in ("auto", "gather", "ring"):
        raise ValueError(f"unknown exchange {exchange!r}")

    # Non-dividing extents: zero-pad sharded axes to a multiple of their
    # mesh-axis size. Padded slots are zero-input samples — exact for this
    # algebra (the clamp edge relocation is handled inside the seq pass).
    pads = {}  # array axis -> pad amount on the last device
    orig_shape = x.shape
    padspec = [(0, 0)] * ndim
    for ax, (nm, D) in shard_of.items():
        rem = x.shape[ax] % D
        if rem:
            pads[ax] = D - rem
            padspec[ax] = (0, D - rem)
    if pads:
        for ax, p in pads.items():
            seg_after = (x.shape[ax] + p) // shard_of[ax][1]
            if ax in scanned and p >= seg_after:
                # The exchange algebra models padding on the globally-last
                # device only; entirely-padded devices are supported for
                # non-scanned (line/batch) axes.
                raise ValueError(
                    f"scan axis {ax} extent {x.shape[ax]} leaves whole "
                    f"devices empty on a {shard_of[ax][1]}-way mesh axis"
                )
        x = jnp.pad(jnp.asarray(x), padspec)

    tiles = spec.tile_widths or (0,) * spec.ndim

    if int_dtype:
        # Exact integer locals (data/batch sharding only) through the
        # tiled limb executor where provable, lax.scan otherwise —
        # the same route as the single-chip path.
        from .. import dimfuse

        def local_int(xl):
            return dimfuse.apply_filter_fused(spec, xl)

        fn = jax.shard_map(
            local_int, mesh=mesh, in_specs=(pspec,), out_specs=pspec,
            check_vma=False,
        )
        out = fn(x)
        if pads:
            out = out[tuple(slice(0, n) for n in orig_shape)]
        return out

    seq_sharded = any(
        shard_of.get(ax, (None, 1))[1] > 1 for ax in scanned
    )

    if not seq_sharded and backend == "einsum":
        # No scanned axis crosses devices: every device runs the COMPLETE
        # shipping executor on its shard — identical route and numeric
        # grade to the single-device path.
        from .. import dimfuse

        def local_full(xl):
            return dimfuse.apply_filter_fused(spec, xl, matmul_precision=mp)

        fn = jax.shard_map(
            local_full, mesh=mesh, in_specs=(pspec,), out_specs=pspec,
            check_vma=False,
        )
        out = fn(x)
        if pads:
            out = out[tuple(slice(0, n) for n in orig_shape)]
        return out

    def local_fn(xl):
        y = xl.astype(jnp.float32)
        groups = list(spec.scans_by_axis().items())
        if backend == "einsum":
            # 2-D filters with ONE sharded scan dim run their ENTIRE local
            # work through the shipping executor; carries come from a
            # skinny Gdev einsum on the input and one deferred injection
            # closes the device.
            fast = _seq_fused2d(y, spec, groups, shard_of, tiles,
                                exchange, mp, pads)
            if fast is not None:
                return fast.astype(jnp.dtype(spec.dtype))
        seq_pos = [gi for gi, (ax, _) in enumerate(groups)
                   if shard_of.get(ax, (None, 1))[1] > 1]
        # Exchange/compute overlap: with ONE sharded scan dimension
        # followed by local dimension passes, the carry collective's
        # result is not needed until the very end — every operator is
        # linear, so the later local passes apply to the UNCORRECTED
        # array while the collective is in flight, the solved carry state
        # N (carry-sized: S/seg of the data) runs through the same local
        # passes, and one injection closes the pipeline. XLA's
        # latency-hiding scheduler overlaps the issued all_gather/ppermute
        # with the local passes' compute — the SURVEY §5.7 blueprint
        # ("overlap carry exchange with the next dimension's intra pass").
        # Latency model per exchange: gather moves D·S·lines floats in one
        # log-depth collective; ring moves S·lines per hop × log₂D hops;
        # overlap hides up to a full local pass (~ms) of either.
        defer_ok = len(seq_pos) == 1 and seq_pos[0] < len(groups) - 1
        pending = None  # (axis, Rsel, N) — deferred carry injection
        for gi, (ax, ids) in enumerate(groups):
            T = tiles[ax] or 32
            T = min(T, y.shape[ax])
            name, D = shard_of.get(ax, (None, 1))
            if D > 1:
                # Scanned axis is sharded: one combined carry exchange
                # completes ALL of the dimension's scans (the dimfuse
                # algebra at device level).
                use_ring = exchange == "ring" or (
                    exchange == "auto" and D > 8
                )
                solve = _seq_solve_ring if use_ring else _seq_solve_gather
                y, Rsel, N = solve(
                    y, ax, spec, ids, T, D, name, backend,
                    pad=pads.get(ax, 0), matmul_precision=mp,
                )
                if defer_ok:
                    pending = (ax, Rsel, N)
                else:
                    y = _apply_seq_corr(y, ax, Rsel, N)
            else:
                y = _local_apply_dim(y, spec, ax, ids, T, backend,
                                     matmul_precision=mp)
                if pending is not None:
                    # run the same (linear) pass over the carry-sized N —
                    # its layout dropped the seq axis (moved last), so
                    # later axes shift down by one
                    pax, Rsel, N = pending
                    nax = ax if ax < pax else ax - 1
                    N = _local_apply_dim(
                        N, spec, nax, ids, min(T, N.shape[nax]), backend,
                        matmul_precision=mp,
                    )
                    pending = (pax, Rsel, N)
        if pending is not None:
            pax, Rsel, N = pending
            y = _apply_seq_corr(y, pax, Rsel, N)
        return y.astype(jnp.dtype(spec.dtype))

    fn = jax.shard_map(
        local_fn, mesh=mesh, in_specs=(pspec,), out_specs=pspec,
        check_vma=False,
    )
    out = fn(x)
    if pads:
        out = out[tuple(slice(0, n) for n in orig_shape)]
    return out


def make_sharded_filter(
    spec: FilterSpec,
    plan: Plan,
    mesh: Mesh,
    data_axis: Optional[int] = None,
    seq_axis: Optional[int] = None,
    backend: Optional[str] = None,
    exchange: str = "auto",
    seq2_axis: Optional[int] = None,
):
    """Jitted closure over (mesh, spec, plan) taking the global array."""

    @jax.jit
    def fn(x):
        return sharded_apply_filter(
            spec, plan, mesh, x,
            data_axis=data_axis, seq_axis=seq_axis, backend=backend,
            exchange=exchange, seq2_axis=seq2_axis,
        )

    return fn
