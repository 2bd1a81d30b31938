"""Full 2-D overlapped execution: both dimensions' carries from one read.

The reference's deepest machinery — cross-dimension residuals
(``add_prev_dimension_residual_to_tails``, ``lib/split.cpp:1215-1633``) —
rebuilt as tensor-product identities. For a filter with scans on dims A then
B (cross-dimension scans commute, so any interleaving regroups legally):

Dim-A completion per tile (from :mod:`dimfuse`):

    Z = Btot_A ∘_A x + Σ_j Rhat_{A,j} ∘_A N_{A,j}

Dim-B local tails act on Z along B; because A- and B-operators act on
different axes they commute, so with U_l = G_{B,l} ∘_B x (computed while x
is being read for the A-tails):

    b_{B,l} = Btot_A ∘_A U_l + Σ_j Rhat_{A,j} ∘_A (G_{B,l} ∘_B N_{A,j})
              [+ Σ_{l'<l} H_{B,l,l'} ∘_B N_{B,l'}]

Everything on the right is carry-sized — the B-dimension's tails cost NO
extra pass over the image. Execution:

    pass 1 (read x):   A-tails b_A, B-moments U
    solves (tiny):     N_A per A-scan, then b_B → N_B per B-scan
    pass 2 (read x):   Z = A-completion            (write Z)
    pass 3 (read Z):   Y = B-completion            (write Y)

5 image touches for the whole 2-D filter vs 6 for dimension-by-dimension.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from . import dimfuse
from .spec import BorderMode, FilterSpec, Scan


def _prec(cdt):
    """True-f32 matmuls (see dimfuse._matmul_precision)."""
    return (
        jax.lax.Precision.HIGHEST
        if cdt not in (jnp.bfloat16, jnp.float16)
        else None
    )


def _axis_prep(x, axis_a: int, axis_b: int, Ta: int, Tb: int):
    """Reshape x to the canonical 7-D (p, na, sa, q, nb, sb, r) view."""
    assert axis_a < axis_b
    shape = x.shape
    wa, wb = shape[axis_a], shape[axis_b]
    na, nb = wa // Ta, wb // Tb
    p = int(np.prod(shape[:axis_a], dtype=np.int64)) if axis_a else 1
    q = int(np.prod(shape[axis_a + 1 : axis_b], dtype=np.int64))
    r = int(np.prod(shape[axis_b + 1 :], dtype=np.int64))
    return x.reshape(p, na, Ta, q, nb, Tb, r), (p, q, r, na, nb)


def _apply_a(Mstack, V, cdt):
    """Apply a dim-A matrix stack (na|1, o, s) over the 'sa' axis."""
    M = jnp.asarray(Mstack, dtype=cdt)
    if M.shape[0] == 1:
        return jnp.einsum("os,pasqbtr->paoqbtr", M[0], V,
                          preferred_element_type=cdt, precision=_prec(cdt))
    return jnp.einsum("aos,pasqbtr->paoqbtr", M, V,
                      preferred_element_type=cdt, precision=_prec(cdt))


def _apply_b(Mstack, V, cdt):
    """Apply a dim-B matrix stack (nb|1, o, t) over the 'sb' axis."""
    M = jnp.asarray(Mstack, dtype=cdt)
    if M.shape[0] == 1:
        return jnp.einsum("ot,pasqbtr->pasqbor", M[0], V,
                          preferred_element_type=cdt, precision=_prec(cdt))
    return jnp.einsum("bot,pasqbtr->pasqbor", M, V,
                      preferred_element_type=cdt, precision=_prec(cdt))


def _solve_chain_a(b, CM, cdt):
    """b: (p, na, k, q, nb, t, r) → N of the same shape (chain over na)."""
    p, na, k, q, nb, t, r = b.shape
    lines = jnp.moveaxis(b, (1, 2), (5, 6)).reshape(-1, na * k)
    N = jnp.einsum("ls,ts->lt", lines, jnp.asarray(CM, dtype=cdt),
                   precision=_prec(cdt))
    N = N.reshape(p, q, nb, t, r, na, k)
    return jnp.moveaxis(N, (5, 6), (1, 2))


def _solve_chain_b(b, CM, cdt):
    """b: (p, na, s, q, nb, k, r) → N of the same shape (chain over nb)."""
    p, na, s, q, nb, k, r = b.shape
    lines = jnp.moveaxis(b, (4, 5), (5, 6)).reshape(-1, nb * k)
    N = jnp.einsum("ls,ts->lt", lines, jnp.asarray(CM, dtype=cdt),
                   precision=_prec(cdt))
    N = N.reshape(p, na, s, q, r, nb, k)
    return jnp.moveaxis(N, (5, 6), (4, 5))


def fused_2d_pass(
    x,
    axis_a: int,
    scans_a: Sequence[Scan],
    Ta: int,
    axis_b: int,
    scans_b: Sequence[Scan],
    Tb: int,
    border: str = BorderMode.ZERO,
    compute_dtype=jnp.float32,
):
    """Apply dim-A scans then dim-B scans with cross-dimension carry fusion.

    Falls back to two :func:`dimfuse.fused_dim_pass` calls when a dimension
    needs the scan-core path (tiny/prime clamp widths) or huge tile counts.
    """
    clamp = border == BorderMode.CLAMP
    cdt = compute_dtype
    if axis_a > axis_b:
        # normalize order: caller guarantees scans_a precede scans_b in the
        # filter, which is all that matters (cross-dim scans commute)
        return fused_2d_pass(
            jnp.swapaxes(x, axis_a, axis_b), axis_b, scans_a, Ta,
            axis_a, scans_b, Tb, border, cdt,
        ).swapaxes(axis_a, axis_b)

    wa, wb = x.shape[axis_a], x.shape[axis_b]
    ka = max(s.order for s in scans_a)
    kb = max(s.order for s in scans_b)
    Ta = int(min(max(Ta, ka), wa))
    Tb = int(min(max(Tb, kb), wb))
    na, nb = -(-wa // Ta), -(-wb // Tb)
    pad_a, pad_b = na * Ta - wa, nb * Tb - wb

    def fallback():
        y = dimfuse.fused_dim_pass(x, axis_a, scans_a, Ta, border, cdt)
        return dimfuse.fused_dim_pass(y, axis_b, scans_b, Tb, border, cdt)

    if clamp and (pad_a or pad_b):
        # exact tiling needed for clamp; dimfuse has the divisor fallback
        return fallback()
    if na > dimfuse._CHAIN_MATMUL_MAX_TILES or nb > dimfuse._CHAIN_MATMUL_MAX_TILES:
        return fallback()
    if Ta < ka or Tb < kb:
        return fallback()

    ma = dimfuse.prepare_dim_pass(scans_a, Ta, na, clamp, pad_slots=pad_a)
    mb = dimfuse.prepare_dim_pass(scans_b, Tb, nb, clamp, pad_slots=pad_b)

    if pad_a or pad_b:
        pads = [(0, 0)] * x.ndim
        pads[axis_a] = (0, pad_a)
        pads[axis_b] = (0, pad_b)
        x = jnp.pad(x, pads)

    X, dims = _axis_prep(x.astype(cdt), axis_a, axis_b, Ta, Tb)
    p, q, r, _, _ = dims

    # Combined-solve op-count treatment (same as dimfuse): every scan's
    # chain solve and all cross-scan H-couplings of a dimension fold into
    # ONE (n·ΣK)² matmul per dimension; the stacked G/Rhat forms turn the
    # per-scan einsum loops into one einsum each. Per-op dispatch overhead
    # dominates carry-sized work on this stack (ROADMAP / VERDICT r1).
    Ka = int(sum(ma.orders))
    Kb = int(sum(mb.orders))
    Ga_cat = dimfuse.pad_rows8(
        np.concatenate([np.asarray(g) for g in ma.G], axis=1))
    Gb_cat = dimfuse.pad_rows8(
        np.concatenate([np.asarray(g) for g in mb.G], axis=1))
    Ra_cat = np.concatenate([np.asarray(m) for m in ma.Rhat], axis=2)
    Rb_cat = np.concatenate([np.asarray(m) for m in mb.Rhat], axis=2)
    CMa = dimfuse.combined_solve_matrix(ma, na)
    CMb = dimfuse.combined_solve_matrix(mb, nb)

    # ---- pass 1 (one read of x): dim-A raw tails + dim-B moments ---------
    bA = _apply_a(Ga_cat, X, cdt)[:, :, :Ka]
    U = _apply_b(Gb_cat, X, cdt)[..., :Kb, :]
    NA = _solve_chain_a(bA, CMa, cdt)

    # ---- dim-B raw tails from carry-sized data only ----------------------
    # Gb∘Z = Btot_A∘(Gb∘X) + Ra_cat∘(Gb∘NA_cat)   (A/B operators commute)
    bb = _apply_a(ma.Btot, U, cdt) + _apply_a(
        Ra_cat, _apply_b(Gb_cat[:, :Kb] if Gb_cat.shape[1] != Kb else Gb_cat,
                         NA, cdt), cdt)
    NB = _solve_chain_b(bb, CMb, cdt)

    # ---- pass 2: dim-A completion (Z); pass 3: dim-B completion ----------
    Z = _apply_a(ma.Btot, X, cdt) + _apply_a(Ra_cat, NA, cdt)
    Y = _apply_b(mb.Btot, Z, cdt) + _apply_b(Rb_cat, NB, cdt)

    shape = x.shape
    y = Y.reshape(shape)
    if pad_a:
        y = jax.lax.slice_in_dim(y, 0, wa, axis=axis_a)
    if pad_b:
        y = jax.lax.slice_in_dim(y, 0, wb, axis=axis_b)
    return y


def apply_filter_overlap(spec: FilterSpec, x, tile_default: int = 32):
    """Whole-filter executor with cross-dimension fusion where possible.

    Three or more scanned dims take :func:`fused_nd_pass`; otherwise dims
    are consumed pairwise (in first-appearance order) through
    :func:`fused_2d_pass`, and an odd remaining dim runs through dimfuse.
    """
    from . import scan_core

    dtype = jnp.dtype(spec.dtype)
    if jnp.issubdtype(dtype, jnp.integer):
        return scan_core.apply_filter(spec, x)
    cdt = jnp.float32 if dtype in (jnp.bfloat16, jnp.float16) else dtype
    x = x.astype(cdt)
    tiles = spec.tile_widths or (0,) * spec.ndim
    groups = list(spec.scans_by_axis().items())
    if len(groups) >= 3:
        # n-D overlap beyond pairs: every dimension's carries from one read
        # (2D+1 image touches vs 3D dimension-by-dimension).
        y = fused_nd_pass(
            x,
            [(ax, [spec.scans[j] for j in ids], tiles[ax] or tile_default)
             for ax, ids in groups],
            spec.border, cdt,
        )
        if y is not None:
            return y.astype(dtype)
    i = 0
    while i < len(groups):
        if i + 1 < len(groups):
            (ax_a, ids_a), (ax_b, ids_b) = groups[i], groups[i + 1]
            x = fused_2d_pass(
                x,
                ax_a, [spec.scans[j] for j in ids_a],
                tiles[ax_a] or tile_default,
                ax_b, [spec.scans[j] for j in ids_b],
                tiles[ax_b] or tile_default,
                spec.border, cdt,
            )
            i += 2
        else:
            ax, ids = groups[i]
            x = dimfuse.fused_dim_pass(
                x, ax, [spec.scans[j] for j in ids],
                tiles[ax] or tile_default, spec.border, cdt,
            )
            i += 1
    return x.astype(dtype)


def fused_nd_pass(
    x,
    groups,
    border: str = BorderMode.ZERO,
    compute_dtype=jnp.float32,
):
    """All D scanned dimensions' carries from ONE read of x (D ≥ 2).

    The n-D generalization of :func:`fused_2d_pass` — the reference's
    cross-dimension machinery (``add_prev_dimension_residual_to_tails``,
    ``lib/split.cpp:1215-1633``) extended past pairs: with Y_e the image
    after dims 0..e's completions, dim d's raw tails satisfy (operators on
    different axes commute)

        G_d ∘ Y_{d-1} = V_{d-1},   V_{-1} = G_d ∘ x  (a pass-1 moment)
        V_e = Btot_e ∘ V_{e-1} + Rcat_e ∘ (G_d ∘ N_e)

    — every term after pass 1 is carry-sized. Execution: one read of x for
    dim-0 tails + all moments, D chained carry derivations/solves (tiny),
    then D completion einsums over the image (2 image touches each): 2D+1
    image touches for the whole filter vs 3D dimension-by-dimension.

    ``groups``: ordered [(axis, scans, tile_width), ...]. Returns None when
    any dimension needs a fallback (clamp with non-dividing width, order
    exceeding tiles, audio-scale tile counts) — callers then run the
    pairwise/dimfuse route.
    """
    clamp = border == BorderMode.CLAMP
    cdt = compute_dtype
    D = len(groups)
    infos = []
    for axis, scans, T in groups:
        w = x.shape[axis]
        k = max(s.order for s in scans)
        T = int(min(max(T, k), w))
        n = -(-w // T)
        pad = n * T - w
        if (clamp and pad) or T < k or n > dimfuse._CHAIN_MATMUL_MAX_TILES:
            return None
        infos.append(dict(axis=axis, scans=scans, T=T, n=n, pad=pad, w=w))

    pads = [(0, 0)] * x.ndim
    for inf in infos:
        pads[inf["axis"]] = (0, inf["pad"])
    if any(p != (0, 0) for p in pads):
        x = jnp.pad(x, pads)

    for inf in infos:
        m = dimfuse.prepare_dim_pass(
            inf["scans"], inf["T"], inf["n"], clamp, pad_slots=inf["pad"]
        )
        inf["K"] = int(sum(m.orders))
        inf["Gp"] = dimfuse.pad_rows8(
            np.concatenate([np.asarray(g) for g in m.G], axis=1))
        inf["G"] = inf["Gp"][:, : inf["K"]]
        inf["R"] = np.concatenate([np.asarray(r) for r in m.Rhat], axis=2)
        inf["B"] = m.Btot
        inf["CM"] = dimfuse.combined_solve_matrix(m, inf["n"])

    # Canonical tiled view + einsum letter plumbing ("z" reserved for the
    # output axis of a dim-apply).
    letters = iter("abcdefghijklmnop")
    tiled = {inf["axis"]: i for i, inf in enumerate(infos)}
    view, axl = [], []
    for ax in range(x.ndim):
        if ax in tiled:
            inf = infos[tiled[ax]]
            nl, sl = next(letters), next(letters)
            inf["nl"], inf["sl"] = nl, sl
            view += [inf["n"], inf["T"]]
            axl += [nl, sl]
        else:
            view.append(x.shape[ax])
            axl.append(next(letters))
    in_str = "".join(axl)
    X = x.reshape(view).astype(cdt)

    def apply_d(Mstack, V, d):
        inf = infos[d]
        out = in_str.replace(inf["sl"], "z")
        M = jnp.asarray(np.asarray(Mstack), dtype=cdt)
        if M.shape[0] == 1:
            eq = f"z{inf['sl']},{in_str}->{out}"
            return jnp.einsum(eq, M[0], V, preferred_element_type=cdt,
                              precision=_prec(cdt))
        eq = f"{inf['nl']}z{inf['sl']},{in_str}->{out}"
        return jnp.einsum(eq, M, V, preferred_element_type=cdt,
                          precision=_prec(cdt))

    def slice_k(V, d):
        inf = infos[d]
        ax = in_str.index(inf["sl"])
        return jax.lax.slice_in_dim(V, 0, inf["K"], axis=ax)

    def solve_d(V, d):
        inf = infos[d]
        i_n, i_s = in_str.index(inf["nl"]), in_str.index(inf["sl"])
        rest = [i for i in range(V.ndim) if i not in (i_n, i_s)]
        perm = rest + [i_n, i_s]
        bt = jnp.transpose(V, perm)
        shp = bt.shape
        N = jnp.einsum(
            "ls,ts->lt", bt.reshape(-1, inf["n"] * inf["K"]),
            jnp.asarray(inf["CM"], dtype=cdt),
            preferred_element_type=cdt, precision=_prec(cdt),
        ).reshape(shp)
        inv = np.argsort(perm)
        return jnp.transpose(N, inv)

    # ---- pass 1 (one read of x): dim-0 raw tails + every moment ----------
    N = [solve_d(slice_k(apply_d(infos[0]["Gp"], X, 0), 0), 0)]
    for d in range(1, D):
        V = slice_k(apply_d(infos[d]["Gp"], X, d), d)
        for e in range(d):
            GN = apply_d(infos[d]["G"], N[e], d)     # carry² sized
            V = apply_d(infos[e]["B"], V, e) + apply_d(infos[e]["R"], GN, e)
        N.append(solve_d(V, d))

    # ---- D completion einsums over the image ------------------------------
    Y = X
    for e in range(D):
        Y = apply_d(infos[e]["B"], Y, e) + apply_d(infos[e]["R"], N[e], e)

    y = Y.reshape(x.shape)
    for inf in infos:
        if inf["pad"]:
            y = jax.lax.slice_in_dim(y, 0, inf["w"], axis=inf["axis"])
    return y
