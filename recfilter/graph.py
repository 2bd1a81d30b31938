"""Stage DAG introspection: names, tags, and producer/consumer links.

The reference materializes its tiling transformation as a DAG of generated
Halide Functions, each tagged for the collective scheduler
(``FunctionTag``: INLINE/INTER/INTRA_N/INTRA_1/REINDEX,
``lib/recfilter_internals.h:23-29``; naming scheme ``lib/split.cpp:20-30``).
Here the "functions" are fused array programs, but the same DAG
is still the right mental model and debugging surface — so we synthesize the
equivalent stage graph from a FilterSpec, use the reference's names/tags, and
let ``RecFilter.func(name)`` evaluate any stage in isolation (parity with
``RecFilter::func``, ``lib/recfilter.h:296-302``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from .spec import FilterSpec

# FunctionTag values (lib/recfilter_internals.h:23-29)
INLINE = "INLINE"
INTER = "INTER"
INTRA_N = "INTRA_N"
INTRA_1 = "INTRA_1"
REINDEX = "REINDEX"

# VarTag values (lib/recfilter_internals.h:31-44)
FULL = "FULL"
INNER = "INNER"
OUTER = "OUTER"
TAIL = "TAIL"
SCAN = "SCAN"
CHANNEL = "CHANNEL"


@dataclasses.dataclass(frozen=True)
class Stage:
    """One node of the synthesized stage DAG."""

    name: str
    tag: str
    axis: Optional[int]  # scanned dimension, if any
    scan_id: Optional[int]  # index into spec.scans, if any
    consumes: Tuple[str, ...]
    doc: str

    def __repr__(self) -> str:
        return f"<Stage {self.name} [{self.tag}] reads {list(self.consumes)}>"


def build_graph(spec: FilterSpec) -> List[Stage]:
    """Synthesize the stage DAG for a (possibly tiled) filter.

    Untiled: a single full-scan stage per scan. Tiled: per scan the full
    reference stage set (naming scheme ``lib/split.cpp:20-30``):

      * ``Intra``  (INTRA_N) — raw per-tile local tails G_i·x
        (``extract_tails_from_each_scan``, ``lib/split.cpp:256-499``)
      * ``Intra_TDeps`` (INLINE) — earlier same-dimension scans' completed
        tails' residual onto scan i's tails
        (``create_tail_residual_term``, ``lib/split.cpp:912-1004``);
        present when the scan has same-dim predecessors
      * ``Intra_CTail`` (INTER) — the sequential cross-tile carry solve
        (``create_complete_tail_term``, ``lib/split.cpp:743-867``)
      * ``Deps`` (REINDEX) — per-tile carry-injection residual Rhat_i·N_i
        (``create_final_residual_term``, ``lib/split.cpp:1008-1130``)
      * ``Final`` (REINDEX) — the image after this scan's completion
        (``add_residuals_to_final_result``, ``lib/split.cpp:1647-1780``)

    Every stage evaluates through ``RecFilter.func(name)`` from the
    SHIPPING dimfuse executor's matrices (``dimfuse.dim_pass_stages``),
    not a legacy path — what you inspect is what runs.
    """
    stages: List[Stage] = [
        Stage(spec.name, INLINE, None, None, (), "pure initialization")
    ]
    prev = spec.name
    tiles = spec.tile_widths or (0,) * spec.ndim
    seen_in_dim: dict = {}
    for i, s in enumerate(spec.scans):
        dim = spec.dims[s.axis]
        cz = "" if s.causal else "a"
        if tiles[s.axis]:
            intra = f"{spec.name}_Intra_{dim.name}_{cz}{i}"
            tdeps = f"{spec.name}_Intra_TDeps_{dim.name}_{cz}{i}"
            ctail = f"{spec.name}_Intra_CTail_{dim.name}_{cz}{i}"
            deps = f"{spec.name}_Deps_{dim.name}_{cz}{i}"
            final = f"{spec.name}_Final_{dim.name}_{cz}{i}"
            stages.append(
                Stage(
                    intra, INTRA_N, s.axis, i, (prev,),
                    "raw per-tile local tails b_i = G_i·x (matmul)",
                )
            )
            ctail_consumes = [intra]
            if seen_in_dim.get(s.axis):
                stages.append(
                    Stage(
                        tdeps, INLINE, s.axis, i,
                        tuple(seen_in_dim[s.axis]),
                        "cross-scan tail residual Σ_j H_ij·N_j",
                    )
                )
                ctail_consumes.append(tdeps)
            stages.append(
                Stage(
                    ctail, INTER, s.axis, i, tuple(ctail_consumes),
                    "cross-tile carry solve N_i = CM_i·(b_i + TDeps) "
                    "(block-Toeplitz matmul)",
                )
            )
            stages.append(
                Stage(
                    deps, REINDEX, s.axis, i, (ctail,),
                    "per-tile injection residual Rhat_i·N_i",
                )
            )
            stages.append(
                Stage(
                    final, REINDEX, s.axis, i, (prev, deps),
                    "completion y_i = Btot_i·x + Σ_j Rhat_ij·N_j "
                    "(fused matmul)",
                )
            )
            seen_in_dim.setdefault(s.axis, []).append(ctail)
            prev = final
        else:
            full = f"{spec.name}_Scan_{dim.name}_{cz}{i}"
            stages.append(
                Stage(full, INTRA_1, s.axis, i, (prev,), "full lax.scan pass")
            )
            prev = full
    return stages


def synopsis(spec: FilterSpec) -> str:
    """Human-readable summary — analog of ``print_synopsis``
    (``lib/recfilter.cpp:1024-1032``)."""
    lines = [f"RecFilter {spec.name} [{spec.dtype}, border={spec.border}]"]
    for d, t in zip(spec.dims, spec.tile_widths or (0,) * spec.ndim):
        tiled = f" tiled {t}" if t else ""
        lines.append(f"  dim {d.name}: extent {d.extent}{tiled}")
    for i, s in enumerate(spec.scans):
        sign = "+" if s.causal else "-"
        lines.append(
            f"  scan {i}: {sign}{spec.dims[s.axis].name} order {s.order} "
            f"b0={s.feedfwd:g} a={list(s.feedback)}"
        )
    return "\n".join(lines)


def print_functions(spec: FilterSpec) -> str:
    """Stage-DAG dump — analog of ``print_functions``
    (``lib/recfilter.cpp:1024``)."""
    return "\n".join(repr(st) for st in build_graph(spec))
