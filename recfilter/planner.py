"""Execution planner: the replacement for the collective scheduler.

The reference's scheduler (``lib/schedule.cpp``) applies Halide scheduling
primitives to *sets* of generated functions selected by FunctionTag, with loop
variables addressed by VarTag — because Halide's user must hand-place loops
onto CUDA blocks/threads/registers. Here XLA owns fusion, kernel choice and
loop placement on the GPU, so the planner's real decisions are different and
fewer:

  * tile width per dimension        (≙ split factors, ``lib/split.cpp:1850``)
  * executor backend                (the einsum matmul path or the lax.scan
                                     core)
  * matmul precision grade          (TF32 / true FP32 / compensated bf16)
  * storage layout between passes   (≙ ``storage_layout``,
                                     ``lib/schedule.cpp:835-913``)
  * device mesh + sharding          (no reference analog — single-GPU there)

The platform enters here and nowhere else: :func:`auto_tile_width` reads the
backend JAX runs on; no executor route branches on it.

``RecFilterSchedule`` keeps the reference's tag-addressed, chainable directive
API (``lib/recfilter.h:516-566``) for source-level parity: every directive is
recorded (replayable via ``print_schedule``, like
``lib/recfilter.cpp:1034-1079``) and the ones with a real meaning here update
the underlying :class:`Plan`; the rest are accepted as documented no-ops
because XLA subsumes them.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from .spec import FilterSpec


# Shipping default: px6 — true-f32 accuracy from six bf16 tensor-core
# products per image-sized matmul (dimfuse._split_einsum), carry solves at
# HIGHEST. Opt-outs: "px3" (~5e-5), "highest" (true FP32 dots), "default"
# (TF32 dots on the GPU), bf16 storage. Measured errors per grade on the
# card: PERF.md.
_DEFAULT_MATMUL_PRECISION = ["px6"]


def set_default_matmul_precision(p: str) -> None:
    """Process-wide default for Plan.matmul_precision
    ("highest" | "high" | "f32x6" | "f32x4" | "f32x3" | "px3" | "px4" | "px6" |
    "default"). Composite apps build internal filters with fresh Plans;
    this is how a benchmark or serving config switches them all to the
    fast modes at once."""
    assert p in ("highest", "high", "f32x6", "f32x4", "f32x3", "f32x9",
                 "px3", "px4", "px6", "default")
    _DEFAULT_MATMUL_PRECISION[0] = p


@dataclasses.dataclass(frozen=True)
class Plan:
    """Static execution plan for a filter (hashable; jit-static)."""

    backend: str = "auto"  # auto | einsum | scan | overlap | blocked | oracle
    mesh_axes: Tuple[str, ...] = ()  # e.g. ("data",) or ("data", "seq")
    mesh_shape: Tuple[int, ...] = ()
    data_axis: Optional[int] = None  # array axis sharded over "data"
    seq_axis: Optional[int] = None  # array axis sharded over "seq" (scan dim)
    matmul_precision: str = dataclasses.field(
        default_factory=lambda: _DEFAULT_MATMUL_PRECISION[0]
    )  # highest | high | f32x6 | f32x4 | f32x3 | px3 | px4 | px6 | default
    # (GPU f32 dots with no precision run in TF32 — "default"; highest is
    # true FP32; px3/px4/px6 and f32x3/f32x4/f32x6 are the compensated
    # split-bf16 product counts — see dimfuse._split_einsum)
    rotate_emit: int = 0
    # Layout chaining for single-dimension filters (the meaning here of the
    # reference's ``storage_layout`` directive, ``lib/schedule.cpp:835-913``):
    # nonzero opts into the contract that the INPUT array carries the scanned
    # dimension as its LAST axis, and the result is emitted with the trailing
    # ``rotate_emit`` axes rotated one step (free in the matmul epilogue).
    # Chaining an x-scan and a y-scan filter with rotate_emit=2 runs both in
    # lanes-contraction form with no relayout copy between them — see
    # ``dimfuse.apply_filter_rotated``.

    def with_(self, **kw) -> "Plan":
        return dataclasses.replace(self, **kw)


def resolve_backend(spec: FilterSpec, plan: Plan, platform: str) -> str:
    """Pick the executor for ``auto``: the fused einsum/px path for tiled
    filters (integers included — the exact limb decomposition,
    ``dimfuse.apply_filter_int_exact``, runs them through the SAME tiled
    pipeline as the reference does by casting coefficients into the image
    type, ``lib/recfilter.cpp:324-341``; it falls back to lax.scan itself
    when exactness is not provable), lax.scan for untiled specs."""
    import jax.numpy as jnp

    if plan.backend != "auto":
        return plan.backend
    if jnp.issubdtype(jnp.dtype(spec.dtype), jnp.integer):
        return "einsum" if spec.tiled else "scan"
    if spec.tiled:
        # The fused per-dimension einsum path (dimfuse) has no sequential
        # device code at all.
        return "einsum"
    return "scan"


# Auto tile width per platform. The reference defaults to 32
# (``lib/recfilter_utils.cpp:32-36``); the GPU value comes from the T sweep
# of the 4K gaussian3 headline on the card (PERF.md, "Bring-up on H100").
_AUTO_TILE = {"gpu": 128, "cpu": 32}


def default_tile_width(extent: int, platform: str) -> int:
    """Auto tile width for ``platform`` ("gpu" | "cpu"), clamped to the
    extent. An unknown platform is an error, not a default."""
    if platform not in _AUTO_TILE:
        raise ValueError(f"no auto tile width for platform {platform!r}")
    return max(min(_AUTO_TILE[platform], extent), 1)


def auto_tile_width(extent: int) -> int:
    """:func:`default_tile_width` for the backend JAX runs on."""
    import jax

    return default_tile_width(extent, jax.default_backend())


class ScheduleVar:
    """A tag-addressed loop variable handle (VarTag analog,
    ``lib/recfilter_internals.h:31-44``)."""

    def __init__(self, tag: str, index: Optional[int] = None):
        self.tag = tag
        self.index = index

    def split_var(self) -> "ScheduleVar":
        return ScheduleVar(self.tag + "_split", self.index)

    def __repr__(self) -> str:
        i = "" if self.index is None else f"({self.index})"
        return f"{self.tag}{i}"


class RecFilterSchedule:
    """Chainable, recorded schedule over a set of stages selected by tag.

    Parity object for ``RecFilterSchedule`` (``lib/recfilter.h:516-566``,
    impl ``lib/schedule.cpp``). Directives that map to a real knob here
    mutate the owner's Plan; all are recorded for ``print_schedule``.
    """

    def __init__(self, owner, selector: str):
        self._owner = owner  # RecFilter
        self._selector = selector  # "intra(1)" | "intra(2)" | "inter" | "full"
        self._log: List[str] = []

    # -- recording helper ---------------------------------------------------
    def _rec(self, directive: str, mapping: str = "") -> "RecFilterSchedule":
        """Record ``directive`` with its mapping report.

        The reference applies every directive literally (GPU loop
        placement in generated CUDA); here each one is annotated with what
        it did — a Plan knob it set, or WHY XLA subsumes it — so a user
        porting a reference schedule sees a mapping report, never a silent
        no-op.
        """
        self._log.append(directive)
        note = f"  # {mapping}" if mapping else ""
        self._owner._schedule_log.append(
            f"{self._selector}: {directive}{note}")
        return self

    # -- directives with a real mapping --------------------------------------
    def compute_locally(self) -> "RecFilterSchedule":
        """≙ ``compute_at`` into gpu_blocks (``lib/schedule.cpp:219-293``).
        XLA decides what stays on chip between the executor's einsums, so
        this is a recorded no-op."""
        return self._rec(
            "compute_locally()",
            "no-op: XLA fuses the intra-tile stages into their consumers")

    def compute_globally(self) -> "RecFilterSchedule":
        """Materialize the stage in device memory (≙ ``compute_root``,
        ``lib/schedule.cpp:188-217``): the einsum backend's behavior."""
        if self._selector.startswith("intra"):
            self._owner._plan = self._owner._plan.with_(backend="einsum")
            return self._rec("compute_globally()",
                             "-> Plan.backend='einsum'")
        return self._rec("compute_globally()",
                         "no-op: inter-tile stages already in device memory")

    def unroll(self, var=None, factor: int = 0) -> "RecFilterSchedule":
        return self._rec(f"unroll({var})",
                         "no-op: XLA unrolls and fuses the tile loops")

    def vectorize(self, var=None, width: int = 0) -> "RecFilterSchedule":
        return self._rec(f"vectorize({var})",
                         "no-op: XLA vectorizes the generated kernels")

    def gpu_threads(self, *vars) -> "RecFilterSchedule":
        return self._rec(
            f"gpu_threads{vars}",
            "no-op: XLA owns the thread placement of its kernels")

    def gpu_blocks(self, *vars) -> "RecFilterSchedule":
        return self._rec(
            f"gpu_blocks{vars}",
            "no-op: block placement is XLA's; tile sizes come from "
            "RecFilter.split()")

    def parallel(self, var=None, factor: int = 0) -> "RecFilterSchedule":
        return self._rec(
            f"parallel({var})",
            "no-op single-chip: cross-chip parallelism is "
            "set_plan(mesh_axes=..., mesh_shape=...) sharding")

    def split(self, var, factor: int) -> "RecFilterSchedule":
        return self._rec(
            f"split({var}, {factor})",
            "no-op: loop splitting ≙ tiling — use RecFilter.split(dim, w)")

    def fuse(self, a, b) -> "RecFilterSchedule":
        return self._rec(f"fuse({a}, {b})",
                         "no-op: XLA fuses producer/consumer loops itself")

    def rename(self, a, b=None) -> "RecFilterSchedule":
        """Loop-variable rename (the reference builds gpu_blocks/threads as
        parallel().rename(), ``lib/schedule.cpp:19-29``)."""
        return self._rec(f"rename({a}, {b})",
                         "no-op: loop names don't survive XLA tracing")

    def reorder(self, *vars) -> "RecFilterSchedule":
        return self._rec(
            f"reorder{vars}",
            "no-op: XLA picks loop order inside fusions; pass order is "
            "the scan list order (see RecFilter.cascade)")

    def reorder_storage(self, *vars) -> "RecFilterSchedule":
        """Storage-order directive (``lib/schedule.cpp:915-990``). The real
        layout knob is ``Plan.rotate_emit`` (rotated-emit pipeline
        chaining, set via ``set_plan``); XLA owns intra-pass layouts."""
        return self._rec(
            f"reorder_storage{vars}",
            "no-op: intra-pass layout is XLA's; inter-pass layout is "
            "Plan.rotate_emit (set_plan(rotate_emit=...))")

    def storage_layout(self, *args) -> "RecFilterSchedule":
        """``lib/schedule.cpp:835-913`` analog — see :meth:`reorder_storage`
        and ``Plan.rotate_emit``."""
        return self._rec(
            f"storage_layout{args}",
            "no-op: see reorder_storage — the layout knob is "
            "Plan.rotate_emit")

    def __repr__(self) -> str:
        body = "\n".join(f"    .{d}" for d in self._log)
        return f"RecFilterSchedule[{self._selector}]\n{body}"
