"""Declarative filter IR: dimensions, scans, and the FilterSpec.

Analog of the reference's filter metadata record
(``lib/recfilter_internals.h:9-19`` ``FilterInfo`` and
``lib/recfilter_internals.h:143-180`` ``RecFilterContents``): a recursive filter
is a pure initialization plus an ordered list of causal/anticausal scans, each
with a feedforward coefficient and ``order`` feedback coefficients
(``lib/recfilter.h:267-281``).

Unlike the reference — where this state is mutated in place by the Halide graph
builder — the spec here is immutable, hashable data that serves as a *static*
argument to ``jax.jit``-traced executors. The compiler (XLA) sees a fresh trace
per distinct spec, which is the JAX-idiomatic replacement for Halide's
metaprogramming over ``Function`` objects.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


class BorderMode:
    """Boundary handling for scans (``lib/recfilter.cpp:321-342``).

    ZERO   — samples before the array start contribute nothing
             (``select(rx>j, call, 0)`` in the reference).
    CLAMP  — out-of-range taps clamp to the array edge
             (``set_clamped_image_border``, ``lib/recfilter.cpp:252-258``).
    """

    ZERO = "zero"
    CLAMP = "clamp"


@dataclasses.dataclass(frozen=True)
class Dim:
    """A named filter dimension with a static extent.

    Mirrors ``RecFilterDim`` (``lib/recfilter.h:68-95``). Unary ``+``/``-``
    select causal/anticausal scan direction, mirroring the reference's
    ``operator+``/``operator-`` (``lib/recfilter.h:135-139``).
    """

    name: str
    extent: int

    def __pos__(self) -> "DimAndCausality":
        return DimAndCausality(self, True)

    def __neg__(self) -> "DimAndCausality":
        return DimAndCausality(self, False)

    def __repr__(self) -> str:
        return f"Dim({self.name}, {self.extent})"


@dataclasses.dataclass(frozen=True)
class DimAndCausality:
    """A dimension paired with a scan direction (``lib/recfilter.h:98-132``)."""

    dim: Dim
    causal: bool

    def __repr__(self) -> str:
        sign = "+" if self.causal else "-"
        return f"{sign}{self.dim.name}"


@dataclasses.dataclass(frozen=True)
class Scan:
    """One recursive scan: v[x] = b0*v[x] + sum_j a_j * v[x -/+ (j+1)].

    ``feedfwd`` is b0 and ``feedback`` is (a_1 .. a_k); ``order`` == k.
    Matches the update definition built by ``RecFilter::add_filter``
    (``lib/recfilter.cpp:264-392``). ``axis`` is the index of the scanned
    dimension in the filter's dim list.
    """

    axis: int
    causal: bool
    feedfwd: float
    feedback: Tuple[float, ...]

    @property
    def order(self) -> int:
        return len(self.feedback)

    def __repr__(self) -> str:
        sign = "+" if self.causal else "-"
        fb = ",".join(f"{a:g}" for a in self.feedback)
        return f"Scan({sign}axis{self.axis}, b0={self.feedfwd:g}, a=[{fb}])"


@dataclasses.dataclass(frozen=True)
class FilterSpec:
    """Complete static description of a recursive filter.

    The immutable analog of ``RecFilterContents``
    (``lib/recfilter_internals.h:143-180``): name, dims, ordered scans,
    border mode, dtype name, and per-dim tile widths once ``split`` has been
    applied (0 = untiled). Hashable so it can be a static jit argument.
    """

    name: str
    dims: Tuple[Dim, ...]
    scans: Tuple[Scan, ...]
    border: str = BorderMode.ZERO
    dtype: str = "float32"
    tile_widths: Tuple[int, ...] = ()  # per-dim; () means untiled
    tuple_width: int = 0  # >0: Tuple output with that many components

    def __post_init__(self):
        if self.tile_widths and len(self.tile_widths) != len(self.dims):
            raise ValueError("tile_widths must match number of dims")

    def stacked(self) -> "FilterSpec":
        """Executor view of a Tuple filter: the components ride a leading
        channel dimension (every scan applies identically to each component,
        as Halide Tuples do — ``RecFilter::define`` with multiple exprs,
        ``apps/DoG/diff_gauss.cpp:84``) and scan axes shift by one."""
        if not self.tuple_width:
            return self
        return FilterSpec(
            name=self.name,
            dims=(Dim("__tuple__", self.tuple_width),) + self.dims,
            scans=tuple(
                dataclasses.replace(s, axis=s.axis + 1) for s in self.scans
            ),
            border=self.border,
            dtype=self.dtype,
            tile_widths=((0,) + self.tile_widths) if self.tile_widths else (),
            tuple_width=0,
        )

    @property
    def tiled(self) -> bool:
        return any(t > 0 for t in self.tile_widths)

    @property
    def ndim(self) -> int:
        return len(self.dims)

    def axis_of(self, dim: Dim) -> int:
        for i, d in enumerate(self.dims):
            if d.name == dim.name:
                return i
        raise ValueError(
            f"Variable {dim.name} is not one of the dimensions of "
            f"the recursive filter {self.name}"
        )

    def scans_by_axis(self) -> "dict[int, list[int]]":
        """Group scan indices by dimension, preserving within-dim order.

        Cross-dimension scans commute (they are tensor products of 1-D linear
        operators), which is what makes the reference's
        ``group_scans_by_dimension`` (``lib/split.cpp:215-242``) and
        ``cascade_by_dimension`` (``lib/reorder.cpp:211-229``) legal.
        """
        groups: dict[int, list[int]] = {}
        for i, s in enumerate(self.scans):
            groups.setdefault(s.axis, []).append(i)
        return groups

    def with_scan(self, scan: Scan) -> "FilterSpec":
        return dataclasses.replace(self, scans=self.scans + (scan,))

    def with_tiles(self, tile_widths: Tuple[int, ...]) -> "FilterSpec":
        return dataclasses.replace(self, tile_widths=tuple(tile_widths))

    def feedfwd_coeff(self) -> np.ndarray:
        """Per-scan feedforward coefficients, shape (num_scans,).

        Analog of ``RecFilterContents::feedfwd_coeff``
        (``lib/recfilter_internals.h:166-170``).
        """
        return np.array([s.feedfwd for s in self.scans], dtype=np.float64)

    def feedback_coeff(self) -> np.ndarray:
        """Per-scan feedback coefficients, shape (num_scans, max_order).

        Rows are zero-padded to the max order, matching the coefficient image
        layout in ``RecFilter::add_filter`` (``lib/recfilter.cpp:353-372``).
        """
        max_order = max((s.order for s in self.scans), default=0)
        out = np.zeros((len(self.scans), max_order), dtype=np.float64)
        for i, s in enumerate(self.scans):
            out[i, : s.order] = s.feedback
        return out


def spec_to_json(spec: FilterSpec) -> str:
    """Serialize a FilterSpec to JSON — the persistence analog of the
    reference's replayable schedule strings (``print_schedule``,
    ``lib/recfilter.cpp:1034-1079``): the whole program is data and can be
    stored/shipped/reloaded."""
    import json

    return json.dumps(
        {
            "name": spec.name,
            "dims": [[d.name, d.extent] for d in spec.dims],
            "scans": [
                {
                    "axis": s.axis,
                    "causal": s.causal,
                    "feedfwd": s.feedfwd,
                    "feedback": list(s.feedback),
                }
                for s in spec.scans
            ],
            "border": spec.border,
            "dtype": spec.dtype,
            "tile_widths": list(spec.tile_widths),
            "tuple_width": spec.tuple_width,
        }
    )


def spec_from_json(text: str) -> FilterSpec:
    """Inverse of :func:`spec_to_json`."""
    import json

    d = json.loads(text)
    return FilterSpec(
        name=d["name"],
        dims=tuple(Dim(n, e) for n, e in d["dims"]),
        scans=tuple(
            Scan(s["axis"], s["causal"], s["feedfwd"], tuple(s["feedback"]))
            for s in d["scans"]
        ),
        border=d["border"],
        dtype=d["dtype"],
        tile_widths=tuple(d["tile_widths"]),
        tuple_width=d.get("tuple_width", 0),
    )


def make_scan(spec: FilterSpec, dx: DimAndCausality, coeff) -> Scan:
    """Build a Scan from a (+dim / -dim) and a [b0, a1, ..., ak] list.

    Mirrors the coefficient unpacking in ``RecFilter::add_filter``
    (``lib/recfilter.cpp:264-291``).
    """
    coeff = [float(c) for c in np.asarray(coeff).ravel()]
    if len(coeff) < 2:
        raise ValueError(
            f"Cannot add scan to recursive filter {spec.name} without "
            "feed forward and feedback coefficients"
        )
    axis = spec.axis_of(dx.dim)
    return Scan(
        axis=axis,
        causal=dx.causal,
        feedfwd=coeff[0],
        feedback=tuple(coeff[1:]),
    )
