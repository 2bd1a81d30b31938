"""Command-line argument parsing for apps and benchmarks.

Rebuild of the reference's ``Arguments`` parser
(``lib/recfilter_utils.cpp:31-112``): width / tile (block) / iterations /
nocheck / noschedule with the same defaults (width 4096, tile 32, 1
iteration) and the same sweep-forces-nocheck rule
(``lib/recfilter_utils.cpp:95-106``).
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional


class Arguments:
    def __init__(self, argv: Optional[List[str]] = None, description: str = ""):
        p = argparse.ArgumentParser(description=description or "recfilter app")
        p.add_argument(
            "--width", "-w", type=int, default=4096,
            help="image width in pixels (0 = sweep mode)",
        )
        p.add_argument(
            "--tile", "-t", "--block", dest="block", type=int, default=32,
            help="tile width for splitting each dimension",
        )
        p.add_argument(
            "--iter", "-i", dest="iterations", type=int, default=1,
            help="number of profiling iterations",
        )
        p.add_argument(
            "--nocheck", action="store_true",
            help="skip correctness check against the oracle",
        )
        p.add_argument(
            "--noschedule", action="store_true",
            help="use the manual plan instead of the auto planner",
        )
        p.add_argument(
            "--dtype", type=str, default="float32",
            help="image dtype (float32, bfloat16, int32, ...)",
        )
        p.add_argument(
            "--backend", type=str, default="auto",
            choices=["auto", "einsum", "overlap", "blocked", "scan", "oracle"],
            help="executor backend",
        )
        ns = p.parse_args(argv if argv is not None else sys.argv[1:])

        self.width: int = ns.width
        self.block: int = ns.block
        self.iterations: int = ns.iterations
        self.nocheck: bool = ns.nocheck
        self.noschedule: bool = ns.noschedule
        self.dtype: str = ns.dtype
        self.backend: str = ns.backend

        # Sweep mode / many iterations force nocheck, as in the reference
        # (lib/recfilter_utils.cpp:95-106).
        if self.width == 0 or self.iterations > 1:
            self.nocheck = True

    def __repr__(self) -> str:
        return (
            f"Arguments(width={self.width}, block={self.block}, "
            f"iterations={self.iterations}, nocheck={self.nocheck}, "
            f"noschedule={self.noschedule}, dtype={self.dtype}, "
            f"backend={self.backend})"
        )
