#!/usr/bin/env python
"""Summed-area table benchmark (``apps/summed_table/summed_table.cpp``)."""

import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from recfilter.utils.platform import apply_platform_env

apply_platform_env()

import recfilter as rf
from recfilter.apps import summed_table
from recfilter import scan_core


def main():
    args = rf.Arguments(description="summed-area table")
    w = args.width or 4096
    if np.issubdtype(np.dtype(args.dtype), np.integer):
        # integer SAT: full-range random content, wrap semantics — rides
        # the wrapping int32 cumulative sums (dimfuse.int_unit_dim_pass);
        # matches the reference's type-invariance doctrine
        # (test_type_invariance.cpp)
        image = rf.generate_random_image(
            w, w, dtype=args.dtype, lo=-1000, hi=1000, seed=1)
    else:
        image = rf.generate_random_image(w, w, dtype=args.dtype)

    F = summed_table(w, w, args.block, dtype=args.dtype)
    if args.backend != "auto":
        F.set_plan(backend=args.backend)
    if not args.noschedule:
        F.gpu_auto_schedule()

    F.profile(args.iterations)

    if not args.nocheck:
        print("\nChecking difference ... ")
        out = np.asarray(F.realize(image))
        ref = scan_core.oracle_apply(F.spec, image)
        print(rf.CheckResult(ref, out))


if __name__ == "__main__":
    main()
