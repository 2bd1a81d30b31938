#!/usr/bin/env python
"""RGB Gaussian blur demo (``demo/demo_gaussian_filter.cpp``): 3rd-order
recursive Gaussian on all channels (Tuple RGB → leading channel axis),
overlapped scans, tile 32. Reads/writes PNG with the stdlib-only codec.
"""

import argparse
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from recfilter.utils.platform import apply_platform_env

apply_platform_env()

import recfilter as rf
from recfilter.apps.gaussian import gaussian_3xy_rgb
from recfilter.utils import image_io


def main():
    p = argparse.ArgumentParser()
    p.add_argument("input", nargs="?", default="")
    p.add_argument("-o", "--output", default="out.png")
    p.add_argument("--sigma", type=float, default=5.0)
    p.add_argument("--tile", type=int, default=32)
    ns = p.parse_args()

    if ns.input:
        img = image_io.load_png(ns.input)  # HxWx3 float in [0,1]
    else:
        # synthetic test card
        h = w = 256
        yy, xx = np.mgrid[0:h, 0:w]
        img = np.stack(
            [
                ((xx // 32 + yy // 32) % 2).astype(np.float32),
                (xx / w).astype(np.float32),
                (yy / h).astype(np.float32),
            ],
            axis=-1,
        )
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=-1)
    img = img[:, :, :3]

    h, w = img.shape[:2]
    # channels ride a leading axis (Tuple RGB, demo_gaussian_filter.cpp:57)
    chw = np.moveaxis(img, -1, 0).astype(np.float32)

    # One overlapped 3rd-order filter over the (3, h, w) channel batch —
    # the channel axis rides both rotated passes (see apps.gaussian_3xy_rgb).
    out = gaussian_3xy_rgb(w, h, ns.tile, sigma=ns.sigma).as_func()(chw)

    result = np.moveaxis(np.asarray(out), 0, -1)
    image_io.save_png(ns.output, result)
    print(f"saved {ns.output} ({h}x{w}, sigma={ns.sigma})")


if __name__ == "__main__":
    main()
