#!/usr/bin/env python
"""Unsharp-mask demo (``demo/demo_unsharp_mask.cpp``): convert RGB→YUV, blur
and sharpen only the luma channel, convert back, save PNG."""

import argparse
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from recfilter.utils.platform import apply_platform_env

apply_platform_env()

from recfilter.apps import unsharp_mask
from recfilter.utils import image_io


def rgb_to_yuv(img):
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = 0.492 * (b - y)
    v = 0.877 * (r - y)
    return y, u, v


def yuv_to_rgb(y, u, v):
    r = y + v / 0.877
    b = y + u / 0.492
    g = (y - 0.299 * r - 0.114 * b) / 0.587
    return np.clip(np.stack([r, g, b], axis=-1), 0.0, 1.0)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("input", nargs="?", default="")
    p.add_argument("-o", "--output", default="usm_out.png")
    p.add_argument("--sigma", type=float, default=4.0)
    p.add_argument("--weight", type=float, default=1.0)
    ns = p.parse_args()

    if ns.input:
        img = image_io.load_png(ns.input)
    else:
        h = w = 256
        yy, xx = np.mgrid[0:h, 0:w]
        img = np.stack(
            [np.sin(xx / 9.0) * 0.5 + 0.5, (yy / h), ((xx + yy) / (h + w))],
            axis=-1,
        ).astype(np.float32)
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=-1)
    img = img[:, :, :3].astype(np.float32)

    h, w = img.shape[:2]
    y, u, v = rgb_to_yuv(img)
    fn = unsharp_mask(w, h, 32, ns.sigma, ns.weight)
    y_sharp = np.asarray(fn(y))
    out = yuv_to_rgb(y_sharp, u, v)
    image_io.save_png(ns.output, out)
    print(f"saved {ns.output}")


if __name__ == "__main__":
    main()
