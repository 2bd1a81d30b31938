#!/usr/bin/env python
"""Median filter via smoothed local histograms
(``demo/demo_smoothed_hist_median_filter.cpp``): 15 Gaussian-weighted
histogram bins per channel, each bin image blurred with the recursive
Gaussian, median located by inverse interpolation across bins."""

import argparse
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from recfilter.utils.platform import apply_platform_env

apply_platform_env()

import jax
import jax.numpy as jnp

from recfilter import iir
from recfilter.apps.gaussian import gaussian_3x_3y
from recfilter.utils import image_io

NUM_BINS = 15
BIN_WIDTH = 1.0 / NUM_BINS
HIST_SIGMA = BIN_WIDTH
GAUSS_SIGMA = 5.0


def bin_center(i):
    return BIN_WIDTH * (i + 0.5)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("input", nargs="?", default="")
    p.add_argument("-o", "--output", default="median_out.png")
    ns = p.parse_args()

    if ns.input:
        img = image_io.load_png(ns.input)
    else:
        rng = np.random.default_rng(0)
        h = w = 128
        img = np.clip(
            0.5 + 0.3 * np.sin(np.mgrid[0:h, 0:w][0] / 7.0)[:, :, None]
            + 0.25 * rng.standard_normal((h, w, 3)),
            0, 1,
        ).astype(np.float32)
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=-1)
    img = img[:, :, :3].astype(np.float32)
    h, w = img.shape[:2]

    fc = gaussian_3x_3y(w, h, 32, GAUSS_SIGMA)
    fns = [f.as_func() for f in fc]

    def smooth(z):
        for f in fns:
            z = f(z)
        return z

    @jax.jit
    def median(imgj):
        # histogram CDF per bin, all channels at once (c, h, w)
        chw = jnp.moveaxis(imgj, -1, 0)
        hist = [
            smooth(iir.gauss_integral(chw, bin_center(i), HIST_SIGMA))
            for i in range(NUM_BINS)
        ]
        g0, gn = hist[0], hist[-1]
        target = g0 + 0.5 * (gn - g0)
        med = None
        for i in range(NUM_BINS - 1):
            gi, gi1 = hist[i], hist[i + 1]
            frac = (target - gi) / (gi1 - gi)
            value = bin_center(i) + frac * BIN_WIDTH
            if med is None:
                med = value
            else:
                cond = (gi < target) & (gi1 >= target)
                med = jnp.where(cond, value, med)
        return jnp.moveaxis(med, 0, -1)

    out = np.asarray(median(jnp.asarray(img)))
    image_io.save_png(ns.output, np.clip(out, 0, 1))
    print(f"saved {ns.output}")


if __name__ == "__main__":
    main()
