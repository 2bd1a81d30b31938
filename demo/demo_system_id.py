#!/usr/bin/env python
"""System-identification demo — no reference analog.

Pass a noise signal through an "unknown" 2nd-order audio IIR filter
(biquad), then recover its coefficients by gradient descent through the
differentiable tiled executor (`recfilter.learnable`): a trainable
biquad is fitted so model(input) ≈ observed output.

Demonstrates that the tiled scan algebra is differentiable end-to-end with
respect to the filter coefficients — recursive filters as trainable layers.
"""

import argparse
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from recfilter.utils.platform import apply_platform_env

apply_platform_env()

import jax
import jax.numpy as jnp
import optax

from recfilter import learnable
from recfilter.spec import Dim, FilterSpec, Scan


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--samples", type=int, default=8192)
    p.add_argument("--steps", type=int, default=400)
    ns = p.parse_args()

    n = ns.samples
    rng = np.random.default_rng(0)
    signal = jnp.asarray(rng.standard_normal((8, n)), dtype=jnp.float32)

    # The "unknown" system: a biquad with poles inside the unit circle.
    true = {"b0": 0.3, "a": (0.9, -0.45)}
    spec = FilterSpec(
        "SysId", (Dim("c", 8), Dim("t", n)), (Scan(1, True, 1.0, (0.0, 0.0)),)
    )
    model = learnable.LearnableRecFilter(spec, tile_width=64)
    observed = model.apply(
        {"scan0": {"b0": jnp.asarray(true["b0"]),
                   "a": jnp.asarray(true["a"])}},
        signal,
    )

    params = model.init_params()  # starts at b0=1, a=(0,0): identity-ish
    opt = optax.adam(2e-2)
    state = opt.init(params)

    @jax.jit
    def step(params, state):
        def loss_fn(prm):
            return ((model.apply(prm, signal) - observed) ** 2).mean()

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, state = opt.update(grads, state)
        return optax.apply_updates(params, updates), state, loss

    for i in range(ns.steps):
        params, state, loss = step(params, state)
        if i % 100 == 0:
            print(f"step {i:4d}  loss {float(loss):.8f}")

    got = params["scan0"]
    print(f"final loss {float(loss):.2e}")
    print(f"true    b0={true['b0']:+.4f}  a={np.round(true['a'], 4)}")
    print(
        f"learned b0={float(got['b0']):+.4f}  "
        f"a={np.round(np.asarray(got['a']), 4)}"
    )


if __name__ == "__main__":
    main()
