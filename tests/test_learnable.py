"""Differentiable-coefficient executors: parity with the static path and an
end-to-end coefficient-fitting optimization."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from recfilter import coeffs, learnable, scan_core
from recfilter.spec import BorderMode, Dim, FilterSpec, Scan

CASES = [
    (1.0, [1.0]),
    (1.2, [0.8, -0.3]),
    (0.9, [0.6, 0.25, -0.1]),
]


@pytest.mark.parametrize("feedfwd,feedback", CASES)
@pytest.mark.parametrize("clamp", [False, True])
def test_impulse_matrix_jnp_matches_static(feedfwd, feedback, clamp):
    got = np.asarray(
        learnable.impulse_matrix_jnp(
            jnp.asarray(feedfwd), jnp.asarray(feedback), 12, clamp
        )
    )
    want = coeffs.impulse_matrix(feedfwd, feedback, 12, clamp)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("feedfwd,feedback", CASES)
def test_state_matrix_jnp_matches_static(feedfwd, feedback):
    got = np.asarray(
        learnable.state_matrix_jnp(jnp.asarray(feedback), 12)
    )
    want = coeffs.state_matrix(feedback, 12)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("border", [BorderMode.ZERO, BorderMode.CLAMP])
def test_learnable_scan_matches_oracle(causal, border):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 20)).astype(np.float32)
    got = np.asarray(
        learnable.apply_scan_learnable(
            jnp.asarray(x), 1, causal, jnp.asarray(0.9),
            jnp.asarray([0.6, 0.25]), tile_width=6, border=border,
        )
    )
    want = scan_core.oracle_apply_scan(
        x, 1, causal, 0.9, [0.6, 0.25], border
    ).astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_gradients_wrt_coefficients_match_finite_difference():
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal((3, 16)).astype(np.float32))

    def loss(a):
        y = learnable.apply_scan_learnable(
            x, 1, True, jnp.asarray(1.0), a, tile_width=4
        )
        return (y**2).mean()

    a0 = jnp.asarray([0.5, 0.2])
    g = jax.grad(loss)(a0)
    for i in range(2):
        eps = 1e-3
        d = jnp.zeros(2).at[i].set(eps)
        fd = (loss(a0 + d) - loss(a0 - d)) / (2 * eps)
        np.testing.assert_allclose(g[i], fd, rtol=5e-2, atol=1e-4)


def test_fit_coefficients_recovers_target():
    """Train a 1st-order filter's coefficients to match a target filter's
    output — the learnable-layer story end to end."""
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal((8, 32)).astype(np.float32))
    spec = FilterSpec(
        "L", (Dim("r", 8), Dim("c", 32)), (Scan(1, True, 1.0, (0.5,)),)
    )
    model = learnable.LearnableRecFilter(spec, tile_width=8)
    target_params = {"scan0": {"b0": jnp.asarray(0.7), "a": jnp.asarray([0.6])}}
    target = model.apply(target_params, x)

    params = model.init_params()  # starts at b0=1.0, a=0.5
    opt = optax.adam(3e-2)
    state = opt.init(params)

    @jax.jit
    def step(params, state):
        def loss_fn(p):
            return ((model.apply(p, x) - target) ** 2).mean()

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, state = opt.update(grads, state)
        return optax.apply_updates(params, updates), state, loss

    for _ in range(300):
        params, state, loss = step(params, state)
    assert float(loss) < 1e-5
    np.testing.assert_allclose(
        float(params["scan0"]["b0"]), 0.7, atol=2e-2
    )
    np.testing.assert_allclose(
        float(params["scan0"]["a"][0]), 0.6, atol=2e-2
    )


def test_fused_dim_learnable_matches_oracle():
    """The traced-coefficient fused dimension pass (multi-scan, mixed
    causality and orders) equals the sequential oracle."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5, 26)).astype(np.float32)
    scans = [
        (True, 1.0, [0.5, 0.25]),
        (False, 1.1, [0.4]),
        (True, 0.9, [0.3, 0.1, -0.05]),
    ]
    pl = [
        (c, jnp.asarray(b0), jnp.asarray(a, dtype=jnp.float32))
        for c, b0, a in scans
    ]
    got = np.asarray(learnable.fused_dim_learnable(jnp.asarray(x), pl, 7))
    want = x.astype(np.float64)
    for c, b0, a in scans:
        want = scan_core.oracle_apply_scan(want, 1, c, b0, a, BorderMode.ZERO)
    np.testing.assert_allclose(got, want.astype(np.float32),
                               rtol=1e-4, atol=1e-4)


def test_learnable_filter_fused_matches_per_scan():
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.standard_normal((2, 18, 22)).astype(np.float32))
    spec = FilterSpec(
        "LF",
        (Dim("c", 2), Dim("y", 18), Dim("x", 22)),
        (
            Scan(2, True, 1.0, (0.5, 0.2)),
            Scan(2, False, 1.1, (0.4,)),
            Scan(1, True, 0.9, (0.6,)),
        ),
    )
    mf = learnable.LearnableRecFilter(spec, tile_width=6, fused=True)
    ms = learnable.LearnableRecFilter(spec, tile_width=6, fused=False)
    p = mf.init_params()
    np.testing.assert_allclose(
        np.asarray(mf.apply(p, x)), np.asarray(ms.apply(p, x)),
        rtol=1e-4, atol=1e-5,
    )


def test_fir_apply_matches_direct():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 12)).astype(np.float32)
    taps = np.asarray([0.8, -0.3, 0.1], dtype=np.float32)
    for causal in (True, False):
        got = np.asarray(
            learnable.fir_apply(jnp.asarray(x), jnp.asarray(taps), causal, 1)
        )
        want = np.zeros_like(x)
        for m, t in enumerate(taps):
            src = np.zeros_like(x)
            if causal:
                src[:, m:] = x[:, : x.shape[1] - m] if m else x
            else:
                src[:, : x.shape[1] - m] = x[:, m:] if m else x
            want += t * src
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_fir_taps_fit_deconvolution():
    """Numerator taps make the filter a full B(z)/A(z) model: fit it to
    invert a known smoothing filter (deconvolution)."""
    rng = np.random.default_rng(6)
    x = jnp.asarray(rng.standard_normal((8, 32)).astype(np.float32))
    spec = FilterSpec(
        "D", (Dim("r", 8), Dim("c", 32)), (Scan(1, True, 1.0, (0.0,)),)
    )
    model = learnable.LearnableRecFilter(spec, tile_width=8, fir_taps=1)
    # target: y[i] = x[i] - 0.6 x[i-1] + 0.25 y[i-1]  (an ARMA(1,1) model)
    target_params = {
        "scan0": {"b": jnp.asarray([1.0, -0.6]), "a": jnp.asarray([0.25])}
    }
    target = model.apply(target_params, x)

    params = model.init_params()
    opt = optax.adam(3e-2)
    state = opt.init(params)

    @jax.jit
    def step(params, state):
        def loss_fn(p):
            return ((model.apply(p, x) - target) ** 2).mean()

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, state = opt.update(grads, state)
        return optax.apply_updates(params, updates), state, loss

    for _ in range(400):
        params, state, loss = step(params, state)
    assert float(loss) < 1e-5
    np.testing.assert_allclose(
        np.asarray(params["scan0"]["b"]), [1.0, -0.6], atol=3e-2
    )
    np.testing.assert_allclose(
        float(params["scan0"]["a"][0]), 0.25, atol=3e-2
    )


def test_fused_learnable_grad_flows():
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.standard_normal((4, 20)).astype(np.float32))
    pl0 = jnp.asarray([0.5, 0.2])

    def loss(a):
        y = learnable.fused_dim_learnable(
            x, [(True, jnp.asarray(1.0), a), (False, jnp.asarray(1.0), a)], 5
        )
        return (y**2).mean()

    g = jax.grad(loss)(pl0)
    eps = 1e-3
    for i in range(2):
        d = jnp.zeros(2).at[i].set(eps)
        fd = (loss(pl0 + d) - loss(pl0 - d)) / (2 * eps)
        np.testing.assert_allclose(g[i], fd, rtol=5e-2, atol=1e-4)


def test_fused_dim_learnable_clamp_matches_oracle():
    """CLAMP border through the fused traced-coefficient pass (first/last
    tile matrix variants), mixed causality, dividing width."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((5, 24)).astype(np.float32)
    scans = [
        (True, 1.0, [0.5, 0.25]),
        (False, 1.1, [0.4]),
        (True, 0.9, [0.3, 0.1]),
    ]
    pl = [
        (c, jnp.asarray(b0), jnp.asarray(a, dtype=jnp.float32))
        for c, b0, a in scans
    ]
    got = np.asarray(
        learnable.fused_dim_learnable(jnp.asarray(x), pl, 6, clamp=True)
    )
    want = x.astype(np.float64)
    for c, b0, a in scans:
        want = scan_core.oracle_apply_scan(want, 1, c, b0, a, BorderMode.CLAMP)
    np.testing.assert_allclose(got, want.astype(np.float32),
                               rtol=1e-4, atol=1e-4)


def test_learnable_filter_fused_clamp_matches_per_scan():
    """Training parity for the clamped (Gaussian-app-style) filters: the
    fused path equals the per-scan blocked path under CLAMP."""
    rng = np.random.default_rng(9)
    x = jnp.asarray(rng.standard_normal((18, 24)).astype(np.float32))
    spec = FilterSpec(
        "LC",
        (Dim("y", 18), Dim("x", 24)),
        (
            Scan(1, True, 1.0, (0.5, 0.2)),
            Scan(1, False, 1.1, (0.4,)),
            Scan(0, True, 0.9, (0.6,)),
            Scan(0, False, 0.9, (0.3, 0.1)),
        ),
        border=BorderMode.CLAMP,
    )
    mf = learnable.LearnableRecFilter(spec, tile_width=6, fused=True)
    ms = learnable.LearnableRecFilter(spec, tile_width=6, fused=False)
    p = mf.init_params()
    np.testing.assert_allclose(
        np.asarray(mf.apply(p, x)), np.asarray(ms.apply(p, x)),
        rtol=1e-4, atol=1e-5,
    )


def test_fused_learnable_clamp_nondividing_falls_back():
    """Prime-ish width with CLAMP: no dividing tile width ≥ order exists
    above, so apply() falls back per-scan — and stays correct."""
    rng = np.random.default_rng(10)
    x = jnp.asarray(rng.standard_normal((4, 23)).astype(np.float32))
    spec = FilterSpec(
        "LP", (Dim("r", 4), Dim("c", 23)),
        (Scan(1, True, 1.0, (0.5, 0.2)), Scan(1, False, 1.1, (0.4,))),
        border=BorderMode.CLAMP,
    )
    m = learnable.LearnableRecFilter(spec, tile_width=4, fused=True)
    got = np.asarray(m.apply(m.init_params(), x))
    want = np.asarray(x, dtype=np.float64)
    for s in spec.scans:
        want = scan_core.oracle_apply_scan(
            want, s.axis, s.causal, s.feedfwd, s.feedback, BorderMode.CLAMP
        )
    np.testing.assert_allclose(got, want.astype(np.float32),
                               rtol=1e-4, atol=1e-4)


def test_fused_learnable_clamp_grad_flows():
    rng = np.random.default_rng(11)
    x = jnp.asarray(rng.standard_normal((4, 20)).astype(np.float32))
    a0 = jnp.asarray([0.5, 0.2])

    def loss(a):
        y = learnable.fused_dim_learnable(
            x, [(True, jnp.asarray(1.0), a), (False, jnp.asarray(1.0), a)],
            5, clamp=True,
        )
        return (y**2).mean()

    g = jax.grad(loss)(a0)
    eps = 1e-3
    for i in range(2):
        d = jnp.zeros(2).at[i].set(eps)
        fd = (loss(a0 + d) - loss(a0 - d)) / (2 * eps)
        np.testing.assert_allclose(g[i], fd, rtol=5e-2, atol=1e-4)


def test_fused_learnable_kernel_route_matches_einsum_and_grads():
    """The traced-coefficient pass at T=128 matches the T=64 pass, and its
    coefficient gradients agree — with no pallas_call in the traced
    program (the learnable layer runs the same XLA einsums as
    inference)."""
    import jax

    from chip_smoke import has_pallas_call
    from recfilter import learnable

    rng = np.random.default_rng(9)
    x = jnp.asarray(rng.standard_normal((48, 256)).astype(np.float32))
    b0 = jnp.asarray(0.8)
    a = jnp.asarray(np.array([0.5, 0.2], np.float32))
    params = [(True, b0, a), (False, jnp.asarray(0.9),
                              jnp.asarray(np.array([0.4], np.float32)))]

    assert not has_pallas_call(jax.make_jaxpr(
        lambda v: learnable.fused_dim_learnable(v, params, 128))(x))
    got = np.asarray(learnable.fused_dim_learnable(x, params, 128))

    # another tile width
    want = np.asarray(learnable.fused_dim_learnable(x, params, 64))
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())

    # coefficient gradients at both tile widths
    ct = jnp.asarray(rng.standard_normal((48, 256)).astype(np.float32))

    def loss(b0v, av, tile):
        p = [(True, b0v, av), params[1]]
        return (learnable.fused_dim_learnable(x, p, tile) * ct).sum()

    g_k = jax.grad(loss, argnums=(0, 1))(b0, a, 128)
    g_e = jax.grad(loss, argnums=(0, 1))(b0, a, 64)
    for gk, ge in zip(g_k, g_e):
        np.testing.assert_allclose(np.asarray(gk), np.asarray(ge),
                                   rtol=1e-4, atol=1e-4)
