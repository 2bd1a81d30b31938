"""Closure-matrix unit tests: B, R, P, W against the numpy oracle.

Validates the tiling algebra's building blocks the way the reference
validates tiled-vs-loop-nest (``tests/README.md``), but at the matrix level:
the impulse matrix must reproduce a zero-state scan, the state matrix must
reproduce the response to a seeded incoming state, and the carry-chain matrix
must solve the cross-tile recurrence exactly.
"""

import numpy as np
import pytest

from recfilter import coeffs
from recfilter.scan_core import oracle_apply_scan
from recfilter.spec import BorderMode

CASES = [
    (1.0, [1.0]),  # summed-area table
    (0.5, [0.5]),
    (1.2, [0.8, -0.3]),
    (0.9, [0.6, 0.25, -0.1]),  # 3rd order, mixed signs
]


@pytest.mark.parametrize("feedfwd,feedback", CASES)
def test_impulse_matrix_matches_zero_state_scan(feedfwd, feedback):
    T = 8
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, T))
    B = coeffs.impulse_matrix(feedfwd, feedback, T)
    got = x @ B.T
    want = oracle_apply_scan(x, 1, True, feedfwd, feedback, BorderMode.ZERO)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("feedfwd,feedback", CASES)
def test_impulse_matrix_clamp_matches_clamped_scan(feedfwd, feedback):
    T = 8
    rng = np.random.default_rng(1)
    x = rng.standard_normal((5, T))
    B = coeffs.impulse_matrix(feedfwd, feedback, T, clamp_border=True)
    got = x @ B.T
    want = oracle_apply_scan(x, 1, True, feedfwd, feedback, BorderMode.CLAMP)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("feedfwd,feedback", CASES)
def test_state_matrix_matches_seeded_scan(feedfwd, feedback):
    """R[:, j] must equal the zero-input response to s[j]=1, where s[j] is
    the scan value at position -1-j. Verified by running the oracle on a
    longer array whose first k entries realize the desired state."""
    T, k = 8, len(feedback)
    R = coeffs.state_matrix(feedback, T)
    # Identity check: the scan of [p | x] restricted to the x-part equals
    # B @ x + R @ s, where s holds the last k outputs of the p-part.
    rng = np.random.default_rng(2)
    P = 6
    full = rng.standard_normal((4, P + T))
    out = oracle_apply_scan(full, 1, True, feedfwd, feedback, BorderMode.ZERO)
    s = np.stack([out[:, P - 1 - j] for j in range(k)], axis=-1)  # (4, k)
    B = coeffs.impulse_matrix(feedfwd, feedback, T)
    got = full[:, P:] @ B.T + s @ R.T
    np.testing.assert_allclose(got, out[:, P:], rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("feedfwd,feedback", CASES)
def test_carry_chain_solves_recurrence(feedfwd, feedback):
    """s_t = W s_{t-1} + b_t, solved in closed form by carry_chain_matrix."""
    k = len(feedback)
    T, n = 4, 7
    W = coeffs.tail_weight_matrix(feedback, T)
    rng = np.random.default_rng(3)
    b = rng.standard_normal((n, k))

    s_seq = np.zeros((n, k))
    s = np.zeros(k)
    s_prev_seq = np.zeros((n, k))
    for t in range(n):
        s_prev_seq[t] = s
        s = W @ s + b[t]
        s_seq[t] = s

    M = coeffs.carry_chain_matrix(feedback, T, n, prev=False)
    np.testing.assert_allclose(
        (M @ b.ravel()).reshape(n, k), s_seq, rtol=1e-10, atol=1e-10
    )
    Mp = coeffs.carry_chain_matrix(feedback, T, n, prev=True)
    np.testing.assert_allclose(
        (Mp @ b.ravel()).reshape(n, k), s_prev_seq, rtol=1e-10, atol=1e-10
    )


def test_tail_weight_is_projected_state_matrix():
    fb = [0.6, 0.25, -0.1]
    T = 8
    W = coeffs.tail_weight_matrix(fb, T)
    R = coeffs.state_matrix(fb, T)
    P = coeffs.tail_projector(T, 3)
    np.testing.assert_allclose(W, P @ R, rtol=1e-14)
    assert W.shape == (3, 3)


def test_antidiagonal():
    A = coeffs.antidiagonal(4)
    x = np.arange(4.0)
    np.testing.assert_allclose(A @ x, x[::-1])
