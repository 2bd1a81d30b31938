"""Native C++ host library vs the pure-python implementations.

Builds ``native/librecfilter_host.so`` on demand (make) and checks every
entry point bit-matches its numpy twin.
"""

import numpy as np
import pytest

from recfilter import coeffs, iir
from recfilter.utils import native


@pytest.fixture(scope="module", autouse=True)
def built():
    if not native.available() and not native.build():
        pytest.skip("native toolchain unavailable")


@pytest.fixture()
def pure():
    """Force the pure-python path inside coeffs for comparison."""
    coeffs.USE_NATIVE = False
    coeffs._carry_chain_cached.cache_clear()
    yield
    coeffs.USE_NATIVE = True
    coeffs._carry_chain_cached.cache_clear()


CASES = [
    (1.0, [1.0]),
    (1.2, [0.8, -0.3]),
    (0.9, [0.6, 0.25, -0.1]),
]


@pytest.mark.parametrize("feedfwd,feedback", CASES)
@pytest.mark.parametrize("clamp", [False, True])
def test_impulse_matrix(pure, feedfwd, feedback, clamp):
    want = coeffs.impulse_matrix(feedfwd, feedback, 16, clamp)
    got = native.impulse_matrix(feedfwd, feedback, 16, clamp)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("feedfwd,feedback", CASES)
def test_state_matrix(pure, feedfwd, feedback):
    want = coeffs.state_matrix(feedback, 16)
    got = native.state_matrix(feedback, 16)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("feedfwd,feedback", CASES)
def test_tail_weight_matrix(pure, feedfwd, feedback):
    want = coeffs.tail_weight_matrix(feedback, 16)
    got = native.tail_weight_matrix(feedback, 16)
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=1e-14)


@pytest.mark.parametrize("feedfwd,feedback", CASES)
@pytest.mark.parametrize("prev", [False, True])
def test_carry_chain_matrix(pure, feedfwd, feedback, prev):
    want = coeffs.carry_chain_matrix(feedback, 8, 6, prev)
    got = native.carry_chain_matrix(feedback, 8, 6, prev)
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("order", [1, 2, 3])
def test_gaussian_weights(order):
    want = iir.gaussian_weights(2.5, order)
    got = native.gaussian_weights(2.5, order)
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_overlap_feedback():
    a = [0.5, 0.25]
    b = [0.3, -0.1, 0.05]
    want = iir.overlap_feedback_coeff(a, b)
    got = native.overlap_feedback_coeff(a, b)
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-14)


def test_native_ppm_roundtrip(tmp_path):
    rng = np.random.default_rng(7)
    for shape in [(6, 9), (5, 4, 3)]:
        a = (rng.random(shape) * 255).astype(np.uint8)
        p = str(tmp_path / "n.ppm")
        native.ppm_write(p, a)
        b = native.ppm_read(p)
        np.testing.assert_array_equal(a.reshape(b.shape), b)
        # cross-check with the pure-python reader
        from recfilter.utils import image_io

        c = image_io.load_ppm(p, dtype=np.uint8)
        np.testing.assert_array_equal(b, c)
