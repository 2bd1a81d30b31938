"""Utility subsystem tests: timing, CLI args, image IO, check helpers."""

import numpy as np
import pytest

from recfilter.utils import image_io, timing
from recfilter.utils.args import Arguments
from recfilter.utils.testing import (
    CheckResult,
    CheckResultVerbose,
    assert_close,
    generate_random_image,
)


def test_throughput_units():
    # 2^20 pixels in 1000 ms = 1 MiP/s (lib/timing.cpp:3-5)
    assert timing.throughput(1000.0, 2**20) == pytest.approx(1.0)
    assert timing.mpix_per_sec(1000.0, 10**6) == pytest.approx(1.0)


def test_arguments_defaults():
    a = Arguments([])
    assert (a.width, a.block, a.iterations) == (4096, 32, 1)
    assert not a.nocheck


def test_arguments_sweep_forces_nocheck():
    assert Arguments(["--width", "0"]).nocheck
    assert Arguments(["--iter", "5"]).nocheck


def test_generate_random_image_default_ones():
    img = generate_random_image(4, 5)
    assert img.shape == (4, 5)
    assert (img == 1).all()


def test_check_result_relative_error():
    ref = np.ones((4, 4))
    out = ref.copy()
    out[0, 0] = 1.16
    st = CheckResult(ref, out)
    assert st.max_error == pytest.approx(100.0 * 0.16 / 16.0)
    assert "Max relative error" in repr(CheckResultVerbose(ref, out))
    with pytest.raises(AssertionError):
        assert_close(ref, out, max_rel_pct=1e-6)


def test_png_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    for shape in [(7, 9), (8, 6, 3), (5, 5, 4)]:
        a = (rng.random(shape) * 255).astype(np.uint8)
        p = str(tmp_path / "t.png")
        image_io.save_png(p, a)
        b = image_io.load_png(p, dtype=np.uint8)
        np.testing.assert_array_equal(a, b)


def test_png_float_scaling(tmp_path):
    a = np.linspace(0, 1, 64, dtype=np.float32).reshape(8, 8)
    p = str(tmp_path / "f.png")
    image_io.save_png(p, a)
    b = image_io.load_png(p)
    assert b.dtype == np.float32
    np.testing.assert_allclose(a, b, atol=1 / 255.0)


def test_ppm_roundtrip(tmp_path):
    rng = np.random.default_rng(1)
    a = (rng.random((6, 7, 3)) * 255).astype(np.uint8)
    p = str(tmp_path / "t.ppm")
    image_io.save_ppm(p, a)
    np.testing.assert_array_equal(a, image_io.load_ppm(p, dtype=np.uint8))


def test_log_sink(tmp_path):
    p = str(tmp_path / "x.perflog")
    log = timing.Log(p)
    log << "a" << "\t" << 1 << "\n"
    log.close()
    assert open(p).read() == "a\t1\n"
