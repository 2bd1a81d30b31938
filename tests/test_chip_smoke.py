"""chip_smoke.py on the CPU: every phase's route at a small size (no
``pallas_call`` in any traced program, each check within its bound), the
four-card phase on four virtual devices, the device check, and the result
line. The card itself runs the full sizes (``python chip_smoke.py``)."""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

import chip_smoke as cs

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PHASES = cs.one_card_phases(cs.TINY)


@pytest.mark.parametrize("i", range(len(_PHASES)),
                         ids=[f"{p.name}-{p.grade}" for p in _PHASES])
def test_phase_route_has_no_pallas_call_and_holds_bound(i):
    rec = cs.run_phase(_PHASES[i], card="cpu", reps=1)
    assert rec["err"] <= rec["bound"]


@pytest.mark.parametrize("i", range(3))
def test_four_card_phase_on_virtual_devices(i):
    devices = jax.devices()[:4]
    assert len(devices) == 4
    ph = cs.four_card_phases(cs.TINY["mesh_img"], devices)[i]
    rec = cs.run_phase(ph, card="cpu", reps=1)
    assert rec["err"] <= rec["bound"]


def test_has_pallas_call_detects_a_kernel():
    """The route guard must see a pallas_call, also inside a jit."""
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    def double(x_ref, o_ref):
        o_ref[...] = x_ref[...] * 2.0

    def kern(x):
        return pl.pallas_call(
            double, out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
            interpret=True)(x)

    x = jnp.ones((8, 128), jnp.float32)
    assert cs.has_pallas_call(jax.make_jaxpr(jax.jit(kern))(x))
    assert not cs.has_pallas_call(jax.make_jaxpr(jax.jit(lambda v: v * 2))(x))


@pytest.mark.parametrize("backend", ["cpu", "rocm", "METAL"])
def test_require_gpu_refuses_other_backends(backend):
    with pytest.raises(SystemExit):
        cs.require_gpu(backend)
    cs.require_gpu("gpu")


def test_result_line_format():
    class Dev:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

    line = cs.result_line([Dev()] * 4)
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}
    assert "\n" not in line


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, os.path.join(cwd, "chip_smoke.py")], cwd=cwd,
        env=env, capture_output=True, text=True, timeout=300)


def test_smoke_script_fails_without_gpu():
    r = _run_smoke(_REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_smoke_script_fails_alone(tmp_path):
    shutil.copy(os.path.join(_REPO, "chip_smoke.py"), tmp_path)
    r = _run_smoke(str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
