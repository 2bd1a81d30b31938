"""The card's smoke phases as tests (skipped where JAX finds no GPU).

Each case runs one phase of ``chip_smoke.py`` at full size — the public
entry points against the plain references, no ``pallas_call`` in the
traced program. On the card, in one process (never under xdist):

    RECFILTER_TEST_GPU=1 python -m pytest tests -m gpu -q
"""

import pytest

import chip_smoke as cs

pytestmark = pytest.mark.gpu

_PHASES = cs.one_card_phases(cs.FULL)


@pytest.mark.parametrize("i", range(len(_PHASES)),
                         ids=[f"{p.name}-{p.grade}" for p in _PHASES])
def test_smoke_phase_on_card(gpu, i):
    rec = cs.run_phase(_PHASES[i], card="pytest", reps=1)
    assert rec["err"] <= rec["bound"]
