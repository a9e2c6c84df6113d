"""rrrMC on every model family the removed kernels served, on the XLA path:
exact energy invariant and agreement with exact enumeration."""

import pytest

import rrrmc_tpu as rt
from _families import BETA, FAMILIES, assert_invariant, assert_law, family


@pytest.mark.parametrize("name", list(FAMILIES))
def test_rrr_family_invariant_and_law(name):
    model = family(name)
    Es, state = rt.rrrMC(model, BETA, iters=3000, step=50, chains=64, seed=8)
    assert rt.LAST_ROUTE["backend"] == "xla"
    assert_invariant(model, state)
    assert_law(model, Es)
