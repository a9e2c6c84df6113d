"""extremal_opt (integer and float energies) and the dense sweep on the
model families the removed kernels served, on the XLA path."""

import jax
import numpy as np
import pytest

import rrrmc_tpu as rt
from rrrmc_tpu.analysis import energy_table
from _families import (BETA, FAMILIES, assert_invariant, assert_law,
                       family)

EO_FAMILIES = [n for n in FAMILIES if n not in ("QuantRRG", "RERRG")]


@pytest.mark.parametrize("name", EO_FAMILIES)
def test_eo_family_ground_state(name):
    """Tracked final and best energies equal the recomputed ones, and the
    best over chains is the exact ground state."""
    model = family(name)
    res = rt.extremal_opt(model, 1.4, 1500, chains=16, seed=11)
    assert rt.LAST_ROUTE["backend"] == "xla"
    phys = jax.jit(jax.vmap(lambda s: model.to_physical(model.energy(s))))
    np.testing.assert_allclose(np.asarray(res.E), np.asarray(phys(res.sigma)),
                               atol=1e-9)
    np.testing.assert_allclose(np.asarray(res.Emin),
                               np.asarray(phys(res.sigma_min)), atol=1e-9)
    e0 = energy_table(model).min()
    assert np.asarray(res.Emin).min() == pytest.approx(e0, abs=1e-9)


@pytest.mark.parametrize("name", ["SKInt", "SKFloat"])
def test_dense_sweep_family_invariant_and_law(name):
    model = family(name)
    Es, state = rt.sweepMC(model, BETA, 400, step=10, chains=64, seed=12)
    assert rt.LAST_ROUTE["backend"] == "xla"
    assert_invariant(model, state)
    assert_law(model, Es)
