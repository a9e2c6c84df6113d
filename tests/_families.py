"""Model families shared by the per-sampler family tests: tiny instances
(N <= 12) whose exact 2^N Boltzmann law is enumerable, one per family the
XLA single-move samplers serve (SAT K=2..7, PSpin3, perceptrons, committee,
replica composites over a sparse base, dense int / float SK)."""

import jax
import numpy as np

import rrrmc_tpu as rt
from rrrmc_tpu.analysis import energy_table

BETA = 1.0

FAMILIES = {
    **{f"SAT{k}": (lambda k=k: rt.GraphSAT(10, k, 2.0, seed=40 + k))
       for k in range(2, 8)},
    "PSpin3": lambda: rt.GraphPSpin3(9, 2, seed=50),
    "PercStep": lambda: rt.GraphPercStep(11, 6, seed=51),
    "PercLinear": lambda: rt.GraphPercLinear(11, 6, seed=52),
    "PercXEntr": lambda: rt.GraphPercXEntr(11, 6, 1.0, seed=53),
    "CommStep": lambda: rt.GraphCommStep(3, 3, 5, seed=54),
    "QuantRRG": lambda: rt.GraphQuant(4, 3, 0.5, BETA,
                                      rt.GraphRRG(4, 3, (-1, 1), seed=55)),
    "RERRG": lambda: rt.GraphRobustEnsemble(
        4, 3, 0.5, BETA, rt.GraphRRG(4, 3, (-1, 1), seed=56)),
    "SKInt": lambda: rt.GraphSK(10, seed=57),
    "SKFloat": lambda: rt.GraphSKNormal(10, seed=58),
}

_CACHE = {}


def family(name):
    if name not in _CACHE:
        _CACHE[name] = FAMILIES[name]()
    return _CACHE[name]


def exact_mean_energy(model, beta=BETA):
    E = energy_table(model)
    w = np.exp(-beta * (E - E.min()))
    return float((w * E).sum() / w.sum())


def assert_invariant(model, state):
    """Tracked energy equals the recomputed one: exactly for integer energy
    domains, to float rounding otherwise."""
    E_re = np.asarray(jax.jit(jax.vmap(model.energy))(state.sigma))
    E = np.asarray(state.E)
    if np.issubdtype(E.dtype, np.integer):
        np.testing.assert_array_equal(E, E_re)
    else:
        np.testing.assert_allclose(E, E_re, atol=1e-9)


def assert_law(model, Es, tol=0.05):
    """Equilibrium mean energy (second half of the series) agrees with exact
    enumeration within 5 correlated standard errors."""
    Es = np.asarray(Es, np.float64)[:, Es.shape[1] // 2:]
    exact = exact_mean_energy(model)
    err = abs(Es.mean() - exact)
    sem = Es.mean(axis=1).std() / np.sqrt(Es.shape[0])
    assert err < max(5 * sem, tol * max(1.0, abs(exact))), (err, sem, exact)
