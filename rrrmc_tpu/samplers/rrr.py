"""rrrMC: reduced-rejection-rate Monte Carlo (the package's namesake).

Semantics follow /root/reference/src/RRRMC.jl:149-290. Per move:

1. sample spin i proportionally to w_i = min(1, e^{-beta dE0_i}) computed on
   the *inner* model (for single models, the model itself), with z = sum w;
2. compute z' = sum of the same weights as if i were flipped (the staged
   reverse-probability z', /root/reference/src/DeltaE.jl:184-230 — here a
   hypothetical functional flip followed by one fused weight pass, which makes
   the subtle two-phase bucket bookkeeping unnecessary);
3. accept with probability min(1, (z/z') * e^{-beta dE1}) where dE1 is the
   residual energy change for DoubleGraph-style models (`accept(c, x)`,
   /root/reference/src/RRRMC.jl:40-44,262) — dE1 = 0 for single models, in
   which case this reduces to the SingleGraph path (rand() < z/z',
   /root/reference/src/RRRMC.jl:192).

The reference's adaptive direct/staged switch (acc_rate EMA vs staged_thr,
/root/reference/src/RRRMC.jl:189-210) selects between two *implementations*
of the identical Markov kernel (eager flip + undo vs staged commit) to save
serial-CPU work; vectorized, one branchless implementation serves both, so
`staged_thr` is accepted for API parity but has no effect.
"""

from __future__ import annotations

import math
from typing import Optional

import jax
import jax.numpy as jnp

from ..core.model import Model
from .common import (DEFAULT_SEED, MCState, init_state, run_with_hook,
                     series_to_chain_major)
from .moves import (acceptance_weights, accept_factor,
                    categorical_from_weights, inner_view, tree_where)


def make_rrr_step(model: Model, beta):
    inner, get_iaux = inner_view(model)
    is_double = model.inner is not None

    def weights(sigma, aux):
        dE0 = inner.delta_all(sigma, get_iaux(aux))
        return dE0, acceptance_weights(inner.to_physical(dE0), beta)

    def step1(sigma, aux, E, key, accepted):
        key, k_mv, k_acc = jax.random.split(key, 3)
        dE0, w = weights(sigma, aux)
        i, z = categorical_from_weights(k_mv, w)
        dE1 = model.residual_delta_one(sigma, aux, i) if is_double else None

        # hypothetical flip -> z' (staged reverse probabilities)
        s2, a2 = model.flip(sigma, aux, i, jnp.asarray(True))
        _, w2 = weights(s2, a2)
        z2 = jnp.sum(w2)

        x = -beta * dE1 if is_double else jnp.zeros((), jnp.float32)
        acc = accept_factor(k_acc, z / z2, x)

        sigma, aux = tree_where(acc, (s2, a2), (sigma, aux))
        if is_double:
            dtot = inner.to_physical(dE0[i]) + dE1
        else:
            dtot = dE0[i]
        E = E + jnp.where(acc, dtot, jnp.zeros_like(dtot))
        return sigma, aux, E, key, accepted + acc.astype(jnp.int32)

    return step1


def rrrMC(model: Model, beta: float, iters: int, *, step: int = 1,
          chains: int = 1, seed: int = DEFAULT_SEED, C0=None,
          observer=None, hook=None, hook_every: int = 10,
          state: Optional[MCState] = None, backend: str = "auto",
          staged_thr: float = None, staged_thr_fact: float = 5.0):
    """Reduced-rejection-rate MC; same call surface as standardMC.

    Returns (Es [chains, iters // step], final MCState).

    backend: "auto" / "xla" run the XLA path; there is no kernel route, so
    "pallas" raises ValueError."""
    from .common import choose_route, set_route

    del staged_thr, staged_thr_fact  # kernel-identical branches; see docstring
    if not math.isfinite(beta):
        raise ValueError(f"beta must be finite, given: {beta}")
    choose_route("rrrMC", model, backend=backend, state=state)
    if state is None:
        state = init_state(model, chains, seed, C0)
    set_route("xla")
    state, series = run_with_hook(model, state, float(beta), make_rrr_step,
                                  iters // step, step, observer,
                                  hook, hook_every)
    return series_to_chain_major(series), state
