"""standardMC: Metropolis with uniform single-spin proposals.

Vectorized analog of /root/reference/src/RRRMC.jl:81-127: per move each chain
draws a uniform site, computes dE from the local-field aux in O(1), accepts
with min(1, e^{-beta dE}) (accept, /root/reference/src/RRRMC.jl:39), and
applies a masked O(degree) flip. Checkpoint energies are recorded every
`step` moves.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from ..core.model import Model
from .common import (DEFAULT_SEED, MCState, choose_route, init_state,
                     run_with_hook, series_to_chain_major, set_route)


def metropolis_accept(key, x):
    """Accept iff x >= 0 or u < e^x (reference `accept`,
    /root/reference/src/RRRMC.jl:39), branchless."""
    u = jax.random.uniform(key, (), jnp.float32)
    return (x >= 0) | (u < jnp.exp(jnp.minimum(x, 0.0)).astype(jnp.float32))


def make_metropolis_step(model: Model, beta: float):
    n = model.N

    def step1(sigma, aux, E, key, accepted):
        key, k_site, k_acc = jax.random.split(key, 3)
        i = jax.random.randint(k_site, (), 0, n)
        dE = model.delta_one(sigma, aux, i)
        acc = metropolis_accept(k_acc, -beta * model.to_physical(dE))
        sigma, aux = model.flip(sigma, aux, i, acc)
        E = E + jnp.where(acc, dE, jnp.zeros_like(dE))
        return sigma, aux, E, key, accepted + acc.astype(jnp.int32)

    return step1


def standardMC(model: Model, beta: float, iters: int, *, step: int = 1,
               chains: int = 1, seed: int = DEFAULT_SEED, C0=None,
               observer=None, hook=None, hook_every: int = 10,
               state: Optional[MCState] = None, backend: str = "auto"):
    """Run `iters` Metropolis moves per chain; returns (Es, state).

    Es: [chains, iters // step] physical energies at each checkpoint.
    state: final MCState (state.sigma is the C0-style warm restart handle).
    hook(it, model, state) -> bool is the reference hook protocol
    (/root/reference/src/RRRMC.jl:61-64): called every `hook_every`
    checkpoints; returning False stops early.

    Reference-faithful: every chain draws its own site sequence. backend:
    "auto" / "xla" run the XLA path; there is no kernel route, so
    "pallas" raises ValueError.
    """
    choose_route("standardMC", model, backend=backend, state=state)
    if state is None:
        state = init_state(model, chains, seed, C0)
    set_route("xla")
    state, series = run_with_hook(model, state, float(beta),
                                  make_metropolis_step,
                                  iters // step, step, observer,
                                  hook, hook_every)
    return series_to_chain_major(series), state
