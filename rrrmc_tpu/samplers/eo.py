"""extremal_opt: tau-extremal optimization ground-state search.

Semantics follow /root/reference/src/RRRMC.jl:474-521: rank all spins by dE
ascending (ties broken uniformly at random), draw a rank k with P(k)
proportional to k^{-tau}, flip that spin unconditionally, track the minimum
energy configuration seen.

Vectorized formulation: the reference maintains sorted class buckets with
cumulative rank weights f_tau (EOCache, /root/reference/src/DeltaE.jl:424-554)
or a full sortperm per move for continuous graphs (:556-635). Here each move
samples the rank by inverse CDF on a precomputed static cumulative k^{-tau}
table, then selects the rank-th order statistic of the dense dE vector with
exact uniform tie-breaking (count-within-equal-class trick) — O(N log N)
vectorized over the whole batch, no mutable buckets.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..core.model import Model
from ..core.struct import pytree
from .common import DEFAULT_SEED, MCState, init_state


@pytree
class EOResult:
    sigma: jnp.ndarray    # [B, N] final configurations
    E: jnp.ndarray        # [B] final physical energies
    Emin: jnp.ndarray     # [B] best physical energies found
    sigma_min: jnp.ndarray  # [B, N] best configurations
    itmin: jnp.ndarray    # [B] iteration of the best configuration


def _rank_cdf(n: int, tau: float) -> np.ndarray:
    """Cumulative P(rank <= k) with P(k) ~ k^{-tau} (the f_tau table,
    /root/reference/src/DeltaE.jl:434-441)."""
    w = np.arange(1, n + 1, dtype=np.float64) ** (-tau)
    c = np.cumsum(w)
    return c / c[-1]


def select_rank_with_ties(key, dE, rank):
    """Index of the `rank`-th smallest entry of dE, uniformly random among
    equal values (the rankshuffle! analog, /root/reference/src/DeltaE.jl:612)."""
    n = dE.shape[0]
    sorted_vals = jnp.sort(dE)
    v = sorted_vals[rank]
    eq = dE == v
    lo = jnp.searchsorted(sorted_vals, v, side="left")
    hi = jnp.searchsorted(sorted_vals, v, side="right")
    j = jax.random.randint(key, (), 0, jnp.maximum(hi - lo, 1))
    csum = jnp.cumsum(eq.astype(jnp.int32))
    return jnp.argmax(csum == (j + 1))


def make_eo_move(model: Model, tau: float, cdf):
    def move1(carry):
        sigma, aux, E, key, Emin, smin, itmin, it = carry
        key, k_rank, k_tie = jax.random.split(key, 3)
        dE = model.delta_all(sigma, aux)
        u = jax.random.uniform(k_rank, (), cdf.dtype)
        rank = jnp.searchsorted(cdf, u, side="right")
        rank = jnp.clip(rank, 0, model.N - 1)
        i = select_rank_with_ties(k_tie, dE, rank)
        sigma, aux = model.flip(sigma, aux, i, jnp.asarray(True))
        E = E + dE[i]
        it = it + 1
        better = E < Emin
        Emin = jnp.where(better, E, Emin)
        smin = jnp.where(better, sigma, smin)
        itmin = jnp.where(better, it, itmin)
        return sigma, aux, E, key, Emin, smin, itmin, it

    return move1


@partial(jax.jit, static_argnames=("iters",))
def _eo_run_xla(model, cdf, state: MCState, iters: int):
    move1 = make_eo_move(model, 0.0, cdf)  # tau is baked into cdf
    batched = jax.vmap(lambda *c: move1(c))

    def body(carry, _):
        return batched(*carry), None

    it0 = jnp.zeros(state.E.shape[0], jnp.int32)
    carry = (state.sigma, state.aux, state.E, state.key,
             state.E, state.sigma, it0, it0)
    carry, _ = jax.lax.scan(body, carry, None, length=iters)
    sigma, aux, E, key, Emin, smin, itmin, it = carry
    return sigma, E, Emin, smin, itmin


@jax.jit
def _to_phys_batch(model, E):
    """Module-level jit (a per-call jax.jit(vmap(...)) recompiles every
    call; see samplers/common.py:92)."""
    return jax.vmap(model.to_physical)(E)


def extremal_opt(model: Model, tau: float, iters: int, *, step: int = 1,
                 chains: int = 1, seed: int = DEFAULT_SEED, C0=None,
                 state: Optional[MCState] = None,
                 backend: str = "auto") -> EOResult:
    """Ground-state search; returns an EOResult (the analog of the
    reference's (C, Emin, Cmin, itmin) tuple).

    backend: "auto" / "xla" run the XLA path; there is no kernel route, so
    "pallas" raises ValueError."""
    from .common import choose_route, set_route

    choose_route("extremal_opt", model, backend=backend, state=state)
    if state is None:
        state = init_state(model, chains, seed, C0)
    set_route("xla")
    cdf = jnp.asarray(_rank_cdf(model.N, float(tau)))
    sigma, E, Emin, smin, itmin = _eo_run_xla(model, cdf, state, iters)
    return EOResult(sigma=sigma, E=_to_phys_batch(model, E),
                    Emin=_to_phys_batch(model, Emin),
                    sigma_min=smin, itmin=itmin)
