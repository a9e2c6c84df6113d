"""wtmMC: rejection-free waiting-time method (Dall & Sibani).

Semantics follow /root/reference/src/RRRMC.jl:376-422 and
/root/reference/src/WaitingTimes.jl: every spin carries an exponential firing
time with mean tau_i = max(1, e^{beta dE_i}); the earliest clock fires, that
spin flips, and affected clocks are redrawn at the new global time. Global
time replaces the iteration counter; `step` is a Float64 measured in global
time scaled by 1/N (/root/reference/src/RRRMC.jl:392).

Vectorized formulation: the times live in a dense [N] vector; `pick_next` is
an argmin (one vector reduction) instead of a mutable binary heap
(/root/reference/src/WaitingTimes.jl:13-37), and after each flip ALL clocks
are redrawn at the current time. By memorylessness of the exponential clocks
this is distributionally identical to the reference's redraw-only-neighbors
update (unfired exponential clocks may be resampled at any instant), and it
turns a heap walk into one fused vector op over the batch.

Checkpoints use the same stream-fill mechanism as bklMC, with float global
time as the coordinate (drain loop analog, /root/reference/src/RRRMC.jl:402).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from ..core.model import Model
from ..core.dtypes import ftype
from .common import DEFAULT_SEED, MCState, init_state
from .bkl import _fill_checkpoints


def draw_times(key, model: Model, sigma, aux, beta, t_now):
    """Fresh absolute firing times: t_now + Exp(mean tau_i),
    tau_i = max(1, e^{beta dE_i}) (THeap init,
    /root/reference/src/WaitingTimes.jl:15-35)."""
    dE = model.to_physical(model.delta_all(sigma, aux))
    # wt = -tau * log1p(-u); tau = 1/min(1, e^{-beta dE}) = max(1, e^{beta dE})
    log_tau = jnp.maximum(beta * dE, 0.0)
    u = jax.random.uniform(key, dE.shape, dE.dtype)
    wt = -jnp.exp(log_tau) * jnp.log1p(-u)
    return t_now + wt


def make_wtm_move(model: Model, beta, tmax):
    # models with an affected-spin table (Pairwise family, and all composite
    # wrappers via their neighbor_table overrides) redraw only the flipped
    # spin's clock and its affected spins' — the reference's exact update
    # (/root/reference/src/WaitingTimes.jl:39-51), O(deg) RNG +
    # transcendentals per move instead of O(N); fully-connected models redraw
    # everything (reference-parity: their `neighbors` is AllButOne,
    # /root/reference/src/graphs/SK.jl:165; valid by memorylessness)
    neigh = model.neighbor_table()

    def move1(sigma, aux, E, key, accepted, t, times):
        active = t < tmax
        key, k_redraw = jax.random.split(key)
        i = jnp.argmin(times)
        t_new = jnp.where(active, times[i], t)
        dE = model.delta_one(sigma, aux, i)
        sigma, aux = model.flip(sigma, aux, i, active)
        E = E + jnp.where(active, dE, jnp.zeros_like(dE))
        if neigh is None:
            fresh = draw_times(k_redraw, model, sigma, aux, beta, t_new)
            times = jnp.where(active, fresh, times)
        else:
            idx = jnp.concatenate([i[None], neigh[i]])   # [K+1]; pad = N
            # one vectorized delta_all pass (cheap: elementwise off aux for
            # most models), gathered at the affected spins with a zero
            # sentinel slot; RNG/exp/log run only on the [K+1] slice
            dE_all = model.to_physical(model.delta_all(sigma, aux))
            dEs = jnp.concatenate(
                [dE_all, jnp.zeros((1,), dE_all.dtype)])[idx]
            log_tau = jnp.maximum(beta * dEs, 0.0)
            u = jax.random.uniform(k_redraw, idx.shape, times.dtype)
            wt = -jnp.exp(log_tau) * jnp.log1p(-u)
            tgt = jnp.where(active, idx, model.N)        # drop when inactive
            times = times.at[tgt].set(t_new + wt, mode="drop")
        accepted = accepted + active.astype(jnp.int32)
        return sigma, aux, E, key, accepted, t_new, times

    return move1


def _wtm_chunk_body(model, beta, tmax, step_t, chunk_moves, state: MCState,
                    t, times, Es, observer=None):
    move1 = make_wtm_move(model, beta, tmax)
    batched = jax.vmap(move1)
    obs_fn = (jax.vmap(partial(observer, model)) if observer is not None
              else lambda s, a, E: jax.vmap(model.to_physical)(E))

    def do_move(carry):
        s, t, times = carry
        sigma, aux, E, key, accepted, t, times = batched(
            s.sigma, s.aux, s.E, s.key, s.accepted, t, times)
        return (MCState(sigma=sigma, aux=aux, E=E, key=key,
                        accepted=accepted), t, times)

    def body(carry, _):
        # straggler tail skip — see samplers/bkl.py chunk body
        s, t, times = jax.lax.cond(jnp.min(carry[1]) >= tmax,
                                   lambda c: c, do_move, carry)
        return (s, t, times), (t, obs_fn(s.sigma, s.aux, s.E))

    t_start = t
    o_start = obs_fn(state.sigma, state.aux, state.E)
    (state, t, times), (ts, ovs) = jax.lax.scan(
        body, (state, t, times), None, length=chunk_moves)
    Es = _fill_checkpoints(Es, step_t, t_start, o_start, ts, ovs)
    return state, t, times, Es


_wtm_chunk = partial(jax.jit, static_argnames=("chunk_moves",
                                               "observer"))(_wtm_chunk_body)


@partial(jax.jit, static_argnames=("chunk_moves", "observer"))
def _wtm_run(model, beta, tmax, step_t, chunk_moves, state: MCState,
             t, times, Es, observer=None):
    """Whole hookless run in ONE jit (see bkl._bkl_run)."""
    def cond(carry):
        _, t, _, _ = carry
        return jnp.min(t) < tmax

    def body(carry):
        state, t, times, Es = carry
        return _wtm_chunk_body(model, beta, tmax, step_t, chunk_moves,
                               state, t, times, Es, observer)

    return jax.lax.while_loop(cond, body, (state, t, times, Es))


def wtmMC(model: Model, beta: float, samples: int, *, step: float = 1.0,
          chains: int = 1, seed: int = DEFAULT_SEED, C0=None,
          chunk_moves: int = 512, hook=None, observer=None,
          state: Optional[MCState] = None, backend: str = "auto"):
    """Waiting-time method; collects up to `samples` checkpoints spaced
    `step` (scaled by 1/N) in global time. Returns (Es [chains, samples],
    final MCState). hook(t, model, state) -> False stops early.
    observer(model, sigma, aux, E) replaces checkpoint energies with any
    per-chain observable (snapshots for the overlap pipeline etc.).

    backend: "auto" / "xla" run the XLA path; there is no kernel route, so
    "pallas" raises ValueError."""
    from .common import choose_route, set_route

    choose_route("wtmMC", model, backend=backend, state=state)
    if state is None:
        state = init_state(model, chains, seed, C0)
    ft = ftype()
    step_t = float(step) / model.N
    tmax = step_t * samples
    set_route("xla")
    key_times = jax.vmap(
        lambda k: jax.random.fold_in(k, 0x77777))(state.key)
    times = jax.jit(jax.vmap(
        lambda k, s, a: draw_times(k, model, s, a, float(beta),
                                   jnp.zeros((), ft))))(
        key_times, state.sigma, state.aux)
    t = jnp.zeros(chains, ft)
    from .bkl import _series_buffer
    Es = _series_buffer(model, state, samples, observer)
    if hook is None:
        state, t, times, Es = _wtm_run(model, float(beta), tmax, step_t,
                                       chunk_moves, state, t, times, Es,
                                       observer)
        return Es, state
    while True:
        state, t, times, Es = _wtm_chunk(model, float(beta), tmax, step_t,
                                         chunk_moves, state, t, times, Es,
                                         observer)
        if hook(float(jnp.min(t)), model, state) is False:
            break
        if float(jnp.min(t)) >= tmax:
            break
    return Es, state
