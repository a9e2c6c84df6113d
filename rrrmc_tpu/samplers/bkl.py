"""bklMC: rejection-free Bortz-Kalos-Lebowitz, generalized to arbitrary
(non-discrete) dE exactly as the reference does.

Semantics follow /root/reference/src/RRRMC.jl:311-359: each kernel step draws
a geometric number of virtually-rejected iterations `skip` with success
probability z/N (rand_skip, /root/reference/src/DeltaE.jl:141-144), then an
always-accepted move proportional to w_i = min(1, e^{-beta dE_i}); the
iteration counter advances by skip+1, so results are directly comparable with
standardMC at equal `iters`.

Vectorization note: chains advance *different* numbers of virtual iterations
per kernel step, so checkpoints cannot be emitted in lockstep. Instead each
chunk of moves records a per-chain (iteration, energy) stream, and checkpoint
energies are filled by a vectorized searchsorted over the stream — the batch
generalization of the reference's checkpoint drain loop
(/root/reference/src/RRRMC.jl:339-344), which pushes the pre-move energy for
every checkpoint index <= it + skip + 1.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from ..core.model import Model
from ..core.dtypes import ftype
from .common import DEFAULT_SEED, MCState, init_state
from .moves import acceptance_weights, categorical_from_weights, geometric_skip


def make_bkl_move(model: Model, beta: float, iters: int):
    n = model.N

    def move1(sigma, aux, E, key, accepted, it):
        active = it < iters
        key, k_skip, k_mv = jax.random.split(key, 3)
        dE = model.delta_all(sigma, aux)
        w = acceptance_weights(model.to_physical(dE), beta)
        i, z = categorical_from_weights(k_mv, w)
        skip = geometric_skip(k_skip, z / n)
        sigma, aux = model.flip(sigma, aux, i, active)
        E = E + jnp.where(active, dE[i], jnp.zeros_like(dE[i]))
        it = it + jnp.where(active, skip + 1, 0)
        accepted = accepted + active.astype(jnp.int32)
        return sigma, aux, E, key, accepted, it

    return move1


def _bkl_chunk_body(model, beta, iters, step, chunk_moves, state: MCState,
                    it, Es, observer=None):
    move1 = make_bkl_move(model, beta, iters)
    batched = jax.vmap(move1)
    obs_fn = (jax.vmap(partial(observer, model)) if observer is not None
              else lambda s, a, E: jax.vmap(model.to_physical)(E))

    def do_move(carry):
        s, it = carry
        sigma, aux, E, key, accepted, it = batched(
            s.sigma, s.aux, s.E, s.key, s.accepted, it)
        return MCState(sigma=sigma, aux=aux, E=E, key=key,
                       accepted=accepted), it

    def body(carry, _):
        # straggler tail: once EVERY chain reached `iters`, the remaining
        # scan steps of this chunk skip the O(N) move entirely (the emitted
        # stream rows repeat the last coordinate — idempotent for the
        # checkpoint fill). Under a disorder vmap the predicate is batched
        # and cond degrades to running the move as before — no regression.
        done = jnp.min(carry[1]) >= iters
        s, it = jax.lax.cond(done, lambda c: c, do_move, carry)
        return (s, it), (it, obs_fn(s.sigma, s.aux, s.E))

    it_start = it
    o_start = obs_fn(state.sigma, state.aux, state.E)
    (state, it), (its, ovs) = jax.lax.scan(body, (state, it), None,
                                           length=chunk_moves)
    Es = _fill_checkpoints(Es, step, it_start, o_start, its, ovs)
    return state, it, Es


_bkl_chunk = partial(jax.jit, static_argnames=(
    "iters", "step", "chunk_moves", "observer"))(_bkl_chunk_body)


@partial(jax.jit, static_argnames=("iters", "step", "chunk_moves",
                                   "observer"))
def _bkl_run(model, beta, iters, step, chunk_moves, state: MCState, it, Es,
             observer=None):
    """Whole hookless run in ONE jit: lax.while_loop over chunks, no host
    sync per chunk (and vmap-able, so sample_disorder can stack it)."""
    def cond(carry):
        _, it, _ = carry
        return jnp.min(it) < iters

    def body(carry):
        state, it, Es = carry
        return _bkl_chunk_body(model, beta, iters, step, chunk_moves,
                               state, it, Es, observer)

    state, it, Es = jax.lax.while_loop(cond, body, (state, it, Es))
    return state, it, Es


def _fill_checkpoints(S, step, x_start, o_start, xs, os_):
    """Fill the checkpoint series S[b, k, ...] (checkpoint coordinate
    ns_k = (k+1)*step) with the observable in effect just before the first
    move whose post-move coordinate reaches ns_k. xs: [chunk, B] per-move
    coordinate streams (non-decreasing); os_: [chunk, B, ...] post-move
    observable stream; o_start: [B, ...] value at the chunk start. The batch
    generalization of the reference's checkpoint drain
    (/root/reference/src/RRRMC.jl:339-344), for energies and any observer
    output alike."""
    n_ckpt = S.shape[1]
    ns = (jnp.arange(1, n_ckpt + 1, dtype=xs.dtype)) * step  # [K]

    def per_chain(Sb, xb, ob, o0, x0):
        idx = jnp.searchsorted(xb, ns, side="left")  # moves strictly before ns
        vals = jnp.concatenate([o0[None], ob])[idx]
        newly = (ns > x0) & (ns <= xb[-1])
        mask = newly.reshape((-1,) + (1,) * (Sb.ndim - 1))
        return jnp.where(mask, vals, Sb)

    return jax.vmap(per_chain, in_axes=(0, 1, 1, 0, 0))(
        S, xs, os_, o_start, x_start)


def _series_buffer(model, state: MCState, n_ckpt: int, observer):
    """Zeroed [B, n_ckpt, ...] checkpoint series matching the observer's
    per-chain output shape/dtype (energy series when observer is None)."""
    if observer is None:
        return jnp.zeros((state.E.shape[0], n_ckpt), ftype())
    o0 = jax.eval_shape(jax.vmap(partial(observer, model)),
                        state.sigma, state.aux, state.E)
    return jnp.zeros((o0.shape[0], n_ckpt) + o0.shape[1:], o0.dtype)


def bklMC(model: Model, beta: float, iters: int, *, step: int = 1,
          chains: int = 1, seed: int = DEFAULT_SEED, C0=None,
          chunk_moves: int = 512, hook=None, observer=None,
          state: Optional[MCState] = None, backend: str = "auto"):
    """Rejection-free BKL; `iters` counts virtual (rejected-inclusive)
    iterations. Returns (Es [chains, iters // step], final MCState).
    hook(it, model, state) -> False stops early (called once per chunk).
    observer(model, sigma, aux, E) replaces the checkpoint energies with any
    per-chain observable (e.g. config snapshots for the overlap pipeline);
    checkpoints take the observable in effect at the checkpoint coordinate
    exactly as energies do.

    backend: "auto" / "xla" run the XLA path; there is no kernel route, so
    "pallas" raises ValueError."""
    from .common import choose_route, set_route

    choose_route("bklMC", model, backend=backend, state=state)
    if state is None:
        state = init_state(model, chains, seed, C0)
    n_ckpt = iters // step
    set_route("xla")
    Es = _series_buffer(model, state, n_ckpt, observer)
    it = jnp.zeros(chains, jnp.int64 if jax.config.jax_enable_x64 else jnp.int32)
    if hook is None:
        # hookless fast path: the whole run is one jitted while_loop (no
        # per-chunk host round trip; vmap-able under sample_disorder)
        state, it, Es = _bkl_run(model, float(beta), iters, step,
                                 chunk_moves, state, it, Es, observer)
        return Es, state
    while True:
        state, it, Es = _bkl_chunk(model, float(beta), iters, step,
                                   chunk_moves, state, it, Es, observer)
        if hook(int(jnp.min(it)), model, state) is False:
            break
        if int(jnp.min(it)) >= iters:
            break
    return Es, state
