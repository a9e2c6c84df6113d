"""Shared sampler scaffolding: batched chain state, init, and the scan driver.

The reference advances ONE chain in a Julia while-loop
(/root/reference/src/RRRMC.jl:100-119). The execution model here is a batch of
`chains` independent chains advanced in lockstep: every per-move function is
written single-chain and vmapped, the time loop is a `lax.scan` with a
checkpoint emission every `step` moves (the vectorized analog of the `hook` /
energy-series mechanism, /root/reference/src/RRRMC.jl:104-109).
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..core.struct import pytree, static
from ..core.model import Model, random_spins

#: arbitrary default seed, mirroring /root/reference/src/RRRMC.jl:82
DEFAULT_SEED = 167432777111 % (2 ** 31)

#: which execution path the LAST sampler call took (routing is automatic,
#: so users otherwise can't tell): {"backend": "xla" | kernel route, ...}
#: plus route diagnostics. experiments.runtest reports it; informational.
LAST_ROUTE: dict = {}


def concrete_model(model) -> bool:
    """True iff every array leaf of the model is concrete (not a jax
    tracer). Kernel routing must DECLINE traced models — under
    sample_disorder's vmap (or any user jit over the model) the kernel's
    host-side table builds would crash on tracers; the XLA paths trace
    fine."""
    return not any(isinstance(leaf, jax.core.Tracer)
                   for leaf in jax.tree_util.tree_leaves(model))


def _spans_devices(state) -> bool:
    """True iff the state's spins are committed across several devices (a
    Pallas call is not partitioned automatically; XLA's path is)."""
    sigma = getattr(state, "sigma", None)
    sharding = getattr(sigma, "sharding", None)
    return sharding is not None and len(sharding.device_set) > 1


def choose_route(sampler: str, model, *, backend: str = "auto",
                 state=None, platform: Optional[str] = None) -> str:
    """The one routing decision of every sampler call: "xla" or the name of
    a kernel route.

    A kernel is taken only on a GPU, for a concrete model the kernel
    accepts, with state on one device. backend="xla" forces the plain path;
    backend="pallas" demands the kernel and raises ValueError where this
    sampler, model or platform has none — it is never mapped to XLA."""
    if backend not in ("auto", "xla", "pallas"):
        raise ValueError(f"unknown backend {backend!r}: "
                         "use 'auto', 'xla' or 'pallas'")
    if backend == "xla":
        return "xla"
    from ..ops.sweep_pallas import kernel_eligible

    platform = platform or jax.default_backend()
    # the one kernel route: sweepMC's lattice sweep; every other sampler,
    # and every model the kernel declines, runs its plain XLA path
    has_kernel = sampler == "sweepMC"
    if (has_kernel and platform == "gpu" and concrete_model(model)
            and not _spans_devices(state) and kernel_eligible(model)):
        return "triton-lattice-sweep"
    if backend == "pallas":
        raise ValueError(
            f"backend='pallas': {sampler} has no kernel for "
            f"{type(model).__name__} on platform {platform!r}"
            + ("" if has_kernel else " (no kernel route exists for it)")
            + "; use backend='auto' or 'xla'")
    return "xla"


def set_route(backend: str, **extra):
    LAST_ROUTE.clear()
    LAST_ROUTE["backend"] = backend
    LAST_ROUTE.update(extra)


@pytree
class MCState:
    sigma: jnp.ndarray   # [B, N] int8
    aux: Any             # model aux, batched on axis 0
    E: jnp.ndarray       # [B] internal units
    key: jnp.ndarray     # [B] PRNG keys
    accepted: jnp.ndarray  # [B] int32


def init_state(model: Model, chains: int, seed: int, C0=None) -> MCState:
    key = jax.random.key(seed)
    kinit, krun = jax.random.split(key)
    if C0 is None:
        sigma = jax.vmap(lambda k: random_spins(k, model.N))(
            jax.random.split(kinit, chains))
    else:
        C0 = jnp.asarray(C0, jnp.int8)
        if C0.ndim == 1:
            C0 = jnp.broadcast_to(C0, (chains, model.N))
        assert C0.shape == (chains, model.N), "invalid C0 shape"
        sigma = C0
    aux = jax.vmap(model.init_aux)(sigma)
    E = jax.vmap(model.energy)(sigma)
    return MCState(sigma=sigma, aux=aux, E=E,
                   key=jax.random.split(krun, chains),
                   accepted=jnp.zeros(chains, jnp.int32))


def rebind(model: Model, state: MCState) -> MCState:
    """Re-derive the aux cache and exact energies of `state.sigma` under a
    (re-parameterized) model, keeping spins, RNG keys, and counters.

    This is the annealing warm-start: the reference rebuilds a graph with a
    new coupling from an old one (GraphQT(X, newK) /root/reference/src/
    graphs/QT.jl:66, GraphRE(X, newgamma) RE.jl:58, GraphLE LE.jl:43,
    GraphTLE TLE.jl:67, GraphPercXEntr PercXEntr.jl:87) and passes C0 to the
    next sampler call. Here: build the new model with its constructor, then
    `state = rebind(new_model, state)` — unlike C0=, the per-chain RNG
    streams continue uninterrupted."""
    aux, E = _rebind_aux_E(model, state.sigma)
    return MCState(sigma=state.sigma, aux=aux, E=E, key=state.key,
                   accepted=state.accepted)


@jax.jit
def _rebind_aux_E(model, sigma):
    # module-level jit: per-call jax.jit(bound method) would recompile on
    # every annealing step (cache is keyed by function identity)
    return jax.vmap(model.init_aux)(sigma), jax.vmap(model.energy)(sigma)


@jax.jit
def init_aux_batch(model, sigma):
    return jax.vmap(model.init_aux)(sigma)


def bound_cache_put(cache: dict, key, value, limit: int = 8):
    """Insert with FIFO eviction — sampler/sweeper caches hold device arrays
    (the [N, N] J and padded copies) and must not grow unboundedly across a
    disorder study."""
    if key not in cache and len(cache) >= limit:
        cache.pop(next(iter(cache)))
    cache[key] = value


def default_observer(model: Model, sigma, aux, E):
    """Per-checkpoint observable: physical energy."""
    return model.to_physical(E)


@partial(jax.jit,
         static_argnames=("make_step", "n_checkpoints",
                          "moves_per_checkpoint", "observer"))
def run_sweeps(model: Model, state: MCState, beta,
               make_step: Callable, n_checkpoints: int,
               moves_per_checkpoint: int,
               observer: Optional[Callable] = None):
    """Advance all chains; emit `observer` output every `moves_per_checkpoint`
    moves. make_step(model, beta) builds the single-chain move function
    (sigma, aux, E, key, accepted) -> same. The model pytree and beta are
    traced (no recompilation across disorder realizations or temperatures of
    the same shape); make_step must be a stable module-level function so the
    jit cache hits across calls."""
    obs_fn = observer or default_observer
    batched_step = jax.vmap(make_step(model, beta))

    def one_move(s: MCState, _):
        sigma, aux, E, key, accepted = batched_step(
            s.sigma, s.aux, s.E, s.key, s.accepted)
        return MCState(sigma=sigma, aux=aux, E=E, key=key, accepted=accepted), None

    def checkpoint(s: MCState, _):
        s, _ = jax.lax.scan(one_move, s, None, length=moves_per_checkpoint)
        return s, jax.vmap(partial(obs_fn, model))(s.sigma, s.aux, s.E)

    state, series = jax.lax.scan(checkpoint, state, None, length=n_checkpoints)
    return state, series


def series_to_chain_major(series):
    """[n_checkpoints, B, ...] -> [B, n_checkpoints, ...]."""
    return jax.tree.map(lambda x: jnp.moveaxis(x, 0, 1), series)


def run_with_hook(model: Model, state: MCState, beta, make_step,
                  n_checkpoints: int, moves_per_checkpoint: int,
                  observer, hook, hook_every: int):
    """Chunked driver for the reference's hook protocol
    (/root/reference/src/RRRMC.jl:61-64,104-109): `hook(it, model, state)` is
    called on the host every `hook_every` checkpoints; returning False stops
    the run early (the collected series so far is returned). The no-hook path
    (`hook=None`) stays one fused jit."""
    if hook is None:
        return run_sweeps(model, state, beta, make_step=make_step,
                          n_checkpoints=n_checkpoints,
                          moves_per_checkpoint=moves_per_checkpoint,
                          observer=observer)
    parts = []
    done = 0
    while done < n_checkpoints:
        k = min(hook_every, n_checkpoints - done)
        state, series = run_sweeps(model, state, beta, make_step=make_step,
                                   n_checkpoints=k,
                                   moves_per_checkpoint=moves_per_checkpoint,
                                   observer=observer)
        parts.append(series)
        done += k
        if hook(done * moves_per_checkpoint, model, state) is False:
            break
    series = jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=0), *parts)
    return state, series
