"""Parallel tempering (replica exchange) over a temperature ladder, sharded
over the device mesh.

New component relative to the reference (which only offers C0 warm-start
annealing, /root/reference/src/RRRMC.jl:59-60; SURVEY.md §2.4 names this as a
required gap-fill). Design for interconnect efficiency: configurations NEVER move
between devices. Each (slot, chain) carries a ladder `rank`; a swap exchanges
the *temperature assignment* (rank), not the spins, so the only cross-device
traffic per swap round is an all_gather of per-chain energies and ranks —
O(T*B) scalars — instead of O(T*B*N) spin tensors.

Swap rule (standard replica exchange): ladder pair (r, r+1) swaps with
probability min(1, exp((beta_{r+1}-beta_r) * (E_{r+1}-E_r))), alternating
even/odd pairs each round. Decisions are computed identically on every device
from a replicated key, so all rank tables stay consistent without extra
communication.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..core.struct import pytree, static
from ..core.dtypes import ftype
from ..models.pairwise import Pairwise
from ..samplers.common import DEFAULT_SEED, MCState, init_state
from ..samplers.sweep import color_masks, _sweep_once


@pytree
class PTState:
    sigma: jnp.ndarray    # [T, B, N]
    aux: object           # [T, B, ...]
    E: jnp.ndarray        # [T, B] internal units
    key: jnp.ndarray      # [T, B] PRNG keys
    rank: jnp.ndarray     # [T, B] int32: ladder rank held by (slot, chain)
    swap_acc: jnp.ndarray  # [T, B] int32 accepted swap count


def init_pt_state(model, betas, chains: int, seed: int) -> PTState:
    T = len(betas)
    states = [init_state(model, chains, seed + 7919 * t) for t in range(T)]
    stack = jax.tree.map(lambda *xs: jnp.stack(xs), *states)
    rank = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32)[:, None],
                            (T, chains))
    return PTState(sigma=stack.sigma, aux=stack.aux, E=stack.E,
                   key=stack.key, rank=rank,
                   swap_acc=jnp.zeros((T, chains), jnp.int32))


def _swap_ranks(E_phys, rank, betas, u, parity, axis_name):
    """Globally-consistent rank update. E_phys/rank: local [Tl, B]; u: full
    [T, B] (replicated); returns (new local rank, accepted mask [Tl, B]).

    The per-round traffic is ONE fused all_gather of a packed [2*Tl, B]
    array (energies ++ ranks-as-float — exact for T < 2^24): collective
    count per swap round is what a latency-bound interconnect charges for,
    so the two logical gathers ride one message."""
    T = betas.shape[0]
    if axis_name is not None:
        packed = jnp.concatenate(
            [E_phys, rank.astype(E_phys.dtype)], axis=0)        # [2Tl, B]
        packed_all = jax.lax.all_gather(packed, axis_name)      # [P, 2Tl, B]
        Tl = rank.shape[0]
        E_all = packed_all[:, :Tl].reshape(T, -1)
        rank_all = packed_all[:, Tl:].reshape(T, -1).astype(rank.dtype)
    else:
        E_all, rank_all = E_phys, rank
    B = E_all.shape[1]
    cols = jnp.broadcast_to(jnp.arange(B)[None, :], rank_all.shape)
    E_byrank = jnp.zeros_like(E_all).at[rank_all, cols].set(E_all)  # [T, B]

    # pair (r, r+1) for r % 2 == parity: accept w.p. min(1, e^{dbeta * dE})
    r = jnp.arange(T)
    dbeta = jnp.concatenate([betas[1:] - betas[:-1], jnp.zeros((1,), betas.dtype)])
    dE = jnp.concatenate([E_byrank[1:] - E_byrank[:-1],
                          jnp.zeros((1, B), E_byrank.dtype)])
    is_lead = (r % 2 == parity) & (r < T - 1)
    acc_pair = (u < jnp.exp(jnp.minimum(dbeta[:, None] * dE, 0.0))) \
        & is_lead[:, None]                                          # [T, B]

    # my slot's rank moves +1 if pair(my rank) accepted, -1 if pair(rank-1)
    cols_local = jnp.broadcast_to(jnp.arange(B)[None, :], rank.shape)
    up = acc_pair[rank, cols_local]
    down = acc_pair[jnp.maximum(rank - 1, 0), cols_local] & (rank > 0)
    new_rank = rank + up.astype(jnp.int32) - down.astype(jnp.int32)
    return new_rank, (up | down)


def _pt_round(model, masks, betas, n_sweeps, axis_name, chain_axis,
              state: PTState, swap_key, parity):
    """n_sweeps checkerboard sweeps at each slot's current beta, then one
    swap round. Operates on the local shard [Tl, B, ...]."""
    beta_chain = betas[state.rank]                                  # [Tl, B]

    def slot_sweeps(sigma, aux, E, key, beta):
        def one(carry, _):
            sigma, aux, E, key = _sweep_once(model, beta, masks, *carry)
            return (sigma, aux, E, key), None
        (sigma, aux, E, key), _ = jax.lax.scan(
            one, (sigma, aux, E, key), None, length=n_sweeps)
        return sigma, aux, E, key

    sweep_tb = jax.vmap(jax.vmap(slot_sweeps))  # over [Tl, B]
    sigma, aux, E, key = sweep_tb(state.sigma, state.aux, state.E,
                                  state.key, beta_chain)

    T = betas.shape[0]
    B = sigma.shape[1]
    # swap uniforms for ALL chains from the replicated key, then this
    # shard's columns: chain b draws the same u however chains are sharded
    n_shards = 1 if chain_axis is None else jax.lax.axis_size(chain_axis)
    u = jax.random.uniform(swap_key, (T, B * n_shards), ftype())
    if chain_axis is not None:
        u = jax.lax.dynamic_slice_in_dim(
            u, jax.lax.axis_index(chain_axis) * B, B, axis=1)
    E_phys = model.to_physical(E)
    new_rank, moved = _swap_ranks(E_phys, state.rank, betas, u, parity,
                                  axis_name)
    return PTState(sigma=sigma, aux=aux, E=E, key=key, rank=new_rank,
                   swap_acc=state.swap_acc + moved.astype(jnp.int32)), E_phys


@partial(jax.jit,
         static_argnames=("n_rounds", "sweeps_per_round", "axis_name",
                          "chain_axis", "mesh"))
def _run_pt(model, masks, betas, state: PTState, base_key,
            n_rounds: int, sweeps_per_round: int,
            axis_name: Optional[str], chain_axis: Optional[str],
            mesh: Optional[Mesh]):
    step_fn = partial(_pt_round, model, masks, betas, sweeps_per_round,
                      axis_name, chain_axis)
    if mesh is not None:
        sh = P(axis_name, chain_axis)
        repl = P()
        state_spec = jax.tree.map(lambda _: sh, state)
        step_fn = shard_map(
            step_fn, mesh=mesh,
            in_specs=(state_spec, repl, repl),
            out_specs=(state_spec, sh),
            check_vma=False)

    def body(carry, i):
        state = carry
        swap_key = jax.random.fold_in(base_key, i)
        state, E_phys = step_fn(state, swap_key, i % 2)
        return state, (E_phys, state.rank)

    state, (Es, ranks) = jax.lax.scan(body, state, jnp.arange(n_rounds))
    return state, Es, ranks


def parallel_tempering(model: Pairwise, betas, n_rounds: int, *,
                       sweeps_per_round: int = 1, chains: int = 1,
                       seed: int = DEFAULT_SEED,
                       mesh: Optional[Mesh] = None, axis: str = "temp",
                       chain_axis: Optional[str] = None,
                       state: Optional[PTState] = None):
    """Replica-exchange sampling over the beta ladder.

    Returns (Es [n_rounds, T, B] physical energies by slot,
             ranks [n_rounds, T, B] ladder rank per slot after each round,
             final PTState). Sort E by rank to get per-temperature series.
    With `mesh`, the T axis is sharded over mesh axis `axis` (T must divide)."""
    betas = jnp.asarray(betas, ftype())
    T = betas.shape[0]
    masks = (model.sweep_masks() if hasattr(model, "sweep_masks")
             else color_masks(model))
    if mesh is not None:
        assert T % mesh.shape[axis] == 0, (T, mesh.shape)
        if chain_axis is not None:
            assert chains % mesh.shape[chain_axis] == 0

        def spec_of(ndim):
            return (P(axis, *([chain_axis] + [None] * (ndim - 2)))
                    if ndim >= 2 else P())

        if state is None:
            # build the PT state as one jitted SPMD program with sharded
            # outputs — works on multi-process meshes where an eager
            # device_put to non-addressable devices is rejected, and keeps
            # PRNG-key leaves on device
            import numpy as _np
            model_h = jax.tree.map(
                lambda x: _np.asarray(jax.device_get(x)), model)
            bl = [float(b) for b in np.asarray(betas)]
            build = lambda m: init_pt_state(m, bl, chains, seed)  # noqa: E731
            shapes = jax.eval_shape(build, model_h)
            shard = jax.tree.map(
                lambda s: NamedSharding(mesh, spec_of(s.ndim)), shapes)
            state = jax.jit(build, out_shardings=shard)(model_h)
        else:
            state = jax.tree.map(
                lambda x: jax.device_put(
                    x, NamedSharding(mesh, spec_of(x.ndim))), state)
        axis_name = axis
    else:
        if state is None:
            state = init_pt_state(model, betas, chains, seed)
        axis_name = None
        chain_axis = None
    base_key = jax.random.key(seed ^ 0x5EED)
    state, Es, ranks = _run_pt(model, masks, betas, state, base_key,
                               n_rounds, sweeps_per_round, axis_name,
                               chain_axis, mesh)
    return Es, ranks, state


# ---------------------------------------------------------------------------
# Generalized ensemble exchange: a ladder of (model_r, beta_r) ENSEMBLES with
# slot-pinned Hamiltonians and configuration swaps.
#
# This is the tempering mode the reference's annealing workloads call for
# (Gamma-annealing on GraphQuant, scripts.jl:766-863; gamma-annealing on
# GraphRobustEnsemble, :866-963): the ladder varies the HAMILTONIAN (via each
# model's re-parameterized constructor), not just beta, so the swap acceptance
# must use cross energies:
#
#   ln A(r, r+1) = -beta_r   [H_r(x_{r+1})     - H_r(x_r)]
#                  -beta_{r+1}[H_{r+1}(x_r)    - H_{r+1}(x_{r+1})]
#
# which reduces to the standard exp(dbeta * dE) rule when all models are
# identical. Unlike `parallel_tempering` above (rank swaps, checkerboard
# sweeps, Pairwise-only), slots here are PINNED to their ensemble and the
# configurations move; each slot runs the generic single-site Metropolis
# kernel, so ANY model implementing the core protocol (incl. Quant/RE/LE/TLE
# wrappers, whose coupling constants live in *static* pytree metadata and
# therefore cannot be vmapped over a ladder axis) can be tempered. The move
# and swap phases for all T slots are traced into ONE jitted lax.scan over
# rounds — a Python loop over slots inside the trace, not T dispatches.
# ---------------------------------------------------------------------------


@pytree
class ETState:
    slots: tuple          # T × MCState (per-ensemble chain batches, [B, ...])
    walker: jnp.ndarray   # [T, B] int32: walker id currently held by slot
    swap_acc: jnp.ndarray  # [T, B] int32 accepted swap count (per lead pair)


#: per-model color-mask cache (greedy coloring is an eager host transform;
#: keyed by id with the array held against id reuse)
_MASK_CACHE: dict = {}


def _cached_masks(model):
    from ..samplers.common import bound_cache_put

    key = id(model.J)
    ent = _MASK_CACHE.get(key)
    if ent is None or ent[0] is not model.J:
        ent = (model.J, color_masks(model))
        bound_cache_put(_MASK_CACHE, key, ent)
    return ent[1]


def sweep_kernel(model, beta, n_moves, st: MCState, masks=None) -> MCState:
    """Throughput move kernel for `tempered_ensembles`: color-mask
    checkerboard sweeps instead of single-site moves (~N times fewer scan
    steps per round). Pairwise slot models only — `rt.flatten()` a
    Quant/LE/AddFields/Mixed wrapper ladder first. `n_moves` is rounded up
    to whole sweeps of N attempted flips.

    `masks` is supplied by tempered_ensembles via the `prepare` hook below:
    the greedy coloring is a host-side transform on concrete neighbor
    tables, so it must run OUTSIDE the jitted round (inside, `model` is a
    traced pytree)."""
    assert isinstance(model, Pairwise), \
        "sweep_kernel needs Pairwise slots; rt.flatten() wrapper stacks first"
    if masks is None:
        masks = _cached_masks(model)
    sweeps = max(1, -(-int(n_moves) // model.N))
    step1 = jax.vmap(partial(_sweep_once, model, beta, masks))

    def body(carry, _):
        return step1(*carry), None

    (sigma, aux, E, key), _ = jax.lax.scan(
        body, (st.sigma, st.aux, st.E, st.key), None, length=sweeps)
    return MCState(sigma=sigma, aux=aux, E=E, key=key, accepted=st.accepted)


def _sweep_prepare(model):
    assert isinstance(model, Pairwise), \
        "sweep_kernel needs Pairwise slots; rt.flatten() wrapper stacks first"
    return _cached_masks(model)


#: host-side per-slot preparation: tempered_ensembles calls this on the
#: CONCRETE models before tracing and threads the result into the kernel
sweep_kernel.prepare = _sweep_prepare


def _metropolis_moves(model, beta, n_moves, st: MCState) -> MCState:
    from ..samplers.metropolis import make_metropolis_step
    step1 = jax.vmap(make_metropolis_step(model, beta))

    def body(carry, _):
        return step1(*carry), None

    carry = (st.sigma, st.aux, st.E, st.key, st.accepted)
    (sigma, aux, E, key, accepted), _ = jax.lax.scan(
        body, carry, None, length=n_moves)
    return MCState(sigma=sigma, aux=aux, E=E, key=key, accepted=accepted)


def _ensemble_round(models, betas_f, n_moves, kernel, preps,
                    state: ETState, swap_key, parity):
    T = len(models)
    if preps is None:
        slots = [kernel(m, b, n_moves, st)
                 for m, b, st in zip(models, betas_f, state.slots)]
    else:
        slots = [kernel(m, b, n_moves, st, p)
                 for m, b, st, p in zip(models, betas_f, state.slots, preps)]
    B = slots[0].sigma.shape[0]

    # physical energies of every slot at its own ensemble
    E_phys = [m.to_physical(st.E).astype(ftype())
              for m, st in zip(models, slots)]
    # cross energies for every adjacent pair (both directions, internal
    # units); parity masking happens in the acceptance, so the round body
    # stays branch-free under the traced parity
    e_up = [jax.vmap(models[r].energy)(slots[r + 1].sigma)
            for r in range(T - 1)]            # H_r(x_{r+1})
    e_dn = [jax.vmap(models[r + 1].energy)(slots[r].sigma)
            for r in range(T - 1)]            # H_{r+1}(x_r)

    u = jax.random.uniform(swap_key, (max(T - 1, 1), B), ftype())
    acc = []
    for r in range(T - 1):
        ln_a = (-betas_f[r] * (models[r].to_physical(e_up[r]).astype(ftype())
                               - E_phys[r])
                - betas_f[r + 1] * (
                    models[r + 1].to_physical(e_dn[r]).astype(ftype())
                    - E_phys[r + 1]))
        lead = jnp.asarray(r % 2, jnp.int32) == parity
        acc.append((u[r] < jnp.exp(jnp.minimum(ln_a, 0.0))) & lead)

    def pick(r, own, up_v, dn_v):
        """Per-slot select: partner-above value if pair r accepted, partner-
        below value if pair r-1 accepted, else own. [B]-shaped masks."""
        out = own
        if r < T - 1:
            m = acc[r].reshape((-1,) + (1,) * (own.ndim - 1))
            out = jnp.where(m, up_v, out)
        if r > 0:
            m = acc[r - 1].reshape((-1,) + (1,) * (own.ndim - 1))
            out = jnp.where(m, dn_v, out)
        return out

    new_slots, new_walker = [], []
    for r in range(T):
        st = slots[r]
        sig_up = slots[r + 1].sigma if r < T - 1 else st.sigma
        sig_dn = slots[r - 1].sigma if r > 0 else st.sigma
        sigma = pick(r, st.sigma, sig_up, sig_dn)
        E = pick(r, st.E,
                 e_up[r] if r < T - 1 else st.E,
                 e_dn[r - 1] if r > 0 else st.E)
        # aux caches are model-specific; after a swap they must be re-derived
        # under this slot's Hamiltonian. The recompute is skipped entirely
        # (lax.cond) on rounds where NO chain of this slot swapped — the
        # common case deep in a ladder at low acceptance
        swapped = jnp.zeros((B,), bool)
        if r < T - 1:
            swapped = swapped | acc[r]
        if r > 0:
            swapped = swapped | acc[r - 1]
        aux = jax.lax.cond(
            jnp.any(swapped),
            lambda s, _a, r=r: jax.vmap(models[r].init_aux)(s),
            lambda _s, a: a, sigma, st.aux)
        new_slots.append(MCState(sigma=sigma, aux=aux, E=E, key=st.key,
                                 accepted=st.accepted))
        new_walker.append(pick(r, state.walker[r],
                               state.walker[r + 1] if r < T - 1 else None,
                               state.walker[r - 1] if r > 0 else None))

    moved = [jnp.zeros((B,), jnp.int32) for _ in range(T)]
    for r in range(T - 1):
        moved[r] = moved[r] + acc[r].astype(jnp.int32)
        moved[r + 1] = moved[r + 1] + acc[r].astype(jnp.int32)
    return (ETState(slots=tuple(new_slots),
                    walker=jnp.stack(new_walker),
                    swap_acc=state.swap_acc + jnp.stack(moved)),
            jnp.stack(E_phys))


@partial(jax.jit, static_argnames=("n_rounds", "n_moves", "kernel"))
def _run_ensembles(models, betas_f, state: ETState, base_key, preps,
                   n_rounds: int, n_moves: int, kernel):
    def body(carry, i):
        state = carry
        swap_key = jax.random.fold_in(base_key, i)
        state, E_phys = _ensemble_round(models, betas_f, n_moves, kernel,
                                        preps, state, swap_key, i % 2)
        return state, (E_phys, state.walker)

    state, (Es, walkers) = jax.lax.scan(body, state, jnp.arange(n_rounds))
    return state, Es, walkers


def tempered_ensembles(models, betas, n_rounds: int, *,
                       moves_per_round: Optional[int] = None,
                       chains: int = 1, seed: int = DEFAULT_SEED,
                       kernel=None, state: Optional[ETState] = None):
    """Replica exchange over a ladder of (model_r, beta_r) ensembles.

    models: sequence of T models on the same N (typically a re-parameterized
        family, e.g. ``[GraphQuant(Nk, M, g, beta, base) for g in Gammas]``
        sharing one base disorder, or T references to one model for a plain
        beta ladder). Arbitrary heterogeneous models are allowed — slots are
        pinned, configurations swap with the cross-energy acceptance rule.
    betas: [T] inverse sampling temperatures (may be all equal for a
        coupling-constant ladder).
    moves_per_round: Metropolis moves per slot between swap attempts
        (default N). kernel(model, beta, n_moves, MCState) -> MCState
        overrides the per-slot move kernel (e.g. `sweep_kernel` for
        color-mask checkerboard sweeps on Pairwise ladders). If the kernel
        has a `.prepare(model)` attribute it is called on each CONCRETE
        model outside the trace and the result passed as a 5th argument
        (host-side transforms like graph coloring can't run on the traced
        models inside the round).

    Returns (Es [n_rounds, T, B] physical energies per slot — slots ARE the
    ladder rungs here, no rank sorting needed —, walkers [n_rounds, T, B]
    walker ids after each swap round, final ETState)."""
    models = list(models)
    T = len(models)
    assert T >= 2, "need at least 2 ensembles"
    N = models[0].N
    assert all(m.N == N for m in models), "ladder models must share N"
    betas_f = tuple(float(b) for b in np.asarray(betas))
    assert len(betas_f) == T, (len(betas_f), T)
    n_moves = int(moves_per_round) if moves_per_round else N
    if state is None:
        slots = tuple(init_state(m, chains, seed + 7919 * t)
                      for t, m in enumerate(models))
        walker = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32)[:, None],
                                  (T, chains))
        state = ETState(slots=slots, walker=walker,
                        swap_acc=jnp.zeros((T, chains), jnp.int32))
    base_key = jax.random.key(seed ^ 0x7E3B)
    kernel = kernel or _metropolis_moves
    prepare = getattr(kernel, "prepare", None)
    preps = tuple(prepare(m) for m in models) if prepare else None
    state, Es, walkers = _run_ensembles(
        tuple(models), betas_f, state, base_key, preps, int(n_rounds),
        n_moves, kernel)
    return Es, walkers, state


def energies_by_rank(Es, ranks):
    """[rounds, T, B] slot-ordered -> rank-ordered (temperature series)."""
    rounds, T, B = Es.shape
    cols = np.broadcast_to(np.arange(B)[None, :], (T, B))
    out = np.empty_like(np.asarray(Es))
    Es, ranks = np.asarray(Es), np.asarray(ranks)
    for it in range(rounds):
        out[it][ranks[it], cols] = Es[it]
    return out
