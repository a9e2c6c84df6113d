"""sweepMC: masked simultaneous Metropolis over graph-coloring classes — the
throughput path.

The reference's hot loop flips ONE spin per iteration
(/root/reference/src/RRRMC.jl:100-119); its O(1) bookkeeping exists to make
that serial loop fast. On an accelerator the move is to flip an entire
*independent set* (color class) of spins per fused kernel: every spin in the
class sees fixed neighbors, so the update is a product of independent
single-site Metropolis decisions — a valid Glauber kernel with the same
stationary Boltzmann law (SURVEY.md §7 "checkerboard sweeps"; equilibrium
observables agree with the strict single-site chain, which standardMC keeps
for reference-equivalent dynamics).

For an EA lattice this is the classic checkerboard (2 colors); for arbitrary
Pairwise graphs a greedy coloring is computed at build time. Per color step,
for all B chains at once:

    dE     = 2 sigma * lf                  (elementwise, [B, N])
    accept = mask_c & (u < exp(-beta dE))  (one uniform draw per spin)
    sigma' = sigma * (1 - 2 accept)
    lf'    = J-gather recompute            (one padded gather, no scatter)

Work is O(B N K) per sweep for B*N attempted flips — pure gather +
elementwise, no data-dependent control flow, so XLA fuses the whole sweep.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..core.dtypes import ftype
from ..models.pairwise import Pairwise
from .common import DEFAULT_SEED, MCState, init_state, series_to_chain_major


def greedy_coloring(neigh: np.ndarray, n: int) -> np.ndarray:
    """[N] color ids such that no edge joins same-colored spins (first-fit
    greedy; exact 2-coloring for bipartite lattices like EA with even L)."""
    colors = np.full(n, -1, dtype=np.int32)
    for i in range(n):
        used = {colors[j] for j in neigh[i] if j < n and colors[j] >= 0}
        c = 0
        while c in used:
            c += 1
        colors[i] = c
    return colors


def color_masks(model: Pairwise) -> jnp.ndarray:
    """[C, N] boolean independent-set masks for a Pairwise model."""
    neigh = np.asarray(model.neigh)
    colors = greedy_coloring(neigh, model.N)
    ncol = int(colors.max()) + 1
    return jnp.asarray(np.stack([colors == c for c in range(ncol)]))


def color_masks_dense(J: np.ndarray) -> jnp.ndarray:
    """[C, N] masks from a dense coupling matrix's sparsity pattern."""
    n = J.shape[0]
    rows = [np.nonzero(J[i])[0] for i in range(n)]
    kmax = max((len(r) for r in rows), default=0) or 1
    neigh = np.full((n, kmax), n, dtype=np.int32)
    for i, r in enumerate(rows):
        neigh[i, : len(r)] = r
    colors = greedy_coloring(neigh, n)
    ncol = int(colors.max()) + 1
    return jnp.asarray(np.stack([colors == c for c in range(ncol)]))


def composite_masks(model):
    """[C, N_composite] independent-set masks for replica composites
    (Quant/RE/LE/TLE wrappers over a SPARSE Pairwise base), or None.

    Validity: the wrapper terms couple only same-site replica pairs —
    Trotter ring (QT.jl:105-108), RE star (RE.jl:70-104), LE center-replica
    star (LE.jl:55-84) — or base-edge pairs (the TLE 4-spin term,
    TLE.jl:17-56). A mask = (one replica slot) x (one base color class)
    therefore contains no interacting pair: same-slot pairs are separated by
    the base coloring, same-site pairs by the slot split, and TLE's 4-spin
    (i, j) terms by both. Center blocks (LE/TLE offset slots) get their own
    per-color masks. Dense bases (SK) have no usable coloring -> None."""
    from ..models.composite import Double
    from ..models.replicas import (LEModel, QuantModel, Replicated, REModel,
                                   TLEModel)

    if not isinstance(model, (QuantModel, REModel, LEModel, TLEModel)):
        return None
    assert isinstance(model, Double)
    resid = model.resid_m
    if not isinstance(resid, Replicated):
        return None
    base = resid.base
    if not isinstance(base, Pairwise):
        return None
    neigh = np.asarray(base.neigh)
    colors = greedy_coloring(neigh, base.N)
    ncol = int(colors.max()) + 1
    if ncol > 32:          # dense-ish base: coloring degenerates
        return None
    Nk, n_slots = resid.Nk, resid.n_slots
    masks = np.zeros((ncol * n_slots, Nk * n_slots), dtype=bool)
    for s in range(n_slots):          # centers (offset blocks) + replicas
        for c in range(ncol):
            masks[s * ncol + c, s * Nk:(s + 1) * Nk] = colors == c
    return jnp.asarray(masks)


#: mask cache: greedy coloring is host-side O(N*K) python — once per model
_CMASK_CACHE: dict = {}


def _cached_composite_masks(model):
    from ..models.replicas import LEModel, QuantModel, REModel, TLEModel

    if not isinstance(model, (QuantModel, REModel, LEModel, TLEModel)):
        return None
    from .common import bound_cache_put

    base = getattr(model.resid_m, "base", None)
    anchor = getattr(base, "neigh", None)
    if anchor is None:
        return None
    key = (id(anchor), type(model).__name__, model.N)
    ent = _CMASK_CACHE.get(key)
    if ent is None or ent[0] is not anchor:
        ent = (anchor, composite_masks(model))
        bound_cache_put(_CMASK_CACHE, key, ent)
    return ent[1]


def _sweep_once_composite(model, beta, masks, sigma, aux, E, key):
    """One full sweep over a replica composite: per color-mask step, one
    fused delta_all pass (PHYSICAL energies — the Double contract) decides
    all mask members at once, then the aux cache is re-derived. Same
    stationary law as single-site Metropolis on the composite."""
    ft = ftype()

    def color_step(carry, mask):
        sigma, aux, E, key = carry
        key, ku = jax.random.split(key)
        dE = model.delta_all(sigma, aux)          # physical
        x = -beta * dE
        u = jax.random.uniform(ku, (model.N,), ft)
        acc = mask & ((x >= 0) | (u < jnp.exp(jnp.minimum(x, 0.0))))
        sigma = jnp.where(acc, -sigma, sigma)
        E = E + jnp.sum(jnp.where(acc, dE, jnp.zeros_like(dE)),
                        dtype=E.dtype)
        aux = model.init_aux(sigma)
        return (sigma, aux, E, key), None

    (sigma, aux, E, key), _ = jax.lax.scan(
        color_step, (sigma, aux, E, key), masks)
    return sigma, aux, E, key


@partial(jax.jit, static_argnames=("n_checkpoints", "sweeps_per_checkpoint"))
def _run_sweepmc_composite(model, state: MCState, beta, masks,
                           n_checkpoints: int, sweeps_per_checkpoint: int):
    batched = jax.vmap(partial(_sweep_once_composite, model, beta, masks))

    def one_sweep(s: MCState, _):
        sigma, aux, E, key = batched(s.sigma, s.aux, s.E, s.key)
        return MCState(sigma=sigma, aux=aux, E=E, key=key,
                       accepted=s.accepted), None

    def checkpoint(s: MCState, _):
        s, _ = jax.lax.scan(one_sweep, s, None, length=sweeps_per_checkpoint)
        return s, s.E.astype(ftype())              # already physical

    state, series = jax.lax.scan(checkpoint, state, None,
                                 length=n_checkpoints)
    return state, series


def _sweep_once(model: Pairwise, beta, masks, sigma, aux, E, key):
    """One full sweep: N attempted flips (all color classes), single chain."""
    ncol = masks.shape[0]
    ft = ftype()

    def color_step(carry, mask):
        sigma, aux, E, key = carry
        key, ku = jax.random.split(key)
        dE = 2 * sigma.astype(model.J.dtype) * aux
        x = -beta * model.to_physical(dE)
        u = jax.random.uniform(ku, (model.N,), ft)
        acc = mask & ((x >= 0) | (u < jnp.exp(jnp.minimum(x, 0.0))))
        sigma = jnp.where(acc, -sigma, sigma)
        E = E + jnp.sum(jnp.where(acc, dE, jnp.zeros_like(dE)),
                        dtype=E.dtype)  # x64 must not widen the carry
        aux = model.local_fields(sigma).astype(aux.dtype)
        return (sigma, aux, E, key), None

    (sigma, aux, E, key), _ = jax.lax.scan(
        color_step, (sigma, aux, E, key), masks)
    return sigma, aux, E, key


@partial(jax.jit, static_argnames=("n_checkpoints", "sweeps_per_checkpoint"))
def _run_sweepmc(model: Pairwise, state: MCState, beta, masks,
                 n_checkpoints: int, sweeps_per_checkpoint: int):
    batched = jax.vmap(partial(_sweep_once, model, beta, masks))

    def one_sweep(s: MCState, _):
        sigma, aux, E, key = batched(s.sigma, s.aux, s.E, s.key)
        return MCState(sigma=sigma, aux=aux, E=E, key=key,
                       accepted=s.accepted), None

    def checkpoint(s: MCState, _):
        s, _ = jax.lax.scan(one_sweep, s, None, length=sweeps_per_checkpoint)
        return s, jax.vmap(model.to_physical)(s.E)

    state, series = jax.lax.scan(checkpoint, state, None, length=n_checkpoints)
    return state, series


@jax.jit
def _kernel_seed(keys):
    """int32 kernel stream base from the chain keys, and the keys advanced:
    a continuation run (state=) never replays the previous call's bits."""
    k0 = keys[0]
    seed = jax.random.randint(k0, (), 0, 2 ** 31 - 1, jnp.int32)
    return seed, jax.vmap(lambda k: jax.random.fold_in(k, 0x5EE9))(keys)


def _run_sweepmc_kernel(model, state: MCState, beta, n_ckpt, step, *,
                        interpret: bool = False):
    """Checkpointed sweepMC over the lattice sweep kernel
    (ops/sweep_pallas.py): one jitted call for all checkpoints, exact int32
    energy tracking; aux is rebuilt once at the end."""
    from ..ops.sweep_pallas import LatticeSweeper
    from .common import init_aux_batch

    sweeper = LatticeSweeper(model, beta, interpret=interpret)
    seed, keys = _kernel_seed(state.key)
    sigma, E, Es = sweeper.run(state.sigma, state.E, seed=seed,
                               n_ckpt=n_ckpt, step=step)
    state = MCState(sigma=sigma, aux=init_aux_batch(model, sigma), E=E,
                    key=keys, accepted=state.accepted)
    return state, model.to_physical(Es)


def sweepMC(model: Pairwise, beta: float, sweeps: int, *, step: int = 1,
            chains: int = 1, seed: int = DEFAULT_SEED, C0=None,
            state: Optional[MCState] = None, backend: str = "auto"):
    """Run `sweeps` full-lattice sweeps (N attempted flips each) per chain.

    Returns (Es [chains, sweeps // step], final MCState). Same stationary law
    as standardMC; use for throughput and equilibrium observables, use
    standardMC when strict single-site dynamics matter.

    backend: "auto" takes the route samplers.common.choose_route picks
    (the lattice sweep kernel for integer even-L LatticeEA on a GPU, the
    generic XLA colour-mask sweep otherwise); "xla" forces the XLA path;
    "pallas" requires the kernel and raises ValueError where there is none.

    FullyConnected models route by structure: a colour-mask sweep with
    matmul local-field recomputes when the dense J is sparse (few colours —
    densify()'d graphs); else the delayed-update sequential scan (true dense
    models)."""
    from ..models.dense import FullyConnected

    from .common import choose_route, set_route

    route = choose_route("sweepMC", model, backend=backend, state=state)
    cmasks = _cached_composite_masks(model)
    if cmasks is not None:
        # Quant/RE/LE/TLE wrapper over a sparse Pairwise base: (slot x base
        # color) product masks; ~N / n_masks moves per fused delta_all pass
        # vs one move per pass on the single-move path
        if state is None:
            state = init_state(model, chains, seed, C0)
        set_route("composite-mask-sweep", n_masks=int(cmasks.shape[0]))
        state, series = _run_sweepmc_composite(model, state, float(beta),
                                               cmasks, sweeps // step, step)
        return series_to_chain_major(series), state
    if isinstance(model, FullyConnected):
        from .dense_sweep import sweepMC_dense, _model_meta
        meta = _model_meta(model)
        if "max_degree" not in meta:
            # one jitted scalar reduction — do NOT pull [N, N] J to host
            # just to discover the model is dense
            meta["max_degree"] = int(jax.jit(
                lambda J: jnp.max(jnp.sum(J != 0, axis=1)))(model.J))
        if meta["max_degree"] > 32:  # genuinely dense: coloring degenerates
            # float J (GraphSKNormal) runs the same delayed-update scan with
            # float local fields and f32/f64 rank-W matmul commits
            return sweepMC_dense(model, beta, sweeps, step=step,
                                 chains=chains, seed=seed, C0=C0,
                                 state=state)
        if "masks" not in meta:
            meta["masks"] = color_masks_dense(np.asarray(model.J))
        if state is None:
            state = init_state(model, chains, seed, C0)
        set_route("xla")
        state, series = _run_sweepmc(model, state, float(beta),
                                     meta["masks"], sweeps // step, step)
        return series_to_chain_major(series), state
    assert isinstance(model, Pairwise), "sweepMC requires a Pairwise model"
    if state is None:
        state = init_state(model, chains, seed, C0)
    if route == "triton-lattice-sweep":
        state, series = _run_sweepmc_kernel(model, state, float(beta),
                                            sweeps // step, step)
        set_route(route)
        return series_to_chain_major(series), state
    set_route("xla")
    masks = (model.sweep_masks() if hasattr(model, "sweep_masks")
             else color_masks(model))
    state, series = _run_sweepmc(model, state, float(beta), masks,
                                 sweeps // step, step)
    return series_to_chain_major(series), state
