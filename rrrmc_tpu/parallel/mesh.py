"""Device-mesh scale-out for chain / disorder sharding.

The reference is strictly single-process (SURVEY.md §2.4); scale-out here is
a first-class new component. Chains are independent, so the base execution
model is pure data parallelism: the MCState's leading (chain) axis is sharded
over the mesh and the model pytree is replicated — XLA then runs each shard's
sweep kernel locally with zero communication, and observable reductions
(means, histograms) become psums at the reduction site only.

Disorder sharding (many (model, seed) realizations) stacks model pytrees on a
leading axis and shards that axis; see `stack_models`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(axis_sizes: Optional[dict] = None, *, devices=None) -> Mesh:
    """Build a Mesh; default = all devices on one 'chains' axis.

    axis_sizes: ordered {axis_name: size} with total = #devices, e.g.
    {"temp": 2, "chains": 4}."""
    devices = devices if devices is not None else jax.devices()
    if axis_sizes is None:
        axis_sizes = {"chains": len(devices)}
    names = tuple(axis_sizes.keys())
    sizes = tuple(axis_sizes.values())
    assert int(np.prod(sizes)) == len(devices), \
        f"mesh {axis_sizes} != {len(devices)} devices"
    dev_array = np.asarray(devices).reshape(sizes)
    return Mesh(dev_array, names)


def shard_leading(tree, mesh: Mesh, axis: str = "chains"):
    """Shard every array leaf's leading axis over `axis`; scalars replicate."""
    def put(x):
        if hasattr(x, "ndim") and x.ndim >= 1:
            spec = P(axis, *([None] * (x.ndim - 1)))
        else:
            spec = P()
        return jax.device_put(x, NamedSharding(mesh, spec))
    return jax.tree.map(put, tree)


def replicate(tree, mesh: Mesh):
    """Replicate a pytree (e.g. the model) across the mesh."""
    return jax.tree.map(
        lambda x: jax.device_put(x, NamedSharding(mesh, P())), tree)


def stack_models(models: Sequence):
    """Stack same-shape disorder realizations on a leading axis (the
    vectorized analog of the reference's per-seed loops,
    /root/reference/scripts/scripts.jl:83-149). Static metadata must agree."""
    return jax.tree.map(lambda *xs: jnp.stack(xs), *models)


def sample_sharded(sampler, model, mesh: Mesh, *args, chains: int,
                   chain_axis: str = "chains", **kw):
    """Run any sampler with the chain axis sharded over the mesh.

    The sampler's jitted scan sees sharded inputs and XLA partitions it
    automatically (no collectives inside: chains are independent)."""
    from ..samplers.common import init_state
    n_shards = mesh.shape[chain_axis]
    assert chains % n_shards == 0, (chains, n_shards)
    model = replicate(model, mesh)
    state = kw.pop("state", None)
    if state is None:
        state = init_state(model, chains, kw.pop("seed", 0),
                           kw.pop("C0", None))
    state = shard_leading(state, mesh, chain_axis)
    return sampler(model, *args, chains=chains, state=state, **kw)


def _disorder_kernel_eligible(sampler, model, kw) -> bool:
    """True iff `sampler` would take a kernel route on this concrete model —
    the disorder study then runs per-instance kernel dispatches (shared
    compile) instead of the vmapped XLA path."""
    from ..samplers.common import choose_route
    from ..samplers.sweep import sweepMC

    if sampler is not sweepMC:
        return False
    return choose_route("sweepMC", model,
                        backend=kw.get("backend", "auto")) != "xla"


def sample_disorder(sampler, models: Sequence, *args, chains: int,
                    mesh: Optional[Mesh] = None, axis: str = "disorder",
                    seed: int = 0, **kw):
    """Run one sampler over MANY disorder realizations — the vectorized
    replacement for the reference's sequential per-seed loops
    (/root/reference/scripts/scripts.jl:83-149).

    `models` must share static metadata (same builder, same sizes). Two
    execution modes:

    * kernel mode (no mesh, concrete models, sampler would take a kernel
      route): one dispatch per instance, all sharing ONE compile (the
      per-instance tables are traced kernel arguments, so the jit cache
      hits across instances). LAST_ROUTE reports the kernel backend and
      the instance count.
    * vmap mode (otherwise): array leaves stack on a leading axis, the
      whole sampler is vmapped over it, and (optionally) that axis is
      sharded over `mesh` — kernel routes decline traced models, so this
      runs the XLA paths.

    Per-disorder seeds derive from `seed`. Returns (Es [D, chains, n_ckpt],
    states with leading D axis) — or the sampler's result pytree stacked on
    a leading D axis (e.g. EOResult for extremal_opt)."""
    import jax
    from ..samplers.common import LAST_ROUTE, init_state

    D = len(models)
    states = [init_state(m, chains, seed + 104729 * d)
              for d, m in enumerate(models)]
    if mesh is None and kw.get("state") is None and all(
            _disorder_kernel_eligible(sampler, m, kw)
            for m in models):
        results = []
        for d, (m, st) in enumerate(zip(models, states)):
            results.append(sampler(m, *args, chains=chains, state=st,
                                   seed=seed + 104729 * d + 1, **kw))
        LAST_ROUTE["disorder_instances"] = D
        return jax.tree.map(lambda *xs: jnp.stack(xs), *results)

    stacked = stack_models(models)
    state0 = jax.tree.map(lambda *xs: jnp.stack(xs), *states)
    if mesh is not None:
        stacked = shard_leading(stacked, mesh, axis)
        state0 = shard_leading(state0, mesh, axis)

    def one(model, state):
        return sampler(model, *args, chains=chains, state=state, **kw)

    return jax.vmap(one)(stacked, state0)
