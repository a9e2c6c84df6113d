"""Multi-host (multi-process) distributed runtime.

The reference is strictly single-process (SURVEY.md §2.4); this module is the
first-class gap-fill: `jax.distributed`-based process initialization, a
global mesh spanning every process's devices, and helpers to build
globally-sharded sampler state whose *values* are bit-identical to the
single-process `init_state` — chains are keyed by their GLOBAL chain id, so a
run sharded over any number of hosts produces exactly the same per-chain
trajectories as an unsharded run (tested bit-exactly by
tests/test_distributed.py with 2 spawned CPU processes).

Topology mapping: chains (and disorder realizations) are embarrassingly
parallel, so the chain axis shards over (hosts x local devices) with zero
intra-run communication — only observable reductions and parallel-tempering
rank exchanges touch the interconnect (psum / all_gather; XLA inserts the
collective from the sharding and hands it to NCCL on GPUs).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .mesh import make_mesh


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Join the distributed runtime (jax.distributed.initialize). Arguments
    default to the standard env vars (JAX_COORDINATOR_ADDRESS /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID). On a machine that announces no
    cluster, pass all three (coordinator "localhost:<port>")."""
    kw = {}
    if coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS"):
        kw["coordinator_address"] = (coordinator_address or
                                     os.environ["JAX_COORDINATOR_ADDRESS"])
    if num_processes or os.environ.get("JAX_NUM_PROCESSES"):
        kw["num_processes"] = int(num_processes or
                                  os.environ["JAX_NUM_PROCESSES"])
    if process_id is not None or os.environ.get("JAX_PROCESS_ID") is not None:
        kw["process_id"] = int(process_id if process_id is not None
                               else os.environ["JAX_PROCESS_ID"])
    jax.distributed.initialize(**kw)


def global_mesh(axis_sizes: Optional[dict] = None) -> Mesh:
    """Mesh over ALL processes' devices (jax.devices() is global after
    initialize()); default = one 'chains' axis."""
    return make_mesh(axis_sizes)


def _global_sharding(mesh: Mesh, axis: str, ndim: int) -> NamedSharding:
    return NamedSharding(mesh, P(axis, *([None] * (ndim - 1))))


def shard_global(tree, mesh: Mesh, axis: str = "chains"):
    """Shard a (key-free) pytree's leading axis over `axis` across ALL
    processes: leaves are materialized host-side identically on every process
    (cheap at state scale), and each process donates its addressable shards
    via jax.make_array_from_callback."""
    def put(x):
        if not hasattr(x, "ndim") or x.ndim == 0:
            spec = P()
        else:
            spec = P(axis, *([None] * (x.ndim - 1)))
        sh = NamedSharding(mesh, spec)
        if jax.process_count() == 1:
            return jax.device_put(x, sh)
        xh = np.asarray(jax.device_get(x))
        return jax.make_array_from_callback(xh.shape, sh,
                                            lambda idx: xh[idx])
    return jax.tree.map(put, tree)


def _state_shardings(model, chains: int, seed: int, mesh: Mesh, axis: str):
    from ..samplers.common import init_state

    build = lambda m: init_state(m, chains, seed)  # noqa: E731
    shapes = jax.eval_shape(build, model)
    shard = jax.tree.map(
        lambda s: NamedSharding(
            mesh, P(axis, *([None] * (s.ndim - 1))) if s.ndim else P()),
        shapes)
    return build, shard


def init_state_distributed(model, chains: int, seed: int, mesh: Mesh,
                           axis: str = "chains"):
    """Globally-sharded MCState, bit-identical to init_state(model, chains,
    seed) unsharded: the init runs as ONE jitted SPMD program with sharded
    out_shardings, so every process computes only its shard and PRNG-key
    leaves never round-trip through the host. Chains derive from per-chain
    key splits of the global seed, so values do not depend on the mesh."""
    n_shards = mesh.shape[axis]
    assert chains % n_shards == 0, (chains, n_shards)
    model = jax.tree.map(lambda x: np.asarray(jax.device_get(x)), model)
    build, shard = _state_shardings(model, chains, seed, mesh, axis)
    return jax.jit(build, out_shardings=shard)(model)


def sample_distributed(sampler, model, *args, chains: int, mesh: Mesh,
                       axis: str = "chains", seed: int = 0, **kw):
    """Run a sampler with chains sharded over a (possibly multi-host) mesh.
    The model replicates; the jitted sampler program is SPMD across
    processes. Returns (Es, state) as global arrays — use
    fetch_global to collect values on every host."""
    from .mesh import replicate

    model = replicate(model, mesh)
    state = kw.pop("state", None)
    if state is None:
        state = init_state_distributed(model, chains, seed, mesh, axis)
    elif not any(isinstance(x, jax.Array) and not x.is_fully_addressable
                 for x in jax.tree.leaves(state)):
        # host-local state: donate shards; an already-global state (e.g. the
        # previous segment's output) passes through untouched
        state = shard_global(state, mesh, axis)
    return sampler(model, *args, chains=chains, state=state, **kw)


def fetch_global(x, mesh: Mesh) -> np.ndarray:
    """Materialize a (possibly cross-process) global array on every host: a
    jitted identity with replicated output sharding performs the all-gather,
    after which the local shard IS the full array."""
    if jax.process_count() == 1:
        return np.asarray(x)
    y = jax.jit(lambda a: a, out_shardings=NamedSharding(mesh, P()))(x)
    return np.asarray(y.addressable_data(0))
