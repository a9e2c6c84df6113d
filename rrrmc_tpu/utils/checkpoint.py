"""Checkpoint / resume for sampler states.

The reference's checkpointing is the C0 warm-start convention (every sampler
accepts C0 and returns the final Config, /root/reference/src/RRRMC.jl:59-60,
93-94) with no RNG-state persistence; SURVEY.md §5 specifies the batched
equivalent as a full pytree dump of (spins, aux, E, RNG keys, counters) so a
resumed run continues the *identical* chain.

Format: one .npz of the flattened pytree leaves (PRNG keys stored as their
uint32 key data) plus the number of leaves as a sanity check; loading
requires a structurally-matching template (e.g. a fresh `init_state` of the
same model/chain count), which keeps the format free of pickled code.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


def _is_key(x) -> bool:
    return isinstance(x, jax.Array) and jnp.issubdtype(x.dtype, jax.dtypes.prng_key)


def save_state(path: str, state) -> None:
    """Dump any sampler state pytree (MCState, PTState, EOResult, ...)."""
    leaves = jax.tree.leaves(state)
    arrays = {}
    for i, leaf in enumerate(leaves):
        if _is_key(leaf):
            arrays[f"leaf_{i}"] = np.asarray(jax.random.key_data(leaf))
            arrays[f"leaf_{i}_iskey"] = np.asarray(True)
        else:
            arrays[f"leaf_{i}"] = np.asarray(leaf)
    arrays["n_leaves"] = np.asarray(len(leaves))
    np.savez(path, **arrays)


def load_state(path: str, like):
    """Load a checkpoint into the structure of `like` (same model / chain
    count / sampler). Returns the restored pytree."""
    data = np.load(path)
    leaves, treedef = jax.tree.flatten(like)
    n = int(data["n_leaves"])
    assert n == len(leaves), \
        f"checkpoint has {n} leaves, template has {len(leaves)}"
    out = []
    for i, leaf in enumerate(leaves):
        raw = data[f"leaf_{i}"]
        if f"leaf_{i}_iskey" in data.files:
            assert _is_key(leaf), f"leaf {i}: checkpoint is a PRNG key, template is not"
            impl = jax.random.key_impl(leaf)
            out.append(jax.random.wrap_key_data(jnp.asarray(raw), impl=impl))
        else:
            assert raw.shape == leaf.shape, \
                f"leaf {i}: shape {raw.shape} != template {leaf.shape}"
            out.append(jnp.asarray(raw, leaf.dtype))
    return jax.tree.unflatten(treedef, out)
