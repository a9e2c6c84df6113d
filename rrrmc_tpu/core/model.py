"""The model contract (batched, functional analog of /root/reference/src/Interface.jl).

A model is an immutable pytree describing one disorder realization of an
Ising-type energy function over N binary spins. All methods are *pure,
single-chain* functions designed to be `jax.vmap`-ed over a batch of chains
and `jax.jit`-ed inside sampler loops; there is no mutable cache object.
Instead of the reference's incrementally-updated `LocalFields` cache
(/root/reference/src/Common.jl:27-36) each model carries an explicit
*auxiliary state* pytree (`init_aux`) threaded through the sampler, updated
functionally by `flip`.

Spin convention: sigma is an int8 array of +-1 values (the reference stores
bits s with sigma = 2s - 1, /root/reference/src/Interface.jl:21-38; we store
sigma directly: vectorized code has no use for scalar bit tricks).

Mapping to the reference interface:

==========================  ====================================================
reference                   here
==========================  ====================================================
`energy(X, C)`              `model.energy(sigma)` (pure; cache is `init_aux`)
`delta_energy(X, C, i)`     `model.delta_one(sigma, aux, i)`
(lfields cache)             `model.delta_all(sigma, aux)` -> [N] vector
`spinflip!(X, C, i)`        `model.flip(sigma, aux, i, do)` -> (sigma', aux')
`allDeltaE(...)`            `model.delta_classes()` (trace-time metadata)
`inner_graph(X)`            `model.inner` (DoubleModel)
`delta_energy_residual`     `model.residual_delta_one(sigma, aux, i)`
`getN(X)`                   `model.N`
==========================  ====================================================

Masked flips: samplers decide acceptance per chain in lockstep, so `flip`
takes a boolean `do`; when False it must be a branchless no-op. The idiom is
to route every scatter through a sentinel index N with `mode="drop"` — see
`flip_spin` below. This keeps the per-step cost O(degree), not O(N).

Internal vs physical units: integer models compute energies in an exact int32
domain; `scale` converts to physical units (see core/dtypes.py). All sampler
acceptance math uses physical units via `to_physical`.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import jax.numpy as jnp

Array = Any


def flip_spin(sigma: Array, i: Array, do: Array) -> Array:
    """Flip sigma[i] if `do`, branchlessly (sentinel-index scatter)."""
    n = sigma.shape[-1]
    tgt = jnp.where(do, i, n)
    return sigma.at[tgt].multiply(-1, mode="drop")


class Model:
    """Base class; concrete models are @pytree dataclasses deriving from it."""

    # --- static metadata ----------------------------------------------------
    N: int  # number of spins
    scale: float = 1.0  # physical energy = internal * scale

    # --- required interface -------------------------------------------------
    def energy(self, sigma: Array) -> Array:
        """Total energy (internal units), computed from scratch."""
        raise NotImplementedError

    def init_aux(self, sigma: Array) -> Any:
        """Build the auxiliary (local-field-like) state for `sigma`."""
        raise NotImplementedError

    def delta_all(self, sigma: Array, aux: Any) -> Array:
        """[N] vector: energy change (internal units) of flipping each spin."""
        raise NotImplementedError

    def flip(self, sigma: Array, aux: Any, i: Array, do: Array):
        """Apply the flip of spin `i` when `do`; returns (sigma', aux')."""
        raise NotImplementedError

    # --- defaults ------------------------------------------------------------
    def delta_one(self, sigma: Array, aux: Any, i: Array) -> Array:
        """Energy change of flipping spin `i`. Default: gather of delta_all."""
        return self.delta_all(sigma, aux)[i]

    def delta_classes(self) -> Optional[Sequence[float]]:
        """Non-negative |dE| class values in physical units for discrete
        models (the `allDeltaE` analog, /root/reference/src/Interface.jl:187),
        or None for continuous models. Trace-time metadata only: the samplers
        do not need it (class bucketing is a serial-CPU artifact), but it is
        kept for parity checks and tests."""
        return None

    def neighbor_table(self) -> Optional[Array]:
        """[N, K] int32 table, padded with the sentinel N, of the spins whose
        `delta_one` value can change when spin i flips — the `neighbors`
        analog (/root/reference/src/Interface.jl:148-158). None means "every
        spin may be affected" (fully-connected models, where the reference's
        own `neighbors` is AllButOne, /root/reference/src/graphs/SK.jl:165);
        samplers then fall back to O(N) updates, which is reference-parity.

        Default: the `neigh` field of Pairwise-family models. Composite
        wrappers override this to derive their union tables."""
        return getattr(self, "neigh", None)

    def to_physical(self, e: Array) -> Array:
        """Convert internal-unit energies to physical units (float)."""
        from .dtypes import ftype

        if jnp.issubdtype(jnp.asarray(e).dtype, jnp.integer) or self.scale != 1.0:
            return jnp.asarray(e, ftype()) * self.scale
        return e

    # --- DoubleGraph analog ---------------------------------------------------
    @property
    def inner(self) -> Optional["Model"]:
        """Inner (exactly-sampled) part for DoubleModel composites, else None."""
        return None

    def inner_aux(self, aux: Any) -> Any:
        """Project the composite aux onto the inner model's aux."""
        raise NotImplementedError

    def residual_delta_one(self, sigma: Array, aux: Any, i: Array) -> Array:
        """Residual energy change (PHYSICAL units) of flipping spin `i`.

        Default 0 for single models (mirrors
        /root/reference/src/Interface.jl:243-253)."""
        return jnp.zeros((), jnp.float32)


def random_spins(key, n: int) -> Array:
    """Random +-1 int8 configuration (the `Config(N)` analog)."""
    import jax

    return (jax.random.bernoulli(key, 0.5, (n,)).astype(jnp.int8) * 2 - 1)
