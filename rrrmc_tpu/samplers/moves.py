"""Vectorized move-selection primitives shared by rrrMC / bklMC / EO.

The reference maintains O(1)-updatable structures for move selection: per-|dE|
class ArraySet buckets with weights T[k] (/root/reference/src/DeltaE.jl:63-104)
for discrete graphs, a Wong-Easton partial-sum tree for continuous ones
(/root/reference/src/DynamicSamplers.jl). Those structures exist to serve a
*serial* CPU loop. Vectorized over a batch of chains, the same distribution —
pick spin i with probability min(1, e^{-beta dE_i}) / z — is computed directly
from the dense dE vector with one fused elementwise pass + cumsum search,
which is the vectorized formulation (one fused pass for all chains, no
data-dependent structure updates).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def acceptance_weights(dE_physical, beta):
    """w_i = min(1, e^{-beta dE_i}) (the `prior` of
    /root/reference/src/DeltaE.jl:299)."""
    return jnp.exp(jnp.minimum(-beta * dE_physical, 0.0))


def categorical_from_weights(key, w):
    """Sample an index proportionally to non-negative weights w (exact inverse
    CDF via cumsum + searchsorted; replaces bucket scan + ArraySet rand,
    /root/reference/src/DeltaE.jl:146-167)."""
    c = jnp.cumsum(w)
    z = c[-1]
    u = jax.random.uniform(key, (), c.dtype) * z
    i = jnp.searchsorted(c, u, side="right")
    return jnp.clip(i, 0, w.shape[0] - 1), z


def geometric_skip(key, p):
    """Number of rejected virtual iterations before an accepted BKL move:
    skip ~ Geometric(p), P(skip=k) = (1-p)^k p (rand_skip,
    /root/reference/src/DeltaE.jl:141-144). p = z/N in (0, 1]."""
    u = jax.random.uniform(key, (), jnp.float64 if jax.config.jax_enable_x64
                           else jnp.float32)
    # floor(log(1-u)/log(1-p)); guard p ~ 1 and p ~ 0
    eps = jnp.finfo(u.dtype).tiny
    denom = jnp.log1p(-jnp.minimum(p, 1 - 1e-12))
    skip = jnp.floor(jnp.log(jnp.maximum(1 - u, eps)) / denom)
    skip = jnp.where(p >= 1.0, 0.0, skip)
    return skip.astype(jnp.int64 if jax.config.jax_enable_x64 else jnp.int32)


def accept_factor(key, c, x):
    """Accept with prob min(1, c * e^x) (reference `accept(c, x)`,
    /root/reference/src/RRRMC.jl:40-44), branchless.

    Computed in the log domain: u < c*e^x  <=>  log u < log c + x. This is
    exact at any magnitude — c = z/z' can be astronomically small while e^x
    is astronomically large at extreme beta (rrrMC Double residual), where a
    direct f32 product would need an overflow cap that silently turns
    certain-accept moves (c*e^x >= 1 with c < e^-30) into near-certain
    rejects. log(u=0) = -inf accepts, matching u < a for any a > 0 up to a
    zero-probability event; log(c=0) + x = -inf never accepts, matching."""
    u = jax.random.uniform(key, (), jnp.float32)
    return jnp.log(u) < jnp.log(c) + x


def inner_view(model):
    """(inner_model, aux projection) — identity for single models."""
    inner = model.inner
    if inner is None:
        return model, (lambda aux: aux)
    return inner, model.inner_aux


def tree_where(pred, a, b):
    """Select pytree a where scalar pred else b."""
    return jax.tree.map(lambda x, y: jnp.where(pred, x, y), a, b)
