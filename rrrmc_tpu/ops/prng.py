"""Counter-based random bits for Pallas kernels.

A stateless murmur3-style hash of (salt, site, chain): the same function runs
in the compiled kernel and in interpret mode, so the CPU tests exercise the
generator that production uses. Callers pass a `salt` that differs per draw
(seed x sweep x colour); site and chain are global indices, so the bits a
chain sees do not depend on how chains are blocked or padded.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

#: Knuth multiplicative constant 0x9E3779B9 (golden ratio)
GOLD = 0x9E3779B9


def fmix(x):
    """murmur3 32-bit finalizer (full avalanche); uint32 in, uint32 out."""
    x = x ^ (x >> 16)
    x = x * jnp.uint32(0x85EBCA6B)
    x = x ^ (x >> 13)
    x = x * jnp.uint32(0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def seed_salt(seed):
    """uint32 stream key of an int32 seed (one fmix: consecutive seeds give
    unrelated streams)."""
    return fmix(seed.astype(jnp.uint32) * jnp.uint32(GOLD)
                + jnp.uint32(0x27D4EB2F))


def draw_salt(key, counter):
    """uint32 salt of one draw: the stream key advanced by a per-draw
    counter (e.g. 2 * sweep + colour)."""
    return fmix(key + counter.astype(jnp.uint32) * jnp.uint32(0xC2B2AE3D))


def random_bits(site, chain, salt):
    """Uniform int32 bits at broadcast (site, chain) positions.

    site, chain: non-negative int32 index arrays that broadcast together;
    salt: uint32 scalar from `draw_salt`."""
    x = (site.astype(jnp.uint32) * jnp.uint32(0x9E3779B1)
         + chain.astype(jnp.uint32) * jnp.uint32(0x85EBCA77) + salt)
    return jax.lax.bitcast_convert_type(fmix(x), jnp.int32)
