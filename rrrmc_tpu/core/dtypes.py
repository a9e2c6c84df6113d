"""Dtype policy.

The reference works in Float64/Int throughout (Julia). On an accelerator
float64 is slow, so the policy is:

* integer-valued models (discrete couplings) keep an exact int32 internal
  energy domain, converted to physical units by a static per-model `scale`
  (this is the accelerator version of the DFloat64 fixed-point trick,
  /root/reference/src/DFloats.jl:11-23: exact arithmetic so that discrete
  delta-E identities never suffer float roundoff);
* continuous models use the default float dtype: float64 when JAX x64 is
  enabled (CPU test runs), float32 otherwise (GPU production runs).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

#: fixed-point scale used when discretizing Float64 coupling levels, mirroring
#: MAXDIGITS=5 in /root/reference/src/DFloats.jl:23
FIXED_POINT_DIGITS = 5
FIXED_POINT_SCALE = 10 ** FIXED_POINT_DIGITS


def ftype():
    """Default floating dtype: f64 if x64 is enabled, else f32."""
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def itype():
    """Default integer dtype for exact discrete energies."""
    return jnp.int32
