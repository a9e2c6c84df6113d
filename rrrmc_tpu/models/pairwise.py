"""Generic sparse pairwise Ising model with padded neighbor lists.

This single kernel implements the whole family of 2-body models in the
reference (EA lattices, RRG, Ising1D, the Suzuki-Trotter ring GraphQT, the
local-entropy star GraphLE, external fields): adjacency as a dense padded
[N, Kmax] int32 table (static shapes for jit; padding entries point at
the sentinel index N and carry J=0), couplings as a matching [N, Kmax] table
with each symmetric edge stored twice, plus per-spin external fields.

Energy convention (matches e.g. /root/reference/src/graphs/EA.jl:195-222):

    E = -1/2 sum_i sigma_i sum_k J[i,k] sigma[neigh[i,k]] - sum_i h_i sigma_i

Auxiliary state: the local field lf_i = sum_k J[i,k] sigma_nb + h_i, so that
dE_i = 2 sigma_i lf_i (the LocalFields cache of /root/reference/src/Common.jl:27
materialized as a dense vector). A flip of spin i updates lf only at i's
neighbors — an O(degree) scatter-add with sentinel-drop masking, the
vectorized equivalent of update_cache! (/root/reference/src/graphs/EA.jl:224).

Integer-coupling instances keep lf/E in exact int32 (the DFloat64 fixed-point
idea, /root/reference/src/DFloats.jl) with a static `scale` to physical units.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import jax.numpy as jnp

from ..core.struct import pytree, static
from ..core.model import Model, flip_spin
from ..core.dtypes import ftype, itype, FIXED_POINT_SCALE


@pytree
class Pairwise(Model):
    neigh: jnp.ndarray  # [N, K] int32, padded with N
    J: jnp.ndarray      # [N, K] couplings (0 on padding)
    h: jnp.ndarray      # [N] external fields
    offset: jnp.ndarray  # scalar constant energy shift (internal units)
    N: int = static()
    K: int = static()
    scale: float = static(1.0)
    classes: Optional[Tuple[float, ...]] = static(None)

    # -- helpers --
    def _sig_ext(self, sigma):
        """sigma extended with a zero sentinel slot, in coupling dtype."""
        z = jnp.zeros((1,), self.J.dtype)
        return jnp.concatenate([sigma.astype(self.J.dtype), z])

    def local_fields(self, sigma):
        se = self._sig_ext(sigma)
        return (self.J * se[self.neigh]).sum(axis=1) + self.h

    # -- Model interface --
    def energy(self, sigma):
        lf = self.local_fields(sigma)
        s = sigma.astype(self.J.dtype)
        pair = (s * (lf - self.h)).sum()
        if jnp.issubdtype(self.J.dtype, jnp.integer):
            pair = pair // 2
        else:
            pair = pair / 2
        return -(pair + (s * self.h).sum()) + self.offset

    def init_aux(self, sigma):
        return self.local_fields(sigma)

    def delta_all(self, sigma, aux):
        return 2 * sigma.astype(self.J.dtype) * aux

    def delta_one(self, sigma, aux, i):
        return 2 * sigma[i].astype(self.J.dtype) * aux[i]

    def flip(self, sigma, aux, i, do):
        n = self.N
        nb = self.neigh[i]          # [K]; reads clamp at i==N, values masked below
        jrow = self.J[i]
        s_i = sigma[i].astype(self.J.dtype)
        tgt = jnp.where(do, nb, n)  # padding already == n
        aux = aux.at[tgt].add(-2 * s_i * jrow, mode="drop")
        sigma = flip_spin(sigma, i, do)
        return sigma, aux

    def delta_classes(self):
        return self.classes


def _pad_adjacency(adj: Sequence[Sequence[int]], couplings: Sequence[Sequence[float]],
                   n: int, kmax: Optional[int] = None):
    """Build padded [N, K] numpy tables from ragged per-spin lists."""
    if kmax is None:
        kmax = max((len(a) for a in adj), default=0)
    kmax = max(kmax, 1)
    neigh = np.full((n, kmax), n, dtype=np.int32)
    jmat = np.zeros((n, kmax), dtype=np.float64)
    for i, (a, js) in enumerate(zip(adj, couplings)):
        assert len(a) == len(js)
        neigh[i, : len(a)] = a
        jmat[i, : len(a)] = js
    return neigh, jmat


def make_pairwise(adj, couplings, n, *, h=None, offset=0.0, kmax=None,
                  integer_scale: Optional[float] = None,
                  classes: Optional[Tuple[float, ...]] = None) -> Pairwise:
    """Construct a Pairwise model from ragged python/numpy adjacency.

    integer_scale: if given, couplings/fields are exact multiples of it; the
    model stores int32 internally with `scale=integer_scale` (exact discrete
    energies). If None, float storage with scale=1.
    """
    neigh, jmat = _pad_adjacency(adj, couplings, n, kmax)
    hvec = np.zeros(n) if h is None else np.asarray(h, dtype=np.float64)
    if integer_scale is not None:
        ji = np.round(jmat / integer_scale).astype(np.int32)
        hi = np.round(hvec / integer_scale).astype(np.int32)
        oi = np.int32(round(offset / integer_scale))
        assert np.allclose(ji * integer_scale, jmat, atol=1e-12), "couplings not on grid"
        assert np.allclose(hi * integer_scale, hvec, atol=1e-12), "fields not on grid"
        return Pairwise(
            neigh=jnp.asarray(neigh), J=jnp.asarray(ji, itype()),
            h=jnp.asarray(hi, itype()), offset=jnp.asarray(oi, itype()),
            N=n, K=neigh.shape[1], scale=float(integer_scale), classes=classes)
    ft = ftype()
    return Pairwise(
        neigh=jnp.asarray(neigh), J=jnp.asarray(jmat, ft),
        h=jnp.asarray(hvec, ft), offset=jnp.asarray(offset, ft),
        N=n, K=neigh.shape[1], scale=1.0, classes=classes)


def infer_integer_scale(values: np.ndarray) -> Optional[float]:
    """Pick an exact fixed-point scale for a finite level set, mirroring the
    DFloat64 auto-wrap of Float64 levels (/root/reference/src/graphs/RRG.jl:162):
    integers get scale 1, short decimals get 10^-5 grid, else None."""
    values = np.asarray(values, dtype=np.float64)
    if np.allclose(values, np.round(values), atol=0):
        return 1.0
    scaled = values * FIXED_POINT_SCALE
    if np.allclose(scaled, np.round(scaled), atol=1e-9):
        return 1.0 / FIXED_POINT_SCALE
    return None


def enumerate_pair_classes(levels: Sequence[float], degree: int) -> Tuple[float, ...]:
    """All possible non-negative |dE| values for a spin of exact degree
    `degree` with couplings drawn from `levels` (the allDeltaE analog,
    computed at build time instead of @generated,
    /root/reference/src/graphs/EA.jl:293)."""
    sums = {0.0}
    for _ in range(degree):
        sums = {s + 2.0 * l * sgn for s in sums for l in levels for sgn in (-1.0, 1.0)}
    out = sorted({abs(round(s, 9)) for s in sums})
    return tuple(out)
