"""3-spin regular hypergraph model (p-spin, p=3).

E = -sum over hyperedges (triangles) of sigma_x sigma_y sigma_z, with every
spin belonging to exactly K triangles (all J = 1). The reference keeps an
incremental lfields cache updated over unique neighbors
(/root/reference/src/graphs/PSpin3.jl:62-145); vectorized, the per-spin cavity
sum is one fused [N, K, 2] gather + product + reduce, so the model is aux-free
(flip = bitflip; delta_all is a single vector pass for all spins and chains).

Exact int32 energies; allDeltaE = (0,4,...,2K) for even K, (2,6,...,2K) odd
(PSpin3.jl:178-180).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..core.struct import pytree, static
from ..core.model import Model, flip_spin
from ..core.dtypes import itype


@pytree
class PSpin3(Model):
    A: jnp.ndarray   # [N, K, 2] the two partners of spin x in each triangle
    N: int = static()
    K: int = static()
    scale: float = static(1.0)

    def _cavity(self, sigma):
        """[N] sum_k sigma_y sigma_z over x's K triangles."""
        s = sigma.astype(itype())
        pairs = s[self.A]                      # [N, K, 2]
        return (pairs[..., 0] * pairs[..., 1]).sum(axis=1)

    def energy(self, sigma):
        s = sigma.astype(itype())
        tot = (s * self._cavity(sigma)).sum()  # counts each triangle 3x
        return -tot // 3

    def init_aux(self, sigma):
        return ()

    def delta_all(self, sigma, aux):
        return 2 * sigma.astype(itype()) * self._cavity(sigma)

    def delta_one(self, sigma, aux, i):
        s = sigma.astype(itype())
        pairs = s[self.A[i]]                   # [K, 2]
        return 2 * s[i] * (pairs[:, 0] * pairs[:, 1]).sum()

    def flip(self, sigma, aux, i, do):
        return flip_spin(sigma, i, do), aux

    def delta_classes(self):
        K = self.K
        if K % 2 == 0:
            return tuple(float(4 * d) for d in range(K // 2 + 1))
        return tuple(float(2 * (2 * d - 1)) for d in range(1, (K + 1) // 2 + 1))


def GraphPSpin3(N: int, K: int, *, seed=None) -> PSpin3:
    """Random 3-spin regular hypergraph: K random perfect triangle partitions
    (PSpin3.jl:21-53). N must be divisible by 3."""
    assert K >= 1
    if N % 3 != 0:
        raise ValueError(f"N must be divisible by 3, given: {N}")
    rng = np.random.default_rng(seed)
    A = np.zeros((N, K, 2), dtype=np.int32)
    for k in range(K):
        perm = rng.permutation(N)
        for i in range(0, N, 3):
            v1, v2, v3 = perm[i], perm[i + 1], perm[i + 2]
            A[v1, k] = (v2, v3)
            A[v2, k] = (v1, v3)
            A[v3, k] = (v1, v2)
    return PSpin3(A=jnp.asarray(A), N=N, K=K)
