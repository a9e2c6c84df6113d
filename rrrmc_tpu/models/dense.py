"""Dense fully-connected models: Sherrington-Kirkpatrick and friends.

The reference stores SK couplings as BitVector rows with XOR-popcount energy
kernels and @simd cache updates (/root/reference/src/graphs/SK.jl:17-133).
Vectorized, a fully-connected model is *matmul-shaped*: the local-field cache
is lf = J @ sigma + h (one matvec at init — and across a batch of chains a
[B, N] x [N, N] matmul), and a flip updates lf by adding a scaled row of J
(one fused elementwise op). `neighbors = AllButOne` (/root/reference/src/graphs/SK.jl:165)
disappears: density is the point.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import jax.numpy as jnp

from ..core.struct import pytree, static
from ..core.model import Model, flip_spin
from ..core.dtypes import ftype, itype


@pytree
class FullyConnected(Model):
    """E = -1/2 sigma^T J sigma - h . sigma, with J symmetric, zero diagonal.

    Integer-valued J/h instances keep an exact int32 internal domain with a
    static `scale` to physical units (the SK +-1/sqrt(N) case)."""

    J: jnp.ndarray       # [N, N] symmetric, zero diagonal
    h: jnp.ndarray       # [N]
    N: int = static()
    scale: float = static(1.0)
    #: run the local-field matmul in bf16 (EXACT when |J| <= 127 and row
    #: sums < 2^24: products are small integers, accumulation is f32; set by
    #: densify()).
    mm_bf16: bool = static(False)

    @property
    def _acc_dtype(self):
        """Accumulator dtype: int32 for integer J (J may be stored int8 —
        densify() does — so products/sums must widen), else J's float."""
        return (jnp.int32 if jnp.issubdtype(self.J.dtype, jnp.integer)
                else self.J.dtype)

    def local_fields(self, sigma):
        import jax.lax as lax
        acc = self._acc_dtype
        if self.mm_bf16:
            # integer |J| <= 256 and +-1 spins are exact in bf16, and f32
            # accumulates their integer products exactly below 2^24: exact
            lf = lax.dot_general(self.J.astype(jnp.bfloat16),
                                 sigma.astype(jnp.bfloat16),
                                 dimension_numbers=(((1,), (0,)), ((), ())),
                                 preferred_element_type=jnp.float32)
            lf = lf.astype(acc)
        else:
            # HIGHEST: a float J must not run in TF32, or the tracked
            # energy drifts from the recomputed one
            lf = lax.dot_general(self.J, sigma.astype(self.J.dtype),
                                 dimension_numbers=(((1,), (0,)), ((), ())),
                                 precision=lax.Precision.HIGHEST,
                                 preferred_element_type=acc)
        return lf + self.h.astype(acc)

    def energy(self, sigma):
        acc = self._acc_dtype
        s = sigma.astype(acc)
        lf = self.local_fields(sigma)
        quad = jnp.matmul(s, lf - self.h.astype(acc), precision="highest")
        if jnp.issubdtype(acc, jnp.integer):
            quad = quad // 2  # exact: symmetric J, zero diag => quad is even
        else:
            quad = quad / 2
        return -(quad + jnp.matmul(s, self.h.astype(acc),
                                   precision="highest"))

    def init_aux(self, sigma):
        return self.local_fields(sigma)

    def delta_all(self, sigma, aux):
        return 2 * sigma.astype(self._acc_dtype) * aux

    def delta_one(self, sigma, aux, i):
        return 2 * sigma[i].astype(self._acc_dtype) * aux[i]

    def flip(self, sigma, aux, i, do):
        acc = self._acc_dtype
        s_i = sigma[i].astype(acc)
        row = self.J[i].astype(acc)
        upd = jnp.where(do, -2 * s_i, jnp.zeros_like(s_i))
        aux = aux + upd * row
        return flip_spin(sigma, i, do), aux


def _sym_zero_diag(J: np.ndarray) -> np.ndarray:
    J = np.triu(J, 1)
    return J + J.T


def GraphSK(N: int, *, seed=None) -> FullyConnected:
    """SK with binary couplings +-1/sqrt(N) (gen_J,
    /root/reference/src/graphs/SK.jl:17-26). Exact int32 internal domain with
    scale 1/sqrt(N)."""
    rng = np.random.default_rng(seed)
    J = _sym_zero_diag(rng.choice([-1, 1], size=(N, N)).astype(np.int32))
    return FullyConnected(J=jnp.asarray(J, itype()),
                          h=jnp.zeros((N,), itype()),
                          N=N, scale=1.0 / np.sqrt(N))


def GraphSKNormal(N: int, *, seed=None) -> FullyConnected:
    """SK with Gaussian couplings N(0, 1/N)
    (/root/reference/src/graphs/SK.jl:170-297)."""
    rng = np.random.default_rng(seed)
    J = _sym_zero_diag(rng.standard_normal((N, N)) / np.sqrt(N))
    return FullyConnected(J=jnp.asarray(J, ftype()),
                          h=jnp.zeros((N,), ftype()), N=N)


def densify(model) -> FullyConnected:
    """Sparse Pairwise -> dense FullyConnected with the same physical
    energies: J materialized as a symmetric [N, N] matrix (int8 when the
    integer couplings fit, preserving exactness via `scale`).

    Why: per-site neighbor gathers are memory-bound, while on the dense
    path local fields become one [B,N]x[N,N] matmul. Composes with
    flatten(): e.g. densify(flatten(GraphQuant(..., GraphEA(...)))) puts a
    wrapped model on the dense path. Memory is O(N^2); intended for N up to a few 10^4."""
    from .pairwise import Pairwise

    assert isinstance(model, Pairwise), "densify requires a Pairwise model"
    assert float(np.asarray(model.offset)) == 0.0, \
        "constant energy offsets are not representable in FullyConnected"
    n = model.N
    neigh = np.asarray(model.neigh)
    Jt = np.asarray(model.J)
    dense = np.zeros((n, n), dtype=np.float64)
    for i in range(n):
        for k in range(neigh.shape[1]):
            j = int(neigh[i, k])
            if j < n:
                dense[i, j] += float(Jt[i, k])
    assert np.allclose(dense, dense.T), "adjacency must be symmetric"
    np.fill_diagonal(dense, 0.0)
    h = np.asarray(model.h)
    if jnp.issubdtype(model.J.dtype, jnp.integer):
        di = np.round(dense).astype(np.int64)
        assert np.array_equal(di, dense)
        dt = np.int8 if np.abs(di).max() <= 127 else np.int32
        mm_bf16 = bool(dt == np.int8
                       and np.abs(di).sum(axis=1).max() < (1 << 24))
        return FullyConnected(J=jnp.asarray(di.astype(dt)),
                              h=jnp.asarray(h, itype()), N=n,
                              scale=model.scale, mm_bf16=mm_bf16)
    return FullyConnected(J=jnp.asarray(dense * model.scale, ftype()),
                          h=jnp.asarray(h * model.scale, ftype()), N=n)


def make_fully_connected(J, h=None, *, scale: Optional[float] = None
                         ) -> FullyConnected:
    """Build from an explicit symmetric coupling matrix (zero diagonal
    enforced); `scale` marks J as exact integers in physical units J*scale."""
    J = np.asarray(J)
    N = J.shape[0]
    assert J.shape == (N, N) and np.allclose(J, J.T), "J must be symmetric"
    J = J - np.diag(np.diag(J))
    hv = np.zeros(N) if h is None else np.asarray(h, dtype=np.float64)
    if scale is not None:
        Ji = np.round(J / scale).astype(np.int32)
        hi = np.round(hv / scale).astype(np.int32)
        assert np.allclose(Ji * scale, J, atol=1e-12)
        assert np.allclose(hi * scale, hv, atol=1e-12)
        return FullyConnected(J=jnp.asarray(Ji, itype()),
                              h=jnp.asarray(hi, itype()), N=N, scale=scale)
    return FullyConnected(J=jnp.asarray(J, ftype()),
                          h=jnp.asarray(hv, ftype()), N=N)
