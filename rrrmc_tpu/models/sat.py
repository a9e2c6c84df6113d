"""Random K-SAT model: energy = number of violated clauses.

The reference maintains a ClauseCache of per-clause satisfying-variable counts
S[a] plus the identity list I[a], updated with ~40 lines of branchy
incremental bookkeeping per flip (/root/reference/src/graphs/SAT.jl:58-320).
Vectorized, the same state is two dense tensors:

* clause-major:  A [Mc, K] var ids (pad N), L [Mc, K] literal signs +-1 (pad 0)
* var-major:     T [N, Cmax] clause ids (pad Mc), TL [N, Cmax] literal signs

aux = sat [Mc] int32 (# satisfying vars per clause). A flip of var i is one
O(Cmax) scatter-add (sat[T[i]] -= sigma_i * TL[i]); delta_one is one O(Cmax)
gather; delta_all is one fused O(Mc*K) scatter pass over all clauses — one
kernel for the whole batch instead of per-move pointer chasing.

Energies are exact int32; allDeltaE = 0..max_conn (SAT.jl:325).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import jax.numpy as jnp

from ..core.struct import pytree, static
from ..core.model import Model, flip_spin
from ..core.dtypes import itype


@pytree
class SATModel(Model):
    A: jnp.ndarray    # [Mc, K] int32 var ids, padded with N
    L: jnp.ndarray    # [Mc, K] int32 literal signs (+-1), 0 on padding
    T: jnp.ndarray    # [N, Cmax] int32 clause ids, padded with Mc
    TL: jnp.ndarray   # [N, Cmax] int32 literal signs, 0 on padding
    N: int = static()
    Mc: int = static()
    K: int = static()
    Cmax: int = static()
    max_conn: int = static()
    scale: float = static(1.0)

    def _sat_counts(self, sigma):
        se = jnp.concatenate([sigma.astype(jnp.int32), jnp.zeros((1,), jnp.int32)])
        return (se[self.A] == self.L).astype(jnp.int32).sum(axis=1)

    def energy(self, sigma):
        return jnp.sum(self._sat_counts(sigma) == 0, dtype=itype())

    def init_aux(self, sigma):
        return self._sat_counts(sigma)

    def delta_all(self, sigma, aux):
        """dE_i = #{a : i sole satisfier of a} - #{a : i in a, a violated}
        (the lfields of SAT.jl:213-225, computed in one scatter pass)."""
        se = jnp.concatenate([sigma.astype(jnp.int32), jnp.zeros((1,), jnp.int32)])
        m = se[self.A] == self.L                       # [Mc, K] i satisfies a
        sat = aux[:, None]
        contrib = jnp.where(m & (sat == 1), 1, 0) + jnp.where(
            (~m) & (sat == 0) & (self.L != 0), -1, 0)
        out = jnp.zeros((self.N + 1,), itype())
        out = out.at[self.A.reshape(-1)].add(contrib.reshape(-1).astype(itype()),
                                             mode="drop")
        return out[: self.N]

    def delta_one(self, sigma, aux, i):
        sat_ext = jnp.concatenate([aux, jnp.zeros((1,), jnp.int32)])
        ci = self.T[i]                                  # [Cmax]
        sat_c = sat_ext[jnp.minimum(ci, self.Mc)]
        tl = self.TL[i]
        m = sigma[i].astype(jnp.int32) == tl
        d = jnp.where(m & (sat_c == 1), 1, 0) + jnp.where(
            (~m) & (sat_c == 0) & (tl != 0), -1, 0)
        return jnp.sum(d, dtype=itype())

    def flip(self, sigma, aux, i, do):
        upd = -sigma[i].astype(jnp.int32) * self.TL[i]  # [Cmax], 0 on padding
        tgt = jnp.where(do, self.T[i], self.Mc)
        aux = jnp.concatenate([aux, jnp.zeros((1,), jnp.int32)])
        aux = aux.at[tgt].add(upd, mode="drop")[: self.Mc]
        return flip_spin(sigma, i, do), aux

    def delta_classes(self):
        return tuple(float(x) for x in range(self.max_conn + 1))

    def var_neighb(self):
        """Per-variable neighborhood (vars sharing a clause; SAT.jl:99-107),
        as ragged python lists — used by the TLE wrapper."""
        A = np.asarray(self.A)
        neighb = [set() for _ in range(self.N)]
        for a in range(self.Mc):
            row = [int(v) for v in A[a] if v < self.N]
            for x in row:
                for y in row:
                    if x != y:
                        neighb[x].add(y)
        return [sorted(s) for s in neighb]


def GraphSAT(N: int, K: int, alpha: float, *, seed=None) -> SATModel:
    """Random K-SAT with round(alpha*N) clauses of K distinct vars and random
    literal signs (gen_randomKSAT, /root/reference/src/graphs/SAT.jl:42-56)."""
    assert N > 0 and K > 0 and alpha >= 0 and N >= K
    rng = np.random.default_rng(seed)
    Mc = int(round(alpha * N))
    A = np.empty((Mc, K), dtype=np.int32)
    for a in range(Mc):
        A[a] = rng.choice(N, size=K, replace=False)
    L = rng.choice([-1, 1], size=(Mc, K)).astype(np.int32)
    return make_sat(N, A, L)


def make_sat(N: int, A: np.ndarray, L: np.ndarray) -> SATModel:
    """Build from explicit clause arrays: A [Mc, K] var ids, L [Mc, K] literal
    signs (+1: satisfied by sigma=+1)."""
    A = np.asarray(A, dtype=np.int32)
    L = np.asarray(L, dtype=np.int32)
    Mc, K = A.shape
    counts = np.zeros(N, dtype=np.int64)
    for a in range(Mc):
        for v in A[a]:
            if v < N:
                counts[v] += 1
    Cmax = max(int(counts.max(initial=0)), 1)
    T = np.full((N, Cmax), Mc, dtype=np.int32)
    TL = np.zeros((N, Cmax), dtype=np.int32)
    fill = np.zeros(N, dtype=np.int64)
    for a in range(Mc):
        for k in range(K):
            v = A[a, k]
            if v < N:
                T[v, fill[v]] = a
                TL[v, fill[v]] = L[a, k]
                fill[v] += 1
    return SATModel(A=jnp.asarray(A), L=jnp.asarray(L),
                    T=jnp.asarray(T), TL=jnp.asarray(TL),
                    N=N, Mc=Mc, K=K, Cmax=Cmax,
                    max_conn=int(counts.max(initial=0)))


def export_cnf(X: SATModel, filename: str, decimate=None):
    """DIMACS CNF export (SAT.jl:129-140); with `decimate` (a list of
    1-based signed variables assumed fixed) performs unit propagation before
    writing, mirroring SAT.jl:142-187: satisfied clauses drop, falsified
    literals are removed, clauses reduced to units join the decimation list
    (contradictions raise)."""
    A = np.asarray(X.A)
    L = np.asarray(X.L)
    clauses = [[(int(A[a, k]), int(L[a, k])) for k in range(A.shape[1])
                if A[a, k] < X.N] for a in range(X.Mc)]
    decimate = list(dict.fromkeys(decimate)) if decimate else []  # dedupe
    if decimate:
        if any(-v in decimate for v in decimate):
            raise ValueError("contradiction in decimation list")
        T = [[] for _ in range(X.N)]
        for a, cl in enumerate(clauses):
            for i, _ in cl:
                T[i].append(a)
        j = 0
        while j < len(decimate):
            v = decimate[j]
            s, i = (1 if v > 0 else -1), abs(v) - 1
            for a in T[i]:
                cl = clauses[a]
                if not cl:
                    continue
                k = next(kk for kk, (ii, _) in enumerate(cl) if ii == i)
                if cl[k][1] == s:
                    clauses[a] = []          # clause satisfied
                else:
                    if len(cl) == 1:
                        raise ValueError("contradiction during decimation")
                    del cl[k]
                    if len(cl) == 1:
                        newv = (cl[0][0] + 1) * cl[0][1]
                        if -newv in decimate:
                            raise ValueError("contradiction during decimation")
                        if newv not in decimate:
                            decimate.append(newv)
                        clauses[a] = []      # emitted as a unit below
            T[i] = []
            j += 1
    n_out = sum(1 for cl in clauses if cl) + len(decimate)
    with open(filename, "w") as f:
        f.write(f"p cnf {X.N} {n_out}\n")
        for cl in clauses:
            if cl:
                f.write(" ".join(str(s * (i + 1)) for i, s in cl) + " 0\n")
        for v in decimate:
            f.write(f"{v} 0\n")


# --- replica-ensemble aliases (REAliases.jl / LEAliases.jl / TLEAliases.jl) --

def GraphSATRE(N, K, alpha, M, gamma, beta, *, seed=None):
    from .replicas import GraphRobustEnsemble
    return GraphRobustEnsemble(N, M, gamma, beta, GraphSAT(N, K, alpha, seed=seed))


def GraphSATLE(N, K, alpha, M, gamma, beta, *, seed=None):
    from .replicas import GraphLocalEntropy
    return GraphLocalEntropy(N, M, gamma, beta, GraphSAT(N, K, alpha, seed=seed))


def GraphSATTLE(N, K, alpha, M, gamma, lambda_, beta, *, seed=None):
    from .replicas import GraphTopologicalLocalEntropy
    base = GraphSAT(N, K, alpha, seed=seed)
    return GraphTopologicalLocalEntropy(N, M, gamma, lambda_, beta, base,
                                        neighb=base.var_neighb())
