"""Replica-ensemble wrappers: quantum Suzuki-Trotter (GraphQuant), robust
ensemble (GraphRobustEnsemble), local entropy (GraphLocalEntropy), topological
local entropy (GraphTopologicalLocalEntropy), and the AddFields family.

The reference implements these as DoubleGraphs holding M mirrored `Config`
copies kept in sync by update_cache! (/root/reference/src/graphs/QT.jl:126-199,
RE.jl:216-327, LE.jl:183-318, TLE.jl:351-502). Vectorized, the replica axis is
a *reshape* of the composite spin vector plus a `jax.vmap` of the base model
over it — no mirrored state, no sync logic; the base model's aux is simply
batched with a leading replica axis.

Index layouts (all mirrored exactly from the reference so that configurations
and observables are inter-convertible):

* Quant   (replica-major): spin (i, k) -> i + k*Nk   (QT.jl:172-182)
* RE      (site-major):    spin (i, k) -> k + i*M    (RE.jl:255-263)
* LE/TLE  (site-major, slot 0 = reference config):
                           spin (i, s) -> s + i*(M+1) (LE.jl:227-240)

Replica disorder: the reference's practical entry points (QAliases/REAliases/
LEAliases) pass an explicitly-generated disorder instance to every replica, so
all replicas share one base model; we take the already-built base `Model`
directly.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..core.struct import pytree, static
from ..core.model import Model, flip_spin
from ..core.dtypes import ftype
from .pairwise import Pairwise, make_pairwise
from .composite import Double, Mixed

MAXDIGITS = 8  # QT.jl:40: fourK rounded to 8 decimal digits


# ---------------------------------------------------------------------------
# Replicated: M copies of a base model as one Model over the composite layout
# ---------------------------------------------------------------------------

@pytree
class Replicated(Model):
    """M replicas of `base` (shared disorder), energy = weight * sum_k E_k.

    Acts on the composite spin vector of N = Nk * n_slots spins in
    REPLICA-MAJOR block layout: blocks [0, offset) are center configurations
    (the LE reference spins; they contribute nothing here), replica k lives
    in the contiguous block [(offset + k) * Nk, (offset + k + 1) * Nk).

    This layout is a deliberate deviation from the reference's site-major
    RE/LE conventions (/root/reference/src/graphs/RE.jl:255-263,
    LE.jl:227-240): the hot paths slice one replica's spins per move, and a
    contiguous dynamic_slice is fast while a per-chain strided gather costs
    ~400us/move (measured). Use `to_reference_layout`/`from_reference_layout`
    to convert configurations to/from the reference's index conventions.

    All returned energies are PHYSICAL floats (exact-integer arithmetic stays
    inside `base`)."""

    base: Model
    N: int = static(0)
    Nk: int = static(0)
    n_slots: int = static(0)        # blocks: offset centers + M replicas
    offset: int = static(0)         # number of leading center blocks (LE: 1)
    weight: float = static(1.0)
    scale: float = static(1.0)

    @property
    def M(self) -> int:
        return self.n_slots - self.offset

    # -- layout --
    def to_replicas(self, sigma):
        """[N] composite -> [M, Nk] per-replica spin rows (contiguous)."""
        return sigma[self.offset * self.Nk:].reshape(self.M, self.Nk)

    def decompose(self, i):
        """Composite index -> (replica k, site ii, is_replica)."""
        k = jnp.maximum(i // self.Nk - self.offset, 0)
        return k, i % self.Nk, i >= self.offset * self.Nk

    def replica_row(self, sigma, k):
        """Spin row [Nk] of replica k: one contiguous dynamic slice."""
        import jax.lax as lax
        return lax.dynamic_slice(sigma, ((k + self.offset) * self.Nk,),
                                 (self.Nk,))

    # -- Model interface (all energies physical) --
    def energy(self, sigma):
        rows = self.to_replicas(sigma)
        Es = jax.vmap(lambda s: self.base.to_physical(self.base.energy(s)))(rows)
        return self.weight * jnp.sum(Es)

    def init_aux(self, sigma):
        return jax.vmap(self.base.init_aux)(self.to_replicas(sigma))

    def delta_all(self, sigma, aux):
        rows = self.to_replicas(sigma)
        d = jax.vmap(lambda s, a: self.base.to_physical(
            self.base.delta_all(s, a)))(rows, aux)
        flat = d.reshape(self.M * self.Nk)
        if self.offset:
            flat = jnp.concatenate(
                [jnp.zeros((self.offset * self.Nk,), flat.dtype), flat])
        return self.weight * flat

    def delta_one(self, sigma, aux, i):
        k, ii, is_rep = self.decompose(i)
        aux_k = jax.tree.map(lambda a: a[k], aux)
        sig_k = self.replica_row(sigma, k)
        d = self.base.to_physical(self.base.delta_one(sig_k, aux_k, ii))
        return jnp.where(is_rep, self.weight * d, jnp.zeros_like(d))

    def flip(self, sigma, aux, i, do):
        k, ii, is_rep = self.decompose(i)
        aux_k = jax.tree.map(lambda a: a[k], aux)
        sig_k = self.replica_row(sigma, k)
        _, aux_k2 = self.base.flip(sig_k, aux_k, ii, do & is_rep)
        aux = jax.tree.map(lambda a, a2: a.at[k].set(a2), aux, aux_k2)
        return flip_spin(sigma, i, do), aux

    def replica_energies(self, sigma):
        """[M] physical energies of the individual replicas (Renergies /
        REenergies / LEenergies analog)."""
        rows = self.to_replicas(sigma)
        return jax.vmap(lambda s: self.base.to_physical(self.base.energy(s)))(rows)

    #: synthesize an all-but-self block table for dense bases up to this Nk
    #: (table memory = N * (Nk-1) * 4 bytes)
    DENSE_TABLE_MAX_NK = 4096

    def neighbor_table(self):
        """Composite table: base neighbors shifted into each replica's block
        (flips only affect deltas within their own replica). Center blocks
        (LE `offset` slots) contribute no Replicated energy, so their rows
        are all-sentinel. Dense bases (no base table) get a synthesized
        all-but-self block table when small enough, else None."""
        nb = self.base.neighbor_table()
        if nb is None:
            if self.Nk > self.DENSE_TABLE_MAX_NK or self.Nk < 2:
                return None
            nb = (jnp.arange(self.Nk)[:, None] + 1
                  + jnp.arange(self.Nk - 1)[None, :]) % self.Nk
        nb = nb.astype(jnp.int32)
        pad = nb >= self.Nk
        blocks = [jnp.where(pad, self.N, nb + (self.offset + k) * self.Nk)
                  for k in range(self.M)]
        if self.offset:
            head = jnp.full((self.offset * self.Nk, nb.shape[1]), self.N,
                            jnp.int32)
            blocks.insert(0, head)
        return jnp.concatenate(blocks, axis=0)


# ---------------------------------------------------------------------------
# GraphQT: Suzuki-Trotter ring coupling (QT.jl:42-121)
# ---------------------------------------------------------------------------

def four_K(beta: float, Gamma: float, M: int) -> float:
    """fourK = 2/beta * log(coth(beta*Gamma/M)), rounded to 8 digits
    (QT.jl:165)."""
    x = beta * Gamma / M
    return round(2.0 / beta * math.log(1.0 / math.tanh(x)), MAXDIGITS)


def GraphQT(Nk: int, M: int, fourK: float) -> Pairwise:
    """Ferromagnetic ring over the M Trotter slices of each of Nk sites:
    E = -(fourK/4) sum_{i,k} sigma_{i,k} sigma_{i,k+1} (QT.jl:68-84).
    Stored as an exact integer Pairwise with scale fourK/4; replica-major
    layout, each spin j couples to j +- Nk (mod N) (QT.jl:105-108)."""
    if M <= 2:
        raise ValueError(f"M must be greater than 2, given: {M}")
    N = Nk * M
    adj = [[(j - Nk) % N, (j + Nk) % N] for j in range(N)]
    J = [[1.0, 1.0]] * N
    return make_pairwise(adj, J, N, integer_scale=1.0,
                         classes=(0.0, abs(fourK))).replace(
        scale=fourK / 4.0)


def transverse_mag(qt: Pairwise, sigma, beta: float) -> jnp.ndarray:
    """cosh(x) - p*sinh(x), x = beta*fourK/2, p = -energy0/N (QT.jl:113-121).
    energy0 is the QT internal integer energy (scale-free ring sum)."""
    e0 = qt.energy(sigma)  # internal units = energy0 (J=1 integer ring)
    p = -e0.astype(ftype()) / qt.N
    x = beta * (4.0 * qt.scale) / 2.0
    return jnp.cosh(x) - p * jnp.sinh(x)


@pytree
class QuantModel(Double):
    """GraphQuant: quantum transverse-field model via Suzuki-Trotter
    (QT.jl:126-199). inner = GraphQT ring, resid = M replicas of the base
    classical model with weight 1/M."""

    M: int = static(0)
    Nk: int = static(0)
    beta: float = static(0.0)
    Gamma: float = static(0.0)

    def Qenergy(self, sigma):
        """Average Hamiltonian per spin: -Gamma*transverse_mag + sum_k E_k/N
        (QT.jl:253-268)."""
        tm = transverse_mag(self.inner_m, sigma, self.beta)
        Es = self.resid_m.replica_energies(sigma)
        return -self.Gamma * tm + jnp.sum(Es) / self.N

    def transverse_mag(self, sigma):
        return transverse_mag(self.inner_m, sigma, self.beta)

    def Renergies(self, sigma):
        """[M] individual replica energies (QT.jl:201-211)."""
        return self.resid_m.replica_energies(sigma)

    def overlaps(self, sigma):
        """[M//2] average replica overlap by Trotter distance delta
        (QT.jl:213-251)."""
        M, Nk = self.M, self.Nk
        rows = self.resid_m.to_replicas(sigma).astype(jnp.int32)
        q = rows @ rows.T  # [M, M] spin dot products
        k = np.arange(M)
        d = np.abs(k[:, None] - k[None, :])
        d = np.minimum(d, M - d)
        out = []
        for delta in range(1, M // 2 + 1):
            mask = jnp.asarray((d == delta) & (k[:, None] < k[None, :]),
                               jnp.int32)
            tot = jnp.sum(q * mask)
            denom = (M * Nk) if (M % 2 == 1 or delta < M // 2) else (M * Nk // 2)
            out.append(tot / denom)
        return jnp.stack(out)


def GraphQuant(Nk: int, M: int, Gamma: float, beta: float,
               base: Model) -> QuantModel:
    """Suzuki-Trotter replication of the classical model `base` (on Nk spins)
    in transverse field Gamma at inverse temperature beta (QT.jl:149-170).
    The base model is shared by all M Trotter slices, as the reference's
    aliases do (QAliases.jl:43: every replica gets the same generated J)."""
    assert Gamma >= 0
    assert base.N == Nk, f"base model has N={base.N}, expected {Nk}"
    fourK = four_K(beta, Gamma, M)
    N = Nk * M
    inner = GraphQT(Nk, M, fourK)
    resid = Replicated(base=base, N=N, Nk=Nk, n_slots=M, offset=0,
                       weight=1.0 / M)
    return QuantModel(inner_m=inner, resid_m=resid, N=N,
                      M=M, Nk=Nk, beta=beta, Gamma=Gamma)


# ---------------------------------------------------------------------------
# GraphRE: robust-ensemble star interaction (RE.jl:28-212)
# ---------------------------------------------------------------------------

def _log2cosh(x):
    """log(2*cosh(x)), overflow-safe."""
    ax = jnp.abs(x)
    return ax + jnp.log1p(jnp.exp(-2.0 * ax))


def _fk_table(M: int, gamma: float, beta: float) -> np.ndarray:
    """fk(mubar) = [log cosh(g*(mubar+1)) - log cosh(g*(mubar-1))]/beta for
    mubar in {-M+1, -M+3, ..., M-1}; entry d holds mubar = 2d - M + 1
    (the Delta-E list of RE.jl:60-67)."""
    def logcoshratio(a, b):
        a, b = abs(a), abs(b)
        return (a - b) + (math.log1p(math.exp(-2 * a))
                          - math.log1p(math.exp(-2 * b)))
    mubar = np.arange(M) * 2 - M + 1
    return np.array([logcoshratio(gamma * (m + 1), gamma * (m - 1)) / beta
                     for m in mubar])


@pytree
class GraphRE(Model):
    """Interaction part of the robust ensemble: E = -sum_i log(2cosh(gamma*
    mu_i))/beta with mu_i the replica magnetization of site i (RE.jl:70-104).
    REPLICA-MAJOR layout j = site + k*Nk (deviation from the reference's
    site-major RE.jl:255-263 — see Replicated); aux = mu [Nk] int32. delta of
    flipping (i,k) is sigma_{ik} * fk(mu_i - sigma_{ik}) via the fk table;
    delta_all is reshape-free (mu tiled across replica blocks)."""

    fk: jnp.ndarray          # [M] fk values indexed by (mubar + M - 1) // 2
    N: int = static(0)
    Nk: int = static(0)
    Mr: int = static(0)
    gamma: float = static(0.0)
    beta_p: float = static(0.0)
    scale: float = static(1.0)

    def _rows(self, sigma):
        return sigma.reshape(self.Mr, self.Nk)  # [k, i]

    def energy(self, sigma):
        mu = self._rows(sigma).astype(jnp.int32).sum(axis=0)
        return -jnp.sum(_log2cosh(self.gamma * mu.astype(ftype()))) / self.beta_p

    def init_aux(self, sigma):
        return self._rows(sigma).astype(jnp.int32).sum(axis=0)

    def delta_all(self, sigma, aux):
        s = sigma.astype(jnp.int32)
        mu_ext = jnp.tile(aux, self.Mr)          # [N]: mu of j's site
        mubar = mu_ext - s
        k = self.fk[(mubar + self.Mr - 1) >> 1]
        return s.astype(self.fk.dtype) * k

    def delta_one(self, sigma, aux, i):
        site = i % self.Nk
        s = sigma[i].astype(jnp.int32)
        mubar = aux[site] - s
        return s.astype(self.fk.dtype) * self.fk[(mubar + self.Mr - 1) >> 1]

    def flip(self, sigma, aux, i, do):
        site = i % self.Nk
        tgt = jnp.where(do, site, self.Nk)
        aux = aux.at[tgt].add(-2 * sigma[i].astype(jnp.int32), mode="drop")
        return flip_spin(sigma, i, do), aux

    def delta_classes(self):
        vals = sorted({round(abs(float(v)), 12) for v in np.asarray(self.fk)})
        return tuple(vals)

    def neighbor_table(self):
        """Flipping (i, k) changes mu_i, hence the deltas of site i in every
        OTHER replica (the RE star, RE.jl:70-104): [N, M-1] table."""
        j = jnp.arange(self.N, dtype=jnp.int32)
        site, k = j % self.Nk, j // self.Nk
        cols = [site + ((k + d) % self.Mr) * self.Nk
                for d in range(1, self.Mr)]
        return jnp.stack(cols, axis=1)


@pytree
class REModel(Double):
    """GraphRobustEnsemble (RE.jl:216-327): inner = GraphRE star, resid = M
    replicas of the base model (weight 1, site-major layout)."""

    M: int = static(0)
    Nk: int = static(0)

    def REenergies(self, sigma):
        """[M] individual replica energies (RE.jl:283-299)."""
        return self.resid_m.replica_energies(sigma)


def GraphRobustEnsemble(Nk: int, M: int, gamma: float, beta: float,
                        base: Model) -> REModel:
    """Robust-ensemble replication of `base` (RE.jl:249-253). All M replicas
    share the base disorder (REAliases.jl:16-18 convention)."""
    if M <= 2:
        raise ValueError(f"M must be greater than 2, given: {M}")
    assert base.N == Nk, f"base model has N={base.N}, expected {Nk}"
    N = Nk * M
    inner = GraphRE(fk=jnp.asarray(_fk_table(M, gamma, beta), ftype()),
                    N=N, Nk=Nk, Mr=M, gamma=gamma, beta_p=beta)
    resid = Replicated(base=base, N=N, Nk=Nk, n_slots=M, offset=0,
                       weight=1.0)
    return REModel(inner_m=inner, resid_m=resid, N=N, M=M, Nk=Nk)


# ---------------------------------------------------------------------------
# GraphLE: local-entropy star with explicit reference (LE.jl:17-179)
# ---------------------------------------------------------------------------

def _le_classes(M: int, gammaT: float) -> Tuple[float, ...]:
    """allDeltaE of GraphLE (LE.jl:176-179)."""
    g = abs(gammaT)
    if M % 2 == 0:
        vals = {4.0 * d * g for d in range(M // 2 + 1)} | {2.0 * g}
    else:
        vals = {2.0 * (2 * d - 1) * g for d in range(1, (M + 1) // 2 + 1)}
    return tuple(sorted(vals))


def GraphLE(Nk: int, M: int, gammaT: float) -> Pairwise:
    """E = -gammaT * sum_i sigma^c_i sum_k sigma_{i,k} (LE.jl:55-84):
    a star of M edges from each reference spin to its replicas. Exact integer
    Pairwise with scale gammaT. REPLICA-MAJOR block layout (deviation
    from LE.jl:227-240's interleaved slots): center block = indices [0, Nk),
    replica k block = [(k+1)*Nk, (k+2)*Nk)."""
    if M <= 2:
        raise ValueError(f"M must be greater than 2, given: {M}")
    S = M + 1
    N = Nk * S
    adj, J = [None] * N, [None] * N
    for i in range(Nk):
        adj[i] = [(k + 1) * Nk + i for k in range(M)]  # center -> replicas
        J[i] = [1.0] * M
        for k in range(M):
            adj[(k + 1) * Nk + i] = [i]                 # replica -> center
            J[(k + 1) * Nk + i] = [1.0]
    return make_pairwise(adj, J, N, integer_scale=1.0,
                         classes=_le_classes(M, gammaT)).replace(scale=gammaT)


@pytree
class LEModel(Double):
    """GraphLocalEntropy (LE.jl:183-318): inner = GraphLE star, resid = M
    replicas of the base model; the reference configuration's own base-model
    energy is NOT part of the Hamiltonian (tracked via cenergy, LE.jl:271)."""

    M: int = static(0)
    Nk: int = static(0)

    def LEenergies(self, sigma):
        """[M] individual replica energies (LE.jl:266-269)."""
        return self.resid_m.replica_energies(sigma)

    def center_config(self, sigma):
        """The reference configuration [Nk] (the leading block)."""
        return sigma[: self.Nk]

    def cenergy(self, sigma):
        """Base-model energy of the reference configuration (LE.jl:271-274)."""
        base = self.resid_m.base
        return base.to_physical(base.energy(self.center_config(sigma)))

    def distances(self, sigma):
        """[M, M] Hamming distances between replicas (LE.jl:309-318)."""
        rows = self.resid_m.to_replicas(sigma).astype(jnp.int32)
        q = rows @ rows.T
        return (self.Nk - q) // 2


def GraphLocalEntropy(Nk: int, M: int, gamma: float, beta: float,
                      base: Model) -> LEModel:
    """Local-entropy replication of `base` with explicit reference spin per
    site; interaction strength gammaT = gamma/beta (LE.jl:221-225)."""
    assert base.N == Nk, f"base model has N={base.N}, expected {Nk}"
    S = M + 1
    N = Nk * S
    inner = GraphLE(Nk, M, gamma / beta)
    resid = Replicated(base=base, N=N, Nk=Nk, n_slots=S, offset=1,
                       weight=1.0)
    return LEModel(inner_m=inner, resid_m=resid, N=N, M=M, Nk=Nk)


# ---------------------------------------------------------------------------
# GraphTLE: topological local entropy (TLE.jl:17-347)
# ---------------------------------------------------------------------------

@pytree
class GraphTLE(Model):
    """LE star + topological 4-spin term over the base graph's edges:

        E = -gammaT * sum_i sigma^c_i sum_k sigma_{i,k}
            -lambdaT * sum_{<i1,i2>} sigma^c_{i1} sigma^c_{i2}
                         sum_k sigma_{i1,k} sigma_{i2,k}

    (TLE.jl:83-142). REPLICA-MAJOR block layout as GraphLE (center block
    first). The site adjacency `neighb` is the base graph's edge structure,
    padded [Nk, Kmax] with sentinel Nk. Deltas are recomputed from sigma
    (aux-free): one gather + reduction pass per call — a fused vector pass
    instead of the reference's dual incremental LocalFields caches
    (TLE.jl:156-299)."""

    neighb: jnp.ndarray      # [Nk, Kmax] int32, padded with Nk
    N: int = static(0)
    Nk: int = static(0)
    Mr: int = static(0)
    gammaT: float = static(0.0)
    lambdaT: float = static(0.0)
    max_deg: int = static(0)
    scale: float = static(1.0)

    def _split(self, sigma):
        """-> (center [Nk+1] int32 zero-padded, reps [M, Nk+1] zero-padded
        on the site axis)."""
        s = sigma.astype(jnp.int32)
        c = jnp.concatenate([s[: self.Nk], jnp.zeros((1,), jnp.int32)])
        r = s[self.Nk:].reshape(self.Mr, self.Nk)
        r = jnp.concatenate([r, jnp.zeros((self.Mr, 1), jnp.int32)], axis=1)
        return c, r

    def energy(self, sigma):
        c, r = self._split(sigma)
        n = -jnp.sum(c[None, : self.Nk] * r[:, : self.Nk])
        # topological: each edge once via i1 < i2 masking of the padded table
        i1 = jnp.arange(self.Nk)[:, None]
        mask = (self.neighb > i1) & (self.neighb < self.Nk)
        rn = r[:, self.neighb]                          # [M, Nk, Kmax]
        dots = jnp.einsum("ki,kij->ij", r[:, : self.Nk], rn)
        t = -jnp.sum(jnp.where(mask, (c[: self.Nk, None] * c[self.neighb]) * dots, 0))
        return n * self.gammaT + t * self.lambdaT

    def init_aux(self, sigma):
        return ()

    def delta_all(self, sigma, aux):
        c, r = self._split(sigma)
        cn = c[self.neighb]                             # [Nk, Kmax]
        rn = r[:, self.neighb]                          # [M, Nk, Kmax]
        ri = r[:, : self.Nk]                            # [M, Nk]
        ci = c[: self.Nk]
        dots = jnp.einsum("ki,kij->ij", ri, rn)         # sum_k s_ik s_jk
        # replica spin (k,i): d1 = 2 gT c_i s_ki ;
        #                     d2 = 2 lT s_ki c_i sum_{j in ∂i} c_j s_kj
        f_rep = jnp.einsum("ij,kij->ki", cn.astype(ftype()),
                           rn.astype(ftype()), precision="highest")
        cr = (ci[None, :] * ri).astype(ftype())
        d_rep = (2.0 * self.gammaT) * cr \
            + (2.0 * self.lambdaT) * cr * f_rep
        # center spin i: d1 = 2 gT c_i mu_i ; d2 = 2 lT c_i sum_j c_j dot_ij
        mu = ri.sum(axis=0)
        d_ctr = (2.0 * self.gammaT) * (ci * mu).astype(ftype()) \
            + (2.0 * self.lambdaT) * ci.astype(ftype()) \
            * (cn * dots).sum(axis=1).astype(ftype())
        return jnp.concatenate([d_ctr, d_rep.reshape(self.Mr * self.Nk)])

    def flip(self, sigma, aux, i, do):
        return flip_spin(sigma, i, do), aux

    def delta_classes(self):
        """Instance-level allDeltaE (TLE.jl:335-347)."""
        d1 = (_le_classes(self.Mr, self.gammaT) if self.gammaT >= 0
              else _le_classes(self.Mr, -self.gammaT))
        mn = self.Mr * self.max_deg
        d2 = [2.0 * d * self.lambdaT for d in range(-mn, mn + 1)]
        vals = sorted({round(abs(a + b), 9) for a in d1 for b in d2})
        return tuple(vals)

    def neighbor_table(self):
        """Affected-spin table for the star + 4-spin topological term
        (TLE.jl:83-142): a replica spin (i, k) affects its center, neighbor
        centers, and same-replica neighbor spins; a center spin i affects
        all replicas at i, neighbor centers, and all replicas at neighbor
        sites. Rows are padded to a uniform width with the sentinel N."""
        Nk, M, K = self.Nk, self.Mr, self.neighb.shape[1]
        nb = self.neighb.astype(jnp.int32)            # [Nk, K], pad = Nk
        pad = nb >= Nk
        sent = jnp.int32(self.N)
        nb_c = jnp.where(pad, sent, nb)
        width = max(1 + 2 * K, M + K + K * M)

        def padded(r):
            fill = jnp.full((Nk, width - r.shape[1]), sent, jnp.int32)
            return jnp.concatenate([r, fill], axis=1)

        site = jnp.arange(Nk, dtype=jnp.int32)
        reps_i = jnp.stack([(k + 1) * Nk + site for k in range(M)], axis=1)
        reps_nb = jnp.concatenate(
            [jnp.where(pad, sent, (k + 1) * Nk + nb) for k in range(M)],
            axis=1)
        rows = [padded(jnp.concatenate([reps_i, nb_c, reps_nb], axis=1))]
        for k in range(M):
            rep_nb = jnp.where(pad, sent, (k + 1) * Nk + nb)
            rows.append(padded(jnp.concatenate(
                [site[:, None], nb_c, rep_nb], axis=1)))
        return jnp.concatenate(rows, axis=0)


@pytree
class TLEModel(Double):
    """GraphTopologicalLocalEntropy (TLE.jl:351-502)."""

    M: int = static(0)
    Nk: int = static(0)

    def TLEenergies(self, sigma):
        return self.resid_m.replica_energies(sigma)

    def center_config(self, sigma):
        return sigma[: self.Nk]

    def cenergy(self, sigma):
        base = self.resid_m.base
        return base.to_physical(base.energy(self.center_config(sigma)))

    def distances(self, sigma):
        rows = self.resid_m.to_replicas(sigma).astype(jnp.int32)
        q = rows @ rows.T
        return (self.Nk - q) // 2


def GraphTopologicalLocalEntropy(Nk: int, M: int, gamma: float,
                                 lambda_: float, beta: float, base: Model,
                                 neighb=None) -> TLEModel:
    """TLE replication of `base`; the topological neighborhood defaults to the
    base graph's adjacency (TLE.jl:390-396). gammaT = gamma/beta, lambdaT =
    lambda/beta (TLE.jl:499-502)."""
    assert base.N == Nk, f"base model has N={base.N}, expected {Nk}"
    if neighb is None:
        assert isinstance(base, Pairwise), \
            "neighb required unless base is a Pairwise model"
        nb = np.asarray(base.neigh)
        neighb = [[int(j) for j in row if j < Nk] for row in nb]
    kmax = max((len(r) for r in neighb), default=0)
    kmax = max(kmax, 1)
    tbl = np.full((Nk, kmax), Nk, dtype=np.int32)
    for i, row in enumerate(neighb):
        assert i not in row, f"neighb[{i}] contains itself"
        tbl[i, :len(row)] = row
    S = M + 1
    N = Nk * S
    inner = GraphTLE(neighb=jnp.asarray(tbl), N=N, Nk=Nk, Mr=M,
                     gammaT=gamma / beta, lambdaT=lambda_ / beta,
                     max_deg=kmax)
    resid = Replicated(base=base, N=N, Nk=Nk, n_slots=S, offset=1,
                       weight=1.0)
    return TLEModel(inner_m=inner, resid_m=resid, N=N, M=M, Nk=Nk)


# ---------------------------------------------------------------------------
# layout conversion to/from the reference's index conventions
# ---------------------------------------------------------------------------

def reference_permutation(model) -> np.ndarray:
    """perm such that sigma_internal[perm[j_ref]] == value at reference index
    j_ref. Quant uses the reference's replica-major layout already
    (QT.jl:172-182); RE is site-major j = k + i*M (RE.jl:255-263); LE/TLE are
    site-major with slot 0 = reference (LE.jl:227-240)."""
    Nk, M = model.Nk, model.M
    if isinstance(model, QuantModel):
        return np.arange(Nk * M)
    if isinstance(model, REModel):
        i, k = np.divmod(np.arange(Nk * M), M)
        return k * Nk + i
    if isinstance(model, (LEModel, TLEModel)):
        i, s = np.divmod(np.arange(Nk * (M + 1)), M + 1)
        return s * Nk + i  # s=0 -> center block, s=k+1 -> replica k block
    raise TypeError(type(model).__name__)


def from_reference_layout(model, sigma_ref):
    """Reference-convention configuration -> internal block layout."""
    perm = jnp.asarray(reference_permutation(model))
    out = jnp.zeros_like(jnp.asarray(sigma_ref))
    return out.at[perm].set(jnp.asarray(sigma_ref))


def to_reference_layout(model, sigma):
    """Internal block layout -> reference-convention configuration."""
    perm = jnp.asarray(reference_permutation(model))
    return jnp.asarray(sigma)[perm]


# ---------------------------------------------------------------------------
# AddFields family (AddFields.jl:16-123)
# ---------------------------------------------------------------------------

def GraphAF(fields) -> Pairwise:
    """Pure external-field model E = +sum_i h_i sigma_i (AddFields.jl:33-43;
    note the reference's sign: fields ADD with +sigma)."""
    h = -np.asarray(fields, dtype=np.float64)  # Pairwise uses E = -sum h*sigma
    n = len(h)
    adj = [[] for _ in range(n)]
    return make_pairwise(adj, adj, n, h=h)


def GraphAddFields(fields, base: Model) -> Double:
    """Double model: inner = the fields (sampled exactly by rrrMC), resid =
    the wrapped graph (AddFields.jl:59-91)."""
    af = GraphAF(fields)
    assert af.N == base.N, \
        f"incompatible length, fields size={af.N} graph size={base.N}"
    return Double(inner_m=af, resid_m=base, N=base.N)


@pytree
class Scaled(Model):
    """model with physical energy multiplied by `factor` (used by
    GraphAddSubFields' add-and-subtract identity)."""

    base: Model
    N: int = static(0)
    factor: float = static(1.0)
    scale: float = static(1.0)

    def energy(self, sigma):
        return self.factor * self.base.to_physical(self.base.energy(sigma))

    def init_aux(self, sigma):
        return self.base.init_aux(sigma)

    def delta_all(self, sigma, aux):
        return self.factor * self.base.to_physical(self.base.delta_all(sigma, aux))

    def delta_one(self, sigma, aux, i):
        return self.factor * self.base.to_physical(self.base.delta_one(sigma, aux, i))

    def flip(self, sigma, aux, i, do):
        return self.base.flip(sigma, aux, i, do)


def GraphAddSubFields(fields, base: Model) -> Double:
    """Add-and-subtract identity: total energy = base only, but rrrMC's inner
    part is the fields, corrected by resid = base - fields
    (AddFields.jl:96-123)."""
    af = GraphAF(fields)
    assert af.N == base.N, \
        f"incompatible length, fields size={af.N} graph size={base.N}"
    resid = Mixed(parts=(base, Scaled(base=af, N=af.N, factor=-1.0)), N=base.N)
    return Double(inner_m=af, resid_m=resid, N=base.N)
