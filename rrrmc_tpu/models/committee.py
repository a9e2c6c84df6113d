"""Two-layer binary committee machines (Step / ReLU / Quadratic hidden units).

The reference maintains two levels of stabilities with marginal ArraySets per
hidden unit, plus per-pattern min/max heaps for the quadratic case
(/root/reference/src/graphs/CommStep.jl:28-48,107-197, CommReLU.jl,
CommQu.jl:115-260) — all serial-update machinery. Vectorized, the whole family
reduces to one generic matmul-shaped template:

    Delta1[k, a] = xi[a, block k] . sigma[block k]    (int32 einsum; the aux)
    Delta2[a]    = sum_k c_k g(Delta1[k, a])          (g = unit activation)
    E            = #misclassified = sum_a loss_a(Delta2)

A flip of spin i in block k moves Delta1[k, a] by exactly -2 sigma_i xi_ai, so

    dE_i = 1/2 sum_a (Dm + Dp)[k(i), a]
         + sigma_i/2 * einsum(xi, (Dm - Dp))[i]

with Dm/Dp[k, a] = loss change if Delta1[k, a] moves by -2/+2 — i.e. the full
[N] delta vector is TWO elementwise tables plus ONE einsum, replacing all
marginal-set logic (same identity as models/perceptron.py, lifted one layer).

Variants (activation g, loss; K1 = inputs/unit, K2 = units):
* Step (CommStep.jl):  g = sign,      loss = (Delta2 < 0);   K1, K2 odd
* ReLU (CommReLU.jl):  g = max(.,0),  loss = (y*Delta2 <= 0); K1, K2 even,
                       c = +1 first half, -1 second half, y random labels
* Qu   (CommQu.jl):    g = x^2,       loss = (y*Delta2 <= 0); same c, y
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..core.struct import pytree, static
from ..core.model import Model, flip_spin
from ..core.dtypes import itype


@pytree
class Committee(Model):
    xi: jnp.ndarray   # [P, N] +-1 patterns (int8)
    y: jnp.ndarray    # [P] +-1 labels (all +1 for step)
    c: jnp.ndarray    # [K2] +-1 unit output weights
    N: int = static()
    K1: int = static()
    K2: int = static()
    P: int = static()
    kind: str = static("step")
    scale: float = static(1.0)

    def _xi_blocks(self):
        return self.xi.reshape(self.P, self.K2, self.K1)

    def _g(self, d1):
        if self.kind == "step":
            return jnp.sign(d1)
        if self.kind == "relu":
            return jnp.maximum(d1, 0)
        return d1 * d1  # qu

    def _loss(self, d2):
        if self.kind == "step":
            return (d2 < 0).astype(itype())
        return (self.y.astype(itype()) * d2 <= 0).astype(itype())

    def _d2(self, aux):
        return (self.c.astype(itype())[:, None] * self._g(aux)).sum(axis=0)

    # -- Model interface --
    def init_aux(self, sigma):
        """Delta1 [K2, P]."""
        s = sigma.astype(itype()).reshape(self.K2, self.K1)
        return jnp.einsum("pkj,kj->kp", self._xi_blocks().astype(itype()), s)

    def energy(self, sigma):
        return jnp.sum(self._loss(self._d2(self.init_aux(sigma))))

    def delta_all(self, sigma, aux):
        d2 = self._d2(aux)                                    # [P]
        l0 = self._loss(d2)                                   # [P]
        ci = self.c.astype(itype())[:, None]
        base = d2[None, :] - ci * self._g(aux)                # [K2, P]
        Dm = self._loss(base + ci * self._g(aux - 2)) - l0[None, :]
        Dp = self._loss(base + ci * self._g(aux + 2)) - l0[None, :]
        tot = (Dm + Dp).sum(axis=1)                           # [K2]
        proj = jnp.einsum("pkj,kp->kj", self._xi_blocks().astype(itype()),
                          Dm - Dp)                            # [K2, K1]
        s = sigma.astype(itype()).reshape(self.K2, self.K1)
        return ((tot[:, None] + s * proj) // 2).reshape(self.N)

    def delta_one(self, sigma, aux, i):
        k = i // self.K1
        d2 = self._d2(aux)
        l0 = self._loss(d2)
        ck = self.c[k].astype(itype())
        d1k = aux[k]                                          # [P]
        step = -2 * sigma[i].astype(itype()) * self.xi[:, i].astype(itype())
        d2_new = d2 - ck * self._g(d1k) + ck * self._g(d1k + step)
        return jnp.sum(self._loss(d2_new) - l0)

    def flip(self, sigma, aux, i, do):
        k = i // self.K1
        upd = jnp.where(do, -2 * sigma[i].astype(itype()), 0)
        tgt = jnp.where(do, k, self.K2)
        aux = aux.at[tgt].add(upd * self.xi[:, i].astype(itype()), mode="drop")
        return flip_spin(sigma, i, do), aux


def _gen_patterns(K1: int, K2: int, P: int, fc: bool, rng, labels: bool):
    Kin = K1 if fc else K1 * K2
    xi = rng.choice([-1, 1], size=(P, Kin)).astype(np.int8)
    if fc:
        xi = np.tile(xi, (1, K2))  # every unit sees the same K1 inputs
    y = (rng.choice([-1, 1], size=P).astype(np.int8) if labels
         else np.ones(P, dtype=np.int8))
    return xi, y


def GraphCommStep(K1: int, K2: int, P: int, *, fc: bool = False,
                  seed=None, xi=None, y=None) -> Committee:
    """Committee with sign hidden units (CommStep.jl:73-93); K1, K2 odd."""
    assert K1 % 2 == 1 and K2 % 2 == 1, \
        f"K1 and K2 must be odd, given: {K1}, {K2}"
    if xi is None:
        xi, y = _gen_patterns(K1, K2, P, fc, np.random.default_rng(seed), False)
    return Committee(xi=jnp.asarray(xi, jnp.int8),
                     y=jnp.asarray(y if y is not None else np.ones(P, np.int8)),
                     c=jnp.ones((K2,), jnp.int8),
                     N=K1 * K2, K1=K1, K2=K2, P=P, kind="step")


def _half_weights(K2: int) -> np.ndarray:
    """+1 for the first half of the units, -1 for the rest
    (c = 2*(2k <= K2) - 1, CommReLU.jl:126)."""
    c = np.ones(K2, dtype=np.int8)
    c[K2 // 2:] = -1
    return c


def GraphCommReLU(K1: int, K2: int, P: int, *, fc: bool = False,
                  seed=None, xi=None, y=None) -> Committee:
    """Committee with ReLU hidden units, +-1 output weights, random labels
    (CommReLU.jl:77-98); K1, K2 even."""
    assert K1 % 2 == 0 and K2 % 2 == 0, \
        f"K1 and K2 must be even, given: {K1}, {K2}"
    if xi is None:
        xi, y = _gen_patterns(K1, K2, P, fc, np.random.default_rng(seed), True)
    return Committee(xi=jnp.asarray(xi, jnp.int8), y=jnp.asarray(y, jnp.int8),
                     c=jnp.asarray(_half_weights(K2)),
                     N=K1 * K2, K1=K1, K2=K2, P=P, kind="relu")


def GraphCommQu(K1: int, K2: int, P: int, *, fc: bool = False,
                seed=None, xi=None, y=None) -> Committee:
    """Committee with quadratic hidden units (CommQu.jl:77-98); K1, K2 even."""
    assert K1 % 2 == 0 and K2 % 2 == 0, \
        f"K1 and K2 must be even, given: {K1}, {K2}"
    if xi is None:
        xi, y = _gen_patterns(K1, K2, P, fc, np.random.default_rng(seed), True)
    return Committee(xi=jnp.asarray(xi, jnp.int8), y=jnp.asarray(y, jnp.int8),
                     c=jnp.asarray(_half_weights(K2)),
                     N=K1 * K2, K1=K1, K2=K2, P=P, kind="qu")


# --- replica-ensemble aliases -----------------------------------------------

def _wrap(builder, wrapper_name, *wargs, **bkw):
    from . import replicas
    base = builder(**bkw)
    wrap = getattr(replicas, wrapper_name)
    return wrap(base.N, *wargs, base)


def GraphQCommStepT(K1, K2, P, M, Gamma, beta, *, fc=False, seed=None):
    return _wrap(GraphCommStep, "GraphQuant", M, Gamma, beta,
                 K1=K1, K2=K2, P=P, fc=fc, seed=seed)


def GraphQCommReLUT(K1, K2, P, M, Gamma, beta, *, fc=False, seed=None):
    return _wrap(GraphCommReLU, "GraphQuant", M, Gamma, beta,
                 K1=K1, K2=K2, P=P, fc=fc, seed=seed)


def GraphQCommQuT(K1, K2, P, M, Gamma, beta, *, fc=False, seed=None):
    return _wrap(GraphCommQu, "GraphQuant", M, Gamma, beta,
                 K1=K1, K2=K2, P=P, fc=fc, seed=seed)


def GraphCommStepRE(K1, K2, P, M, gamma, beta, *, fc=False, seed=None):
    return _wrap(GraphCommStep, "GraphRobustEnsemble", M, gamma, beta,
                 K1=K1, K2=K2, P=P, fc=fc, seed=seed)


def GraphCommReLURE(K1, K2, P, M, gamma, beta, *, fc=False, seed=None):
    return _wrap(GraphCommReLU, "GraphRobustEnsemble", M, gamma, beta,
                 K1=K1, K2=K2, P=P, fc=fc, seed=seed)


def GraphCommQuRE(K1, K2, P, M, gamma, beta, *, fc=False, seed=None):
    return _wrap(GraphCommQu, "GraphRobustEnsemble", M, gamma, beta,
                 K1=K1, K2=K2, P=P, fc=fc, seed=seed)


def GraphCommStepLE(K1, K2, P, M, gamma, beta, *, fc=False, seed=None):
    return _wrap(GraphCommStep, "GraphLocalEntropy", M, gamma, beta,
                 K1=K1, K2=K2, P=P, fc=fc, seed=seed)


def GraphCommReLULE(K1, K2, P, M, gamma, beta, *, fc=False, seed=None):
    return _wrap(GraphCommReLU, "GraphLocalEntropy", M, gamma, beta,
                 K1=K1, K2=K2, P=P, fc=fc, seed=seed)


def GraphCommQuLE(K1, K2, P, M, gamma, beta, *, fc=False, seed=None):
    return _wrap(GraphCommQu, "GraphLocalEntropy", M, gamma, beta,
                 K1=K1, K2=K2, P=P, fc=fc, seed=seed)
