"""Single-layer binary perceptron models (Step / Linear / XEntr losses).

The reference keeps per-pattern stabilities Delta_a = xi_a . sigma in an
incrementally-updated vector plus ArraySet "marginal" sets p/m so a serial
move only touches patterns at the decision boundary
(/root/reference/src/graphs/PercStep.jl:30-43,108-179, PercLinear.jl,
PercXEntr.jl). Vectorized, these models are *matmul-shaped*:

* aux = Delta [P] int32 = xi @ sigma — one matvec at init ([B,N]x[N,P]
  across a chain batch);
* a flip of spin i is Delta -= 2 sigma_i xi[:, i] — one fused vector op;
* delta_all exploits that a flip moves Delta_a by exactly +-2:
      dE_i = sum_a loss(Delta_a - 2 sigma_i xi_ai) - loss(Delta_a)
           = const + sigma_i * (xi^T g)_i / ... — i.e. ONE matvec with
  g_a = loss(Delta_a - 2) - loss(Delta_a + 2), so the rejection-free samplers
  get the full [N] delta vector from one matvec instead of marginal-set logic.

Patterns are +-1 ("xi" absorbs the labels); N must be odd so Delta != 0
(PercStep.jl:55).

Losses (per pattern, as functions of Delta):
* Step   (PercStep.jl:83-106):  E = #(Delta < 0)                [int, scale 1]
* Linear (PercLinear.jl:85-111): E = sum_{Delta<0} ((-Delta-1)/2+1) * 2/sqrt(N)
                                                    [int internal, scale 2/sqrt(N)]
* XEntr  (PercXEntr.jl:97-119): E = sum_a log(1+exp(-2 lam Delta/sqrt(N)))
                                    via a precomputed [N+1] table  [float]
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import jax.numpy as jnp

from ..core.struct import pytree, static
from ..core.model import Model, flip_spin
from ..core.dtypes import ftype, itype


def gen_xi(N: int, P: int, rng) -> np.ndarray:
    """P random +-1 patterns (gen_xi, PercStep.jl:18-28)."""
    return rng.choice([-1, 1], size=(P, N)).astype(np.int8)


@pytree
class Perceptron(Model):
    """Shared machinery; `loss_table[(Delta+N)//2]` gives the per-pattern loss
    in internal units (int32 for step/linear, float for xentr)."""

    xi: jnp.ndarray          # [P, N] +-1 patterns (int8)
    loss_table: jnp.ndarray  # [N+1] loss at Delta = -N, -N+2, ..., N
    N: int = static()
    P: int = static()
    scale: float = static(1.0)

    def _loss(self, delta):
        return self.loss_table[(delta + self.N) >> 1]

    def energy(self, sigma):
        delta = self.xi.astype(itype()) @ sigma.astype(itype())
        return jnp.sum(self._loss(delta))

    def init_aux(self, sigma):
        return self.xi.astype(itype()) @ sigma.astype(itype())

    def delta_all(self, sigma, aux):
        lo = self._loss(aux)
        g_minus = self._loss(aux - 2) - lo   # pattern loses alignment
        g_plus = self._loss(aux + 2) - lo    # pattern gains alignment
        tot = jnp.sum(g_minus + g_plus)
        diff = (g_minus - g_plus).astype(self.loss_table.dtype)
        # [N] matvec; HIGHEST keeps float losses out of TF32
        proj = jnp.matmul(self.xi.astype(self.loss_table.dtype).T, diff,
                          precision="highest")
        half = sigma.astype(self.loss_table.dtype) * proj
        if jnp.issubdtype(self.loss_table.dtype, jnp.integer):
            return (tot + half) // 2
        return (tot + half) / 2

    def delta_one(self, sigma, aux, i):
        step = -2 * sigma[i].astype(itype()) * self.xi[:, i].astype(itype())
        return jnp.sum(self._loss(aux + step) - self._loss(aux))

    def flip(self, sigma, aux, i, do):
        upd = jnp.where(do, -2 * sigma[i].astype(itype()), 0)
        aux = aux + upd * self.xi[:, i].astype(itype())
        return flip_spin(sigma, i, do), aux


def _delta_grid(N: int) -> np.ndarray:
    return np.arange(-N, N + 1, 2)


def GraphPercStep(N: int, P: int, *, seed=None, xi=None) -> Perceptron:
    """E = number of misclassified patterns (PercStep.jl:62-72)."""
    assert N % 2 == 1, f"N must be odd, given: {N}"
    if xi is None:
        xi = gen_xi(N, P, np.random.default_rng(seed))
    table = (_delta_grid(N) < 0).astype(np.int32)
    return Perceptron(xi=jnp.asarray(xi, jnp.int8),
                      loss_table=jnp.asarray(table), N=N, P=P)


def GraphPercLinear(N: int, P: int, *, seed=None, xi=None) -> Perceptron:
    """E = sum over violated patterns of the number of weight flips needed to
    satisfy them, * 2/sqrt(N) (PercLinear.jl:62-72); exact int internal."""
    assert N % 2 == 1, f"N must be odd, given: {N}"
    if xi is None:
        xi = gen_xi(N, P, np.random.default_rng(seed))
    d = _delta_grid(N)
    table = np.where(d < 0, (-d - 1) // 2 + 1, 0).astype(np.int32)
    return Perceptron(xi=jnp.asarray(xi, jnp.int8),
                      loss_table=jnp.asarray(table), N=N, P=P,
                      scale=2.0 / np.sqrt(N))


def GraphPercXEntr(N: int, P: int, lam: float, *, seed=None, xi=None) -> Perceptron:
    """Cross-entropy loss log(1+exp(-2 lam Delta/sqrt(N))) via the Hs table
    (PercXEntr.jl:66, 97-119)."""
    assert N % 2 == 1, f"N must be odd, given: {N}"
    if xi is None:
        xi = gen_xi(N, P, np.random.default_rng(seed))
    d = _delta_grid(N).astype(np.float64)
    table = np.log1p(np.exp(-2.0 * lam * d / np.sqrt(N)))
    return Perceptron(xi=jnp.asarray(xi, jnp.int8),
                      loss_table=jnp.asarray(table, ftype()), N=N, P=P)


# --- replica-ensemble aliases -----------------------------------------------

def GraphQPercStepT(N, P, M, Gamma, beta, *, seed=None):
    from .replicas import GraphQuant
    return GraphQuant(N, M, Gamma, beta, GraphPercStep(N, P, seed=seed))


def GraphQPercLinearT(N, P, M, Gamma, beta, *, seed=None):
    from .replicas import GraphQuant
    return GraphQuant(N, M, Gamma, beta, GraphPercLinear(N, P, seed=seed))


def GraphPercStepRE(N, P, M, gamma, beta, *, seed=None):
    from .replicas import GraphRobustEnsemble
    return GraphRobustEnsemble(N, M, gamma, beta, GraphPercStep(N, P, seed=seed))


def GraphPercLinearRE(N, P, M, gamma, beta, *, seed=None):
    from .replicas import GraphRobustEnsemble
    return GraphRobustEnsemble(N, M, gamma, beta, GraphPercLinear(N, P, seed=seed))


def GraphPercStepLE(N, P, M, gamma, beta, *, seed=None):
    from .replicas import GraphLocalEntropy
    return GraphLocalEntropy(N, M, gamma, beta, GraphPercStep(N, P, seed=seed))


def GraphPercLinearLE(N, P, M, gamma, beta, *, seed=None):
    from .replicas import GraphLocalEntropy
    return GraphLocalEntropy(N, M, gamma, beta, GraphPercLinear(N, P, seed=seed))
