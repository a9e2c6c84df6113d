"""Flatten wrapper compositions into a single Pairwise model.

The replica wrappers (Quant/LE/AddFields/Mixed, models/replicas.py) are
*combinators*: their energy is a sum of pairwise parts acting on disjoint or
shared index ranges of the composite spin vector. The generic composite
`delta_all` pays a vmap-over-replicas + reshape + concat per call — fine
inside sweep kernels, but the single-move samplers (standardMC / bklMC /
wtmMC / extremal_opt) call it every move.

`flatten(model)` statically merges every pairwise-representable part into ONE
Pairwise over the composite N — adjacency lists concatenated per spin, all
couplings/fields/offsets converted to physical units — so those samplers run
the plain local-fields hot path (O(degree) scatter per move, no replica
machinery). The reference has no analog (its serial caches are already O(1));
this is the vectorized equivalent of inlining the DoubleGraph composition
algebra (/root/reference/src/Interface.jl:212-268).

Supported: Pairwise, Scaled, Mixed, Double (incl. QuantModel / LEModel /
AddFields / AddSubFields), Replicated over a Pairwise base. Not flattenable
(raises ValueError): GraphRE (nonlinear log-cosh star), GraphTLE (4-spin
term), non-pairwise bases (SK dense, SAT, perceptron, committee, p-spin).

The result is float-valued (parts carry different physical scales, so the
exact shared integer grid is lost); sampler energy invariants hold to float
tolerance. rrrMC should keep the ORIGINAL Double model — it samples the
inner part exactly and needs the split.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .pairwise import Pairwise, make_pairwise
from .composite import Double, Mixed
from .replicas import Replicated, Scaled


def _pairwise_lists(pw: Pairwise, weight: float):
    """Pairwise -> (adj lists, J lists, h, offset), all physical * weight."""
    neigh = np.asarray(pw.neigh)
    J = np.asarray(pw.J, np.float64) * pw.scale * weight
    h = np.asarray(pw.h, np.float64) * pw.scale * weight
    off = float(np.asarray(pw.offset)) * pw.scale * weight
    adj: List[List[int]] = [[] for _ in range(pw.N)]
    cpl: List[List[float]] = [[] for _ in range(pw.N)]
    for i in range(pw.N):
        for k in range(neigh.shape[1]):
            j = int(neigh[i, k])
            if j < pw.N and J[i, k] != 0.0:
                adj[i].append(j)
                cpl[i].append(float(J[i, k]))
    return adj, cpl, h, off


def _collect(model, weight: float, n: int, parts: list):
    """Recursively append (adj, cpl, h, offset) tuples over the composite
    index space [0, n)."""
    if isinstance(model, Pairwise):
        assert model.N == n, (model.N, n)
        parts.append(_pairwise_lists(model, weight))
    elif isinstance(model, Scaled):
        _collect(model.base, weight * model.factor, n, parts)
    elif isinstance(model, Mixed):
        for p in model.parts:
            _collect(p, weight, n, parts)
    elif isinstance(model, Double):
        _collect(model.inner_m, weight, n, parts)
        _collect(model.resid_m, weight, n, parts)
    elif isinstance(model, Replicated):
        base = model.base
        if not isinstance(base, Pairwise):
            raise ValueError(
                f"cannot flatten Replicated over {type(base).__name__} "
                "(only Pairwise bases are pairwise-representable)")
        adj_b, cpl_b, h_b, off_b = _pairwise_lists(
            base, weight * model.weight)
        Nk = model.Nk
        adj = [[] for _ in range(n)]
        cpl = [[] for _ in range(n)]
        h = np.zeros(n)
        for k in range(model.M):
            lo = (model.offset + k) * Nk
            for i in range(Nk):
                adj[lo + i] = [lo + j for j in adj_b[i]]
                cpl[lo + i] = list(cpl_b[i])
            h[lo:lo + Nk] = h_b
        parts.append((adj, cpl, h, off_b * model.M))
    else:
        raise ValueError(
            f"cannot flatten {type(model).__name__}: not pairwise-"
            "representable (RE's log-cosh star, TLE's 4-spin term, and "
            "non-pairwise bases have no Pairwise form)")


def flatten(model) -> Pairwise:
    """Merge a wrapper composition into one physical-unit Pairwise over the
    composite spin vector. Energies / deltas match `model`'s physical values
    to float tolerance; the spin layout is unchanged (the internal
    replica-major block layout). Use for standardMC/bklMC/wtmMC/extremal_opt;
    keep the original Double for rrrMC."""
    n = model.N
    parts: list = []
    _collect(model, 1.0, n, parts)
    adj = [[] for _ in range(n)]
    cpl: List[List[float]] = [[] for _ in range(n)]
    h = np.zeros(n)
    offset = 0.0
    for adj_p, cpl_p, h_p, off_p in parts:
        for i in range(n):
            adj[i].extend(adj_p[i])
            cpl[i].extend(cpl_p[i])
        h += h_p
        offset += off_p
    # merge duplicate edges (AddSubFields-style cancellations sum to ~0)
    for i in range(n):
        if len(set(adj[i])) != len(adj[i]):
            acc = {}
            for j, v in zip(adj[i], cpl[i]):
                acc[j] = acc.get(j, 0.0) + v
            adj[i] = [j for j, v in acc.items() if v != 0.0]
            cpl[i] = [v for v in acc.values() if v != 0.0]
    return make_pairwise(adj, cpl, n, h=h, offset=offset)
