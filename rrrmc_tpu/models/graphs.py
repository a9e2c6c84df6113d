"""Tier-1 graph builders: EA lattices, random regular graphs, Ising1D,
non-interacting fields, and trivial debug models.

Disorder generation happens on the host in numpy (it is one-time setup, not a
hot path); the resulting padded tables live on device. Each builder mirrors
the corresponding reference constructor (cited per function) but produces a
`Pairwise` pytree instead of a specialized Julia type — one vectorized
padded-adjacency kernel covers them all.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import jax.numpy as jnp

from ..core.struct import pytree, static
from ..core.model import Model, flip_spin
from ..core.dtypes import ftype
from .pairwise import (Pairwise, make_pairwise, infer_integer_scale,
                       enumerate_pair_classes)
from .composite import Double


def _rng(seed) -> np.random.Generator:
    return np.random.default_rng(seed)


# ---------------------------------------------------------------------------
# adjacency generators
# ---------------------------------------------------------------------------

def gen_ea_adjacency(L: int, D: int) -> list:
    """Periodic L^D lattice; each site lists its 2D neighbors (with the
    duplicate parallel-edge convention for L=2, like gen_EA,
    /root/reference/src/graphs/EA.jl:24-43)."""
    n = L ** D
    coords = np.indices((L,) * D).reshape(D, n)
    adj = []
    for x in range(n):
        c = coords[:, x]
        nbrs = []
        for d in range(D):
            for s in (+1, -1):
                cc = c.copy()
                cc[d] = (cc[d] + s) % L
                y = int(np.ravel_multi_index(cc, (L,) * D))
                nbrs.append(y)
        adj.append(sorted(nbrs))
    return adj


def gen_rrg_adjacency(N: int, K: int, rng: np.random.Generator) -> list:
    """Random K-regular simple graph via the pairing model with restarts
    (gen_RRG, /root/reference/src/graphs/RRG.jl:26-69)."""
    assert (N * K) % 2 == 0, "N*K must be even"
    for _ in range(100_000):
        stubs = rng.permutation(np.repeat(np.arange(N), K))
        a, b = stubs[0::2], stubs[1::2]
        if np.any(a == b):
            continue
        lo, hi = np.minimum(a, b), np.maximum(a, b)
        edges = lo.astype(np.int64) * N + hi
        if len(np.unique(edges)) != len(edges):
            continue
        adj = [[] for _ in range(N)]
        for x, y in zip(a, b):
            adj[int(x)].append(int(y))
            adj[int(y)].append(int(x))
        return adj
    raise RuntimeError("RRG generation failed (K too large?)")


def assign_edge_couplings(adj: list, draw) -> list:
    """Symmetric per-edge couplings: one draw per undirected edge, stored in
    both endpoint rows (gen_J, /root/reference/src/graphs/RRG.jl:71-96).
    Duplicate parallel edges (EA L=2) get independent draws per slot."""
    n = len(adj)
    used = [0] * n  # next unassigned slot per row
    J = [[None] * len(a) for a in adj]
    for x in range(n):
        for k, y in enumerate(adj[x]):
            if J[x][k] is not None:
                continue
            if y >= x:
                v = draw()
                J[x][k] = v
                if y != x:
                    # fill y's first unassigned slot pointing back at x
                    for l in range(used[y], len(adj[y])):
                        if adj[y][l] == x and J[y][l] is None:
                            J[y][l] = v
                            break
    for x in range(n):
        assert all(v is not None for v in J[x])
    return J


def _discretize(x: np.ndarray, lev: Sequence[float]):
    """Nearest-level split into (discrete, residual)
    (discretize, /root/reference/src/Common.jl:38-72)."""
    lev = np.asarray(lev, dtype=np.float64)
    idx = np.argmin(np.abs(x[..., None] - lev), axis=-1)
    d = lev[idx]
    return d, x - d


# ---------------------------------------------------------------------------
# model builders
# ---------------------------------------------------------------------------

def _pairwise_from_levels(adj, J, n, lev, degree) -> Pairwise:
    scale = infer_integer_scale(np.asarray(lev, dtype=np.float64))
    classes = enumerate_pair_classes([float(l) for l in lev], degree)
    return make_pairwise(adj, J, n, integer_scale=scale, classes=classes)


def GraphEA(L: int, D: int, LEV: Tuple[float, ...] = (-1, 1), *, seed=None) -> Pairwise:
    """Edwards-Anderson lattice (GraphEA, /root/reference/src/graphs/EA.jl:170).

    For L > 2 returns the roll-based LatticeEA specialization (fast sweep
    kernel); L = 2 keeps the generic Pairwise path (doubled parallel edges,
    EA.jl:156-158)."""
    rng = _rng(seed)
    if L > 2:
        from .lattice import lattice_ea_from_levels
        return lattice_ea_from_levels(L, D, LEV, rng)
    adj = gen_ea_adjacency(L, D)
    lev = [float(l) for l in LEV]
    J = assign_edge_couplings(adj, lambda: float(rng.choice(lev)))
    return _pairwise_from_levels(adj, J, L ** D, lev, 2 * D)


def GraphEANormal(L: int, D: int, *, seed=None) -> Pairwise:
    """EA with unit-variance Gaussian J (GraphEANormal,
    /root/reference/src/graphs/EA.jl:534)."""
    rng = _rng(seed)
    if L > 2:
        from .lattice import lattice_ea_normal
        return lattice_ea_normal(L, D, rng)
    adj = gen_ea_adjacency(L, D)
    J = assign_edge_couplings(adj, lambda: float(rng.standard_normal()))
    return make_pairwise(adj, J, L ** D)


def GraphRRG(N: int, K: int, LEV: Tuple[float, ...] = (-1, 1), *, seed=None) -> Pairwise:
    """Random regular graph with level couplings (GraphRRG,
    /root/reference/src/graphs/RRG.jl:140)."""
    rng = _rng(seed)
    adj = gen_rrg_adjacency(N, K, rng)
    lev = [float(l) for l in LEV]
    J = assign_edge_couplings(adj, lambda: float(rng.choice(lev)))
    return _pairwise_from_levels(adj, J, N, lev, K)


def GraphRRGNormal(N: int, K: int, *, seed=None) -> Pairwise:
    """RRG with Gaussian J (GraphRRGNormal, /root/reference/src/graphs/RRG.jl:504)."""
    rng = _rng(seed)
    adj = gen_rrg_adjacency(N, K, rng)
    J = assign_edge_couplings(adj, lambda: float(rng.standard_normal()))
    return make_pairwise(adj, J, N)


def _normal_discretized(adj, n, lev, degree, rng) -> Double:
    Jc = assign_edge_couplings(adj, lambda: float(rng.standard_normal()))
    Jc_np = [np.asarray(row, dtype=np.float64) for row in Jc]
    dJ, rJ = zip(*(_discretize(row, lev) for row in Jc_np))
    inner = _pairwise_from_levels(adj, [list(d) for d in dJ], n, lev, degree)
    resid = make_pairwise(adj, [list(r) for r in rJ], n)
    return Double(inner_m=inner, resid_m=resid, N=n)


def GraphRRGNormalDiscretized(N: int, K: int, LEV: Tuple[float, ...], *, seed=None) -> Double:
    """Gaussian-J RRG split into discretized inner + residual DoubleGraph
    (GraphRRGNormalDiscretized, /root/reference/src/graphs/RRG.jl:285-307)."""
    rng = _rng(seed)
    adj = gen_rrg_adjacency(N, K, rng)
    return _normal_discretized(adj, N, [float(l) for l in LEV], K, rng)


def GraphEANormalDiscretized(L: int, D: int, LEV: Tuple[float, ...], *, seed=None) -> Double:
    """(GraphEANormalDiscretized, /root/reference/src/graphs/EA.jl:311-530)."""
    rng = _rng(seed)
    adj = gen_ea_adjacency(L, D)
    return _normal_discretized(adj, L ** D, [float(l) for l in LEV], 2 * D, rng)


def load_ea_instance(fname: str):
    """Parse a 2-D EA instance file (gen_AJ, /root/reference/src/graphs/EA.jl:73-118):
    header lines `type:`, `size: L`, `name:`, then `x y Jxy` edges with
    1-based site indices on the L x L periodic lattice. Returns (L, adj, J)."""
    with open(fname) as f:
        line = f.readline().strip()
        assert line.startswith("type:"), line
        ls = f.readline().split()
        assert len(ls) == 2 and ls[0] == "size:", ls
        L = int(ls[1])
        assert f.readline().strip().startswith("name:")
        adj = gen_ea_adjacency(L, 2)
        n = L * L
        J = [[None] * len(a) for a in adj]
        for raw in f:
            ls = raw.split()
            if not ls:
                continue
            assert len(ls) == 3, ls
            x, y, Jxy = int(ls[0]) - 1, int(ls[1]) - 1, float(ls[2])
            for a, b in ((x, y), (y, x)):
                k = adj[a].index(b)
                if J[a][k] is not None:  # doubled edge (L=2): next free slot
                    k = adj[a].index(b, k + 1)
                assert J[a][k] is None
                J[a][k] = Jxy
        assert all(v is not None for row in J for v in row), "incomplete file"
    return L, adj, J


def GraphEAFromFile(fname: str) -> Pairwise:
    """EA 2-D model from an instance file (the GraphEANormal file constructor,
    /root/reference/src/graphs/EA.jl:576-581)."""
    L, adj, J = load_ea_instance(fname)
    return make_pairwise(adj, J, L * L)


def GraphIsing1D(N: int) -> Pairwise:
    """Antiferromagnetic ring with constant fields h=1 (GraphIsing1D,
    /root/reference/src/graphs/Ising1D.jl:12-93); allDeltaE = (2, 6)."""
    assert N > 2
    adj = [[(i - 1) % N, (i + 1) % N] for i in range(N)]
    J = [[-1.0, -1.0] for _ in range(N)]
    return make_pairwise(adj, J, N, h=np.ones(N), integer_scale=1.0,
                         classes=(2.0, 6.0))


def GraphFields(N: int, LEV: Tuple[float, ...] = (1,), *, seed=None) -> Pairwise:
    """Non-interacting spins in random fields from LEV (GraphFields,
    /root/reference/src/graphs/Fields.jl:13)."""
    rng = _rng(seed)
    lev = [float(l) for l in LEV]
    h = rng.choice(lev, size=N)
    scale = infer_integer_scale(np.asarray(lev))
    classes = tuple(sorted({abs(2.0 * l) for l in lev}))
    adj = [[] for _ in range(N)]
    J = [[] for _ in range(N)]
    return make_pairwise(adj, J, N, h=h, integer_scale=scale, classes=classes)


def GraphFieldsNormalDiscretized(N: int, LEV: Tuple[float, ...], *, seed=None) -> Double:
    """(GraphFieldsNormalDiscretized, /root/reference/src/graphs/Fields.jl:82)."""
    rng = _rng(seed)
    lev = [float(l) for l in LEV]
    hc = rng.standard_normal(N)
    hd, hr = _discretize(hc, lev)
    scale = infer_integer_scale(np.asarray(lev))
    classes = tuple(sorted({abs(2.0 * l) for l in lev}))
    adj = [[] for _ in range(N)]
    J = [[] for _ in range(N)]
    inner = make_pairwise(adj, J, N, h=hd, integer_scale=scale, classes=classes)
    resid = make_pairwise(adj, J, N, h=hr)
    return Double(inner_m=inner, resid_m=resid, N=N)


def GraphEmpty(N: int) -> Pairwise:
    """Free spins, energy always 0 (GraphEmpty,
    /root/reference/src/graphs/Empty.jl:14)."""
    adj = [[] for _ in range(N)]
    return make_pairwise(adj, adj, N, integer_scale=1.0)


def GraphTwoSpin() -> Pairwise:
    """(GraphTwoSpin, /root/reference/src/graphs/TwoSpin.jl:12)."""
    return make_pairwise([[1], [0]], [[1.0], [1.0]], 2, integer_scale=1.0,
                         classes=(2.0,))


def GraphThreeSpin() -> Pairwise:
    """(GraphThreeSpin, /root/reference/src/graphs/ThreeSpin.jl:12)."""
    adj = [[1, 2], [0, 2], [0, 1]]
    J = [[1.0, 1.0]] * 3
    return make_pairwise(adj, J, 3, integer_scale=1.0, classes=(0.0, 4.0))
