"""Exact-enumeration validation and mixing-time analysis tools.

The reference ships these as dev utilities (truep, second_eigenvalue_standard
/ _bkl / _rrr, second_eigenvalue_stats, tm, ravg,
/root/reference/src/RRRMC.jl:523-731): exact 2^N Boltzmann distributions and
dense Markov transition matrices of each sampler kernel, used to verify
stationarity to 1e-13 and compare mixing times. Vectorized, everything
derives from ONE vmapped energy sweep over all 2^N states (one jit,
batched); the matrix assembly and eigensolves are small-N host work.

State encoding matches observables.pack_config: bit j of the state id is
(sigma_j + 1)/2.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import jax
import jax.numpy as jnp

from .observables import unpack_config


def energy_table(model, max_N: int = 24) -> np.ndarray:
    """[2^N] physical energies of every configuration (one vmapped pass)."""
    n = model.N
    assert n <= max_N, f"N={n} too large for exact enumeration"
    states = unpack_config(jnp.arange(2 ** n, dtype=jnp.int32), n)
    E = jax.jit(jax.vmap(lambda s: model.to_physical(model.energy(s))))(states)
    return np.asarray(E, dtype=np.float64)


def truep(model, beta: float) -> np.ndarray:
    """Exact Boltzmann distribution (truep, RRRMC.jl:528-543)."""
    E = energy_table(model)
    w = np.exp(-beta * (E - E.min()))
    return w / w.sum()


def _flip_ids(n: int) -> np.ndarray:
    """[S, N] state id after flipping each spin."""
    s = np.arange(1 << n, dtype=np.int64)[:, None]
    return s ^ (np.int64(1) << np.arange(n, dtype=np.int64))[None, :]


def transition_matrix_standard(model, beta: float) -> np.ndarray:
    """Dense single-spin Metropolis kernel Q[to, from]
    (second_eigenvalue_standard, RRRMC.jl:592-622)."""
    n = model.N
    E = energy_table(model)
    flips = _flip_ids(n)
    dE = E[flips] - E[:, None]                      # [S, N]
    p = np.minimum(1.0, np.exp(-beta * dE)) / n
    S = 1 << n
    Q = np.zeros((S, S))
    rows = flips.ravel()
    cols = np.repeat(np.arange(S), n)
    np.add.at(Q, (rows, cols), p.ravel())
    Q[np.arange(S), np.arange(S)] = 1.0 - p.sum(axis=1)
    return Q


def transition_matrix_bkl(Q: np.ndarray) -> np.ndarray:
    """Rejection-free chain embedded in Q (second_eigenvalue_bkl,
    RRRMC.jl:624-637): strip the diagonal, renormalize columns."""
    pr = np.diag(Q).copy()
    rfQ = (Q - np.diag(pr)) / (1.0 - pr[None, :])
    return rfQ


def transition_matrix_rrr(model, beta: float) -> np.ndarray:
    """RRR kernel: move j proposed w.p. w_j/z, accepted w.p. min(1, z/z');
    combined pp = w_j / max(z, z') (second_eigenvalue_rrr,
    RRRMC.jl:639-676)."""
    n = model.N
    E = energy_table(model)
    flips = _flip_ids(n)
    dE = E[flips] - E[:, None]
    w = np.minimum(1.0, np.exp(-beta * dE))         # [S, N]
    z = w.sum(axis=1)                               # [S]
    zprime = z[flips]                               # [S, N]: z of flipped state
    pp = w / np.maximum(z[:, None], zprime)
    S = 1 << n
    Q = np.zeros((S, S))
    np.add.at(Q, (flips.ravel(), np.repeat(np.arange(S), n)), pp.ravel())
    Q[np.arange(S), np.arange(S)] = np.clip(1.0 - pp.sum(axis=1), 0.0, 1.0)
    return Q


def second_eigenvalue(Q: np.ndarray) -> float:
    """Mixing time tau = -1/log(lambda_2) (RRRMC.jl:585-590)."""
    ev = np.linalg.eigvals(Q)
    assert np.all(np.abs(ev.imag) <= 1e-8), "non-real eigenvalue"
    lam2 = np.sort(ev.real)[-2]
    return -1.0 / np.log(lam2)


def stationarity_error(Q: np.ndarray, p: np.ndarray) -> float:
    """max |p - Qp| — must be ~1e-13 for a correct kernel (RRRMC.jl:691)."""
    return float(np.max(np.abs(p - Q @ p)))


def rejection_rate(Q: np.ndarray, p: np.ndarray) -> float:
    """Equilibrium rejection probability sum_x p(x) Q[x,x] (RRRMC.jl:694)."""
    return float(np.sum(np.diag(Q) * p))


def spectral_stats(graph_builder, betas: Sequence[float], n_seeds: int = 10,
                   seed: int = 86823, quiet: bool = True):
    """Compare mixing times of standard / bkl / rrr kernels over disorder
    (second_eigenvalue_stats, RRRMC.jl:678-731). Returns
    (taus [n_seeds, n_betas, 3], rrs [n_seeds, n_betas, 3])."""
    taus = np.zeros((n_seeds, len(betas), 3))
    rrs = np.zeros((n_seeds, len(betas), 3))
    for j in range(n_seeds):
        X = graph_builder(seed=seed + j)
        for l, beta in enumerate(betas):
            p = truep(X, beta)
            Q = transition_matrix_standard(X, beta)
            assert stationarity_error(Q, p) < 1e-12
            taus[j, l, 0] = second_eigenvalue(Q)
            rrs[j, l, 0] = rejection_rate(Q, p)
            rfQ = transition_matrix_bkl(Q)
            taus[j, l, 1] = second_eigenvalue(rfQ)
            Qr = transition_matrix_rrr(X, beta)
            assert stationarity_error(Qr, p) < 1e-12
            taus[j, l, 2] = second_eigenvalue(Qr)
            rrs[j, l, 2] = rejection_rate(Qr, p)
            if not quiet:
                print(f"seed={seed + j} beta={beta}: tau={taus[j, l]}, "
                      f"rr={rrs[j, l]}")
    return taus, rrs


# --- running averages (tm / ravg, RRRMC.jl:559-583) -------------------------

def tm(Es: np.ndarray, step: int = 1, skip0: float = 0.1,
       skip1: float = 0.05) -> np.ndarray:
    """Cumulative running mean of an energy series after a skip0 burn-in,
    dropping the first skip1 fraction of points (tm, RRRMC.jl:559-571)."""
    Es = np.asarray(Es, dtype=np.float64)
    i0 = int(np.floor(len(Es) * skip0))
    n = (len(Es) - i0) // step
    blocks = Es[i0:i0 + n * step].reshape(n, step).mean(axis=1)
    m = np.cumsum(blocks) / np.arange(1, n + 1)
    return m[int(np.floor(skip1 * n)):]


def ravg(Es: np.ndarray, step: int = 1000, skip0: float = 0.0) -> np.ndarray:
    """Non-overlapping block means (ravg, RRRMC.jl:573-583)."""
    Es = np.asarray(Es, dtype=np.float64)
    i0 = int(np.floor(len(Es) * skip0))
    n = (len(Es) - i0) // step
    return Es[i0:i0 + n * step].reshape(n, step).mean(axis=1)
