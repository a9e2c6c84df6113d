"""Scale-out validation on the 8-virtual-device CPU mesh:

1. sweepMC (checkerboard kernel) stationarity + exact energy invariant, and
   LatticeEA roll-based local fields == generic Pairwise gather local fields;
2. parallel tempering: rank tables stay permutations, per-temperature means
   match exact Boltzmann, single-device == semantics of mesh-sharded run;
3. chain-sharded sampling via parallel.mesh produces the same results as
   unsharded (pure data parallelism).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rrrmc_tpu as rt
from rrrmc_tpu.core.model import random_spins
from rrrmc_tpu.models.pairwise import Pairwise
from rrrmc_tpu.parallel.mesh import make_mesh, sample_sharded
from rrrmc_tpu.parallel.tempering import parallel_tempering, energies_by_rank
from rrrmc_tpu.observables import unpack_config


def exact_mean_energy(model, beta):
    states = unpack_config(jnp.arange(2 ** model.N, dtype=jnp.int32), model.N)
    E = np.asarray(jax.jit(jax.vmap(
        lambda s: model.to_physical(model.energy(s))))(states), np.float64)
    w = np.exp(-beta * (E - E.min()))
    return float((w * E).sum() / w.sum())


def test_lattice_local_fields_match_generic():
    X = rt.GraphEA(4, 3, (-1, 1), seed=5)    # LatticeEA
    sigma = random_spins(jax.random.key(0), X.N)
    lf_roll = X.local_fields(sigma)
    lf_gather = Pairwise.local_fields(X, sigma)
    np.testing.assert_array_equal(np.asarray(lf_roll), np.asarray(lf_gather))
    # energy agrees with generic path too
    assert int(X.energy(sigma)) == int(Pairwise.energy(X, sigma))


def test_lattice_masks_are_checkerboard():
    X = rt.GraphEA(4, 3, (-1, 1), seed=5)
    masks = np.asarray(X.sweep_masks())
    assert masks.shape == (2, X.N)
    assert masks.sum() == X.N and not np.any(masks[0] & masks[1])
    # no edge inside a color class
    neigh = np.asarray(X.neigh)
    for c in range(2):
        for i in np.nonzero(masks[c])[0]:
            assert not np.any(masks[c][neigh[i]])


def test_sweep_invariant_and_stationarity():
    X = rt.GraphEA(4, 2, (-1, 1), seed=3)    # N=16, 2-D even lattice
    beta = 1.5
    Es, state = rt.sweepMC(X, beta, sweeps=4000, step=10, chains=32, seed=2)
    E_re = jax.jit(jax.vmap(X.energy))(state.sigma)
    np.testing.assert_array_equal(np.asarray(E_re), np.asarray(state.E))
    E_exact = exact_mean_energy(X, beta)
    got = float(np.asarray(Es)[:, 200:].mean())
    assert abs(got - E_exact) < 0.15, (got, E_exact)


def test_sweep_generic_coloring_graph():
    """sweepMC on a non-lattice Pairwise model (greedy coloring path)."""
    X = rt.GraphRRG(10, 3, (-1, 1), seed=4)
    beta = 1.2
    Es, state = rt.sweepMC(X, beta, sweeps=4000, step=10, chains=32, seed=2)
    E_re = jax.jit(jax.vmap(X.energy))(state.sigma)
    np.testing.assert_array_equal(np.asarray(E_re), np.asarray(state.E))
    E_exact = exact_mean_energy(X, beta)
    got = float(np.asarray(Es)[:, 200:].mean())
    assert abs(got - E_exact) < 0.15, (got, E_exact)


BETAS = [0.5, 1.0, 1.5, 2.0, 2.5, 3.0, 3.5, 4.0]


def _pt_run(mesh=None, chain_axis=None, chains=16, rounds=300):
    X = rt.GraphEA(4, 2, (-1, 1), seed=3)
    Es, ranks, st = parallel_tempering(
        X, BETAS, rounds, sweeps_per_round=2, chains=chains, seed=1,
        mesh=mesh, chain_axis=chain_axis)
    return X, np.asarray(Es), np.asarray(ranks), st


def test_pt_ranks_are_permutations():
    X, Es, ranks, st = _pt_run(rounds=50)
    T = len(BETAS)
    for b in range(ranks.shape[2]):
        assert sorted(ranks[-1, :, b]) == list(range(T))


def test_pt_matches_boltzmann():
    X, Es, ranks, st = _pt_run()
    ebr = energies_by_rank(Es, ranks)
    means = ebr[150:].mean(axis=(0, 2))
    assert np.all(np.diff(means) < 0.2)  # colder -> lower
    for r, beta in [(1, 1.0), (3, 2.0)]:
        E_exact = exact_mean_energy(X, beta)
        assert abs(means[r] - E_exact) < 0.2, (beta, means[r], E_exact)


def test_pt_sharded_temp_axis():
    mesh = make_mesh({"temp": 8})
    X, Es, ranks, st = _pt_run(mesh=mesh, rounds=200)
    ebr = energies_by_rank(Es, ranks)
    means = ebr[100:].mean(axis=(0, 2))
    assert np.all(np.diff(means) < 0.2)
    E_exact = exact_mean_energy(X, 2.0)
    assert abs(means[3] - E_exact) < 0.25, (means[3], E_exact)


def test_pt_sharded_temp_and_chains():
    mesh = make_mesh({"temp": 2, "chains": 4})
    X, Es, ranks, st = _pt_run(mesh=mesh, chain_axis="chains", rounds=200)
    T = len(BETAS)
    for b in range(ranks.shape[2]):
        assert sorted(ranks[-1, :, b]) == list(range(T))
    ebr = energies_by_rank(Es, ranks)
    means = ebr[100:].mean(axis=(0, 2))
    assert np.all(np.diff(means) < 0.2)


def test_pt_sharded_matches_unsharded_bit_exact():
    """Sharding temperatures and chains must not change any trajectory, on a
    ladder whose swaps are genuinely random (acceptance neither ~0 nor ~1):
    chain b draws the same swap uniform on every mesh."""
    X = rt.GraphEA(4, 2, (-1, 1), seed=3)
    betas = np.linspace(0.5, 4.0, 4)
    run = lambda **kw: parallel_tempering(  # noqa: E731
        X, betas, 40, sweeps_per_round=1, chains=8, seed=2, **kw)
    Es_u, ranks_u, st_u = run()
    moved = np.asarray(st_u.swap_acc).mean() / 40   # per slot and round
    assert 0.05 < moved < 0.6, moved       # some, not all, swaps accepted
    for axes in ({"temp": 2, "chains": 2}, {"temp": 4}, {"temp": 1,
                                                         "chains": 4}):
        mesh = make_mesh(axes, devices=jax.devices()[:4])
        Es, ranks, st = run(mesh=mesh, axis="temp",
                            chain_axis="chains" if "chains" in axes else None)
        np.testing.assert_array_equal(np.asarray(ranks), np.asarray(ranks_u))
        np.testing.assert_array_equal(np.asarray(Es), np.asarray(Es_u))
        np.testing.assert_array_equal(np.asarray(st.sigma),
                                      np.asarray(st_u.sigma))


def test_chain_sharded_sampling_matches_unsharded():
    X = rt.GraphEA(4, 2, (-1, 1), seed=9)
    mesh = make_mesh({"chains": 8})
    Es_sh, st_sh = sample_sharded(rt.standardMC, X, mesh, 1.5,
                                  iters=2000, step=100, chains=32, seed=7)
    Es, st = rt.standardMC(X, 1.5, iters=2000, step=100, chains=32, seed=7)
    # same seeds + same math -> identical trajectories regardless of sharding
    np.testing.assert_array_equal(np.asarray(Es_sh), np.asarray(Es))
    np.testing.assert_array_equal(np.asarray(st_sh.sigma), np.asarray(st.sigma))
