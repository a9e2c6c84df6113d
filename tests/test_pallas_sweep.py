"""Lattice sweep kernel (ops/sweep_pallas.py) in the Pallas interpreter:
bit-identity with the XLA sweep at zero temperature, exact energy tracking,
agreement in law at finite temperature, chain padding, and the site order.

All comparisons are in int32 (spins, integer couplings, energies): no matrix
product and so no matmul precision enters them. The compiled kernel is
checked against the same reference on a GPU by the `gpu`-marked test at the
end and by chip_smoke.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rrrmc_tpu as rt
from rrrmc_tpu.ops import sweep_pallas as sp
from rrrmc_tpu.samplers.sweep import _run_sweepmc, _run_sweepmc_kernel


def _with_field(X, seed=3, lo=-2, hi=3):
    h = np.random.RandomState(seed).randint(lo, hi, size=X.N)
    return dataclasses.replace(X, h=jnp.asarray(h, X.h.dtype))


def _energy_exact(X, sigma, E):
    E_re = jax.jit(jax.vmap(X.energy))(sigma)
    np.testing.assert_array_equal(np.asarray(E_re), np.asarray(E))


def _xla_sweeps(X, state, beta, sweeps):
    st, _ = _run_sweepmc(X, state, beta, X.sweep_masks(), 1, sweeps)
    return st


@pytest.mark.parametrize("field", [False, True])
@pytest.mark.parametrize("D", [2, 3])
@pytest.mark.parametrize("L", [4, 6, 8])
def test_zero_temperature_bit_identical(L, D, field):
    """beta=50: every uphill move has probability 0 on both paths (threshold
    -2^31 in the kernel; exp underflow in XLA), so both dynamics are
    deterministic and must agree bit for bit after 20 sweeps: neighbours,
    wrap, colouring and the dE bookkeeping, with no statistical noise."""
    X = rt.GraphEA(L, D, (-1, 1), seed=L + D)
    if field:
        X = _with_field(X)
    st = rt.init_state(X, 24, seed=1)
    sigma, E = sp.LatticeSweeper(X, 50.0, block_chains=8, interpret=True)(
        st.sigma, st.E, seed=3, n_sweeps=20)
    ref = _xla_sweeps(X, st, 50.0, 20)
    np.testing.assert_array_equal(np.asarray(sigma), np.asarray(ref.sigma))
    np.testing.assert_array_equal(np.asarray(E), np.asarray(ref.E))
    _energy_exact(X, sigma, E)


@pytest.mark.parametrize("L", [4, 6])
def test_exp_path_bit_identical(L):
    """Fixed-point couplings (Gaussian disorder discretized to 1e-5) give a
    wide local-field range, so the kernel takes its exp path (no threshold
    table); at a beta where every uphill probability underflows it must
    still agree bit for bit with XLA."""
    rng = np.random.default_rng(L)
    X = rt.models.lattice.lattice_ea_from_levels(
        L, 2, list(np.round(rng.standard_normal(5), 5)), rng)
    sw = sp.LatticeSweeper(X, 1e8, block_chains=8, interpret=True)
    assert sw.max_half == 0            # exp path
    st = rt.init_state(X, 16, seed=2)
    sigma, E = sw(st.sigma, st.E, seed=5, n_sweeps=10)
    ref = _xla_sweeps(X, st, 1e8, 10)
    np.testing.assert_array_equal(np.asarray(sigma), np.asarray(ref.sigma))
    np.testing.assert_array_equal(np.asarray(E), np.asarray(ref.E))


def test_pallas_sweep_invariant_and_physics():
    """beta=2: exact int32 energy tracking through the kernel, and the
    stationary energy per spin matches the XLA sweep's."""
    X = rt.GraphEA(4, 3, (-1, 1), seed=5)     # N=64
    st = rt.init_state(X, 64, seed=1)
    sigma, E = sp.LatticeSweeper(X, 2.0, block_chains=16, interpret=True)(
        st.sigma, st.E, seed=3, n_sweeps=60)
    _energy_exact(X, sigma, E)
    Es_x, _ = rt.sweepMC(X, 2.0, sweeps=60, step=60, chains=64, seed=2,
                         backend="xla")
    e_kernel = float(np.asarray(E).mean()) * X.scale / X.N
    e_xla = float(np.asarray(Es_x)[:, -1].mean()) / X.N
    assert abs(e_kernel - e_xla) < 0.12, (e_kernel, e_xla)


@pytest.mark.parametrize("D", [2, 3])
def test_law_matches_xla(D):
    """beta=2 in law: equilibrium energy per spin and acceptance rate agree
    with the XLA path within 4 standard errors, errors taken over chains.
    One sweep attempts every site once, so the spins that changed in a
    one-sweep call are exactly the accepted flips."""
    L = 6 if D == 2 else 4
    X = rt.GraphEA(L, D, (-1, 1), seed=7 + D)
    B, beta, burn, meas = 128, 0.6, 30, 30
    st = rt.init_state(X, B, seed=4)
    sw = sp.LatticeSweeper(X, beta, block_chains=32, interpret=True)
    s_k, E_k = sw(st.sigma, st.E, seed=1, n_sweeps=burn)
    s_x = _xla_sweeps(X, st, beta, burn)
    e_k, e_x, a_k, a_x = [], [], [], []
    for t in range(meas):
        s1, E_k = sw(s_k, E_k, seed=100 + t, n_sweeps=1)
        a_k.append(np.mean(np.asarray(s1) != np.asarray(s_k), axis=1))
        s_k = s1
        e_k.append(np.asarray(E_k, np.float64) / X.N)
        x1 = _xla_sweeps(X, s_x, beta, 1)
        a_x.append(np.mean(np.asarray(x1.sigma) != np.asarray(s_x.sigma),
                           axis=1))
        s_x = x1
        e_x.append(np.asarray(s_x.E, np.float64) / X.N)
    _energy_exact(X, s_k, E_k)
    for a, b in [(e_k, e_x), (a_k, a_x)]:
        a = np.mean(a, axis=0)                 # per-chain time averages
        b = np.mean(b, axis=0)
        se = np.sqrt(a.var() / B + b.var() / B)
        assert abs(a.mean() - b.mean()) < 4 * se, (a.mean(), b.mean(), se)


@pytest.mark.parametrize("B", [1, 5, 37, 64])
@pytest.mark.parametrize("bt", [8, 32])
def test_chain_padding_and_blocking_do_not_change_chains(B, bt):
    """Any chain count runs (the last block is padded), and each chain's
    trajectory is independent of the block width: random bits are keyed by
    the global chain index."""
    X = rt.GraphEA(4, 2, (-1, 1), seed=9)
    st = rt.init_state(X, B, seed=6)
    ref = sp.LatticeSweeper(X, 1.0, block_chains=16, interpret=True)(
        st.sigma, st.E, seed=11, n_sweeps=6)
    got = sp.LatticeSweeper(X, 1.0, block_chains=bt, interpret=True)(
        st.sigma, st.E, seed=11, n_sweeps=6)
    assert got[0].shape == (B, X.N) and got[1].shape == (B,)
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(ref[0]))
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(ref[1]))
    _energy_exact(X, *got)


def test_seeds_give_distinct_streams():
    X = rt.GraphEA(4, 2, (-1, 1), seed=9)
    st = rt.init_state(X, 16, seed=6)
    sw = sp.LatticeSweeper(X, 1.0, block_chains=16, interpret=True)
    a = np.asarray(sw(st.sigma, st.E, seed=1, n_sweeps=4)[0])
    b = np.asarray(sw(st.sigma, st.E, seed=1, n_sweeps=4)[0])
    c = np.asarray(sw(st.sigma, st.E, seed=2, n_sweeps=4)[0])
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_pallas_sweep_fields_boltzmann():
    """LatticeEA WITH integer external fields (the AddFields composition,
    /root/reference/src/graphs/AddFields.jl:16-123): exact energy tracking
    and agreement with the exact 2^16 Boltzmann mean."""
    from rrrmc_tpu.analysis import energy_table

    X = _with_field(rt.GraphEA(4, 2, (-1, 1), seed=11))    # N = 16
    beta, B, reps = 1.0, 256, 40
    st = rt.init_state(X, B, seed=1)
    sw = sp.LatticeSweeper(X, beta, block_chains=64, interpret=True)
    sigma, E = sw(st.sigma, st.E, seed=3, n_sweeps=100)
    _energy_exact(X, sigma, E)
    tot = np.zeros(B)
    for r in range(reps):
        sigma, E = sw(sigma, E, seed=100 + r, n_sweeps=5)
        tot += np.asarray(E, np.float64)
    got = (tot / reps).mean() * X.scale
    E_all = energy_table(X)
    w = np.exp(-beta * (E_all - E_all.min()))
    assert abs(got - (w * E_all).sum() / w.sum()) < 0.25


def test_pallas_rejects_unsupported():
    with pytest.raises(ValueError):
        sp.LatticeSweeper(rt.GraphEANormal(4, 3, seed=1), 2.0)
    with pytest.raises(ValueError):
        sp.LatticeSweeper(rt.GraphRRG(64, 3, (-1, 1), seed=1), 2.0)
    with pytest.raises(ValueError):
        sp.LatticeSweeper(rt.GraphEA(5, 2, (-1, 1), seed=1), 2.0)


def test_sweepmc_routes_fields_to_pallas():
    """The route function sends field-carrying integer lattices to the
    kernel on a GPU, and the checkpointed driver (interpreted here) tracks
    each field variant's own energy: variants sharing a Jd object never
    share tables."""
    from rrrmc_tpu.samplers.common import choose_route

    X0 = rt.GraphEA(4, 2, (-1, 1), seed=7)
    X = dataclasses.replace(X0, h=jnp.asarray(np.full(X0.N, 3), X0.h.dtype))
    assert choose_route("sweepMC", X, platform="gpu") == "triton-lattice-sweep"
    s0, Es0 = _run_sweepmc_kernel(X0, rt.init_state(X0, 32, seed=5), 1.0,
                                  4, 5, interpret=True)
    s1, Es1 = _run_sweepmc_kernel(X, rt.init_state(X, 32, seed=5), 1.0,
                                  4, 5, interpret=True)
    assert Es0.shape == (4, 32) and Es1.shape == (4, 32)
    for m, s, Es in [(X0, s0, Es0), (X, s1, Es1)]:
        _energy_exact(m, s.sigma, s.E)
        np.testing.assert_allclose(np.asarray(Es)[-1],
                                   np.asarray(s.E) * m.scale)
        # the aux cache is rebuilt for the final spins
        np.testing.assert_array_equal(
            np.asarray(s.aux),
            np.asarray(jax.vmap(m.init_aux)(s.sigma)))
    assert np.asarray(s1.sigma, np.float64).mean() > 0.5   # strong field


def test_continuation_does_not_replay_bits():
    """A run continued from its returned state draws fresh bits (the stream
    base derives from the advancing chain keys)."""
    X = rt.GraphEA(4, 2, (-1, 1), seed=8)
    st = rt.init_state(X, 16, seed=1)
    a, _ = _run_sweepmc_kernel(X, st, 0.3, 1, 3, interpret=True)
    b, _ = _run_sweepmc_kernel(X, a, 0.3, 1, 3, interpret=True)
    c, _ = _run_sweepmc_kernel(X, st, 0.3, 1, 3, interpret=True)
    np.testing.assert_array_equal(np.asarray(a.sigma), np.asarray(c.sigma))
    keys = jax.random.key_data
    assert not np.array_equal(np.asarray(keys(a.key)),
                              np.asarray(keys(b.key)))
    assert not np.array_equal(np.asarray(b.sigma), np.asarray(a.sigma))


@pytest.mark.parametrize("L,D", [(4, 1), (6, 1), (4, 2), (6, 2), (4, 3),
                                 (6, 3), (8, 3), (10, 2)])
def test_site_order_is_checkerboard(L, D):
    """Each site appears once; colour c holds the sites of coordinate-sum
    parity c; no two sites of one colour are lattice neighbours."""
    order = sp.site_order(L, D)
    N = L ** D
    assert order.shape == (2, N // 2)
    assert sorted(order.ravel().tolist()) == list(range(N))
    coords = np.stack(np.unravel_index(np.arange(N), (L,) * D))
    par = coords.sum(axis=0) % 2
    for c in (0, 1):
        assert np.all(par[order[c]] == c)
    if L > 2 and D >= 1:
        X = rt.models.lattice.make_lattice_ea(
            L, D, np.ones((D,) + (L,) * D), integer_scale=1.0)
        neigh = np.asarray(X.neigh)
        for c in (0, 1):
            members = set(order[c].tolist())
            assert not any(int(j) in members
                           for i in order[c] for j in neigh[i])


@pytest.mark.parametrize("N,expected", [(64, 32), (216, 4), (4096, 256),
                                        (32768, 256), (36, 2), (1000, 4)])
def test_tile_sites(N, expected):
    ts = sp.tile_sites(N)
    assert ts == expected and (N // 2) % ts == 0


def test_accept_thresholds_match_probabilities():
    """bits ~ U(int32) < th[v-1] happens with probability e^(-beta2s v)."""
    beta2s = 0.7
    th = sp.accept_thresholds(beta2s, 12).astype(np.float64)
    p = (th + 2.0 ** 31) / 2.0 ** 32
    np.testing.assert_allclose(p, np.exp(-beta2s * np.arange(1, 13)),
                               atol=2.0 ** -31)
    assert np.all(np.diff(th) < 0)
    assert sp.accept_thresholds(1e3, 3).tolist() == [-2 ** 31] * 3


@pytest.mark.gpu
def test_compiled_kernel_matches_xla_on_gpu(gpu):
    """The compiled kernel (no interpreter) against the XLA sweep, bit for
    bit at beta=50, on the card."""
    X = rt.GraphEA(16, 3, (-1, 1), seed=42)
    st = rt.init_state(X, 512, seed=1)
    sigma, E = sp.LatticeSweeper(X, 50.0)(st.sigma, st.E, seed=3,
                                           n_sweeps=20)
    ref = _xla_sweeps(X, st, 50.0, 20)
    np.testing.assert_array_equal(np.asarray(sigma), np.asarray(ref.sigma))
    np.testing.assert_array_equal(np.asarray(E), np.asarray(ref.E))
