"""densify(): sparse Pairwise -> dense FullyConnected equivalence (exact for
integer couplings, incl. int8 storage), sweepMC routing, and composition with
flatten()."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rrrmc_tpu as rt


def _assert_equivalent(pw, fc, key, exact=True):
    assert fc.N == pw.N
    for s in range(3):
        sigma = rt.random_spins(jax.random.fold_in(key, s), pw.N)
        e_p = float(pw.to_physical(pw.energy(sigma)))
        e_f = float(fc.to_physical(fc.energy(sigma)))
        d_p = np.asarray(pw.to_physical(
            pw.delta_all(sigma, pw.init_aux(sigma))), np.float64)
        d_f = np.asarray(fc.to_physical(
            fc.delta_all(sigma, fc.init_aux(sigma))), np.float64)
        if exact:
            assert e_p == e_f, (e_p, e_f)
            np.testing.assert_array_equal(d_f, d_p)
        else:
            assert abs(e_p - e_f) < 1e-9 * max(1.0, abs(e_p))
            np.testing.assert_allclose(d_f, d_p, atol=1e-9)


def test_densify_rrg_int8():
    m = rt.GraphRRG(64, 3, (-1, 1), seed=2)
    d = rt.densify(m)
    assert d.J.dtype == jnp.int8
    assert d.scale == m.scale
    _assert_equivalent(m, d, jax.random.key(0))


def test_densify_ea_with_fields_and_float():
    m = rt.GraphIsing1D(16)              # integer J with fields
    d = rt.densify(m)
    _assert_equivalent(m, d, jax.random.key(1))
    mf = rt.GraphRRGNormal(32, 3, seed=4)  # float couplings
    df = rt.densify(mf)
    _assert_equivalent(mf, df, jax.random.key(2), exact=False)


def test_densify_flatten_composition():
    """densify(flatten(wrapper)) reproduces the wrapper's physics."""
    base = rt.GraphEA(4, 2, (-1, 1), seed=7)
    m = rt.GraphQuant(16, 4, Gamma=0.5, beta=2.0, base=base)
    d = rt.densify(rt.flatten(m))
    sigma = rt.random_spins(jax.random.key(3), m.N)
    e_w = float(m.to_physical(m.energy(sigma)))
    e_d = float(d.to_physical(d.energy(sigma)))
    assert abs(e_w - e_d) < 1e-9 * max(1.0, abs(e_w))


def test_sweepmc_routes_dense():
    """sweepMC on a FullyConnected delegates to the dense sweep; invariant
    holds and the equilibrium matches the sparse color-sweep."""
    m = rt.GraphRRG(64, 3, (-1, 1), seed=5)
    d = rt.densify(m)
    Es_d, st_d = rt.sweepMC(d, 1.5, sweeps=400, step=40, chains=64, seed=1)
    E_re = jax.jit(jax.vmap(d.energy))(st_d.sigma)
    np.testing.assert_array_equal(np.asarray(E_re), np.asarray(st_d.E))
    Es_s, _ = rt.sweepMC(m, 1.5, sweeps=400, step=40, chains=64, seed=2)
    a = np.asarray(Es_d)[:, 3:].mean()
    b = np.asarray(Es_s)[:, 3:].mean()
    assert abs(a - b) < 2.5, (a, b)


def test_sweepmc_dense_int32_couplings_and_zero_sweeps():
    """Integer couplings beyond int8 must run (int32 matmul path), and
    sweeps=0 must be a no-op instead of a crash."""
    J = np.zeros((8, 8))
    for i in range(8):
        J[i, (i + 1) % 8] = J[(i + 1) % 8, i] = 200.0
    m = rt.densify(rt.make_pairwise(
        [[(i - 1) % 8, (i + 1) % 8] for i in range(8)],
        [[200.0, 200.0]] * 8, 8, integer_scale=1.0))
    assert m.J.dtype == jnp.int32
    Es, st = rt.sweepMC(m, 0.5, sweeps=200, step=50, chains=16, seed=1,
                        backend="xla")
    E_re = jax.jit(jax.vmap(m.energy))(st.sigma)
    np.testing.assert_array_equal(np.asarray(E_re), np.asarray(st.E))

    from rrrmc_tpu.samplers.dense_sweep import sweepMC_dense
    m2 = rt.densify(rt.GraphRRG(64, 3, (-1, 1), seed=5))
    st0 = rt.init_state(m2, 128, seed=2)
    Es0, st1 = sweepMC_dense(m2, 1.0, sweeps=0, chains=128, seed=3,
                             state=st0)
    assert Es0.shape[1] == 0
    np.testing.assert_array_equal(np.asarray(st1.sigma),
                                  np.asarray(st0.sigma))


def test_densify_rejects_offset():
    m = rt.make_pairwise([[1], [0]], [[1.0], [1.0]], 2, offset=3.0)
    with pytest.raises(AssertionError):
        rt.densify(m)
