"""Disorder-realization sharding: many (model, seed) instances advanced in
one vmapped program (the reference's per-seed script loops vectorized,
scripts.jl:83-149)."""

import jax
import numpy as np

import rrrmc_tpu as rt
from rrrmc_tpu.parallel.mesh import make_mesh, sample_disorder, stack_models


def test_sample_disorder_matches_sequential():
    models = [rt.GraphEA(4, 2, (-1, 1), seed=s) for s in (1, 2, 3, 4)]
    Es_d, st_d = sample_disorder(rt.standardMC, models, 1.5,
                                 iters=1000, step=100, chains=8, seed=5)
    assert np.asarray(Es_d).shape == (4, 8, 10)
    # each disorder realization individually matches a sequential run
    for d, m in enumerate(models):
        st = rt.init_state(m, 8, 5 + 104729 * d)
        Es, st2 = rt.standardMC(m, 1.5, iters=1000, step=100, chains=8,
                                state=st)
        np.testing.assert_array_equal(np.asarray(Es_d)[d], np.asarray(Es))
        np.testing.assert_array_equal(np.asarray(st_d.sigma)[d],
                                      np.asarray(st2.sigma))


def test_sample_disorder_sharded():
    mesh = make_mesh({"disorder": 8})
    models = [rt.GraphEA(4, 2, (-1, 1), seed=s) for s in range(8)]
    Es, st = sample_disorder(rt.standardMC, models, 1.5,
                             iters=500, step=100, chains=4, seed=9,
                             mesh=mesh)
    assert np.asarray(Es).shape == (8, 4, 5)
    E_re = jax.jit(jax.vmap(jax.vmap(models[0].energy)))(st.sigma)
    # energies recomputed with disorder 0's couplings only match row 0
    np.testing.assert_array_equal(np.asarray(E_re)[0],
                                  np.asarray(st.E)[0])


def test_sample_disorder_bkl_wtm():
    """Host-loop samplers under disorder vmap: the hookless path is a single
    jitted while_loop, so bkl/wtm stack like the scan samplers."""
    models = [rt.GraphEA(4, 2, (-1, 1), seed=s) for s in (1, 2, 3)]
    Es_b, st_b = sample_disorder(rt.bklMC, models, 1.5,
                                 iters=2000, step=200, chains=4, seed=5,
                                 chunk_moves=64)
    assert np.asarray(Es_b).shape == (3, 4, 10)
    for d, m in enumerate(models):
        E_re = jax.jit(jax.vmap(m.energy))(st_b.sigma[d])
        np.testing.assert_array_equal(np.asarray(E_re),
                                      np.asarray(st_b.E)[d])
        # matches the standalone hookless run bit-for-bit
        st = rt.init_state(m, 4, 5 + 104729 * d)
        Es_1, _ = rt.bklMC(m, 1.5, iters=2000, step=200, chains=4,
                           state=st, chunk_moves=64)
        np.testing.assert_array_equal(np.asarray(Es_b)[d], np.asarray(Es_1))

    Es_w, st_w = sample_disorder(rt.wtmMC, models, 1.5,
                                 samples=6, step=2.0, chains=4, seed=7,
                                 chunk_moves=64)
    assert np.asarray(Es_w).shape == (3, 4, 6)
    for d, m in enumerate(models):
        E_re = jax.jit(jax.vmap(m.energy))(st_w.sigma[d])
        np.testing.assert_array_equal(np.asarray(E_re),
                                      np.asarray(st_w.E)[d])


def test_hookless_equals_hooked_bkl():
    """The while_loop fast path and the host chunk loop produce identical
    series and final states (same chunking, same RNG stream)."""
    m = rt.GraphEA(4, 2, (-1, 1), seed=3)
    kw = dict(iters=1500, step=100, chains=4, seed=11, chunk_moves=128)
    Es_a, st_a = rt.bklMC(m, 2.0, **kw)
    Es_b, st_b = rt.bklMC(m, 2.0, hook=lambda it, X, s: True, **kw)
    np.testing.assert_array_equal(np.asarray(Es_a), np.asarray(Es_b))
    np.testing.assert_array_equal(np.asarray(st_a.sigma),
                                  np.asarray(st_b.sigma))


def test_stack_models_keeps_static():
    models = [rt.GraphEA(4, 2, (-1, 1), seed=s) for s in (1, 2)]
    stacked = stack_models(models)
    assert stacked.N == models[0].N
    assert stacked.J.shape == (2,) + models[0].J.shape


def test_sample_disorder_sweepmc():
    """sweepMC under disorder vmap (lattice masks are static metadata, so
    the stacked trace shares them)."""
    models = [rt.GraphEA(4, 3, (-1, 1), seed=s) for s in (1, 2)]
    Es, st = sample_disorder(rt.sweepMC, models, 1.5,
                             sweeps=200, step=50, chains=8, seed=3,
                             backend="xla")
    assert np.asarray(Es).shape == (2, 8, 4)
    for d, m in enumerate(models):
        E_re = jax.jit(jax.vmap(m.energy))(st.sigma[d])
        np.testing.assert_array_equal(np.asarray(E_re),
                                      np.asarray(st.E)[d])
