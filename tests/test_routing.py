"""The one routing function (samplers.common.choose_route), the compile-cache
helper, the in-kernel random bits, and the perceptron-family regression."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rrrmc_tpu as rt
from rrrmc_tpu.samplers.common import choose_route

KERNEL = "triton-lattice-sweep"

MODELS = {
    "EA3D_int_evenL": (lambda: rt.GraphEA(4, 3, (-1, 1), seed=1), True),
    "EA2D_int_evenL": (lambda: rt.GraphEA(6, 2, (-1, 1), seed=2), True),
    "EA2D_int_oddL": (lambda: rt.GraphEA(5, 2, (-1, 1), seed=3), False),
    "EA_float": (lambda: rt.GraphEANormal(4, 2, seed=4), False),
    "RRG": (lambda: rt.GraphRRG(16, 3, (-1, 1), seed=5), False),
    "SK": (lambda: rt.GraphSK(16, seed=6), False),
    "SAT": (lambda: rt.GraphSAT(12, 3, 2.0, seed=7), False),
}


@pytest.mark.parametrize("chains", [1, 100, 8192])
@pytest.mark.parametrize("platform", ["cpu", "gpu"])
@pytest.mark.parametrize("name", list(MODELS))
def test_sweep_route(name, platform, chains):
    """The lattice kernel is taken only on a GPU, for integer even-L
    lattices, at any chain count; everything else is XLA."""
    build, lattice = MODELS[name]
    model = build()
    state = rt.init_state(model, chains, seed=0)
    want = KERNEL if (lattice and platform == "gpu") else "xla"
    assert choose_route("sweepMC", model, state=state,
                        platform=platform) == want
    assert choose_route("sweepMC", model, backend="xla",
                        platform=platform) == "xla"
    if want == KERNEL:
        assert choose_route("sweepMC", model, backend="pallas",
                            platform=platform) == KERNEL
    else:
        with pytest.raises(ValueError, match="backend='pallas'"):
            choose_route("sweepMC", model, backend="pallas",
                         platform=platform)


@pytest.mark.parametrize("sampler", ["standardMC", "rrrMC", "bklMC", "wtmMC",
                                     "extremal_opt", "sweepMC_dense"])
@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_samplers_without_kernel_route_to_xla(sampler, platform):
    model = rt.GraphEA(4, 3, (-1, 1), seed=1)
    assert choose_route(sampler, model, platform=platform) == "xla"
    with pytest.raises(ValueError, match="no kernel route exists"):
        choose_route(sampler, model, backend="pallas", platform=platform)


def test_unknown_backend_rejected():
    with pytest.raises(ValueError, match="unknown backend"):
        choose_route("sweepMC", rt.GraphEA(4, 2, seed=1), backend="tpu")


def test_traced_model_routes_to_xla():
    """Under a user jit (or sample_disorder's vmap) the model is traced:
    the kernel's host-side tables cannot be built, so routing declines."""
    model = rt.GraphEA(4, 2, (-1, 1), seed=1)
    seen = []

    @jax.jit
    def f(m):
        seen.append(choose_route("sweepMC", m, platform="gpu"))
        return m.Jd.sum()

    f(model)
    assert seen == ["xla"]


def test_sharded_state_routes_to_xla():
    """A Pallas call is not partitioned automatically: a chain-sharded state
    takes the XLA path, which XLA partitions."""
    from rrrmc_tpu.parallel.mesh import make_mesh, shard_leading

    model = rt.GraphEA(4, 2, (-1, 1), seed=1)
    mesh = make_mesh({"chains": 4}, devices=jax.devices()[:4])
    state = shard_leading(rt.init_state(model, 8, seed=0), mesh)
    assert choose_route("sweepMC", model, state=state, platform="gpu") == "xla"
    one = rt.init_state(model, 8, seed=0)
    assert choose_route("sweepMC", model, state=one, platform="gpu") == KERNEL


@pytest.mark.parametrize("call", [
    lambda X: rt.standardMC(X, 1.0, 10, chains=2, backend="pallas"),
    lambda X: rt.rrrMC(X, 1.0, 10, chains=2, backend="pallas"),
    lambda X: rt.bklMC(X, 1.0, 10, chains=2, backend="pallas"),
    lambda X: rt.wtmMC(X, 1.0, 2, chains=2, backend="pallas"),
    lambda X: rt.extremal_opt(X, 1.4, 10, chains=2, backend="pallas"),
    lambda X: rt.sweepMC(X, 1.0, 2, chains=2, backend="pallas"),
    lambda X: rt.sweepMC_dense(rt.GraphSK(8, seed=1), 1.0, 2, chains=2,
                               backend="pallas"),
], ids=["standardMC", "rrrMC", "bklMC", "wtmMC", "extremal_opt", "sweepMC",
        "sweepMC_dense"])
def test_public_pallas_request_raises_on_cpu(call):
    """backend='pallas' with no kernel for this call is an error, never a
    silent XLA run."""
    with pytest.raises(ValueError, match="backend='pallas'"):
        call(rt.GraphEA(4, 2, (-1, 1), seed=1))


def test_last_route_reports_xla_on_cpu():
    X = rt.GraphEA(4, 2, (-1, 1), seed=1)
    rt.sweepMC(X, 1.0, 2, chains=4)
    assert rt.LAST_ROUTE["backend"] == "xla"


# ---------------------------------------------------------------------------
# compile cache helper
# ---------------------------------------------------------------------------

@pytest.fixture
def cache_config():
    saved = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", saved)


def test_compile_cache_env_set_is_left_to_jax(monkeypatch, tmp_path,
                                              cache_config):
    from rrrmc_tpu.utils import compile_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", "/untouched")
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == "/untouched"


def test_compile_cache_env_unset_uses_checkout_dir(monkeypatch, cache_config):
    from pathlib import Path

    from rrrmc_tpu.utils import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = compile_cache.enable_compile_cache()
    repo = Path(rt.__file__).resolve().parents[1]
    assert got == str(repo / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got


# ---------------------------------------------------------------------------
# counter-based random bits (the only generator the kernel uses)
# ---------------------------------------------------------------------------

def _bits(seed, counter, rows=256, cols=64, col0=0):
    from rrrmc_tpu.ops import prng

    site = jnp.arange(rows, dtype=jnp.int32)[:, None]
    chain = col0 + jnp.arange(cols, dtype=jnp.int32)[None, :]
    salt = prng.draw_salt(prng.seed_salt(jnp.int32(seed)),
                          jnp.int32(counter))
    return np.asarray(prng.random_bits(site, chain, salt))


def test_random_bits_uniform():
    b = _bits(1, 0).astype(np.int64).ravel()
    u = (b + 2 ** 31) / 2 ** 32
    assert abs(u.mean() - 0.5) < 4 * np.sqrt(1 / 12 / u.size)
    # every bit is balanced
    for k in range(32):
        frac = ((b >> k) & 1).mean()
        assert abs(frac - 0.5) < 4 * 0.5 / np.sqrt(b.size), (k, frac)


@pytest.mark.parametrize("a,b", [((1, 0), (1, 1)), ((1, 0), (2, 0)),
                                 ((7, 3), (8, 3))])
def test_random_bits_streams_differ(a, b):
    x, y = _bits(*a), _bits(*b)
    assert np.mean(x == y) < 0.01
    np.testing.assert_array_equal(x, _bits(*a))


def test_random_bits_keyed_by_global_chain():
    """Blocking does not change a chain's bits: columns 32..63 drawn as a
    block starting at chain 32 equal those of one wide block."""
    wide = _bits(5, 2, cols=64)
    part = _bits(5, 2, cols=32, col0=32)
    np.testing.assert_array_equal(wide[:, 32:], part)


# ---------------------------------------------------------------------------
# regression: two perceptron losses on one pattern set keep their own law
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sampler", ["bklMC", "rrrMC", "wtmMC",
                                     "standardMC"])
def test_perceptron_losses_sharing_xi_stay_distinct(sampler):
    """GraphPercStep and GraphPercLinear built on ONE xi are different
    models: each run tracks its own energy, and the two energies differ."""
    from rrrmc_tpu.models.perceptron import gen_xi

    xi = gen_xi(21, 12, np.random.default_rng(3))
    step = rt.GraphPercStep(21, 12, xi=xi)
    lin = rt.GraphPercLinear(21, 12, xi=xi)
    fn = getattr(rt, sampler)
    n = 4 if sampler == "wtmMC" else 400
    out = {}
    for name, m in (("step", step), ("linear", lin)):
        _, st = fn(m, 1.0, n, chains=8, seed=3)
        E_re = jax.jit(jax.vmap(m.energy))(st.sigma)
        np.testing.assert_allclose(np.asarray(st.E), np.asarray(E_re),
                                   atol=1e-9)
        out[name] = (st.sigma, np.asarray(jax.vmap(m.to_physical)(st.E)))
    # the same spins score differently under the two losses
    s = out["step"][0]
    e_step = np.asarray(jax.vmap(lambda x: step.to_physical(step.energy(x)))(s))
    e_lin = np.asarray(jax.vmap(lambda x: lin.to_physical(lin.energy(x)))(s))
    assert not np.allclose(e_step, e_lin)
    assert not np.allclose(out["step"][1], out["linear"][1])
