"""Smoke test on one GPU: the system's main path end to end, every kernel of
that path compiled for the card and compared with the plain XLA reference at
real widths, and the public samplers through their normal routing.

    python chip_smoke.py           # one card
    python chip_smoke.py --four    # the four-card path only (4 GPUs)

Phases (one card):
  0. on-card tests: `pytest -m gpu` in a child process, run before this
     process opens the card (one JAX process per card at a time);
  1. card: nvidia-smi name and power limit, JAX platform / kind / count;
  2. compile: the lattice sweep kernel at L=16 and L=32, B=8192, with its
     compiled memory analysis;
  3. reference: kernel vs XLA sweep at L=16 and L=32, B=8192 — bit-identical
     at beta=50; at beta=2 exact energy tracking, and energy per spin and
     acceptance rate equal within 4 standard errors;
  4. main path: rt.sweepMC on EA-3D L=32 and L=16 with 8192 chains, then
     standardMC / rrrMC / bklMC / wtmMC / extremal_opt on EA-3D L=16 with
     1024 chains; LAST_ROUTE and the energy invariant for each;
  5. timing: end-to-end rt.sweepMC on the routed kernel vs the XLA path,
     warm calls, median of 5, with the card's name and power limit.

--four: parallel tempering on a {"temp": 2, "chains": 2} mesh of 4 cards and
chain-sharded rt.sweepMC over 4 cards, each bit-exact against its unsharded
run on one card, with every output spread over all 4 cards.

Any failed phase ends the script with a non-zero exit and no result line.
The last line of a passing run is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from contextlib import contextmanager


def card() -> str:
    """`name, power.limit` of the first card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout
    return out.strip().splitlines()[0]


@contextmanager
def phase(name: str):
    print(f"== {name}", flush=True)
    t0 = time.perf_counter()
    yield
    print(f"   {name}: ok in {time.perf_counter() - t0:.1f} s", flush=True)


def gpu_tests() -> None:
    """The `gpu`-marked tests, in a child process (this process has not
    opened the card yet)."""
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    r = subprocess.run([sys.executable, "-m", "pytest", "tests/", "-q",
                        "-m", "gpu", "-p", "no:cacheprovider"], env=env)
    if r.returncode != 0:
        raise RuntimeError(f"gpu-marked tests failed (exit {r.returncode})")


# ---------------------------------------------------------------------------
# one card
# ---------------------------------------------------------------------------

def _invariant(model, sigma, E) -> int:
    import jax
    import numpy as np

    E_re = jax.jit(jax.vmap(model.energy))(sigma)
    return int(np.max(np.abs(np.asarray(E_re, np.int64)
                             - np.asarray(E, np.int64))))


def compile_kernel(L: int, B: int, **kw) -> None:
    import jax
    import jax.numpy as jnp

    import rrrmc_tpu as rt
    from rrrmc_tpu.ops import sweep_pallas as sp

    X = rt.GraphEA(L, 3, (-1, 1), seed=42)
    sw = sp.LatticeSweeper(X, 2.0, **kw)
    args = (jax.ShapeDtypeStruct((B, X.N), jnp.int8),
            jax.ShapeDtypeStruct((B,), jnp.int32), sw.jc, sw.th, sw.beta2s,
            jnp.zeros((1,), jnp.int32), jnp.ones((1,), jnp.int32))
    t0 = time.perf_counter()
    compiled = sp._sweep.lower(
        *args, L=L, D=3, max_half=sw.max_half, has_field=sw.has_field,
        block_chains=sw.block_chains, tile=sw.tile, num_warps=sw.num_warps,
        n_ckpt=1, interpret=sw.interpret).compile()
    print(f"   L={L} B={B} BT={sw.block_chains} TS={sw.tile} "
          f"warps={sw.num_warps}: compiled in "
          f"{time.perf_counter() - t0:.1f} s; memory_analysis: "
          f"{compiled.memory_analysis()}", flush=True)


def reference(L: int, B: int, *, burn: int = 40, blocks: int = 8,
              block_sweeps: int = 5, **kw) -> None:
    """Kernel vs the XLA sweep at one width (integer arithmetic only, so no
    matmul precision enters the comparison)."""
    import numpy as np

    import rrrmc_tpu as rt
    from rrrmc_tpu.ops.sweep_pallas import LatticeSweeper
    from rrrmc_tpu.samplers.sweep import _run_sweepmc

    X = rt.GraphEA(L, 3, (-1, 1), seed=42)
    masks = X.sweep_masks()
    st = rt.init_state(X, B, seed=1)

    # zero temperature: both dynamics deterministic -> bit for bit
    s_k, E_k = LatticeSweeper(X, 50.0, **kw)(st.sigma, st.E, seed=3,
                                              n_sweeps=20)
    ref, _ = _run_sweepmc(X, st, 50.0, masks, 1, 20)
    same = (np.array_equal(np.asarray(s_k), np.asarray(ref.sigma))
            and np.array_equal(np.asarray(E_k), np.asarray(ref.E)))
    print(f"   L={L} B={B} beta=50, 20 sweeps: kernel == XLA bit for bit: "
          f"{same}", flush=True)
    if not same:
        raise AssertionError("kernel differs from the XLA sweep at beta=50")

    # beta=2: the same Markov chain law from the same start, so every
    # per-sweep statistic has the same expectation on both paths
    beta = 2.0
    sw = LatticeSweeper(X, beta, **kw)
    s_k, E_k = sw(st.sigma, st.E, seed=5, n_sweeps=burn)
    x, _ = _run_sweepmc(X, st, beta, masks, 1, burn)
    obs = {"kernel": ([], []), "xla": ([], [])}
    for b in range(blocks):
        s_k, E_k = sw(s_k, E_k, seed=100 + 2 * b, n_sweeps=block_sweeps - 1)
        s1, E_k = sw(s_k, E_k, seed=101 + 2 * b, n_sweeps=1)
        obs["kernel"][0].append(np.asarray(E_k, np.float64) / X.N)
        obs["kernel"][1].append(
            np.mean(np.asarray(s1) != np.asarray(s_k), axis=1))
        s_k = s1
        x, _ = _run_sweepmc(X, x, beta, masks, 1, block_sweeps - 1)
        x1, _ = _run_sweepmc(X, x, beta, masks, 1, 1)
        obs["xla"][0].append(np.asarray(x1.E, np.float64) / X.N)
        obs["xla"][1].append(
            np.mean(np.asarray(x1.sigma) != np.asarray(x.sigma), axis=1))
        x = x1
    inv = _invariant(X, s_k, E_k)
    print(f"   L={L} beta=2: kernel tracked - recomputed energy, max |.| = "
          f"{inv}", flush=True)
    if inv != 0:
        raise AssertionError("kernel energy invariant broken")
    for i, what in enumerate(("energy per spin", "acceptance rate")):
        m, se = {}, {}
        for path in ("kernel", "xla"):
            a = np.asarray(obs[path][i])              # [blocks, B]
            m[path] = a.mean()
            se_chains = a.mean(axis=0).std() / np.sqrt(a.shape[1])
            se_blocks = a.mean(axis=1).std() / np.sqrt(a.shape[0])
            se[path] = max(se_chains, se_blocks)
        d = abs(m["kernel"] - m["xla"])
        lim = 4 * np.hypot(se["kernel"], se["xla"])
        print(f"   L={L} beta=2 {what}: kernel {m['kernel']:.6f} "
              f"xla {m['xla']:.6f} |diff| {d:.2e} limit {lim:.2e}",
              flush=True)
        if not d < lim:
            raise AssertionError(f"{what} differs beyond 4 standard errors")


def main_path(sizes=((32, 8192), (16, 8192)), small=(16, 1024)) -> None:
    import jax
    import numpy as np

    import rrrmc_tpu as rt

    for L, B in sizes:
        X = rt.GraphEA(L, 3, (-1, 1), seed=42)
        Es, st = rt.sweepMC(X, beta=2.0, sweeps=20, step=5, chains=B)
        inv = _invariant(X, st.sigma, st.E)
        print(f"   sweepMC EA-3D L={L} N={X.N} chains={B}: "
              f"LAST_ROUTE={rt.LAST_ROUTE['backend']} E/N="
              f"{float(np.asarray(Es)[:, -1].mean()) / X.N:.5f} "
              f"invariant max |E - E_re| = {inv}", flush=True)
        if inv != 0 or Es.shape != (B, 4):
            raise AssertionError(f"sweepMC L={L} failed")
    L, B = small
    X = rt.GraphEA(L, 3, (-1, 1), seed=42)
    runs = {
        "standardMC": lambda: rt.standardMC(X, 2.0, 2000, step=500,
                                            chains=B),
        "rrrMC": lambda: rt.rrrMC(X, 2.0, 500, step=100, chains=B),
        "bklMC": lambda: rt.bklMC(X, 2.0, 2000, step=500, chains=B),
        "wtmMC": lambda: rt.wtmMC(X, 2.0, 4, step=200.0, chains=B),
    }
    for name, run in runs.items():
        Es, st = run()
        inv = _invariant(X, st.sigma, st.E)
        ok = inv == 0 and bool(np.all(np.isfinite(np.asarray(Es))))
        print(f"   {name} EA-3D L={L} chains={B}: "
              f"LAST_ROUTE={rt.LAST_ROUTE['backend']} "
              f"invariant max |E - E_re| = {inv}", flush=True)
        if not ok:
            raise AssertionError(f"{name} failed")
    res = rt.extremal_opt(X, 1.4, 500, chains=B)
    phys = jax.jit(jax.vmap(lambda s: X.to_physical(X.energy(s))))
    d = float(np.max(np.abs(np.asarray(phys(res.sigma_min))
                            - np.asarray(res.Emin))))
    print(f"   extremal_opt EA-3D L={L} chains={B}: "
          f"LAST_ROUTE={rt.LAST_ROUTE['backend']} Emin/N="
          f"{float(np.asarray(res.Emin).min()) / X.N:.5f} "
          f"invariant max |Emin - E(sigma_min)| = {d}", flush=True)
    if d != 0.0:
        raise AssertionError("extremal_opt invariant broken")


def timing(gpu: str, cells=((16, 8192, 500, 100), (32, 8192, 100, 10)),
           repeats: int = 5) -> dict:
    """Attempted flips/s of rt.sweepMC end to end, routed (kernel) vs
    backend="xla"; warm calls timed to block_until_ready, median."""
    import jax
    import numpy as np

    import rrrmc_tpu as rt

    out = {}
    for L, B, sk, sx in cells:
        X = rt.GraphEA(L, 3, (-1, 1), seed=42)
        row = {}
        for backend, sweeps in (("auto", sk), ("xla", sx)):
            _, st = rt.sweepMC(X, 2.0, sweeps, step=sweeps, chains=B,
                               seed=1, backend=backend)
            jax.block_until_ready(st.E)
            ts = []
            for _ in range(repeats):
                t0 = time.perf_counter()
                _, st = rt.sweepMC(X, 2.0, sweeps, step=sweeps, chains=B,
                                   state=st, backend=backend)
                jax.block_until_ready(st.E)
                ts.append(time.perf_counter() - t0)
            rates = B * X.N * sweeps / np.asarray(ts)
            row[rt.LAST_ROUTE["backend"]] = float(np.median(rates))
            print(f"   L={L} B={B} {rt.LAST_ROUTE['backend']}: median "
                  f"{np.median(rates):.4e} attempted flips/s over {repeats} "
                  f"warm runs of {sweeps} sweeps (min {rates.min():.4e}, "
                  f"max {rates.max():.4e}) [{gpu}]", flush=True)
        out[f"L{L}_B{B}"] = row
    return out


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------

def _spread(x, n: int) -> None:
    devs = x.sharding.device_set
    if len(devs) != n:
        raise AssertionError(f"output on {len(devs)} devices, expected {n}")


def four_cards(n: int = 4, L: int = 16, T: int = 16, B: int = 1024,
               rounds: int = 3) -> None:
    """Sharded tempering and chain-sharded sweeps vs their one-card runs,
    bit for bit; every output must be spread over all n devices."""
    import jax
    import numpy as np

    import rrrmc_tpu as rt
    from rrrmc_tpu.parallel.mesh import make_mesh, sample_sharded

    devs = jax.devices()
    if len(devs) < n:
        raise RuntimeError(f"need {n} devices, have {len(devs)}")
    X = rt.GraphEA(L, 3, (-1, 1), seed=7)
    betas = np.linspace(0.3, 2.0, T)
    mesh = make_mesh({"temp": 2, "chains": n // 2}, devices=devs[:n])
    Es, ranks, st = rt.parallel_tempering(
        X, betas, rounds, sweeps_per_round=2, chains=B, seed=3, mesh=mesh,
        axis="temp", chain_axis="chains")
    jax.block_until_ready(Es)
    for x in (st.sigma, st.E):
        _spread(x, n)
    with jax.default_device(devs[0]):
        Es_u, ranks_u, st_u = rt.parallel_tempering(
            X, betas, rounds, sweeps_per_round=2, chains=B, seed=3)
    same = (np.array_equal(np.asarray(Es), np.asarray(Es_u))
            and np.array_equal(np.asarray(ranks), np.asarray(ranks_u))
            and np.array_equal(np.asarray(st.sigma), np.asarray(st_u.sigma)))
    print(f"   parallel_tempering EA-3D L={L} T={T} x {B} chains on mesh "
          f"{dict(mesh.shape)}: sharded == one-card bit for bit: {same}",
          flush=True)
    if not same:
        raise AssertionError("sharded tempering differs from one card")

    mesh_c = make_mesh({"chains": n}, devices=devs[:n])
    Es_s, st_s = sample_sharded(rt.sweepMC, X, mesh_c, 2.0, 20, step=5,
                                chains=8192, seed=11)
    route_s = rt.LAST_ROUTE["backend"]
    _spread(st_s.sigma, n)
    _spread(Es_s, n)
    with jax.default_device(devs[0]):
        Es_r, st_r = rt.sweepMC(X, 2.0, 20, step=5, chains=8192, seed=11,
                                backend="xla")
    same = (np.array_equal(np.asarray(Es_s), np.asarray(Es_r))
            and np.array_equal(np.asarray(st_s.sigma), np.asarray(st_r.sigma)))
    inv = _invariant(X, st_s.sigma, st_s.E)
    print(f"   sample_sharded(sweepMC) L={L} 8192 chains over {n} cards "
          f"(route {route_s}) == one-card XLA run bit for bit: {same}; "
          f"invariant max |E - E_re| = {inv}", flush=True)
    if not same or inv != 0:
        raise AssertionError("chain-sharded sweeps differ from one card")


# ---------------------------------------------------------------------------

def main(argv) -> int:
    four = "--four" in argv
    gpu = card()
    if not four:
        with phase("on-card tests (pytest -m gpu, child process)"):
            gpu_tests()

    from rrrmc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: JAX's default device is {dev.platform!r}",
              file=sys.stderr)
        return 1
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    with phase("card"):
        print(f"   {gpu}; JAX {jax.__version__}: {device}", flush=True)
    if four:
        with phase("four cards: tempering and chain sharding vs one card"):
            four_cards()
    else:
        with phase("compile"):
            for L in (16, 32):
                compile_kernel(L, 8192)
        with phase("reference: kernel vs XLA"):
            for L in (16, 32):
                reference(L, 8192)
        with phase("main path through the public samplers"):
            main_path()
        with phase("timing: routed kernel vs XLA"):
            timing(gpu)
    print(gpu)
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
