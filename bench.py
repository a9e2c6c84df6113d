"""Headline benchmark: attempted spin flips per second on EA-3D, on a GPU.

Workload: Edwards-Anderson 3D +-J lattice, L=16 (N=4096), beta=2.0, B=8192
chains, checkerboard sweeps through the public entry point rt.sweepMC and
its normal routing (on a GPU: the lattice sweep kernel,
ops/sweep_pallas.py). Warm calls only, each timed to
jax.block_until_ready; the value is the median of the repeats.

Fails (non-zero exit, no result) when JAX's default device is not a GPU.
Prints the card's name and power limit, then ONE JSON line.

Usage: python bench.py [repeats]
"""

import json
import sys
import time

from chip_smoke import card
from rrrmc_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import rrrmc_tpu as rt  # noqa: E402


def main():
    repeats = int(sys.argv[1]) if len(sys.argv) > 1 else 5
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX's default device is "
                 f"{dev.platform!r}")
    gpu = card()
    print(gpu)
    L, B, beta, sweeps = 16, 8192, 2.0, 1000
    X = rt.GraphEA(L, 3, (-1, 1), seed=42)
    _, state = rt.sweepMC(X, beta, 10, step=10, chains=B, seed=1)  # compile
    jax.block_until_ready(state.E)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        _, state = rt.sweepMC(X, beta, sweeps, step=sweeps, chains=B,
                              state=state)
        jax.block_until_ready(state.E)
        times.append(time.perf_counter() - t0)
    route = rt.LAST_ROUTE["backend"]
    rates = np.sort(B * X.N * sweeps / np.asarray(times))

    # correctness guard: exact integer energy invariant
    E_re = jax.jit(jax.vmap(X.energy))(state.sigma)
    inv = int(np.max(np.abs(np.asarray(E_re) - np.asarray(state.E))))
    if inv != 0:
        sys.exit(f"energy invariant broken: max |E - E_recomputed| = {inv}")

    print(json.dumps({
        "metric": "ea3d_attempted_flips_per_s",
        "value": float(np.median(rates)),
        "q1": float(np.quantile(rates, 0.25)),
        "q3": float(np.quantile(rates, 0.75)),
        "unit": "flips/s",
        "route": route,
        "card": gpu,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
