"""Reproduce the reference paper's RRG relaxation experiment
(test_RRG, /root/reference/scripts/scripts.jl:83-149): quench a +-J random
regular graph to inverse temperature beta and record the energy relaxation
E(t) for each sampler on a common nominal-iteration time axis, averaged over
disorder realizations and chains.

The reference loops over 10 seeds sequentially on one core with a 40 s
budget per run; here the disorder axis is vectorized (sample_disorder) and
every chain batch advances in lockstep, so the whole study is a few jitted
dispatches. Iteration axes are aligned by nominal iterations directly (the
reference's wall-clock `*_factor` constants exist only because serial
samplers have different per-iteration costs; see
experiments.equal_wallclock_factors for measuring those on this hardware).

Usage: python scripts/paper_rrg.py [N] [n_seeds] [chains] [beta]
Writes a markdown table to stdout and a JSON artifact next to it.
"""

import json
import sys

from rrrmc_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()

import numpy as np  # noqa: E402
import rrrmc_tpu as rt  # noqa: E402
from rrrmc_tpu.experiments import stats_time  # noqa: E402
from rrrmc_tpu.parallel.mesh import sample_disorder  # noqa: E402


def main():
    N = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
    n_seeds = int(sys.argv[2]) if len(sys.argv) > 2 else 10
    chains = int(sys.argv[3]) if len(sys.argv) > 3 else 64
    beta = float(sys.argv[4]) if len(sys.argv) > 4 else 2.0
    iters, step = 100_000, 1000

    models = [rt.GraphRRG(N, 3, (-1, 1), seed=100 + s) for s in range(n_seeds)]
    out = {"N": N, "K": 3, "beta": beta, "n_seeds": n_seeds,
           "chains": chains, "iters": iters, "step": step, "samplers": {}}
    for name, sampler, kw in [
        ("standardMC", rt.standardMC, {}),
        ("rrrMC", rt.rrrMC, {}),
        ("bklMC", rt.bklMC, {}),
    ]:
        Es, _ = sample_disorder(sampler, models, beta, iters=iters,
                                step=step, chains=chains, seed=7, **kw)
        Es = np.asarray(Es, np.float64).reshape(n_seeds * chains, -1) / N
        st = stats_time(Es, step=step, nbins=12)
        out["samplers"][name] = {k: v.tolist() for k, v in st.items()}
        print(f"== {name} ==")
        for t, m, s in zip(st["t"], st["E_mean"], st["E_sem"]):
            print(f"  t={t:>10.0f}  E/N = {m:+.5f} +- {s:.5f}")

    with open("paper_rrg_results.json", "w") as f:
        json.dump(out, f, indent=1)
    print("wrote paper_rrg_results.json")


if __name__ == "__main__":
    main()
