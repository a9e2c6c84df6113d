"""Reproduce the reference's equal-wallclock sampler-alignment experiment
(/root/reference/scripts/scripts.jl:30-37,163-166): per-iteration speed of
each sampler relative to rrrMC on GraphRRG N=10^4 K=3 at beta in {2, 3, 4},
for +-J and Gaussian couplings — the numbers the paper uses to align sampler
time axes (Met 3.7-4.5x, BKL 95-6083x effective, WTM 53-3375x on serial CPU).

Usage: python scripts/rrg_factors.py [N] [chains]
"""

import sys

from rrrmc_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()

import rrrmc_tpu as rt  # noqa: E402
from rrrmc_tpu.experiments import equal_wallclock_factors, runtest  # noqa: E402


def main():
    N = int(sys.argv[1]) if len(sys.argv) > 1 else 10_000
    chains = int(sys.argv[2]) if len(sys.argv) > 2 else 256
    for name, builder in [
        ("RRG +-J", lambda: rt.GraphRRG(N, 3, (-1, 1), seed=167)),
        ("RRG Normal", lambda: rt.GraphRRGNormal(N, 3, seed=167)),
    ]:
        X = builder()
        print(f"== {name} (N={N}, chains={chains}) ==")
        for beta in (2.0, 3.0, 4.0):
            f = equal_wallclock_factors(X, beta, iters=20_000, chains=chains)
            print(f"  beta={beta}: " + "  ".join(
                f"{k}={v:.2f}x" for k, v in sorted(f.items())))
        r = runtest(rt.standardMC, X, 2.0, 20_000, chains=chains)
        print(f"  standardMC aggregate: {r['flips_per_s']:.3e} flips/s, "
              f"accept {r['accept_rate']:.3f}, E/N {r['E_per_spin']:.4f}")


if __name__ == "__main__":
    main()
