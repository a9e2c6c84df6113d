"""Dense-model (SK) sweep: sequential single-site Metropolis with
matmul-blocked delayed local-field updates.

A fully-connected flip costs O(N) local-field work, which is why the serial
reference leans on @simd bit tricks (/root/reference/src/graphs/SK.jl:96-133).
Here the classic delayed-update (rank-W) blocking maps that work onto one
matrix product per window:

* each sweep visits the sites of one shared random permutation (a valid
  random-scan Metropolis; the site order is state-independent, so sharing it
  across the chain batch preserves every chain's law while making every
  J-row access a broadcast instead of a per-chain gather);
* the sweep is processed in windows of W sites: inside a window, decisions
  are made sequentially against the stale local fields plus an O(W)-per-move
  correction from the window's own accepted flips (exact — the [W, W]
  coupling block is gathered once);
* the O(N * W) local-field update is ONE int8 matmul per window,
  lf += J[:, window] @ delta, accumulated in int32 (exact).

Layout: spins and local fields live transposed [N, B] (chains contiguous);
window row slices are row gathers. Exact int32 energies throughout.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from ..core.dtypes import ftype
from ..models.dense import FullyConnected
from .common import DEFAULT_SEED, MCState, init_state, series_to_chain_major


def _window_step(beta_s, carry, inputs):
    """One move inside a window. Carry holds only pure-add state (no dynamic
    row writes — dynamic_update_slice in a scan carry forced whole-array
    copies, ~150us/move measured); per-move results leave via scan outputs."""
    lf_cur, E = carry                 # lf_cur: [W, B] int32 (or float for
    k, Jw_k, u, s_k = inputs          # float J); Jw_k: [W]; u, s_k: [B]
    dE = 2 * s_k * lf_cur[k]          # exact int32 / float
    acc = (dE <= 0) | (u < jnp.exp(-beta_s * dE.astype(ftype())))
    d_k = jnp.where(acc, -2 * s_k, 0)                # [B] int32
    lf_cur = lf_cur + Jw_k[:, None] * d_k[None, :]
    E = E + jnp.where(acc, dE, jnp.zeros_like(dE))
    return (lf_cur, E), (jnp.where(acc, -s_k, s_k), d_k, acc)


@partial(jax.jit, static_argnames=("n_sweeps", "W"))
def _run_dense_sweeps(J, h, beta_s, sigmaT, lfT, E, key, acc_count,
                      n_sweeps: int, W: int):
    """sigmaT: [N, B] int32; lfT: [N, B] int32 (integer J) or float (float
    J, the GraphSKNormal case — same delayed-update algebra, f32/f64 rank-W
    matmul commits); J: [N, N] int8/int32/float; E: [B] matching lfT.

    Float J refreshes lf and E from scratch at every sweep end (one extra
    [N,N]x[N,B] matmul per sweep) so rounding drift stays bounded by one
    sweep's accumulation — the f32 analog of the reference's periodic
    DynamicSampler refresh (/root/reference/src/DynamicSamplers.jl:84-98);
    without it the running energy drifts visibly over ~1e4 f32 updates."""
    N, B = sigmaT.shape
    n_win = N // W
    integer = jnp.issubdtype(J.dtype, jnp.integer)
    acc_dt = jnp.int32 if integer else J.dtype

    def one_window(carry, rows_and_keys):
        sigmaT, lfT, E, acc_count = carry
        rows, ku = rows_and_keys                     # rows: [W] site ids
        Jw = J[rows][:, rows].astype(acc_dt)         # [W, W]
        sig_w = sigmaT[rows]                         # [W, B]
        lf_w = lfT[rows]
        u = jax.random.uniform(ku, (W, B), ftype())
        (_, E), (sig_new, delta, accs) = jax.lax.scan(
            partial(_window_step, beta_s),
            (lf_w, E),
            (jnp.arange(W), Jw, u, sig_w))
        sigmaT = sigmaT.at[rows].set(sig_new)
        # rank-W local-field update as one matmul: lf += J[:, rows] @ delta
        # (int8 operands when J fits, delta is {0, +-2}; int32 otherwise;
        # float J commits in its own precision)
        mm_dt = (jnp.int8 if J.dtype == jnp.int8
                 else jnp.int32 if integer else J.dtype)
        # float J: HIGHEST keeps the product in full f32 (a GPU may
        # otherwise run it in TF32) so the tracked energy stays within
        # rounding of the recomputed one
        upd = jax.lax.dot_general(
            J[rows].astype(mm_dt), delta.astype(mm_dt),
            dimension_numbers=(((0,), (0,)), ((), ())),
            precision=None if integer else jax.lax.Precision.HIGHEST,
            preferred_element_type=acc_dt)           # [N, B]
        lfT = lfT + upd
        acc_count = acc_count + accs.sum(axis=0, dtype=jnp.int32)
        return (sigmaT, lfT, E, acc_count), None

    def one_sweep(carry, key):
        k_perm, k_u = jax.random.split(key)
        perm = jax.random.permutation(k_perm, N).reshape(n_win, W)
        kus = jax.random.split(k_u, n_win)
        carry, _ = jax.lax.scan(one_window, carry, (perm, kus))
        if not integer:  # drift refresh (see docstring)
            sigmaT_c, _, _, acc_count = carry
            s = sigmaT_c.astype(acc_dt)
            lfT_c = (jax.lax.dot_general(
                J, s, dimension_numbers=(((1,), (0,)), ((), ())),
                precision=jax.lax.Precision.HIGHEST,
                preferred_element_type=acc_dt) + h.astype(acc_dt)[:, None])
            E_c = -(jnp.sum(s * (lfT_c + h.astype(acc_dt)[:, None]),
                            axis=0) / 2)
            carry = (sigmaT_c, lfT_c, E_c, acc_count)
        return carry, carry[2]  # emit E per sweep

    keys = jax.random.split(key, n_sweeps)
    (sigmaT, lfT, E, acc_count), E_series = jax.lax.scan(
        one_sweep, (sigmaT, lfT, E, acc_count), keys)
    return sigmaT, lfT, E, acc_count, E_series


#: per-model metadata (|J| maximum, colour masks, max degree),
#: computed once per model: each costs a device reduction and a host copy.
#: Keyed by id(model.J) with the arrays held to prevent id reuse.
_MODEL_CACHE: dict = {}


def _model_meta(model) -> dict:
    from .common import bound_cache_put

    # h identity matters: field variants built with dataclasses.replace
    # share the J object
    key = (id(model.J), id(model.h))
    ent = _MODEL_CACHE.get(key)
    if ent is None or ent["J"] is not model.J or ent["h"] is not model.h:
        ent = {"J": model.J, "h": model.h,
               "j_max": int(jnp.max(jnp.abs(model.J)))}
        bound_cache_put(_MODEL_CACHE, key, ent)
    return ent


def sweepMC_dense(model: FullyConnected, beta: float, sweeps: int, *,
                  step: int = 1, chains: int = 1, seed: int = DEFAULT_SEED,
                  C0=None, window: int = 128, backend: str = "auto",
                  state: Optional[MCState] = None):
    """Sequential single-site Metropolis sweeps on a dense model; `sweeps`
    full sweeps of N attempted flips per chain. Returns
    (Es [chains, sweeps // step], final MCState). Integer J keeps exact
    int32 energies; the window W is the largest divisor of N up to
    `window`. Site order: a fresh random permutation per sweep
    (reference-faithful random scan).

    Float J (GraphSKNormal, /root/reference/src/graphs/SK.jl:170-297) runs
    the same delayed-update algebra with float local fields and f32/f64
    rank-W matmul commits. backend: "auto" / "xla" run this XLA path; there
    is no kernel route, so "pallas" raises ValueError."""
    from .common import choose_route, set_route

    assert isinstance(model, FullyConnected), "requires a FullyConnected model"
    choose_route("sweepMC_dense", model, backend=backend, state=state)
    integer = jnp.issubdtype(model.J.dtype, jnp.integer)
    N = model.N
    W = min(window, N)
    if N % W:  # largest divisor of N that fits the requested window
        W = max(d for d in range(1, W + 1) if N % d == 0)
    if state is None:
        state = init_state(model, chains, seed, C0)
    set_route("xla")
    beta_s = jnp.asarray(beta * model.scale, ftype())
    if integer:
        Jm = (model.J.astype(jnp.int8) if _model_meta(model)["j_max"] <= 127
              else model.J.astype(jnp.int32))
        lf_dt = e_dt = jnp.int32
    else:
        Jm = model.J
        lf_dt = e_dt = model.J.dtype
    key = jax.random.fold_in(jax.random.key(seed), 0x5EEb)
    sigT = state.sigma.T.astype(jnp.int32)
    lfT = jax.vmap(model.local_fields)(state.sigma).T.astype(lf_dt)
    sigT, lfT, E, acc, E_series = _run_dense_sweeps(
        Jm, model.h, beta_s, sigT, lfT, state.E.astype(e_dt), key,
        state.accepted, sweeps, W)
    state = MCState(sigma=sigT.T.astype(jnp.int8),
                    aux=lfT.T.astype(state.aux.dtype), E=E, key=state.key,
                    accepted=acc)
    n_ckpt = sweeps // step
    Es = jax.vmap(model.to_physical)(
        E_series[step - 1::step][:n_ckpt])            # [n_ckpt, B]
    return series_to_chain_major(Es), state
