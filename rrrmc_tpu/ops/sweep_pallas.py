"""Checkerboard sweep of an EA lattice as one Pallas kernel on the Triton route.

The XLA sweep (samplers/sweep.py) recomputes all N local fields after every
colour step, draws a threefry uniform and an `exp` for every site, and
round-trips sigma and the int32 local-field cache through device memory.
This kernel keeps each block of chains in one program for all `n_sweeps`
sweeps:

* layout [N, B]: sites on rows, chains contiguous, so every site row is one
  coalesced load of BT int8 spins; one program per block of BT chains, and
  blocks never interact;
* the sweep loop (dynamic trip count), the two colours and the site tiles
  all run inside the program. A tile holds TS sites of ONE colour (sites are
  enumerated colour-compacted), so no work is spent on the inactive half;
  tiles store only the sites they own, and a block barrier separates the
  colour steps (checkerboard: same-colour sites are never neighbours);
* neighbours are index loads from the spin ref: the row of x +- e_d with the
  periodic wrap folded into the index, the same identity the roll-based
  local field of models/lattice.py uses;
* acceptance is integer: dE = 2 * half with half = sigma * lf, accept iff
  half <= 0 or bits < th[half], where th is a tiny int32 threshold table
  (the local field takes at most 2 * D * |J|max + |h|max values) and bits
  come from the counter hash of ops/prng.py. Energies are tracked exactly in
  int32.

Restricted to integer-coupling LatticeEA with even L (checkerboard);
integer external fields ride as one more coupling row. Acceptance matches
metropolis_accept (/root/reference/src/RRRMC.jl:39).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgt

from .prng import draw_salt, random_bits, seed_salt

#: threshold tables longer than this use the exp path instead (fixed-point
#: couplings make the local field range wide)
MAX_TABLE = 64

#: chains per program and warps per program: the fastest pair measured on
#: an H100 at EA-3D L=16 and L=32 with 8192 chains, among block widths
#: 16..128 and 2..8 warps
BLOCK_CHAINS = 64
NUM_WARPS = 8


def _div(a, b: int):
    """Truncating int32 division by a constant (operands are >= 0)."""
    return jax.lax.div(a, jnp.int32(b))


def _rem(a, b: int):
    return jax.lax.rem(a, jnp.int32(b))


def _site_of(k, colour, L: int, D: int):
    """Site index of the k-th site of `colour` (0 = even coordinate sum).
    Row q = k // (L/2) of the lattice's innermost axis holds L/2 sites of
    each colour at alternating x."""
    half_l = L // 2
    q = _div(k, half_l)
    par = jnp.zeros_like(q)
    qq = q
    for _ in range(D - 1):
        par = par + _rem(qq, L)
        qq = _div(qq, L)
    x = 2 * _rem(k, half_l) + _rem(par + colour, 2)
    return q * L + x


def site_order(L: int, D: int) -> np.ndarray:
    """[2, N/2] site indices in the kernel's colour-compacted order."""
    k = jnp.arange(L ** D // 2, dtype=jnp.int32)
    return np.stack([np.asarray(_site_of(k, c, L, D)) for c in (0, 1)])


def _sweep_kernel(seed_ref, ns_ref, beta2s_ref, th_ref, jc_ref, e_ref,
                  sig_in_ref, sig_ref, e_out_ref, *, L, D, BT, TS,
                  max_half, has_field, barrier):
    """One program = one block of BT chains. sig_ref [N, BT] is the output
    block, aliased to the input (sig_in_ref is never read); jc_ref
    [2, 2D(+1), N/2] holds, per colour and compacted site, the couplings
    toward +e_d and -e_d (and the field)."""
    del sig_in_ref
    N = L ** D
    n_tiles = (N // 2) // TS
    strides = [L ** (D - 1 - d) for d in range(D)]
    cols = jax.lax.broadcasted_iota(jnp.int32, (1, BT), 1)
    chain = pl.program_id(0) * BT + cols
    key = seed_salt(seed_ref[0])
    beta2s = beta2s_ref[0]       # exp path only

    def tile(colour, salt, t, dE):
        k = t * TS + jax.lax.broadcasted_iota(jnp.int32, (TS, 1), 0)
        i = _site_of(k, colour, L, D)
        lf = None
        for d, s in enumerate(strides):
            c = _rem(_div(i, s), L)
            up = jnp.where(c == L - 1, i - s * (L - 1), i + s)
            dn = jnp.where(c == 0, i + s * (L - 1), i - s)
            jp = jc_ref[colour, 2 * d, pl.ds(t * TS, TS)][:, None]
            jm = jc_ref[colour, 2 * d + 1, pl.ds(t * TS, TS)][:, None]
            t_d = (jp * sig_ref[up, cols].astype(jnp.int32)
                   + jm * sig_ref[dn, cols].astype(jnp.int32))
            lf = t_d if lf is None else lf + t_d
        if has_field:
            lf = lf + jc_ref[colour, 2 * D, pl.ds(t * TS, TS)][:, None]
        sig = sig_ref[i, cols].astype(jnp.int32)
        half = sig * lf                                  # dE = 2 * half
        bits = random_bits(i, chain, salt)
        if max_half:
            th = th_ref[jnp.clip(half, 1, max_half) - 1]
        else:
            p = jnp.exp(-beta2s * half.astype(jnp.float32))
            th = jnp.clip(p * 4294967296.0 - 2147483648.0,
                          -2147483648.0, 2147483520.0).astype(jnp.int32)
        acc = (half <= 0) | (bits < th)
        plgt.store(sig_ref.at[i, cols], (-sig).astype(jnp.int8), mask=acc)
        return dE + 2 * jnp.sum(jnp.where(acc, half, 0), axis=0,
                                dtype=jnp.int32)

    def one_sweep(sw, dE):
        for colour in (0, 1):
            salt = draw_salt(key, 2 * sw + colour)
            dE = jax.lax.fori_loop(jnp.int32(0), jnp.int32(n_tiles),
                                   partial(tile, colour, salt), dE)
            if barrier:
                plgt.debug_barrier()
        return dE

    dE = jax.lax.fori_loop(jnp.int32(0), ns_ref[0], one_sweep,
                           jnp.zeros((BT,), jnp.int32))
    e_out_ref[...] = e_ref[...] + dE


def accept_thresholds(beta2s: float, max_half: int) -> np.ndarray:
    """int32 thresholds th[v-1] for half = v in 1..max_half: accept iff
    bits < th where bits ~ U(int32) — i.e. with prob e^(-beta2s*v)."""
    v = np.arange(1, max_half + 1, dtype=np.float64)
    p = np.exp(-float(beta2s) * v)
    return np.clip(p * 4294967296.0 - 2147483648.0,
                   -2147483648.0, 2147483520.0).astype(np.int32)


def tile_sites(N: int, cap: int = 256) -> int:
    """Largest power of two <= cap dividing the N/2 sites of one colour."""
    n2 = N // 2
    ts = 1
    while ts * 2 <= cap and n2 % (ts * 2) == 0:
        ts *= 2
    return ts


@partial(jax.jit, static_argnames=("L", "D", "max_half", "has_field",
                                   "block_chains", "tile", "num_warps",
                                   "n_ckpt", "interpret"))
def _sweep(sigma, E, jc, th, beta2s, seed, step, *, L, D, max_half,
           has_field, block_chains, tile, num_warps, n_ckpt, interpret):
    """n_ckpt kernel dispatches of `step` sweeps each, in one jit: the
    [N, B] layout is kept between checkpoints. Returns (sigma, E,
    Es [n_ckpt, B])."""
    B, N = sigma.shape
    BT = block_chains
    Bp = -(-B // BT) * BT
    # chains padded to whole blocks; the padding chains are dropped after
    sigT = jnp.pad(sigma.T, ((0, 0), (0, Bp - B)), constant_values=1)
    Ep = jnp.pad(E.astype(jnp.int32), (0, Bp - B))
    kernel = partial(_sweep_kernel, L=L, D=D, BT=BT, TS=tile,
                     max_half=max_half, has_field=has_field,
                     barrier=not interpret)
    whole = lambda shape: pl.BlockSpec(shape, lambda j: (0,) * len(shape))
    call = pl.pallas_call(
        kernel,
        grid=(Bp // BT,),
        in_specs=[whole((1,)), whole((1,)), whole((1,)), whole(th.shape),
                  whole(jc.shape),
                  pl.BlockSpec((BT,), lambda j: (j,)),
                  pl.BlockSpec((N, BT), lambda j: (0, j))],
        out_specs=[pl.BlockSpec((N, BT), lambda j: (0, j)),
                   pl.BlockSpec((BT,), lambda j: (j,))],
        out_shape=[jax.ShapeDtypeStruct((N, Bp), jnp.int8),
                   jax.ShapeDtypeStruct((Bp,), jnp.int32)],
        input_output_aliases={6: 0},
        compiler_params=plgt.CompilerParams(num_warps=num_warps,
                                            num_stages=1),
        backend="triton",
        interpret=interpret,
        name="lattice_sweep",
    )

    def checkpoint(carry, k):
        sigT, Ep = carry
        sigT, Ep = call(seed + k, step, beta2s, th, jc, Ep, sigT)
        return (sigT, Ep), Ep[:B]

    (sigT, Ep), Es = jax.lax.scan(checkpoint, (sigT, Ep),
                                  jnp.arange(n_ckpt, dtype=jnp.int32))
    return sigT[:, :B].T, Ep[:B].astype(E.dtype), Es


def kernel_eligible(model) -> bool:
    """Integer-coupling LatticeEA with even L: the checkerboard this kernel
    sweeps."""
    from ..models.lattice import LatticeEA

    return (isinstance(model, LatticeEA)
            and jnp.issubdtype(model.Jd.dtype, jnp.integer)
            and jnp.issubdtype(model.h.dtype, jnp.integer)
            and model.L % 2 == 0)


class LatticeSweeper:
    """Kernel runner for one (model, beta): builds the colour-compacted
    coupling table and the threshold table once; each call is one jitted
    dispatch of `n_sweeps` sweeps over all chains.

    block_chains: chains per program (power of two); interpret=True runs
    the kernel in the Pallas interpreter (tests only)."""

    def __init__(self, model, beta: float, *,
                 block_chains: int = BLOCK_CHAINS, interpret: bool = False):
        if not kernel_eligible(model):
            raise ValueError("the lattice sweep kernel needs an integer-"
                             "coupling LatticeEA with even L")
        L, D, N = model.L, model.D, model.N
        Jd = np.asarray(model.Jd, np.int32)
        h = np.asarray(model.h, np.int32).reshape(N)
        rows = []
        for d in range(D):
            rows.append(Jd[d].reshape(N))                       # toward +e_d
            rows.append(np.roll(Jd[d], 1, axis=d).reshape(N))   # toward -e_d
        self.has_field = bool(np.any(h))
        if self.has_field:
            rows.append(h)
        table = np.stack(rows)                                   # [K, N]
        order = site_order(L, D)
        self.jc = jnp.asarray(np.stack([table[:, order[c]] for c in (0, 1)]))
        mh = int(np.abs(table).sum(axis=0).max())
        self.max_half = mh if mh <= MAX_TABLE else 0
        beta2s = 2.0 * float(beta) * float(model.scale)
        self.th = jnp.asarray(accept_thresholds(beta2s, max(self.max_half, 1)))
        self.beta2s = jnp.asarray([beta2s], jnp.float32)
        self.L, self.D = L, D
        self.tile = tile_sites(N)
        self.block_chains = block_chains
        self.num_warps = NUM_WARPS
        self.interpret = interpret

    def run(self, sigma, E, *, seed, n_ckpt: int, step: int):
        """sigma [B, N] int8, E [B] int32 -> (sigma', E', Es [n_ckpt, B]):
        n_ckpt checkpoints of `step` sweeps each; any B (the last block of
        chains is padded). seed: int32 scalar; checkpoint k draws from
        stream seed + k."""
        return _sweep(sigma, E, self.jc, self.th, self.beta2s,
                      jnp.asarray(seed, jnp.int32).reshape(1),
                      jnp.asarray([step], jnp.int32),
                      L=self.L, D=self.D, max_half=self.max_half,
                      has_field=self.has_field,
                      block_chains=self.block_chains, tile=self.tile,
                      num_warps=self.num_warps, n_ckpt=n_ckpt,
                      interpret=self.interpret)

    def __call__(self, sigma, E, *, seed, n_sweeps: int):
        """One checkpoint of n_sweeps sweeps -> (sigma', E')."""
        sigma, E, _ = self.run(sigma, E, seed=seed, n_ckpt=1, step=n_sweeps)
        return sigma, E
