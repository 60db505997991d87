"""The expand's byte stage as a Pallas kernel through the Triton route,
for CUDA GPUs: the same bytes as ops/device.expand_bytes, from the same
per-command tables (ops/device.expand_tables).

One program writes one output tile of one block.  It finds the commands
of its first and last byte by a scalar binary search over the block's
command starts, then gives every byte of the tile its command by a
vector binary search between those two, and writes the tile with one
gather from the literal section (masked to literal bytes) or the run
symbol.  Unlike the XLA formulation, no [nb, B] int32 index plane goes
through device memory: the kernel reads the command tables (cached) and
O(compressed) literals, and writes each output byte once.  On the H100 it
expands 256 MiB about 5x faster than the XLA formulation (PERF.md).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

TILE = 2048         # output bytes per program
NUM_WARPS = 4


def _kernel(start_ref, run_at_ref, lit_base_ref, sym_ref, lits_ref,
            meta_ref, out_ref, *, steps: int):
    b = pl.program_id(0)
    j0 = pl.program_id(1) * TILE
    n_cmds = meta_ref[b, 0]
    blen = meta_ref[b, 1]
    C = start_ref.shape[1]

    def last_start_le(pos):             # scalar binary search
        lo = jnp.int32(0)
        for k in reversed(range(steps)):
            cand = lo + (1 << k)
            ok = (cand < n_cmds) & (
                start_ref[b, jnp.minimum(cand, C - 1)] <= pos)
            lo = jnp.where(ok, cand, lo)
        return lo

    c_lo = last_start_le(j0)
    c_hi = last_start_le(j0 + TILE - 1)
    nbits = 32 - jax.lax.clz(c_hi - c_lo)
    j = j0 + jnp.arange(TILE, dtype=jnp.int32)

    def body(i, lo):                    # vector binary search in the tile
        cand = lo + jax.lax.shift_left(jnp.int32(1), nbits - 1 - i)
        ok = (cand <= c_hi) & (start_ref[b, jnp.minimum(cand, C - 1)] <= j)
        return jnp.where(ok, cand, lo)

    c = jax.lax.fori_loop(0, nbits, body,
                          jnp.full((TILE,), c_lo, jnp.int32))
    in_lit = j < run_at_ref[b, c]
    li = jnp.clip(j + lit_base_ref[b, c], 0, lits_ref.shape[1] - 1)
    lit = plgpu.load(lits_ref.at[b, li], mask=in_lit, other=0)
    val = jnp.where(in_lit, lit.astype(jnp.int32), sym_ref[b, c])
    out_ref[...] = jnp.where(j < blen, val, 0).astype(jnp.uint8)


def expand_bytes(start, run_at, lit_base, sym, lits, n_cmds, block_len, *,
                 block_size: int, interpret: bool = False) -> jnp.ndarray:
    """Same contract as ops/device.expand_bytes.  ``interpret`` runs the
    kernel in the Pallas interpreter, for the CPU tests only."""
    nb, C = start.shape
    meta = jnp.stack([n_cmds, block_len], axis=1).astype(jnp.int32)
    Bp = -(-block_size // TILE) * TILE
    args = (start, run_at, lit_base, sym.astype(jnp.int32), lits, meta)
    whole = [pl.BlockSpec(a.shape, lambda b, t, n=a.ndim: (0,) * n)
             for a in args]
    out = pl.pallas_call(
        functools.partial(_kernel, steps=max(1, (C - 1).bit_length())),
        grid=(nb, Bp // TILE),
        in_specs=whole,
        out_specs=pl.BlockSpec((None, TILE), lambda b, t: (b, t)),
        # inside shard_map the output varies over the same mesh axes as
        # the command tables
        out_shape=jax.ShapeDtypeStruct((nb, Bp), jnp.uint8,
                                       vma=jax.typeof(start).vma),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="hrt1_expand_triton",
    )(*args)
    return out[:, :block_size]
