"""Device (XLA) encode/decode over planar blocks.

Plain ``jnp``/``lax`` formulations built from prefix sums, gathers and
scatters, which the GPU runs natively.  Everything is shape-static and
batched over the block axis, so the same code runs under `jit`, inside
`shard_map` partitions, and on the CPU backend for tests.

Algorithmic mapping from the reference's scalar loops (SURVEY.md section 7):

- encode: neighbor-compare -> run boundaries -> distance-to-next-boundary via
  reversed cumulative minimum -> emission mask (cost model) -> prefix-sum +
  scatter compaction of commands and literals.  Replaces the
  cmpeq/movemask/ctz scan loop (rle8_extreme_cpu.h:768-931).
- decode (expand): exclusive prefix sums of (lit_len + count) give each
  command's output start; a 1 scattered at every start and a prefix sum
  over the output plane give each output byte its command; one gather from
  the literal section or the run symbol materializes the byte.  Replaces
  the memcpy/memset command loop (rle8_extreme_cpu.h:1546-1634).  The
  literal section may be narrower than the block (O(compressed) input).
  On a CUDA GPU the byte stage runs as a Pallas Triton kernel instead
  (ops/expand_triton.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from . import expand_triton
from .planar import PlanarBlocks


# ---------------------------------------------------------------------------
# prefix-sum data movement
# ---------------------------------------------------------------------------

def distribute(compact: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """Spread a left-compacted stream over the True positions of ``mask``
    (last axis): ``out[i] = compact[rank(i)]`` where ``rank(i)`` counts the
    True positions before i.  Positions where ``mask`` is False hold an
    arbitrary element of ``compact``.  Prefix sum + gather."""
    m = mask.astype(jnp.int32)
    rank = jnp.cumsum(m, axis=-1) - m
    idx = jnp.clip(rank, 0, compact.shape[-1] - 1)
    return jnp.take_along_axis(compact, idx, axis=-1)


def compact(values: jnp.ndarray, keep: jnp.ndarray, size: int) -> jnp.ndarray:
    """Stable left-compaction along the last axis: ``out[k]`` is the value
    at the k-th True position of ``keep``; zeros past the kept count (and
    kept values beyond ``size`` are dropped).  Prefix sum + scatter."""
    lead = values.shape[:-1]
    n = values.shape[-1]
    v = values.reshape(-1, n)
    k = keep.reshape(-1, n)
    dest = jnp.where(k, jnp.cumsum(k.astype(jnp.int32), axis=-1) - 1, size)
    rows = jnp.arange(v.shape[0], dtype=jnp.int32)[:, None]
    out = jnp.zeros((v.shape[0], size), values.dtype)
    out = out.at[rows, dest].set(v, mode="drop")
    return out.reshape(*lead, size)


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------

def _encode_rows(x: jnp.ndarray, n: jnp.ndarray, capacity: int,
                 min_count: int, only_sym: jnp.ndarray) -> tuple:
    """Encode ``[nb, B]`` bytes (``n[b]`` valid) into planar commands.
    ``only_sym[b]`` < 0 emits every qualifying run; otherwise only runs of
    that byte (Single family, rle8_extreme_cpu.c:53-153)."""
    nb, B = x.shape
    pos = jnp.arange(B, dtype=jnp.int32)[None, :]
    n = n[:, None]
    valid = pos < n

    # pad with an alternating out-of-alphabet pattern so no run crosses n
    xi = jnp.where(valid, x.astype(jnp.int32), 256 + (pos & 1))

    bnd = jnp.concatenate([jnp.ones((nb, 1), bool),
                           xi[:, 1:] != xi[:, :-1]], axis=1)  # run starts
    # next boundary strictly after i (reverse cumulative minimum)
    bnd_idx = jnp.where(bnd, pos, B)
    nxt = jnp.concatenate([bnd_idx[:, 1:], jnp.full((nb, 1), B, jnp.int32)],
                          axis=1)
    next_bnd = jax.lax.cummin(nxt, axis=1, reverse=True)
    run_len = jnp.where(bnd, jnp.minimum(next_bnd, n) - pos, 0)

    emit = bnd & valid & (run_len >= min_count) & \
        ((only_sym[:, None] < 0) | (xi == only_sym[:, None]))
    n_runs = jnp.sum(emit.astype(jnp.int32), axis=1)

    sym = compact(x, emit, capacity)
    count = compact(run_len, emit, capacity)
    start = compact(jnp.broadcast_to(pos, (nb, B)), emit, capacity)
    end = start + count
    prev_end = jnp.concatenate([jnp.zeros((nb, 1), jnp.int32), end[:, :-1]],
                               axis=1)
    k = jnp.arange(capacity, dtype=jnp.int32)[None, :]
    real = k < n_runs[:, None]
    lit_len = jnp.where(real, start - prev_end, 0)

    # tail command at index n_runs: trailing literals, count == 0
    last_end = jnp.take_along_axis(
        end, jnp.maximum(n_runs - 1, 0)[:, None], axis=1)[:, 0]
    last_end = jnp.where(n_runs > 0, last_end, 0)
    lit_len = jnp.where(k == n_runs[:, None], (n[:, 0] - last_end)[:, None],
                        lit_len)
    n_cmds = n_runs + 1

    # literal compaction: bytes not covered by an emitted run
    cover_end = jax.lax.cummax(jnp.where(emit, pos + run_len, 0), axis=1)
    lit_keep = valid & (pos >= cover_end)
    n_lits = jnp.sum(lit_keep.astype(jnp.int32), axis=1)
    lits = compact(x, lit_keep, B)
    return sym, count, lit_len, lits, n_cmds, n_lits, n[:, 0]


@functools.partial(jax.jit, static_argnames=("capacity", "min_count"))
def encode_blocks(x: jnp.ndarray, block_len: jnp.ndarray, *, capacity: int,
                  min_count: int = 6,
                  only_sym: jnp.ndarray | None = None) -> PlanarBlocks:
    """Encode ``[nb, B]`` bytes into planar commands. ``block_len[nb]`` gives
    the valid byte count of each block (all but the last are usually B);
    ``only_sym[nb]`` (or None) restricts emission per block (Single)."""
    x = jnp.asarray(x, jnp.uint8)
    block_len = jnp.asarray(block_len, jnp.int32)
    if only_sym is None:
        only_sym = jnp.full(x.shape[0], -1, jnp.int32)
    return PlanarBlocks(*_encode_rows(x, block_len, capacity, min_count,
                                      jnp.asarray(only_sym, jnp.int32)))


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def expand_tables(sym, count, lit_len, n_cmds):
    """Per-command tables of the expand, ``[nb, C]`` int32 each:
    ``start`` (first output byte of the command; padding commands start at
    int32 max), ``run_at`` (first byte of its run) and ``lit_base``
    (literal index of output byte j is ``j + lit_base``)."""
    C = count.shape[1]
    real = jnp.arange(C, dtype=jnp.int32)[None, :] < n_cmds[:, None]
    ll = jnp.where(real, lit_len, 0).astype(jnp.int32)
    ct = jnp.where(real, count, 0).astype(jnp.int32)
    span = ll + ct
    start = jnp.cumsum(span, axis=1) - span
    lit_base = jnp.cumsum(ll, axis=1) - ll - start
    run_at = start + ll
    start = jnp.where(real, start, jnp.iinfo(jnp.int32).max)
    return start, run_at, lit_base


def command_index(start, block_size: int) -> jnp.ndarray:
    """``[nb, B]`` index of the command that writes each output byte: the
    last command whose start is <= j.  A 1 is scattered at every command
    start inside the block, and a prefix sum counts them."""
    nb = start.shape[0]
    rows = jnp.arange(nb, dtype=jnp.int32)[:, None]
    marks = jnp.zeros((nb, block_size), jnp.int32)
    marks = marks.at[rows, start].add(1, mode="drop")
    return jnp.cumsum(marks, axis=1) - 1


def expand_bytes(start, run_at, lit_base, sym, lits, n_cmds, block_len, *,
                 block_size: int):
    """Materialize ``[nb, B]`` bytes from the per-command tables
    (:func:`expand_tables`): each byte takes its command's literal below
    the run and the run symbol from there on; zero past ``block_len``.
    The plain XLA formulation, and the reference for the GPU kernel."""
    del n_cmds                  # padding commands start past every byte
    C = run_at.shape[1]
    c = jnp.clip(command_index(start, block_size), 0, C - 1)
    j = jnp.arange(block_size, dtype=jnp.int32)[None, :]
    in_lit = j < jnp.take_along_axis(run_at, c, axis=1)
    li = jnp.clip(j + jnp.take_along_axis(lit_base, c, axis=1),
                  0, lits.shape[1] - 1)
    out = jnp.where(in_lit, jnp.take_along_axis(lits, li, axis=1),
                    jnp.take_along_axis(sym, c, axis=1))
    return jnp.where(j < block_len[:, None], out, 0).astype(jnp.uint8)


@functools.partial(jax.jit, static_argnames=("block_size",))
def expand(sym, count, lit_len, lits, n_cmds, block_len, *,
           block_size: int) -> jnp.ndarray:
    """Planar columns -> decoded ``[nb, block_size]`` uint8 (zero past
    ``block_len``).  ``lits`` is ``[nb, L]`` with any L >= max(n_lits).

    The byte stage is chosen when the computation is lowered: on a CUDA
    GPU the Pallas Triton kernel (ops/expand_triton.py, which beat this
    module's XLA formulation end to end on the H100, PERF.md), anywhere
    else the XLA formulation :func:`expand_bytes`."""
    with jax.named_scope("hrt1_expand"):
        n_cmds = n_cmds.astype(jnp.int32)
        tables = expand_tables(sym, count, lit_len, n_cmds)
        args = (*tables, sym.astype(jnp.uint8), lits.astype(jnp.uint8),
                n_cmds, block_len.astype(jnp.int32))
        return jax.lax.platform_dependent(
            *args,
            cuda=functools.partial(expand_triton.expand_bytes,
                                   block_size=block_size),
            default=functools.partial(expand_bytes, block_size=block_size))


def decode_blocks(pb: PlanarBlocks) -> jnp.ndarray:
    """Decode planar blocks back to ``[nb, B]`` bytes (zero past block_len);
    B is the width of the literal plane."""
    return expand(pb.sym, pb.count, pb.lit_len, pb.lits, pb.n_cmds,
                  pb.block_len, block_size=pb.lits.shape[1])
