"""Planar (columnar) command representation — the device-side codec IR.

The reference interleaves commands and literals in one sequential byte stream
(`[symbol][count][range][literals...]`, rle8_extreme_cpu.h:768-931), which
forces a serial parse.  The device-native representation is columnar: per block,
fixed-capacity arrays

    sym[C]      run symbol of command c
    count[C]    run length (0 for the tail/padding commands)
    lit_len[C]  number of literal bytes preceding the run
    lits[B]     the concatenated literal bytes
    n_cmds      number of real commands (always >= 1: a final tail command
                with count == 0 carries the trailing literals)
    n_lits      number of literal bytes

A block decodes as ``concat(lits[s_c : s_c+lit_len[c]] + sym[c]*count[c])``
over commands c, where ``s_c`` is the exclusive prefix sum of ``lit_len``.
Every column is trivially parallel to produce and consume; the serialized
container bit-packs the columns (see parallel/container.py) so compressed
sizes stay at or below the reference's varint grammar.

Each codec family maps onto this IR via its emission rule (which runs become
commands); the 8-bit base family uses ``count >= 6`` (rle8_extreme_cpu.h:5).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class PlanarBlocks:
    """A batch of blocks in planar command form (leading axis = block)."""

    sym: Any        # [nb, C] uint8   run symbols
    count: Any      # [nb, C] int32   run lengths (0 for tail/padding)
    lit_len: Any    # [nb, C] int32   literals preceding each run
    lits: Any       # [nb, B] uint8   literal bytes (tail undefined)
    n_cmds: Any     # [nb]    int32   incl. the tail command
    n_lits: Any     # [nb]    int32
    block_len: Any  # [nb]    int32   uncompressed bytes in this block (<= B)

    @property
    def num_blocks(self) -> int:
        return self.sym.shape[0]

    @property
    def capacity(self) -> int:
        return self.sym.shape[1]

    @property
    def block_size(self) -> int:
        return self.lits.shape[1]


def capacity_for(block_size: int, min_count: int) -> int:
    """Worst-case command count for a block: one run per ``min_count`` bytes,
    plus the tail command, rounded up to a lane multiple."""
    c = block_size // max(min_count, 1) + 2
    return (c + 127) // 128 * 128


def host_encode_block(data: np.ndarray, capacity: int, block_size: int,
                      min_count: int = 6,
                      only_sym: int | None = None) -> tuple[np.ndarray, ...]:
    """Golden host encoder for one block (numpy; the device encoder in
    ops/device.py must match it exactly).  ``only_sym`` restricts emission
    to runs of that byte (the Single family's filter,
    rle8_extreme_cpu.c:53-153)."""
    n = int(data.shape[0])
    assert n <= block_size
    sym = np.zeros(capacity, np.uint8)
    count = np.zeros(capacity, np.int32)
    lit_len = np.zeros(capacity, np.int32)
    lits = np.zeros(block_size, np.uint8)
    if n == 0:
        return sym, count, lit_len, lits, np.int32(1), np.int32(0), np.int32(0)

    change = np.flatnonzero(data[1:] != data[:-1]) + 1
    starts = np.concatenate(([0], change))
    lengths = np.concatenate((change, [n])) - starts
    keep = lengths >= min_count
    if only_sym is not None:
        keep &= data[starts] == only_sym
    ks, kl = starts[keep], lengths[keep]
    n_runs = int(ks.shape[0])
    assert n_runs + 1 <= capacity, (n_runs, capacity)

    sym[:n_runs] = data[ks]
    count[:n_runs] = kl
    prev_end = np.concatenate(([0], (ks + kl)[:-1]))
    lit_len[:n_runs] = ks - prev_end
    last_end = int((ks + kl)[-1]) if n_runs else 0
    lit_len[n_runs] = n - last_end          # tail command (count == 0)
    n_cmds = n_runs + 1

    mask = np.ones(n, bool)
    for s, l in zip(ks, kl):
        mask[s:s + l] = False
    kept = data[mask]
    n_lits = int(kept.shape[0])
    lits[:n_lits] = kept
    return sym, count, lit_len, lits, np.int32(n_cmds), np.int32(n_lits), np.int32(n)


def host_decode_block(sym, count, lit_len, lits, n_cmds, block_len) -> np.ndarray:
    """Golden host decoder for one block (numpy)."""
    out = np.empty(int(block_len), np.uint8)
    pos = 0
    lp = 0
    for c in range(int(n_cmds)):
        ll = int(lit_len[c])
        out[pos:pos + ll] = lits[lp:lp + ll]
        pos += ll
        lp += ll
        cnt = int(count[c])
        out[pos:pos + cnt] = sym[c]
        pos += cnt
    assert pos == int(block_len), (pos, int(block_len))
    return out
