"""Device decode of the Low Entropy / ``rle8m`` formats — the device analog of
the reference's OpenCL decoder.

The reference's only accelerator backend is an OpenCL kernel that decodes
the ``rle8m`` container with one work-group per subsection: the host parses
the container (offset table + symbol LUT), uploads payload/LUT/offsets, and
the device runs the scalar expand loop per subsection
(`rle8_ocl.c:265-413`, kernel `rle8_ocl_kernel.h:6-81`).

This version keeps the same host/device split but replaces the scalar
work-group loop with the planar IR: the host pass walks each subsection's
command stream once (O(compressed size)) and lowers it to planar columns
``(sym, count, lit_len, lits)``; the device then expands **all** subsections
at once with the vectorized block decoder (`ops/device.py:decode_blocks`).
One subsection maps to one block — exactly the work-group-per-subsection
shape, but with every byte of the expansion vectorized instead of one
scalar loop per group.
"""

from __future__ import annotations

import struct

import jax.numpy as jnp
import numpy as np

from . import device
from .planar import PlanarBlocks
from ..formats.low_entropy import _symbol_to_count

_ROW = 128


def _parse_section_to_planar(buf: memoryview, p: int, want: int,
                             rle: np.ndarray, stc: np.ndarray):
    """Walk one subsection's compressed stream; return (sym, count, lit_len,
    lits, n_cmds, n_lits, next_p).  Every compressed byte is a literal; an
    RLE-enabled byte is additionally followed by one count byte
    (rle8_ocl_kernel.h:9-45 is the scalar dual of this)."""
    sym, count, lit_len = [], [], []
    lits = bytearray()
    lit_run = 0
    produced = 0
    end = len(buf)
    while produced < want:
        if p >= end:
            raise ValueError("low-entropy stream truncated mid-subsection")
        b = buf[p]; p += 1
        lits.append(b)
        lit_run += 1
        produced += 1
        if rle[b]:
            if p >= end:
                raise ValueError("low-entropy stream truncated at count byte")
            c = int(stc[buf[p]]); p += 1
            if c:
                sym.append(b)
                count.append(c)
                lit_len.append(lit_run)
                lit_run = 0
                produced += c
    if produced != want:
        # a run crossed the subsection boundary: the host decoder carries the
        # overshoot into the next subsection; here it means the stream does
        # not decompose into independent blocks, so fail loudly.
        raise ValueError(
            f"subsection overshoot: produced {produced}, wanted {want}")
    sym.append(0)
    count.append(0)
    lit_len.append(lit_run)          # tail command (count == 0)
    return (np.array(sym, np.uint8), np.array(count, np.int32),
            np.array(lit_len, np.int32), np.frombuffer(bytes(lits), np.uint8),
            len(sym), len(lits), p)


def _stack_planar(parts, block_lens):
    """Pad per-section planar columns to a common static shape."""
    nb = len(parts)
    cap = max(len(p[0]) for p in parts)
    cap = (cap + _ROW - 1) // _ROW * _ROW
    B = max(int(l) for l in block_lens)
    B = (B + _ROW - 1) // _ROW * _ROW
    sym = np.zeros((nb, cap), np.uint8)
    count = np.zeros((nb, cap), np.int32)
    lit_len = np.zeros((nb, cap), np.int32)
    lits = np.zeros((nb, B), np.uint8)
    n_cmds = np.zeros(nb, np.int32)
    n_lits = np.zeros(nb, np.int32)
    for i, (s, c, ll, lb, nc, nl, _) in enumerate(parts):
        sym[i, :nc] = s
        count[i, :nc] = c
        lit_len[i, :nc] = ll
        lits[i, :nl] = lb
        n_cmds[i] = nc
        n_lits[i] = nl
    return PlanarBlocks(jnp.asarray(sym), jnp.asarray(count),
                        jnp.asarray(lit_len), jnp.asarray(lits),
                        jnp.asarray(n_cmds), jnp.asarray(n_lits),
                        jnp.asarray(np.asarray(block_lens, np.int32)))


def le_decompress_device(buf) -> bytes:
    """Decode a Low Entropy (+Short: same grammar) stream on the device."""
    buf = memoryview(bytes(buf))
    _csize, usize = struct.unpack_from("<II", buf, 0)
    if usize == 0:
        return b""
    p = 8
    rle = np.unpackbits(np.frombuffer(buf, np.uint8, 32, p),
                        bitorder="little").astype(bool)
    p += 32
    sc = buf[p]; p += 1
    nsym = sc if sc else 255
    stc = _symbol_to_count(bytes(buf[p:p + nsym]))
    p += nsym
    part = _parse_section_to_planar(buf, p, usize, rle, stc)
    pb = _stack_planar([part], [usize])
    out = np.asarray(device.decode_blocks(pb))
    return out[0, :usize].tobytes()


def rle8m_decompress_device(buf) -> bytes:
    """Decode an ``rle8m`` container on the device, one block per
    subsection — the direct analog of `rle8m_opencl_decompress`
    (rle8_ocl.c:265-413) with the NDRange replaced by the block axis."""
    buf = memoryview(bytes(buf))
    _csize, usize = struct.unpack_from("<II", buf, 0)
    p = 8
    subs = struct.unpack_from("<I", buf, p)[0]; p += 4
    if subs == 0 or usize == 0:
        return b""
    # per-subsection end offsets are authoritative (rle8_ocl.c pStartOffsets;
    # host rle8m_decompress re-anchors the same way)
    offsets = [struct.unpack_from("<I", buf, p + 4 * i)[0]
               for i in range(subs - 1)]
    p += 4 * (subs - 1)
    rle = np.unpackbits(np.frombuffer(buf, np.uint8, 32, p),
                        bitorder="little").astype(bool)
    p += 32
    sc = buf[p]; p += 1
    nsym = sc if sc else 255
    stc = _symbol_to_count(bytes(buf[p:p + nsym]))
    p += nsym

    sub = usize // subs
    sizes = [sub] * (subs - 1) + [usize - sub * (subs - 1)]
    bounds = offsets + [_csize]
    parts = []
    for k, want in enumerate(sizes):
        part = _parse_section_to_planar(buf, p, want, rle, stc)
        p = part[-1]
        if p > bounds[k]:
            raise ValueError(
                f"subsection {k} parse ran past its recorded offset "
                f"({p} > {bounds[k]})")
        p = bounds[k]                 # re-anchor to the recorded offset
        parts.append(part)
    pb = _stack_planar(parts, sizes)
    out = np.asarray(device.decode_blocks(pb))
    chunks = [out[i, :sizes[i]] for i in range(subs)]
    return np.concatenate(chunks).tobytes()
