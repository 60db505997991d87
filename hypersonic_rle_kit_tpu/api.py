"""User-facing compress / decompress.

Mirrors the reference's public surface (rle.h:53-468) with two interchangeable
on-disk formats:

- **reference formats** (`formats/*`): byte-exact interop with the C library,
  host-side.
- **HRT1 container** (`parallel/container.py`): the accelerator-native
  block format; encode and decode run on the device via `ops/device.py`.

Sizes use Python ints (the reference caps at u32/1 GiB per stream; HRT1
streams are u64 and sharded by blocks).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from . import spec as spec_mod
from .ops import device, planar, unpack_device
from .parallel import container

# per-family minimum run length for the HRT1 cost model: one command must not
# cost more than it saves.  8-bit commands cost ~3 bytes in the reference
# grammar (min_count 6, rle8_extreme_cpu.h:5); HRT1 commands cost
# cnt_bits+lit_bits+8 bits ~= 3 bytes, so the same threshold is used.
_DEFAULT_MIN_COUNT = 6

def hrt1_params(cspec: "spec_mod.CodecSpec"):
    """Map a reference codec spec onto the HRT1 device pipeline's parameter
    space: ``(width_bytes, default_block_size, min_count, single)``.

    Accelerator-native re-design of the reference's macro matrix
    (SURVEY.md §1):
    instead of five macro-instantiated SIMD codec copies per width
    (rleX_extreme_cpu.c:4-64), *one* engine runs behind a per-codec
    transform:

    - **width** (16/24/32/48/64/128 bit, rleX/rle24/rle48/rle128): blocks
      are de-interleaved into ``w`` byte lanes, so a run of w-byte symbols
      becomes w contiguous byte runs and the stride-1 engine applies
      unchanged (the device analog of the reference's staggered broadcast
      registers, rle24_extreme_cpu_decode.h:30-55).  Byte-aligned
      ("(Byte)"/UNBOUND) and symbol-aligned variants both map here: the
      per-lane view captures partial-symbol repetition a fortiori.
    - **short / packed / greedy** change the command cost model: Short's
      one-byte commands (rleX_Xsl_short.h:13-42) lower the profitable run
      length, Packed's same-symbol elision (rle8_extreme_cpu.h:832-853)
      sits between; HRT1 expresses this as the emission threshold
      ``min_count`` because its bit-packed columns already adapt command
      width per block.
    - **single** (rle8_extreme_cpu.c:53-153): emission restricted to the
      block's dominant byte; the symbol column then collapses.

    Low-entropy / MMTF / SH families keep their own device paths
    (ops/low_entropy_device.py, ops/mmtf_device.py); through HRT1 they
    fall back to the base byte-lane engine.
    """
    F = spec_mod.Family
    w = max(1, cspec.width // 8) if cspec.family in (
        F.RLE8, F.RLEX, F.LUT, F.SHORT) else 1
    if cspec.family is F.MEMCPY:
        w = 1
    block = 196608 if w in (3, 6) else container.DEFAULT_BLOCK_SIZE
    F2 = spec_mod.Family
    if cspec.short or cspec.greedy or cspec.family is F2.LUT:
        # deep-layout commands cost ~2 bytes (6b count + 6b lit_len + 3b
        # symbol ref), the Short/LUT cost model (rleX_Xsl_short.h:13-42)
        min_count = 4
    elif cspec.packed:
        min_count = 5
    else:
        min_count = _DEFAULT_MIN_COUNT
    return w, block, min_count, bool(cspec.single)


def _deinterleave_block(row: np.ndarray, n: int, w: int) -> tuple[np.ndarray, int]:
    """One padded block row -> byte-lane layout prefix of length
    ceil(n/w)*w (rest zero), with the transformed valid length."""
    B = row.shape[0]
    bt = -(-n // w) * w
    out = np.zeros(B, np.uint8)
    out[:bt] = row[:bt].reshape(bt // w, w).T.reshape(-1)
    return out, bt


def _interleave_to_stream(y, *, w: int, n: int, xp=jnp):
    """[nb, B] decoded blocks in the byte-lane layout -> the first ``n``
    bytes of the original stream.  Full blocks transpose their [w, B/w]
    lane plane; the partial last block holds ceil(n_last/w)*w lane bytes
    (the inverse of :func:`_deinterleave_block`).  ``xp`` is jnp (device)
    or np (host golden path)."""
    nb, B = y.shape
    if w == 1:
        return y.reshape(-1)[:n]
    n_last = n - (nb - 1) * B
    bt = -(-n_last // w) * w
    head = y[:nb - 1].reshape(nb - 1, w, B // w).swapaxes(1, 2).reshape(-1)
    tail = y[nb - 1, :bt].reshape(w, bt // w).T.reshape(-1)[:n_last]
    return xp.concatenate([head, tail])


# on-device re-interleave + trim, one compile per (geometry, width, size)
_interleave_plane = jax.jit(_interleave_to_stream, static_argnames=("w", "n"))


def _deinterleave(x: np.ndarray, lens: np.ndarray, w: int):
    """[nb, B] blocks + original lengths -> transformed blocks + lengths."""
    if w == 1:
        return x, lens
    nb, B = x.shape
    xt = x.reshape(nb, B // w, w).swapaxes(1, 2).reshape(nb, B)
    tlens = (-(-lens.astype(np.int64) // w) * w).astype(np.int32)
    for b in np.flatnonzero(lens != B):           # partial (tail) blocks
        xt[b], tlens[b] = _deinterleave_block(x[b], int(lens[b]), w)
    return xt, tlens


def _as_bytes_array(data) -> np.ndarray:
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data.reshape(-1).view(np.uint8))
    return np.frombuffer(memoryview(data), dtype=np.uint8)


def _to_blocks(arr: np.ndarray, block_size: int) -> tuple[np.ndarray, np.ndarray]:
    n = arr.size
    nb = max(1, -(-n // block_size))
    padded = np.zeros(nb * block_size, np.uint8)
    padded[:n] = arr
    lens = np.full(nb, block_size, np.int32)
    tail = n - (nb - 1) * block_size
    lens[-1] = tail
    return padded.reshape(nb, block_size), lens


def compress_bounds(in_size: int, block_size: int = container.DEFAULT_BLOCK_SIZE) -> int:
    """Worst-case HRT1 size: header + table + per-block worst payload."""
    nb = max(1, -(-in_size // block_size))
    per_block = block_size + block_size // _DEFAULT_MIN_COUNT * 8 + 64
    return 24 + nb * (16 + per_block)


def compress(data, codec: str | int | spec_mod.CodecSpec = "8 Bit", *,
             block_size: int | None = None,
             backend: str = "auto") -> bytes:
    """Compress to the HRT1 container.

    The codec spec selects the HRT1 pipeline parameters (width transform,
    emission threshold, single-symbol mode -- see :func:`hrt1_params`), so
    different codec families produce genuinely different payloads.

    ``backend``: 'device' (jit XLA encode), 'native' (C++ host encoder),
    'host' (numpy golden path) or 'auto' (native if available, else
    device).  All encoders emit identical commands.
    """
    if backend not in ("auto", "device", "native", "host"):
        raise ValueError(f"unknown backend {backend!r}")
    cspec = _resolve(codec)
    w, bdef, min_count, single = hrt1_params(cspec)
    if block_size is None:
        block_size = bdef
    if block_size % w:
        raise ValueError(f"block_size {block_size} not divisible by the "
                         f"{w}-byte symbol width of {cspec.name!r}")
    arr = _as_bytes_array(data)
    if arr.size == 0:
        return container.serialize_blocks(
            cspec.index, 0, block_size, min_count,
            np.zeros((0, 1), np.uint8), np.zeros((0, 1), np.int32),
            np.zeros((0, 1), np.int32), np.zeros((0, block_size), np.uint8),
            np.zeros(0, np.int32), np.zeros(0, np.int32))
    x, lens = _deinterleave(*_to_blocks(arr, block_size), w)
    only_sym = None
    if single:
        # dominant byte per block in one O(n) pass (the approximate-scan
        # analog of rle8_extreme_cpu.c:53-153): one flat bincount over
        # (block, byte) pairs, padding masked by weight
        nb_, B_ = x.shape
        flat = (np.arange(nb_, dtype=np.int64)[:, None] * 256
                + x.astype(np.int64))
        wt = (np.arange(B_)[None, :] < lens[:, None]).astype(np.float64)
        hist = np.bincount(flat.ravel(), weights=wt.ravel(),
                           minlength=nb_ * 256).reshape(nb_, 256)
        only_sym = hist.argmax(axis=1).astype(np.int32)
    cap = planar.capacity_for(block_size, min_count)
    cols = None
    if backend in ("auto", "native"):
        from .utils import native
        cols = native.planar_from_bytes(x, lens, cap, min_count,
                                        only_sym=only_sym)
        if cols is None and backend == "native":
            raise RuntimeError("native runtime unavailable")
    if cols is None and backend in ("auto", "device"):
        pb = device.encode_blocks(
            x, lens, capacity=cap, min_count=min_count,
            only_sym=None if only_sym is None else jnp.asarray(only_sym))
        cols = [np.asarray(v) for v in
                (pb.sym, pb.count, pb.lit_len, pb.lits, pb.n_cmds, pb.n_lits)]
    if cols is None:
        cols = _host_encode(x, lens, cap, block_size, min_count, only_sym)
    return container.serialize_blocks(
        cspec.index, arr.size, block_size, min_count, *cols)


def decompress(buf, *, backend: str = "auto") -> bytes:
    """Decompress an HRT1 container.

    ``backend``: 'auto' or 'device' (decode on the default JAX device from
    O(compressed) payload sections), 'host' (numpy golden path).
    """
    if backend not in ("auto", "device", "host"):
        raise ValueError(f"unknown backend {backend!r}")
    buf = bytes(buf)
    info, blocks = container.parse(buf)
    if info.uncompressed_size == 0:
        return b""
    try:
        w = hrt1_params(spec_mod.by_index(info.codec_index))[0]
    except (IndexError, KeyError):
        w = 1
    if info.block_size % w:
        raise container.ContainerError(
            f"block size {info.block_size} not divisible by codec "
            f"{info.codec_index}'s {w}-byte width")
    n = info.uncompressed_size
    B = info.block_size
    tlen = np.full(info.n_blocks, B, np.int32)
    # widths decode in the byte-lane domain (hrt1_params)
    tlen[-1] = -(-(n - (info.n_blocks - 1) * B) // w) * w

    if backend == "host":
        _, (sym, count, lit_len, lits, n_cmds, _nl, _bl) = \
            container.deserialize_to_planar(buf)
        y = np.stack([
            np.pad(planar.host_decode_block(
                sym[b], count[b], lit_len[b], lits[b],
                int(n_cmds[b]), int(tlen[b])), (0, B - int(tlen[b])))
            for b in range(info.n_blocks)])
        return _interleave_to_stream(y, w=w, n=n, xp=np).tobytes()

    y = None
    # The one place that chooses the device route.  Every container that
    # pack_for_device accepts (container-uniform bit widths, which every
    # serializer here emits) decodes from O(compressed) payload sections
    # with the bit-unpack on the device.  Containers with per-block widths
    # (container.py: pack_for_device returns None) take the host unpack
    # and ship planar columns instead.
    pk = container.pack_for_device(buf, parsed=(info, blocks))
    if pk is not None:
        pk["block_len"] = tlen
        y, bad = unpack_device.dispatch_packed(pk, unpack_device.ship_packed(pk))
        if bad is not None and bool(jnp.any(bad != 0)):
            # hostile deep container: stored sub-header counts disagree
            # with the escape population; re-route to the validating host
            # reader, which raises ContainerError
            y = None
    if y is None:
        _, (sym, count, lit_len, lits, n_cmds, _nl, _bl) = \
            container.deserialize_to_planar(buf)
        y = device.expand(sym, count, lit_len, lits, n_cmds, tlen,
                          block_size=B)
    return np.asarray(_interleave_plane(y, w=w, n=n)).tobytes()


def _host_encode(x, lens, cap, block_size, min_count, only_sym=None):
    outs = [planar.host_encode_block(
        x[b, :lens[b]], cap, block_size, min_count,
        None if only_sym is None else int(only_sym[b]))
        for b in range(x.shape[0])]
    sym = np.stack([o[0] for o in outs])
    count = np.stack([o[1] for o in outs])
    lit_len = np.stack([o[2] for o in outs])
    lits = np.stack([o[3] for o in outs])
    n_cmds = np.array([o[4] for o in outs], np.int32)
    n_lits = np.array([o[5] for o in outs], np.int32)
    return [sym, count, lit_len, lits, n_cmds, n_lits]


def _resolve(codec) -> spec_mod.CodecSpec:
    if isinstance(codec, spec_mod.CodecSpec):
        return codec
    if isinstance(codec, int):
        return spec_mod.by_index(codec)
    return spec_mod.by_name(codec)
