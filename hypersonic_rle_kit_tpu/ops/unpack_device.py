"""Device-side container unpack: payload bytes (device memory) -> planar
columns -> decoded bytes, all in one jit.

The host ships only O(compressed) bytes -- the bit-packed count/lit_len
sections, run symbols and literal bytes, 128-padded per block
(parallel/container.pack_for_device) -- exactly the shape of the
reference's OpenCL decoder, which uploads payload + offset table and
expands on-device (rle8_ocl.c:335-348).  Because serializers emit
container-uniform bit widths (container.serialize_blocks), the unpack is
pure static-shape XLA: strided byte slices -> 32-bit windows -> shift/mask.
The deep layout's escape overflow lists and symbol misses are spread to
their commands with a prefix sum and a gather (ops/device.distribute), and
the expand is ops/device.expand.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import device


def _unpack_wide(packed: jnp.ndarray, width: int, n: int) -> jnp.ndarray:
    """[nb, S] packed bytes -> [nb, n] int32 values of ``width`` bits
    (little-endian bit order, matching container._bitpack).

    O(4n): value ``8k + j`` starts at byte ``k*width + (j*width >> 3)``
    with a fixed in-byte shift per phase j, so each of the 8 phases is four
    *strided slices* of the byte stream assembled into a 32-bit window --
    no [n, width] bit plane is ever materialized.  Requires width <= 25
    and 4 bytes of zero padding after the section (container.pack_for_device
    pads every section array)."""
    nb, S = packed.shape
    if width == 0:
        return jnp.zeros((nb, n), jnp.int32)
    assert width <= 25 and n % 8 == 0, (width, n)
    assert 8 * S >= n * width, (S, n, width)
    m = n // 8
    mask = (1 << width) - 1
    pw = packed.astype(jnp.int32)
    phases = []
    for j in range(8):
        b0 = (j * width) >> 3
        sh = (j * width) & 7
        word = jnp.zeros((nb, m), jnp.int32)
        for t in range(4):
            start = b0 + t
            limit = start + (m - 1) * width + 1
            assert limit <= S, (limit, S, width, n)
            byte = jax.lax.slice(pw, (0, start), (nb, limit), (1, width))
            word = word | (byte << (8 * t))
        phases.append((word >> sh) & mask)
    return jnp.stack(phases, axis=-1).reshape(nb, n)


@functools.partial(jax.jit, static_argnames=(
    "cnt_bits", "lit_bits", "capacity", "block_size", "min_count"))
def decode_payload_device(cnts_raw, lls_raw, syms, lits, n_cmds, n_lits,
                          block_len, *, cnt_bits: int, lit_bits: int,
                          capacity: int, block_size: int,
                          min_count: int) -> jnp.ndarray:
    """Flat-layout payload sections (device arrays) -> decoded
    [nb, block_size] uint8: on-device bit-unpack of the command columns,
    then the expand."""
    del n_lits
    cap = capacity
    n_cmds = n_cmds.astype(jnp.int32)
    with jax.named_scope("hrt1_unpack"):
        idx = jnp.arange(cap, dtype=jnp.int32)[None, :]
        cnt_vals = _unpack_wide(cnts_raw, cnt_bits, cap)
        ll_vals = _unpack_wide(lls_raw, lit_bits, cap)
        count = jnp.where(idx < n_cmds[:, None] - 1, cnt_vals + min_count, 0)
        lit_len = jnp.where(idx < n_cmds[:, None], ll_vals, 0)
    return device.expand(syms, count, lit_len, lits, n_cmds, block_len,
                         block_size=block_size)


def _resolve_deep(cnt_vals, cnt_ovf, ll_vals, ll_ovf, lut, miss, dict7,
                  n_cmds, *, cnt_bits: int, lit_bits: int, min_count: int):
    """[nb, cap] unpacked deep-layout columns -> resolved (count, lit_len,
    sym): escaped values are replaced from the block's overflow list, and
    3-bit symbol references from the block dictionary (0 = next entry of
    the miss stream).  ``cnt_bits``/``lit_bits`` are 0 for a column
    without an overflow tier."""
    cap = cnt_vals.shape[1]
    idx = jnp.arange(cap, dtype=jnp.int32)[None, :]
    is_run = idx < n_cmds[:, None] - 1
    is_cmd = idx < n_cmds[:, None]
    cnt = cnt_vals
    if cnt_bits:
        esc = is_run & (cnt == (1 << cnt_bits) - 1)
        cnt = jnp.where(esc, device.distribute(cnt_ovf, esc), cnt)
    ll = ll_vals
    if lit_bits:
        esc = is_cmd & (ll == (1 << lit_bits) - 1)
        ll = jnp.where(esc, device.distribute(ll_ovf, esc), ll)
    d8 = jnp.concatenate([jnp.zeros((dict7.shape[0], 1), jnp.uint8),
                          dict7.astype(jnp.uint8)], axis=1)
    hit = jnp.take_along_axis(d8, lut, axis=1)
    is_miss = is_run & (lut == 0)
    sym = jnp.where(is_miss, device.distribute(miss, is_miss), hit)
    return (jnp.where(is_run, cnt + min_count, 0),
            jnp.where(is_cmd, ll, 0), sym.astype(jnp.uint8))


@functools.partial(jax.jit, static_argnames=(
    "cnt_bits", "lit_bits", "cnt_ovf_bits", "ll_ovf_bits",
    "capacity", "block_size", "min_count"))
def decode_deep_device(cnts_raw, cnt_ovf_raw, lls_raw, ll_ovf_raw,
                       lut_raw, miss_raw, dict7, lits,
                       n_cmds, n_lits, block_len,
                       n_cnt_ovf=None, n_ll_ovf=None, n_miss=None, *,
                       cnt_bits: int, lit_bits: int, cnt_ovf_bits: int,
                       ll_ovf_bits: int, capacity: int, block_size: int,
                       min_count: int):
    """Deep-layout payload sections -> (decoded bytes, bad flags), one jit.

    Resolves the two-tier count/lit_len escapes and the symbol-miss
    stream (the parallel analog of the reference's MTF LUT decode,
    rleX_Xsl_short.h:2201-2424), then runs the expand.

    ``bad[b] != 0`` marks a block whose stored sub-header escape/miss
    counts disagree with the actual escape population (a hostile
    container); callers must re-route such input to the validating host
    reader, which raises ContainerError."""
    del n_lits
    cap = capacity
    n_cmds = n_cmds.astype(jnp.int32)
    with jax.named_scope("hrt1_unpack"):
        cnt_vals = _unpack_wide(cnts_raw, cnt_bits, cap)
        cov_vals = _unpack_wide(cnt_ovf_raw, cnt_ovf_bits, cap)
        ll_vals = _unpack_wide(lls_raw, lit_bits, cap)
        lov_vals = _unpack_wide(ll_ovf_raw, ll_ovf_bits, cap)
        lut = _unpack_wide(lut_raw, 3, cap)
        idx = jnp.arange(cap, dtype=jnp.int32)[None, :]
        is_run = idx < n_cmds[:, None] - 1
        is_cmd = idx < n_cmds[:, None]
        bad = jnp.zeros(n_cmds.shape[0], jnp.int32)
        if n_cnt_ovf is not None and cnt_bits:
            actual = jnp.sum((is_run & (cnt_vals == (1 << cnt_bits) - 1))
                             .astype(jnp.int32), axis=1)
            bad = bad | (actual != n_cnt_ovf.astype(jnp.int32)).astype(
                jnp.int32)
        if n_ll_ovf is not None and lit_bits:
            actual = jnp.sum((is_cmd & (ll_vals == (1 << lit_bits) - 1))
                             .astype(jnp.int32), axis=1)
            bad = bad | (actual != n_ll_ovf.astype(jnp.int32)).astype(
                jnp.int32)
        if n_miss is not None:
            actual = jnp.sum((is_run & (lut == 0)).astype(jnp.int32), axis=1)
            bad = bad | (actual != n_miss.astype(jnp.int32)).astype(jnp.int32)
    with jax.named_scope("hrt1_resolve"):
        count, lit_len, sym = _resolve_deep(
            cnt_vals, cov_vals, ll_vals, lov_vals, lut, miss_raw, dict7,
            n_cmds, cnt_bits=cnt_bits if cnt_ovf_bits else 0,
            lit_bits=lit_bits if ll_ovf_bits else 0, min_count=min_count)
    out = device.expand(sym, count, lit_len, lits, n_cmds, block_len,
                        block_size=block_size)
    return out, bad


SECTION_KEYS = ("cnts_raw", "lls_raw", "syms", "lits", "cnt_ovf_raw",
                "ll_ovf_raw", "lut_raw", "miss_raw", "dict7",
                "n_cmds", "n_lits", "block_len",
                "n_cnt_ovf", "n_ll_ovf", "n_miss")


def dispatch_packed(pk: dict, arrs: dict):
    """Run the right device decode for a pack_for_device dict whose array
    members (``SECTION_KEYS`` subset) are already on the device in
    ``arrs``.  Returns ``(out, bad)`` without a host fetch: ``out`` is the
    [nb, B] decoded plane and ``bad`` the deep layout's per-block
    sub-header-mismatch flags (None for flat containers, which carry no
    redundant counts to validate)."""
    if pk["info"].deep:
        return decode_deep_device(
            arrs["cnts_raw"], arrs["cnt_ovf_raw"],
            arrs["lls_raw"], arrs["ll_ovf_raw"],
            arrs["lut_raw"], arrs["miss_raw"], arrs["dict7"], arrs["lits"],
            arrs["n_cmds"], arrs["n_lits"], arrs["block_len"],
            arrs.get("n_cnt_ovf"), arrs.get("n_ll_ovf"), arrs.get("n_miss"),
            cnt_bits=pk["cnt_bits"], lit_bits=pk["lit_bits"],
            cnt_ovf_bits=pk["cnt_ovf_bits"], ll_ovf_bits=pk["ll_ovf_bits"],
            capacity=pk["capacity"], block_size=pk["info"].block_size,
            min_count=pk["info"].min_count)
    out = decode_payload_device(
        arrs["cnts_raw"], arrs["lls_raw"], arrs["syms"], arrs["lits"],
        arrs["n_cmds"], arrs["n_lits"], arrs["block_len"],
        cnt_bits=pk["cnt_bits"], lit_bits=pk["lit_bits"],
        capacity=pk["capacity"], block_size=pk["info"].block_size,
        min_count=pk["info"].min_count)
    return out, None


def decode_packed(pk: dict) -> np.ndarray:
    """Convenience host wrapper: pack_for_device dict -> [nb, B] bytes.

    Raises ContainerError when the deep sub-header counts disagree with
    the actual escape population (hostile input)."""
    from ..parallel import container
    out, bad = dispatch_packed(pk, ship_packed(pk))
    if bad is not None and bool(jnp.any(bad != 0)):
        raise container.ContainerError(
            "deep block: sub-header escape/miss counts disagree with the "
            "escape population")
    return np.asarray(out)


# ---------------------------------------------------------------------------
# shipping: all payload sections in two concatenated host buffers (uint8
# sections; int32 sections), so a decompress pays two device_puts instead
# of one per section
# ---------------------------------------------------------------------------

def build_ship_buffers(pk: dict):
    """pack_for_device dict -> (u8_buf, i32_buf, manifest).

    ``manifest`` is a hashable tuple of (key, kind, nb, width, offset)
    where kind 0 = uint8 section in u8_buf, 1 = int32 section in i32_buf;
    offsets are in elements of the owning buffer."""
    u8_parts, i32_parts, manifest = [], [], []
    u8_off = i32_off = 0
    for k in SECTION_KEYS:
        if k not in pk:
            continue
        a = pk[k]
        if a.ndim == 1:
            a = a.reshape(1, -1)
        nb, w = a.shape
        if a.dtype == np.uint8:
            u8_parts.append(np.ascontiguousarray(a).reshape(-1))
            manifest.append((k, 0, nb, w, u8_off))
            u8_off += nb * w
        else:
            i32_parts.append(np.ascontiguousarray(a.astype(np.int32,
                                                           copy=False))
                             .reshape(-1))
            manifest.append((k, 1, nb, w, i32_off))
            i32_off += nb * w
    u8 = (np.concatenate(u8_parts) if u8_parts
          else np.zeros(128, np.uint8))
    i32 = (np.concatenate(i32_parts) if i32_parts
           else np.zeros(128, np.int32))
    return u8, i32, tuple(manifest)


@functools.partial(jax.jit, static_argnames=("manifest",))
def _slice_sections(u8_buf, i32_buf, *, manifest):
    out = {}
    for k, kind, nb, w, off in manifest:
        src = i32_buf if kind else u8_buf
        sec = jax.lax.slice(src, (off,), (off + nb * w,)).reshape(nb, w)
        out[k] = sec[0] if k in ("n_cmds", "n_lits", "block_len",
                                 "n_cnt_ovf", "n_ll_ovf", "n_miss") else sec
    return out


def ship_packed(pk: dict) -> dict:
    """Host pack dict -> device section arrays via two device_puts + one
    on-device slicing jit (static offsets)."""
    u8, i32, manifest = build_ship_buffers(pk)
    return _slice_sections(jax.device_put(u8), jax.device_put(i32),
                           manifest=manifest)
