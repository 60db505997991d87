#!/usr/bin/env python3
"""Benchmark harness: one JSON line on stdout with the headline metric.

    python bench.py [--mib 256] [--quick]

Runs on one GPU in this process and fails (exit code 1) when JAX's
default device is not a GPU.  The device, the card's name and its power
limit are printed on stderr and carried in the JSON line.

Headline: 8-bit RLE decode throughput, HRT1 payload sections in device
memory -> decoded bytes in device memory, in one jit: on-device
bit-unpack of the command columns, deep-layout resolve and expand
(ops/unpack_device.py).  The device reads O(compressed) input only, like
the reference decoder that touches only compressed bytes
(rle8_extreme_cpu.h:1825-1913) and its OpenCL path that uploads the
payload only (rle8_ocl.c:335-348).
Baseline: the reference's published single-thread x86 number on
video_frame.raw (25,830.4 MiB/s decode, README.md:28 => 27.086 GB/s).

Also reported in the same JSON object (and as stderr lines):
  copy_gbps            a large device copy, read + write bytes per second
  expand_gbps          planar columns in device memory -> bytes (expand only)
  expand_xla_gbps      the same with the XLA byte stage instead of the
                       Triton kernel
  decode_e2e_gbps      api.decompress: host blob -> host bytes
  decode_flat_gbps     device decode of the flat layout
  decode_<row>_gbps    device decode of the random / bwt / sh corpus rows,
                       each at the headline size (--mib)
  decode_w64_gbps      64 Bit Packed (Byte): device decode + re-interleave
  ref_ingest_gbps      reference-format 8-bit stream -> bytes (host walk +
                       device expand), end to end
  encode_device_gbps   device.encode_blocks: bytes (device) -> commands
  encode_host_gbps     C++ host encoder (bytes -> planar)
  ratio, ratio_<row>   HRT1 compressed size over input size

Every time is the median of warm calls ended by ``block_until_ready``;
compilation happens in an untimed first call.  The dataset is synthesized
to match the reference dataset's statistics (quantized video-frame DCTs);
the real file is not redistributable.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
import time

import numpy as np

BASELINE_DECODE_GBPS = 27.086   # 25830.4 MiB/s, README.md:28
BASELINE_ENCODE_GBPS = 3.481    # 3319.6 MiB/s, README.md:28


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def make_dataset(mib: int, seed: int = 42) -> np.ndarray:
    """DCT-like 64-byte blocks: a short nonzero coefficient prefix, zeros
    after; a few dense "detail" blocks.  Calibrated so the 8-bit reference
    codec lands at ~19.3% -- the ratio it achieves on the real file."""
    n = mib << 20
    rng = np.random.default_rng(seed)
    nblk = n // 64
    k = np.minimum(rng.geometric(1.0 / 7.0, nblk), 40)
    dense = rng.random(nblk) < 0.055
    k = np.where(dense, rng.integers(40, 64, nblk), k)
    vals = rng.integers(-9, 10, (nblk, 64)).astype(np.int8).astype(np.uint8)
    mask = np.arange(64)[None, :] < k[:, None]
    return np.where(mask, vals, 0).astype(np.uint8).reshape(-1)


def make_bwt_dataset(mib: int, seed: int = 7) -> np.ndarray:
    """enwik-bwt-like row: BWT output is bursty — Zipf-length runs of
    skewed symbols broken by literal stretches.  Calibrated so the 8-bit
    codec lands near the reference's 48.8% on enwik9.bwt (README.md:115)."""
    n = mib << 20
    rng = np.random.default_rng(seed)
    m = n // 4
    lens = np.minimum(rng.zipf(1.7, m), 1000).astype(np.int64)
    lit = rng.random(m) < 0.65
    lens = np.where(lit, np.minimum(lens, 80), lens)
    syms = rng.integers(0, 256, m).astype(np.uint8)
    out = np.repeat(syms, lens)[:n]
    litmask = np.repeat(lit, lens)[:n]
    noise = rng.integers(0, 256, n, dtype=np.uint8)
    return np.where(litmask, noise, out).astype(np.uint8)


def make_sh_dataset(mib: int, seed: int = 21) -> np.ndarray:
    """Recency-regime row: long zero runs + literals drawn from a rolling
    3-symbol recency process -- the regime where the reference's SH coder
    posts its best real-file ratio (12.51% vs 19.34% base, README.md:59,
    rle_sh.c:98-267).  HRT1's per-block literal dictionary wins when the
    literal distribution is skewed per block but cannot follow a rolling
    recency chain; this row prices that concession.  The sequence is made
    by a Python loop, so above 16 MiB it repeats with a 16 MiB period (a
    whole number of blocks: no block sees the repeat)."""
    if mib > 16:
        return np.tile(make_sh_dataset(16, seed), -(-mib // 16))[:mib << 20]
    n = mib << 20
    rng = np.random.default_rng(seed)
    out = np.zeros(n, np.uint8)
    pos = 0
    recent = [1, 2, 3]
    while pos < n:
        pos += int(rng.geometric(1 / 24.0))
        lit = min(int(rng.geometric(1 / 6.0)), 40)
        for i in range(lit):
            if pos + i >= n:
                break
            r = rng.random()
            if r < 0.55:
                v = recent[0]
            elif r < 0.75:
                v = recent[1]
            elif r < 0.85:
                v = recent[2]
            else:
                v = int(rng.integers(1, 256))
            if v != recent[0]:
                recent = [v, recent[0], recent[1]]
            out[pos + i] = v
        pos += lit
    return out


def make_random_dataset(mib: int, seed: int = 9) -> np.ndarray:
    """Incompressible control row (the memcpy-adjacent worst case)."""
    return np.random.default_rng(seed).integers(
        0, 256, mib << 20, dtype=np.uint8)


def card_info() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip()


def device_info() -> dict:
    """Platform, kind and count of JAX's devices; exits the process with
    code 1 when the default device is not a GPU (no CPU numbers are ever
    reported under a device metric)."""
    import jax
    d0 = jax.devices()[0]
    info = dict(platform=d0.platform, kind=d0.device_kind,
                count=len(jax.devices()))
    if d0.platform != "gpu":
        log(f"no GPU: JAX's default device is {info}")
        sys.exit(1)
    return info


def timed(fn, reps: int) -> float:
    """Median wall seconds of ``reps`` warm calls of ``fn`` (which returns
    device arrays), each ended by block_until_ready."""
    import jax
    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def wall(fn, reps: int) -> float:
    """Median wall seconds of ``reps`` calls of a host-returning ``fn``
    after one warm-up call."""
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def copy_gbps(n: int, reps: int) -> float:
    """Read + write bytes per second of an elementwise pass over ``n``
    bytes already on the device -- the memory-bound yardstick."""
    import jax
    x = jax.device_put(np.zeros(n // 4, np.int32))
    f = jax.jit(lambda a: a + 1)
    return 2 * n / timed(lambda: f(x), reps) / 1e9


def decode_row(blob: bytes, data: np.ndarray, reps: int) -> float:
    """Device decode GB/s of one container: payload sections already on
    the device -> decoded stream on the device (bit-unpack, resolve,
    expand, re-interleave), checked byte-exact against ``data``."""
    import jax.numpy as jnp
    from hypersonic_rle_kit_tpu import api, spec
    from hypersonic_rle_kit_tpu.ops import unpack_device
    from hypersonic_rle_kit_tpu.parallel import container

    info, blocks = container.parse(blob)
    w = api.hrt1_params(spec.by_index(info.codec_index))[0]
    pk = container.pack_for_device(blob, parsed=(info, blocks))
    B = info.block_size
    pk["block_len"][-1] = -(-(data.size - (info.n_blocks - 1) * B) // w) * w
    arrs = unpack_device.ship_packed(pk)

    def run():
        y, _ = unpack_device.dispatch_packed(pk, arrs)
        return api._interleave_plane(y, w=w, n=data.size)
    if not bool(jnp.all(run() == jnp.asarray(data))):
        raise AssertionError("device decode is not byte-exact")
    return data.size / timed(run, reps) / 1e9


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mib", type=int, default=256)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    if args.quick:
        args.mib, args.reps = 32, 3

    from hypersonic_rle_kit_tpu.utils import jax_cache
    jax_cache.configure()
    dev = device_info()
    dev["card"] = card_info()
    log(f"device: {dev}")

    import jax
    import jax.numpy as jnp
    from hypersonic_rle_kit_tpu import api
    from hypersonic_rle_kit_tpu.formats import rle8 as rle8_fmt
    from hypersonic_rle_kit_tpu.ops import device, planar, ref_device
    from hypersonic_rle_kit_tpu.parallel import container
    from hypersonic_rle_kit_tpu.utils import native

    native.lib()           # build the native runtime outside timed regions
    data = make_dataset(args.mib)
    n = data.size
    r: dict = {}
    r["copy_gbps"] = copy_gbps(n, args.reps)
    log(f"device copy (read + write): {r['copy_gbps']:.1f} GB/s")

    # --- host encode (C++) + container ---
    B = container.DEFAULT_BLOCK_SIZE
    x = data.reshape(-1, B)
    lens = np.full(x.shape[0], B, np.int32)
    cap = planar.capacity_for(B, 6)
    t0 = time.perf_counter()
    cols = native.planar_from_bytes(x, lens, cap)
    r["encode_host_gbps"] = n / (time.perf_counter() - t0) / 1e9
    blob = api.compress(data, "8 Bit")
    r["ratio"] = len(blob) / n
    log(f"host planar encode (C++): {r['encode_host_gbps']:.2f} GB/s; "
        f"HRT1 ratio {100 * r['ratio']:.2f}% (reference 8-bit on the real "
        f"video_frame.raw: 19.34%)")

    # --- headline: device decode of the default (deep + litdict) layout ---
    r["gbps"] = decode_row(blob, data, args.reps)
    log(f"device decode (payload -> bytes): {r['gbps']:.2f} GB/s "
        f"(reference x86: {BASELINE_DECODE_GBPS} GB/s)")

    # --- expand alone: planar columns on the device -> bytes ---
    _, pc = container.deserialize_to_planar(blob)
    lmax = max(128, -(-int(pc[5].max()) // 128) * 128)
    dc = [jax.device_put(a) for a in
          (pc[0], pc[1], pc[2], pc[3][:, :lmax], pc[4], pc[6])]
    r["expand_gbps"] = n / timed(
        lambda: device.expand(*dc, block_size=B), args.reps) / 1e9
    # the XLA formulation of the byte stage on the same card, for comparison
    tables = device.expand_tables(dc[0], dc[1], dc[2], dc[4])
    xla_bytes = jax.jit(functools.partial(device.expand_bytes, block_size=B))
    r["expand_xla_gbps"] = n / timed(
        lambda: xla_bytes(*tables, dc[0], dc[3], dc[4], dc[5]),
        args.reps) / 1e9
    log(f"expand only: {r['expand_gbps']:.2f} GB/s (Triton byte stage); "
        f"XLA byte stage {r['expand_xla_gbps']:.2f} GB/s")

    # --- end to end: host blob -> host bytes ---
    assert api.decompress(blob) == data.tobytes()
    r["decode_e2e_gbps"] = n / wall(lambda: api.decompress(blob),
                                    max(3, args.reps // 2)) / 1e9
    log(f"api.decompress end to end: {r['decode_e2e_gbps']:.2f} GB/s")

    blob_f = container.serialize_blocks(0, n, B, 6, *cols, deep=False)
    r["ratio_flat"] = len(blob_f) / n
    r["decode_flat_gbps"] = decode_row(blob_f, data, args.reps)
    log(f"flat layout: {r['decode_flat_gbps']:.2f} GB/s "
        f"(ratio {100 * r['ratio_flat']:.2f}%)")

    for tag, maker in (("random", make_random_dataset),
                       ("bwt", make_bwt_dataset), ("sh", make_sh_dataset)):
        d2 = maker(args.mib)
        b2 = api.compress(d2, "8 Bit")
        r[f"ratio_{tag}"] = len(b2) / d2.size
        r[f"decode_{tag}_gbps"] = decode_row(b2, d2, args.reps)
        log(f"[{tag}] ratio {100 * r[f'ratio_{tag}']:.1f}%  decode "
            f"{r[f'decode_{tag}_gbps']:.2f} GB/s")

    blob_w = api.compress(data, "64 Bit Packed (Byte)")
    r["ratio_w64"] = len(blob_w) / n
    r["decode_w64_gbps"] = decode_row(blob_w, data, args.reps)
    log(f"[64 Bit Packed (Byte)] ratio {100 * r['ratio_w64']:.1f}%  decode "
        f"+ re-interleave {r['decode_w64_gbps']:.2f} GB/s")

    # --- reference-stream ingest: C-format blob -> bytes, end to end ---
    rn = min(n, 32 << 20)
    rblob = rle8_fmt.rle8_compress(data[:rn].tobytes())
    assert ref_device.decompress_ref_device(rblob, "8 Bit") == \
        data[:rn].tobytes()
    r["ref_ingest_gbps"] = rn / wall(
        lambda: ref_device.decompress_ref_device(rblob, "8 Bit"),
        max(3, args.reps // 2)) / 1e9
    log(f"[ref-stream] {r['ref_ingest_gbps']:.2f} GB/s end to end")

    # --- device encode: bytes on the device -> planar commands ---
    ne = min(n, 64 << 20) // B
    xe = jax.device_put(x[:ne])
    le = jax.device_put(lens[:ne])
    pb = device.encode_blocks(xe, le, capacity=cap, min_count=6)
    for i, col in enumerate((pb.sym, pb.count, pb.lit_len, pb.lits,
                             pb.n_cmds, pb.n_lits)):
        assert np.array_equal(np.asarray(col), cols[i][:ne]), i
    r["encode_device_gbps"] = ne * B / timed(
        lambda: device.encode_blocks(xe, le, capacity=cap, min_count=6),
        args.reps) / 1e9
    log(f"device encode (bytes -> commands): {r['encode_device_gbps']:.2f} "
        f"GB/s (reference x86: {BASELINE_ENCODE_GBPS} GB/s)")
    r["peak_bytes_in_use"] = jax.devices()[0].memory_stats().get(
        "peak_bytes_in_use")

    out = {"metric": "rle8_device_decode_compressed_input",
           "value": round(r.pop("gbps"), 3), "unit": "GB/s",
           "vs_baseline": None, "device": dev, "mib": args.mib}
    out["vs_baseline"] = round(out["value"] / BASELINE_DECODE_GBPS, 4)
    for k, v in r.items():
        out[k] = round(v, 4) if isinstance(v, float) else v
    print(json.dumps(out))


if __name__ == "__main__":
    main()
