#!/usr/bin/env python3
"""Smoke test of the HRT1 main path on one NVIDIA GPU.

    python chip_smoke.py          # one card: every phase below
    python chip_smoke.py --four   # four cards: the sharded path only

Phases (one card):
  0. the GPU test lane (``pytest -m gpu tests/``) in a child process,
     before this process touches the card;
  1. the device: JAX's platform, kind and count, the card's name and power
     limit;
  2. decode through ``api.decompress`` at 256 MiB of the bench's DCT corpus,
     byte-exact: the default deep + literal-dictionary layout, the flat
     layout, 64 Bit Packed (Byte), 24 Bit (Symbol), and a 32 MiB
     reference-format 8-bit stream through ``ref_device``;
  3. device encode (``api.compress(backend="device")``) equal to the native
     encoder's bytes at 64 MiB;
  4. numbers, on earlier lines of stdout: warm decode GB/s end to end and
     of the expand alone, a large device copy's GB/s, compile seconds, and
     the device's peak bytes in use.
With ``--four``: ``dist.compress_distributed`` and ``dist.pipeline_step`` on
a 4-GPU mesh, compared byte for byte with single-device ``api.compress``.

The last line of stdout is one JSON object with the device; it is printed
only when every phase passed.  Without a GPU, or run outside a checkout of
the repository, the script exits non-zero before printing it.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
MIB = 1 << 20


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(*a) -> None:
    print(*a, flush=True)


def gpu_tests() -> None:
    """Phase 0: the gpu-marked tests, in a child that holds the card and
    exits before this process imports JAX."""
    env = dict(os.environ, HSRK_GPU_LANE="1")
    t0 = time.perf_counter()
    rc = subprocess.run([sys.executable, "-m", "pytest", "-q", "-m", "gpu",
                         "-p", "no:cacheprovider", "tests/"],
                        cwd=ROOT, env=env).returncode
    say(f"phase 0: pytest -m gpu: rc={rc} "
        f"({time.perf_counter() - t0:.1f} s)")
    if rc != 0:
        fail(f"GPU tests failed (pytest rc={rc})")


def device(n_expected: int) -> dict:
    """Phase 1: JAX's devices; exits non-zero without n_expected GPUs."""
    import bench
    info = bench.device_info()
    say(f"phase 1: device {info}")
    if info["count"] < n_expected:
        fail(f"{info['count']} GPU(s), {n_expected} needed")
    return info


def check(name: str, got: bytes, want: bytes) -> None:
    if got != want:
        fail(f"{name}: decoded bytes differ from the input")
    say(f"  {name}: byte-exact ({len(want)} bytes)")


def single() -> dict:
    import jax
    import numpy as np
    import bench
    from hypersonic_rle_kit_tpu import api
    from hypersonic_rle_kit_tpu.formats import rle8 as rle8_fmt
    from hypersonic_rle_kit_tpu.ops import device as device_ops
    from hypersonic_rle_kit_tpu.ops import planar, ref_device
    from hypersonic_rle_kit_tpu.parallel import container
    from hypersonic_rle_kit_tpu.utils import native

    info = device(1)
    if native.lib() is None:
        fail("the native host runtime did not build")
    cache = jax.config.jax_compilation_cache_dir
    cached = len(os.listdir(cache)) if os.path.isdir(cache) else 0

    say("phase 2: decode main path at 256 MiB")
    data = bench.make_dataset(256)
    raw = data.tobytes()
    blob = api.compress(data, "8 Bit")
    binfo = container.parse(blob)[0]
    if not (binfo.deep and binfo.litdict):
        fail("the 8-bit DCT container is not deep + litdict")
    t0 = time.perf_counter()
    got = api.decompress(blob)
    first_s = time.perf_counter() - t0
    check("8 Bit, deep + litdict", got, raw)
    warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        got = api.decompress(blob)
        warm.append(time.perf_counter() - t0)
    check("8 Bit, deep + litdict (warm)", got, raw)
    e2e_s = float(np.median(warm))

    B = container.DEFAULT_BLOCK_SIZE
    cap = planar.capacity_for(B, 6)
    x = data.reshape(-1, B)
    lens = np.full(x.shape[0], B, np.int32)
    cols = native.planar_from_bytes(x, lens, cap)
    blob_f = container.serialize_blocks(0, data.size, B, 6, *cols,
                                        deep=False)
    if container.parse(blob_f)[0].deep:
        fail("flat container came out deep")
    check("8 Bit, flat", api.decompress(blob_f), raw)
    for codec in ("64 Bit Packed (Byte)", "24 Bit (Symbol)"):
        check(codec, api.decompress(api.compress(data, codec)), raw)
    rraw = raw[:32 * MIB]
    check("reference 8-bit stream via ref_device",
          ref_device.decompress_ref_device(rle8_fmt.rle8_compress(rraw),
                                           "8 Bit"), rraw)

    say("phase 3: device encode at 64 MiB")
    enc = data[:64 * MIB]
    dev_blob = api.compress(enc, "8 Bit", backend="device")
    if dev_blob != api.compress(enc, "8 Bit", backend="native"):
        fail("device encode differs from the native encoder")
    say(f"  device encode == native encode ({len(dev_blob)} bytes)")

    say("phase 4: numbers")
    n = data.size
    _, pc = container.deserialize_to_planar(blob)
    lmax = max(128, -(-int(pc[5].max()) // 128) * 128)
    dc = [jax.device_put(a) for a in
          (pc[0], pc[1], pc[2], pc[3][:, :lmax], pc[4], pc[6])]
    expand_s = bench.timed(lambda: device_ops.expand(*dc, block_size=B), 10)
    copy = bench.copy_gbps(n, 10)
    stats = jax.devices()[0].memory_stats() or {}
    say(f"  api.decompress end to end, warm: {n / e2e_s / 1e9:.3f} GB/s "
        f"({e2e_s * 1e3:.1f} ms for {n // MIB} MiB)")
    say(f"  expand alone, warm: {n / expand_s / 1e9:.2f} GB/s "
        f"({expand_s * 1e3:.3f} ms)")
    say(f"  device copy (read + write): {copy:.1f} GB/s")
    say(f"  first api.decompress: {first_s:.2f} s, tracing and compiling "
        f"or loading from the compile cache ({cache}: {cached} entries "
        f"before phase 2)")
    say(f"  peak_bytes_in_use: {stats.get('peak_bytes_in_use')}")
    return info


def four() -> dict:
    import jax.numpy as jnp
    import numpy as np
    import bench
    from hypersonic_rle_kit_tpu import api
    from hypersonic_rle_kit_tpu.ops import planar
    from hypersonic_rle_kit_tpu.parallel import dist

    info = device(4)
    mesh = dist.make_mesh(4)
    say(f"phase 2: sharded path on a {mesh.devices.size}-GPU mesh")
    B = 1 << 16
    data = bench.make_dataset(64)
    t0 = time.perf_counter()
    blob = dist.compress_distributed(data, mesh, block_size=B)
    dist_s = time.perf_counter() - t0
    if blob != api.compress(data, "8 Bit", block_size=B):
        fail("compress_distributed bytes differ from api.compress")
    say(f"  compress_distributed == api.compress ({len(blob)} bytes, "
        f"{dist_s:.2f} s incl. compile)")
    check("api.decompress of the distributed container",
          api.decompress(blob), data.tobytes())

    x = data.reshape(-1, B)
    lens = np.full(x.shape[0], B, np.int32)
    cap = planar.capacity_for(B, 6)
    y, offsets, sizes = dist.pipeline_step(
        jnp.asarray(x), jnp.asarray(lens), capacity=cap, min_count=6,
        mesh=mesh)
    y, offsets, sizes = np.asarray(y), np.asarray(offsets), np.asarray(sizes)
    if not np.array_equal(y, x):
        fail("pipeline_step round trip differs from the input")
    if not np.array_equal(offsets, np.cumsum(sizes) - sizes):
        fail("pipeline_step offsets are not the prefix sum of the sizes")
    say(f"  pipeline_step round trip byte-exact over {x.shape[0]} blocks")
    return info


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-GPU sharded path")
    args = ap.parse_args()
    if not os.path.isdir(os.path.join(ROOT, "hypersonic_rle_kit_tpu")):
        fail("run from a checkout of the repository")
    if shutil.which("nvidia-smi") is None:
        fail("no nvidia-smi: no GPU on this machine")
    sys.path.insert(0, ROOT)
    import bench
    card = bench.card_info()
    if not args.four:
        gpu_tests()
    from hypersonic_rle_kit_tpu.utils import jax_cache
    jax_cache.configure()
    info = four() if args.four else single()
    say(card)
    say(json.dumps({"ok": True, "device": info}))


if __name__ == "__main__":
    main()
