#!/usr/bin/env python3
"""End-to-end A/B of the expand's byte stage on one GPU: ``api.decompress``
of the bench's DCT container (deep + literal dictionary) with the Pallas
Triton kernel that ships on CUDA (ops/expand_triton.py) against the XLA
formulation (ops/device.expand_bytes).

    python scripts/ab_expand.py [--mib 256] [--quads 32]
    python scripts/ab_expand.py --first {xla,triton} [--mib 256]

The A/B times ``--quads`` groups of four calls in the order XLA, Triton,
Triton, XLA, and pairs each call with its neighbour of the other kind.
The stage is switched by pointing the CUDA branch of ``device.expand`` at
the other function and clearing JAX's in-memory caches; an untimed call
follows every switch, so each timed call runs compiled code.  Printed:
each side's median and quartiles, the median paired difference, and how
many pairs the Triton stage won with the one-sided sign-test p-value.

``--first`` times the first ``api.decompress`` of this process with the
given stage (tracing and compilation included, or loading from the
compile cache where it holds the executables) and one warm call after it.
Run it once against an empty cache and once against a filled one to tell
compilation from cache loading.

Exits non-zero when JAX's default device is not a GPU.  The last line of
stdout is one JSON object with the numbers.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402

STAGES = ("xla", "triton")


def set_stage(stage: str) -> None:
    """Make the next trace of ``device.expand`` use ``stage`` on CUDA."""
    import jax
    from hypersonic_rle_kit_tpu.ops import device, expand_triton
    if not hasattr(set_stage, "triton"):
        set_stage.triton = expand_triton.expand_bytes
    expand_triton.expand_bytes = (device.expand_bytes if stage == "xla"
                                  else set_stage.triton)
    jax.clear_caches()


def quartiles(xs) -> list:
    return [float(v) for v in np.percentile(xs, [25, 50, 75])]


def sign_test_p(wins: int, n: int) -> float:
    """One-sided p-value of at least ``wins`` of ``n`` under a fair coin."""
    return sum(math.comb(n, k) for k in range(wins, n + 1)) / 2 ** n


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mib", type=int, default=256)
    ap.add_argument("--quads", type=int, default=32)
    ap.add_argument("--first", choices=STAGES)
    args = ap.parse_args()

    from hypersonic_rle_kit_tpu.utils import jax_cache
    jax_cache.configure()
    dev = bench.device_info()
    dev["card"] = bench.card_info()
    bench.log(f"device: {dev}")

    from hypersonic_rle_kit_tpu import api
    from hypersonic_rle_kit_tpu.utils import native
    native.lib()
    data = bench.make_dataset(args.mib)
    raw = data.tobytes()
    blob = api.compress(data, "8 Bit")
    out = {"device": dev, "mib": args.mib}

    def call() -> float:
        t0 = time.perf_counter()
        got = api.decompress(blob)
        dt = time.perf_counter() - t0
        if got != raw:
            raise AssertionError("decoded bytes differ from the input")
        return dt

    if args.first:
        set_stage(args.first)
        out.update(stage=args.first, first_s=call(), warm_s=call())
        bench.log(f"{args.first}: first api.decompress {out['first_s']:.3f} s,"
                  f" warm {out['warm_s']:.3f} s")
        print(json.dumps(out))
        return

    times = {s: [] for s in STAGES}
    diffs = []                  # XLA minus Triton, per adjacent pair
    switch_s = []
    for _ in range(args.quads):
        quad = []
        for stage in ("xla", "triton", "triton", "xla"):
            if not quad or quad[-1][0] != stage:
                t0 = time.perf_counter()
                set_stage(stage)
                call()
                switch_s.append(time.perf_counter() - t0)
            quad.append((stage, call()))
        for s, t in quad:
            times[s].append(t)
        diffs += [quad[0][1] - quad[1][1], quad[3][1] - quad[2][1]]
    set_stage("triton")

    wins = sum(d > 0 for d in diffs)
    out.update(
        quads=args.quads,
        **{f"{s}_ms_q25_q50_q75": [1e3 * v for v in quartiles(times[s])]
           for s in STAGES},
        pair_diff_ms_q25_q50_q75=[1e3 * v for v in quartiles(diffs)],
        triton_pair_wins=wins, pairs=len(diffs),
        sign_test_p=sign_test_p(wins, len(diffs)),
        switch_s_median=float(np.median(switch_s)),
        xla_ms=[1e3 * t for t in times["xla"]],
        triton_ms=[1e3 * t for t in times["triton"]])
    for s in STAGES:
        q = out[f"{s}_ms_q25_q50_q75"]
        bench.log(f"{s}: median {q[1]:.2f} ms, quartiles {q[0]:.2f}-{q[2]:.2f}")
    q = out["pair_diff_ms_q25_q50_q75"]
    bench.log(f"XLA - Triton per pair: median {q[1]:.2f} ms, quartiles "
              f"{q[0]:.2f}-{q[2]:.2f}; Triton won {wins}/{len(diffs)} "
              f"(sign test p = {out['sign_test_p']:.4g})")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
