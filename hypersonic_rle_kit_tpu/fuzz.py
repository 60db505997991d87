"""Structured round-trip fuzzer — the analog of `rle_fuzz.c`.

Inputs are concatenations of sections (random bytes | repeated symbol of
1..16 bytes), with section lengths swept across every codec's header-format
boundary values (escape thresholds around 256 and 2^16, rle_fuzz.c:30-44).

Two modes (rle_fuzz.c:533+):
- iterative: deterministic sweep over section lengths, order, symbol
  alignment and symbol length (the odometer at rle_fuzz.c:266-283);
- random:   seeded RNG draws.

Adversarial details kept from the reference:
- the compressed buffer is scrambled past the claimed compressed size before
  decoding, to catch decoders that read past their input (rle_fuzz.c:629-636);
- the input buffer is checksummed around the encoder call to catch encoders
  writing into their input (INPUT_BUFFER_VALIDATE, rle_fuzz.c:605-612);
- failures persist the offending input to ``fuzz-failure.bin``
  (rle_fuzz.c:582-585).

Usage:  python -m hypersonic_rle_kit_tpu.fuzz [--iterative|--random]
        [--iterations N] [--sections N] [--codec NAME ...] [--device]
"""

from __future__ import annotations

import argparse
import hashlib
import itertools
import sys

import numpy as np

from . import spec as spec_mod
from .formats import registry

BOUNDARY_LENGTHS = (
    [1, 2, 3, 5, 7, 13, 30, 31, 32, 33, 125, 126, 127, 128, 129, 254, 255,
     256, 257, 280, 767, 768, 8191, 8192]
    + [65527, 65528, 65535, 65536, 65544, 65560]
)


def _section(rng: np.random.Generator, length: int, kind: str,
             sym_len: int) -> np.ndarray:
    if kind == "random":
        return rng.integers(0, 256, length, dtype=np.uint8)
    sym = rng.integers(0, 256, sym_len, dtype=np.uint8)
    reps = length // sym_len + 2
    return np.tile(sym, reps)[:length]


def iterative_inputs(sections: int, seed: int = 1):
    """Deterministic odometer over (length-set, kinds, symbol length)."""
    rng = np.random.default_rng(seed)
    length_sets = [BOUNDARY_LENGTHS[i::7] for i in range(7)]
    for sym_len in (1, 2, 3, 4, 7, 8, 12, 16):
        for lengths in length_sets:
            for kinds in itertools.islice(
                    itertools.product(("random", "repeat"), repeat=sections),
                    0, None, max(1, 2 ** sections // 8)):
                parts = [
                    _section(rng, lengths[i % len(lengths)], kinds[i], sym_len)
                    for i in range(sections)
                ]
                yield np.concatenate(parts).tobytes()


def random_inputs(sections: int, iterations: int, seed: int = 0xF00D):
    rng = np.random.default_rng(seed)
    for _ in range(iterations):
        parts = []
        for _ in range(sections):
            length = int(rng.choice(BOUNDARY_LENGTHS))
            kind = "random" if rng.random() < 0.5 else "repeat"
            parts.append(_section(rng, length, kind,
                                  int(rng.integers(1, 17))))
        yield np.concatenate(parts).tobytes()


def fuzz_one(data: bytes, s: spec_mod.CodecSpec,
             scramble_seed: int = 7) -> str | None:
    """Round-trip one input through one codec; returns an error string or
    None.  Includes the buffer-scramble and input-validation traps."""
    in_digest = hashlib.sha256(data).digest()
    comp = registry.compress(data, s)
    if hashlib.sha256(data).digest() != in_digest:
        return "encoder corrupted its input buffer"
    if not comp and data:
        return "compress returned empty"
    # poison the buffer slack past the claimed compressed size (the
    # reference scrambles its allocation's tail, rle_fuzz.c:629-636; here
    # the decoder receives a longer buffer whose bytes past the claimed
    # size are random -- the same out-of-bounds-read trap, with a swept
    # slack length so off-by-small reads hit poison immediately).  Pure
    # transforms carry no header and are decoded with an exact size
    # argument, so they are excluded, as in the reference harness.
    if s.is_transform:
        poisoned = comp
    else:
        rng = np.random.default_rng(scramble_seed)
        slack = int(rng.integers(1, 129))
        poisoned = comp + rng.integers(0, 256, slack,
                                       dtype=np.uint8).tobytes()
    dec = registry.decompress(poisoned, s)
    if dec != data:
        return f"round-trip mismatch ({len(dec)} vs {len(data)} bytes)"
    return None


# default device-fuzz codec subset: one per HRT1 parameter family
# (width x threshold x single), see api.hrt1_params
DEVICE_FUZZ_CODECS = (
    "8 Bit", "8 Bit Packed", "8 Bit Single", "8 Bit 3LUT Short",
    "16 Bit (Symbol)", "24 Bit (Byte)", "32 Bit Packed (Byte)",
    "48 Bit (Symbol)", "64 Bit 3LUT Short Grdy (Byte)",
    "128 Bit (Symbol)",
)


def fuzz_device_one(data: bytes, s: spec_mod.CodecSpec,
                    rng: np.random.Generator) -> str | None:
    """Round-trip one input through the HRT1 device pipeline, then mutate
    the container and require a typed error or a clean (possibly wrong)
    decode -- never an unhandled crash.  This is the device-path analog of
    the reference's buffer-scramble trap (rle_fuzz.c:629-636) on top of the
    container validation (rle8_extreme_cpu.h:707-712)."""
    from . import api
    from .parallel import container

    blob = api.compress(data, s)
    dec = api.decompress(blob, backend="device")
    if dec != data:
        return f"device round-trip mismatch ({len(dec)} vs {len(data)})"
    for _ in range(4):
        m = bytearray(blob)
        for _ in range(int(rng.integers(1, 9))):
            m[int(rng.integers(len(m)))] ^= 1 << int(rng.integers(8))
        try:
            api.decompress(bytes(m), backend="device")
        except container.ContainerError:
            pass              # typed rejection is the desired outcome
        except Exception as e:  # noqa: BLE001 - the trap itself
            return (f"mutated container escaped validation with "
                    f"{type(e).__name__}: {e}")
    # truncations must always be rejected
    for cut in (1, len(blob) // 2, len(blob) - 1):
        try:
            api.decompress(blob[:cut], backend="device")
            return f"truncated container (len {cut}) accepted"
        except container.ContainerError:
            pass
        except Exception as e:  # noqa: BLE001
            return f"truncated container raised {type(e).__name__}: {e}"
    return None


def run_device(inputs, specs, max_failures: int = 1, log=print,
               seed: int = 0xD0D0) -> int:
    rng = np.random.default_rng(seed)
    failures = 0
    for n, data in enumerate(inputs):
        for s in specs:
            err = fuzz_device_one(data, s, rng)
            if err:
                failures += 1
                with open("fuzz-failure.bin", "wb") as f:
                    f.write(data)
                log(f"DEVICE FAILURE [{s.name}] len={len(data)}: {err} "
                    f"(input saved to fuzz-failure.bin)")
                if failures >= max_failures:
                    return failures
        if (n + 1) % 5 == 0:
            log(f"  {n + 1} inputs x {len(specs)} codecs clean (device)")
    return failures


def run(inputs, specs, max_failures: int = 1, log=print) -> int:
    failures = 0
    for n, data in enumerate(inputs):
        for s in specs:
            err = fuzz_one(data, s)
            if err:
                failures += 1
                with open("fuzz-failure.bin", "wb") as f:
                    f.write(data)
                log(f"FAILURE [{s.name}] len={len(data)}: {err} "
                    f"(input saved to fuzz-failure.bin)")
                if failures >= max_failures:
                    return failures
        if (n + 1) % 10 == 0:
            log(f"  {n + 1} inputs x {len(specs)} codecs clean")
    return failures


def main(argv=None):
    ap = argparse.ArgumentParser(prog="hsrlekit-fuzz")
    ap.add_argument("--iterative", action="store_true")
    ap.add_argument("--random", action="store_true")
    ap.add_argument("--iterations", type=int, default=50)
    ap.add_argument("--sections", type=int, default=6)
    ap.add_argument("--codec", action="append", default=None)
    ap.add_argument("--skip-slow", action="store_true",
                    help="skip MMTF/greedy codecs (slow host paths)")
    ap.add_argument("--device", action="store_true",
                    help="fuzz the HRT1 device pipeline (compress ->"
                         " device decode, container mutation, truncation)")
    args = ap.parse_args(argv)

    if args.device:
        # the device pipeline runs on the default JAX backend; every input
        # shape compiles, so cache compilations across runs
        from .utils import jax_cache
        jax_cache.configure()
        specs = [spec_mod.by_name(n) for n in DEVICE_FUZZ_CODECS]
        if args.codec:
            specs = [s for s in spec_mod.REGISTRY if s.name in args.codec]
        if args.iterative:
            inputs = itertools.islice(
                iterative_inputs(args.sections), args.iterations)
        else:
            inputs = random_inputs(args.sections, args.iterations)
        failures = run_device(inputs, specs)
        print("fuzz (device):", "FAILED" if failures else "clean")
        return 1 if failures else 0

    specs = [s for s in spec_mod.REGISTRY
             if s.family is not spec_mod.Family.MEMCPY]
    if args.codec:
        specs = [s for s in specs if s.name in args.codec]
    if args.skip_slow:
        specs = [s for s in specs
                 if s.family not in (spec_mod.Family.MMTF,
                                     spec_mod.Family.RLE8_MMTF)
                 and not s.greedy]

    if args.iterative:
        inputs = itertools.islice(
            iterative_inputs(args.sections), args.iterations)
    else:
        inputs = random_inputs(args.sections, args.iterations)

    failures = run(inputs, specs)
    print("fuzz:", "FAILED" if failures else "clean")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
