"""Reference-format streams decoded on the device (ops/ref_device.py).

Streams are produced by the byte-exact host encoders (pinned to the C
reference by the parity suites), then decoded through the planar device
path; outputs must equal the host format decoders byte for byte.  This is
the device analog of routing reference artifacts through the OpenCL decoder
(rle8_ocl.c:265-413) generalized to the whole RLE codec space
(rleX_extreme_cpu_decode.h:27-164).
"""

import numpy as np
import pytest

from hypersonic_rle_kit_tpu.formats import registry
from hypersonic_rle_kit_tpu.ops import ref_device

CODECS = [
    "8 Bit", "8 Bit Packed", "8 Bit Single", "8 Bit Single Packed",
    "8 Bit 3LUT", "8 Bit 7LUT", "8 Bit Short", "8 Bit 3LUT Short",
    "8 Bit Single Short",
    "16 Bit (Symbol)", "16 Bit (Byte)", "16 Bit Packed (Symbol)",
    "24 Bit (Symbol)", "32 Bit (Byte)", "48 Bit Packed (Byte)",
    "64 Bit (Symbol)", "64 Bit 3LUT (Symbol)", "64 Bit 7LUT Short (Byte)",
    "128 Bit (Symbol)", "128 Bit Packed (Byte)",
    "32 Bit 1LUT Short (Symbol)", "16 Bit 3LUT (Byte)",
]


def _datasets():
    rng = np.random.default_rng(11)
    runs = np.repeat(rng.integers(0, 6, 700).astype(np.uint8),
                     rng.integers(1, 80, 700))
    mixed = rng.integers(0, 255, 40_000, dtype=np.uint8)
    mixed[rng.random(40_000) < 0.7] = 42
    periodic = np.tile(np.frombuffer(b"ABCDEFGH", np.uint8), 5_000).copy()
    periodic[rng.random(40_000) < 0.02] = 250
    tiny = np.frombuffer(b"xyzzyxyzzy", np.uint8)
    allsame = np.full(9_000, 7, np.uint8)
    return {"runs": runs, "mixed": mixed, "periodic": periodic,
            "tiny": tiny, "allsame": allsame}


DATA = _datasets()


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("ds", sorted(DATA))
def test_ref_stream_device_roundtrip(codec, ds):
    data = DATA[ds].tobytes()
    blob = registry.compress(data, codec)
    if not blob:
        pytest.skip("encoder declined input")
    want = registry.decompress(blob, codec)
    assert want == data
    got = ref_device.decompress_ref_device(
        blob, codec, block_size=4096)
    assert got == want


def test_large_block_spanning_runs():
    """Runs and literal ranges crossing block boundaries split correctly."""
    rng = np.random.default_rng(3)
    parts = []
    for _ in range(30):
        parts.append(np.full(rng.integers(1, 9000), rng.integers(0, 256),
                             np.uint8))
        parts.append(rng.integers(0, 256, rng.integers(1, 3000),
                     dtype=np.uint8))
    data = np.concatenate(parts).tobytes()
    blob = registry.compress(data, "8 Bit")
    got = ref_device.decompress_ref_device(
        blob, "8 Bit", block_size=2048)
    assert got == data


def test_empty_stream():
    assert ref_device.decompress_ref_device(
        b"\x00" * 16, "16 Bit (Symbol)") == b""
