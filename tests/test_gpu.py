"""GPU lane: the device path compiled for the card, at real widths.

Each test takes the ``gpu`` fixture (tests/conftest.py), which skips where
JAX has no GPU.  On a machine with a card:

    HSRK_GPU_LANE=1 python -m pytest -m gpu tests/
"""

import functools

import numpy as np
import pytest

import jax

from hypersonic_rle_kit_tpu import api
from hypersonic_rle_kit_tpu.ops import device, expand_triton, planar
from hypersonic_rle_kit_tpu.parallel import container

pytestmark = pytest.mark.gpu

B = container.DEFAULT_BLOCK_SIZE


def _dct(n, seed):
    rng = np.random.default_rng(seed)
    d = rng.integers(-4, 5, n).astype(np.int8).astype(np.uint8)
    d[rng.random(n) < 0.8] = 0
    return d


def test_expand_compiled_matches_host(gpu):
    data = _dct(4 * B, 0).reshape(4, B)
    lens = np.array([B, B, B, B - 777], np.int32)
    data[3, lens[3]:] = 0
    cap = planar.capacity_for(B, 6)
    outs = [planar.host_encode_block(data[b, :lens[b]], cap, B, 6)
            for b in range(4)]
    cols = [np.stack([o[i] for o in outs]) for i in range(4)]
    lmax = -(-max(int(o[5]) for o in outs) // 128) * 128
    y = device.expand(cols[0], cols[1], cols[2], cols[3][:, :lmax],
                      np.array([o[4] for o in outs], np.int32), lens,
                      block_size=B)
    assert y.devices() == {gpu}
    np.testing.assert_array_equal(np.asarray(y), data)


def test_triton_expand_matches_xla(gpu):
    """The compiled Triton byte stage equals the XLA formulation on the
    card, with a ragged last block."""
    data = _dct(8 * B, 1).reshape(8, B)
    lens = np.full(8, B, np.int32)
    lens[-1] = B - 4097
    pb = device.encode_blocks(data, lens, capacity=planar.capacity_for(B, 6),
                              min_count=6)
    tables = device.expand_tables(pb.sym, pb.count, pb.lit_len, pb.n_cmds)
    args = (*tables, pb.sym, pb.lits[:, :B // 2], pb.n_cmds, pb.block_len)
    want = np.asarray(jax.jit(functools.partial(
        device.expand_bytes, block_size=B))(*args))
    got = jax.jit(functools.partial(
        expand_triton.expand_bytes, block_size=B))(*args)
    np.testing.assert_array_equal(np.asarray(got), want)


def test_device_encode_matches_host(gpu):
    data = _dct(2 * B, 3).reshape(2, B)
    lens = np.full(2, B, np.int32)
    cap = planar.capacity_for(B, 6)
    pb = device.encode_blocks(jax.device_put(data, gpu), lens,
                              capacity=cap, min_count=6)
    for b in range(2):
        ref = planar.host_encode_block(data[b], cap, B, 6)
        for i, col in enumerate((pb.sym, pb.count, pb.lit_len)):
            np.testing.assert_array_equal(np.asarray(col)[b], ref[i])
        nl = int(ref[5])
        assert int(pb.n_cmds[b]) == int(ref[4]) and int(pb.n_lits[b]) == nl
        np.testing.assert_array_equal(np.asarray(pb.lits)[b, :nl],
                                      ref[3][:nl])


@pytest.mark.parametrize("codec", ["8 Bit", "64 Bit Packed (Byte)",
                                   "24 Bit (Symbol)"])
def test_decompress_roundtrip(gpu, codec):
    payload = _dct(3 * B + 12345, 11).tobytes()
    blob = api.compress(payload, codec)
    assert api.decompress(blob) == payload
    assert api.compress(payload, codec, backend="device") == blob


def test_profiler_trace_names_the_expand(gpu, tmp_path):
    """A decode under jax.profiler leaves a device trace on disk whose
    events carry the expand's stable name."""
    payload = _dct(B, 5).tobytes()
    blob = api.compress(payload)
    api.decompress(blob)
    with jax.profiler.trace(str(tmp_path)):
        assert api.decompress(blob) == payload
    traces = list(tmp_path.rglob("*.xplane.pb"))
    assert traces, "no profiler trace written"
    assert any(b"hrt1_expand" in t.read_bytes() for t in traces)


def test_hostile_deep_container_rejected(gpu):
    rng = np.random.default_rng(11)
    data = np.zeros(300_000, np.uint8)
    pos, k = 0, 0
    while pos < data.size - 400:
        run = int(rng.integers(8, 60))
        data[pos:pos + run] = k % 251
        k += 1
        pos += run + int(rng.integers(0, 6))
    blob = api.compress(data.tobytes())
    info, blocks = container.parse(blob)
    assert info.deep
    bl = blocks[0]
    offs, sizes = container._deep_sections(bl, bl["n_cmds"], bl["n_lits"])
    buf = bytearray(blob)
    p = bl["payload_off"] + offs[4]
    buf[p:p + sizes[4]] = bytes(sizes[4])
    with pytest.raises(container.ContainerError):
        api.decompress(bytes(buf))
