"""HRT1 container validation: malformed input raises ContainerError
(the analog of the reference's header checks, rle8_extreme_cpu.h:707-712)."""

import numpy as np
import pytest

from hypersonic_rle_kit_tpu import api
from hypersonic_rle_kit_tpu.parallel import container


@pytest.fixture(scope="module")
def blob():
    rng = np.random.default_rng(0)
    data = rng.integers(0, 4, 200_000, dtype=np.uint8)
    data[rng.random(data.size) < 0.8] = 0
    return api.compress(data.tobytes()), data.tobytes()


def test_roundtrip(blob):
    b, payload = blob
    assert api.decompress(b, backend="device") == payload


@pytest.mark.parametrize("mutate", [
    "empty", "magic", "short_header", "short_table", "n_cmds", "n_lits",
    "bit_width", "truncate_payload", "usize"])
def test_malformed_raises(blob, mutate):
    b, _ = blob
    buf = bytearray(b)
    if mutate == "empty":
        buf = bytearray(b"HRT")
    elif mutate == "magic":
        buf[0] = 0
    elif mutate == "short_header":
        buf = buf[:10]
    elif mutate == "short_table":
        buf = buf[:container._HEADER.size + 3]
    elif mutate == "n_cmds":
        buf[container._HEADER.size + 4] ^= 0xFF
    elif mutate == "n_lits":
        buf[container._HEADER.size + 8] ^= 0xFF
    elif mutate == "bit_width":
        buf[container._HEADER.size + 12] = 60
    elif mutate == "truncate_payload":
        buf = buf[: len(buf) // 2]
    elif mutate == "usize":
        buf[8:16] = (1 << 50).to_bytes(8, "little")
    with pytest.raises(container.ContainerError):
        container.parse(bytes(buf))


def test_native_numpy_unpack_agree(blob):
    b, _ = blob
    from hypersonic_rle_kit_tpu.utils import native
    info, cols_a = container.deserialize_to_planar(b)
    if native.lib() is None:
        pytest.skip("native runtime unavailable")
    real = native.unpack_container
    try:
        native.unpack_container = lambda *a, **k: None
        _, cols_b = container.deserialize_to_planar(b)
    finally:
        native.unpack_container = real
    for x, y in zip(cols_a, cols_b):
        np.testing.assert_array_equal(x, y)


def test_deep_subheader_count_mismatch_rejected():
    """A parse-valid deep container whose lut section implies a different
    miss population than the stored n_miss must raise ContainerError on
    every backend -- including the device path, whose resolver validates
    the counts it would otherwise trust."""
    rng = np.random.default_rng(11)
    data = np.zeros(300_000, np.uint8)
    # many distinct run symbols so the block dictionary has misses and hits
    pos = 0
    k = 0
    while pos < data.size - 400:
        run = int(rng.integers(8, 60))
        data[pos:pos + run] = k % 251
        k += 1
        pos += run + int(rng.integers(0, 6))
    blob = api.compress(data.tobytes())
    info, blocks = container.parse(blob)
    if not info.deep:
        pytest.skip("serializer picked the flat layout for this input")
    bl = blocks[0]
    offs, sizes = container._deep_sections(bl, bl["n_cmds"], bl["n_lits"])
    lut_off, lut_sz = offs[4], sizes[4]
    assert lut_sz > 0 and bl["n_miss"] < bl["n_cmds"] - 1
    buf = bytearray(blob)
    p = bl["payload_off"] + lut_off
    # zero the whole lut section: every run symbol becomes a miss, so the
    # actual miss population now exceeds the stored n_miss
    for i in range(lut_sz):
        buf[p + i] = 0
    hostile = bytes(buf)
    container.parse(hostile)          # still structurally valid
    pk = container.pack_for_device(hostile)
    assert pk is not None
    from hypersonic_rle_kit_tpu.ops import unpack_device
    with pytest.raises(container.ContainerError):
        unpack_device.decode_packed(pk)
    with pytest.raises(container.ContainerError):
        api.decompress(hostile, backend="device")


def test_litdict_layout_and_hostile_litcodes():
    """The k-bit literal dictionary (FLAG_LITDICT) must be chosen on
    literal-skewed data, beat the plain deep layout, and reject hostile
    containers whose literal codes imply a different miss population
    than the stored n_lmiss."""
    import sys
    sys.path.insert(0, __file__.rsplit("/", 2)[0])
    import bench
    data = bench.make_dataset(2).tobytes()
    blob = api.compress(data, "8 Bit")
    info, blocks = container.parse(blob)
    assert info.litdict and info.deep
    lk = blocks[0]["lit_k"]
    assert 2 <= lk <= 8
    for be in ("host", "auto", "device"):
        assert api.decompress(blob, backend=be) == data

    # hostile: zero a block's literal-code section so the implied miss
    # population exceeds the stored n_lmiss
    bl = blocks[0]
    offs, sizes = container._deep_sections(bl, bl["n_cmds"], bl["n_lits"])
    assert sizes[7] > 0 and bl["n_lmiss"] < bl["n_lits"]
    buf = bytearray(blob)
    p = bl["payload_off"] + offs[7]
    for i in range(sizes[7]):
        buf[p + i] = 0
    hostile = bytes(buf)
    container.parse(hostile)          # still structurally valid
    with pytest.raises(container.ContainerError):
        container.pack_for_device(hostile)
    with pytest.raises(container.ContainerError):
        api.decompress(hostile, backend="host")


def test_pack_for_device_uniform_and_fallback():
    """serialize_blocks emits container-uniform bit widths by default, so
    pack_for_device slices sections for the device unpack; per-block-width
    containers (multi-host assemble path) return None and decompress falls
    back to the host unpack on every backend."""
    import numpy as np
    from hypersonic_rle_kit_tpu import api
    from hypersonic_rle_kit_tpu.ops import unpack_device
    from hypersonic_rle_kit_tpu.parallel import container

    rng = np.random.default_rng(3)
    data = rng.integers(0, 4, 300_000, dtype=np.uint8)
    data[rng.random(300_000) < 0.8] = 0
    blob = api.compress(bytes(data), "8 Bit")
    pk = container.pack_for_device(blob)
    assert pk is not None
    y = unpack_device.decode_packed(pk)
    assert y.reshape(-1)[: data.size].tobytes() == bytes(data)

    # per-block widths (uniform_bits=False): device path must decline
    from hypersonic_rle_kit_tpu.ops import planar
    from hypersonic_rle_kit_tpu.utils import native
    B = container.DEFAULT_BLOCK_SIZE
    nb2 = 4
    x = np.zeros((nb2, B), np.uint8)
    x[0, :500] = 7
    x[2, :60000] = 9
    lens = np.full(nb2, B, np.int32)
    cols = native.planar_from_bytes(x, lens, planar.capacity_for(B, 6))
    if cols is None:
        cols = api._host_encode(x, lens, planar.capacity_for(B, 6), B, 6)
    blob2 = container.serialize_blocks(0, nb2 * B, B, 6, *cols,
                                       uniform_bits=False)
    widths = {bl["cnt_bits"] for bl in container.parse(blob2)[1]}
    if len(widths) > 1:
        assert container.pack_for_device(blob2) is None
    assert api.decompress(blob2, backend="device") == x.tobytes()
