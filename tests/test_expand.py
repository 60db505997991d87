"""The expand's byte stage vs the host golden: block geometries,
densities and edge cases of the planar command IR.  ``impl`` "xla" is
ops/device.expand_bytes (what every non-CUDA platform runs); "triton" is
the GPU kernel (ops/expand_triton.py) in the Pallas interpreter."""

import numpy as np
import pytest

import jax.numpy as jnp

from hypersonic_rle_kit_tpu import api
from hypersonic_rle_kit_tpu.ops import device, expand_triton, planar
from hypersonic_rle_kit_tpu.parallel import container

B = 4096


def _cols(blocks, lens, B, min_count=6):
    cap = planar.capacity_for(B, min_count)
    outs = [planar.host_encode_block(blocks[b][: lens[b]], cap, B, min_count)
            for b in range(len(blocks))]
    return ([np.stack([o[i] for o in outs]) for i in range(4)]
            + [np.array([o[i] for o in outs], np.int32) for i in (4, 5)])


def _expand(impl, sym, count, lit_len, lits, n_cmds, n_lits, block_len, B):
    # O(compressed) input: the literal section trimmed to its used width
    lw = max(128, -(-int(np.max(n_lits)) // 128) * 128)
    n_cmds = jnp.asarray(n_cmds, jnp.int32)
    tables = device.expand_tables(jnp.asarray(sym), jnp.asarray(count),
                                  jnp.asarray(lit_len), n_cmds)
    args = (*tables, jnp.asarray(sym), jnp.asarray(lits[:, :lw]), n_cmds,
            jnp.asarray(block_len, jnp.int32))
    if impl == "xla":
        out = device.expand_bytes(*args, block_size=B)
    else:
        out = expand_triton.expand_bytes(*args, block_size=B,
                                         interpret=True)
    return np.asarray(out)


IMPLS = pytest.mark.parametrize("impl", ["xla", "triton"])


def _roundtrip(impl, blocks, lens, B):
    blocks = np.stack(blocks)
    lens = np.asarray(lens, np.int32)
    out = _expand(impl, *_cols(blocks, lens, B), lens, B)
    want = blocks.copy()
    for b in range(len(lens)):
        want[b, lens[b]:] = 0
    np.testing.assert_array_equal(out, want)


@IMPLS
@pytest.mark.parametrize("p_zero", [0.0, 0.5, 0.85, 0.99])
def test_random_densities(impl, p_zero):
    rng = np.random.default_rng(int(p_zero * 100))
    data = rng.integers(-4, 5, (3, B)).astype(np.int8).astype(np.uint8)
    data[rng.random(data.shape) < p_zero] = 0
    lens = np.array([B, B, B - 777])
    data[2, lens[2]:] = 0
    _roundtrip(impl, list(data), lens, B)


@IMPLS
def test_multi_stripe_block(impl):
    rng = np.random.default_rng(0)
    BB = 16384
    data = rng.integers(0, 3, (2, BB)).astype(np.uint8)
    data[:, ::2] = 0
    _roundtrip(impl, list(data), [BB, BB - 5], BB)


@IMPLS
def test_small_block(impl):
    rng = np.random.default_rng(1)
    BB = 2048
    data = rng.integers(0, 3, (2, BB)).astype(np.uint8)
    _roundtrip(impl, list(data), [BB, BB], BB)


@IMPLS
def test_unaligned_block_size_decodes(impl):
    """Block sizes that are not a multiple of 1024 (16640 here) decode
    through the expand and through api.decompress."""
    BB = 16640
    rng = np.random.default_rng(5)
    data = rng.integers(0, 3, (1, BB)).astype(np.uint8)
    _roundtrip(impl, list(data), [BB], BB)
    raw = data.reshape(-1).tobytes()
    blob = api.compress(raw, block_size=BB)
    assert api.decompress(blob, backend="device") == raw


@IMPLS
@pytest.mark.parametrize("case", [
    "whole_run", "run_ends_at_bnd", "run_starts_at_bnd", "adjacent_runs",
    "empty", "tiny", "dense_min_runs", "tail_run"])
def test_edges(impl, case):
    BB = 8192
    d = np.zeros(BB, np.uint8)
    n = BB
    if case == "whole_run":
        d[:] = 7
    elif case == "run_ends_at_bnd":
        d[:4096] = 9
        d[4096:4100] = [1, 2, 3, 4]
    elif case == "run_starts_at_bnd":
        d[:] = np.arange(BB) & 0xFF
        d[4096:6000] = 5
    elif case == "adjacent_runs":
        d[:100] = 3
        d[100:200] = 4
    elif case == "empty":
        n = 0
    elif case == "tiny":
        d[:5] = [9, 8, 7, 6, 5]
        n = 5
    elif case == "dense_min_runs":
        d[:] = np.repeat(np.arange(BB // 6 + 1) % 251, 6)[:BB]
    elif case == "tail_run":
        n = BB - 1000
    _roundtrip(impl, [d], [n], BB)


@IMPLS
def test_mid_stream_zero_count_commands(impl):
    """count==0 commands mid-stream (possible in crafted containers) decode
    as pure-literal commands rather than corrupting the stream."""
    BB = 4096
    cap = 256
    sym = np.zeros((1, cap), np.uint8)
    count = np.zeros((1, cap), np.int32)
    lit_len = np.zeros((1, cap), np.int32)
    lits = np.zeros((1, BB), np.uint8)
    # cmd0: 4 lits + run of 10 'A'; cmd1: 3 lits, count 0; cmd2: tail lits
    lits[0, :12] = np.arange(1, 13)
    sym[0, 0] = 65
    count[0, 0] = 10
    lit_len[0, :3] = [4, 3, 5]
    out = _expand(impl, sym, count, lit_len, lits, np.array([3], np.int32),
                  np.array([12], np.int32), np.array([22], np.int32), BB)
    want = np.zeros(BB, np.uint8)
    want[:4] = [1, 2, 3, 4]
    want[4:14] = 65
    want[14:17] = [5, 6, 7]
    want[17:22] = [8, 9, 10, 11, 12]
    np.testing.assert_array_equal(out[0], want)


@IMPLS
def test_worst_density_and_ragged_tail(impl):
    """Worst legal density (every 6 bytes a run) plus a ragged tail block
    decodes exactly."""
    rng = np.random.default_rng(7)
    BB = 16384
    data = np.repeat(rng.integers(0, 251, (3, BB // 6 + 1)), 6,
                     axis=1)[:, :BB].astype(np.uint8)
    lens = np.asarray([BB, BB - 3000, 17], np.int32)
    for b in range(3):
        data[b, lens[b]:] = 0
    _roundtrip(impl, list(data), lens, BB)


@IMPLS
def test_large_block(impl):
    """A 1 MiB block (past any per-block size budget) decodes exactly."""
    BB = 1 << 20
    rng = np.random.default_rng(8)
    d = rng.integers(0, 3, BB).astype(np.uint8)
    d[rng.random(BB) < 0.7] = 0
    _roundtrip(impl, [d], [BB], BB)


@IMPLS
def test_events_only_late_in_block(impl):
    """A block whose only run sits far from its start."""
    BB = 65536
    sym = np.zeros((1, 128), np.uint8)
    count = np.zeros((1, 128), np.int32)
    lit_len = np.zeros((1, 128), np.int32)
    sym[0, 0] = 3
    count[0, 0] = 6
    lit_len[0, 0] = 30755
    lit_len[0, 1] = BB - 6 - 30755
    n_lits = BB - 6
    lits = np.zeros((1, BB), np.uint8)
    lits[0, :n_lits] = (np.arange(n_lits) % 251).astype(np.uint8)
    y = _expand(impl, sym, count, lit_len, lits, np.array([2], np.int32),
                np.array([n_lits], np.int32), np.array([BB], np.int32), BB)
    h = planar.host_decode_block(sym[0], count[0], lit_len[0], lits[0], 2, BB)
    assert np.array_equal(y[0], h)


@IMPLS
def test_all_literal_block(impl):
    """A single-command (incompressible) block next to a run-heavy one."""
    BB = 65536
    rng = np.random.default_rng(4)
    raw = rng.integers(0, 256, BB, dtype=np.uint8)
    runs = np.zeros(BB, np.uint8)
    runs[: BB // 2] = 7
    cols = _cols(np.stack([raw, runs]), np.full(2, BB), BB)
    assert cols[4][0] == 1          # the raw block really is one command
    y = _expand(impl, *cols, np.full(2, BB, np.int32), BB)
    np.testing.assert_array_equal(y, np.stack([raw, runs]))


@IMPLS
def test_all_run_block(impl):
    """A block that is one whole-block run, and a partial-tail all-run
    block."""
    BB = 65536
    blocks = np.stack([np.full(BB, 9, np.uint8), np.zeros(BB, np.uint8)])
    lens = np.array([BB, BB - 321], np.int32)
    blocks[1, lens[1]:] = 0
    cols = _cols(blocks, lens, BB)
    assert cols[4][0] == 2 and cols[1][0, 0] == BB
    np.testing.assert_array_equal(_expand(impl, *cols, lens, BB), blocks)


def test_dense_capacity_decodes():
    """Blocks at the densest command count a 256 KiB block can hold (runs
    of 6 split by one literal) decode exactly through api.decompress."""
    BB = 1 << 18
    unit = np.concatenate([np.zeros(6, np.uint8), np.array([7], np.uint8)])
    raw = np.tile(unit, BB // 7 + 1)[:BB].tobytes()
    blob = api.compress(raw, block_size=BB)
    _, cols = container.deserialize_to_planar(blob)
    assert int(cols[4].max()) > BB // 8
    assert api.decompress(blob, backend="device") == raw


@pytest.mark.parametrize("min_count", [1, 2, 3])
def test_short_min_count_decodes(min_count):
    """Containers whose runs are shorter than 4 bytes decode on the device
    (hand-serialized: no codec emits min_count < 4)."""
    BB = 8192
    rng = np.random.default_rng(min_count)
    d = np.repeat(rng.integers(0, 4, BB), rng.integers(1, 5, BB))[:BB]
    d = d.astype(np.uint8)
    cap = planar.capacity_for(BB, min_count)
    o = planar.host_encode_block(d, cap, BB, min_count)
    blob = container.serialize_blocks(
        0, BB, BB, min_count, *[a[None] for a in o[:4]],
        np.array([o[4]], np.int32), np.array([o[5]], np.int32))
    assert api.decompress(blob, backend="device") == d.tobytes()


@pytest.mark.parametrize("w", [2, 3, 4, 6, 8, 16])
@pytest.mark.parametrize("seed", [0, 3])
def test_interleave_to_stream(w, seed):
    """The on-device width re-interleave (full blocks and the partial
    tail) inverts the byte-lane split of api._deinterleave."""
    rng = np.random.default_rng(seed)
    Bw = w * 256
    n = 3 * Bw - 5 - seed
    orig = rng.integers(0, 256, n).astype(np.uint8)
    x, lens = api._deinterleave(*api._to_blocks(orig, Bw), w)
    got = np.asarray(api._interleave_plane(x, w=w, n=n))
    np.testing.assert_array_equal(got, orig)
    host = api._interleave_to_stream(x, w=w, n=n, xp=np)
    np.testing.assert_array_equal(host, orig)
