"""Device block encoder (ops/device.encode_blocks) vs the host golden
(ops/planar.host_encode_block): byte-identical command emission."""

import numpy as np
import pytest

import jax.numpy as jnp

from hypersonic_rle_kit_tpu.ops import device, planar

B = 2048


def _check(data, lens, B, min_count=6):
    cap = planar.capacity_for(B, min_count)
    pb = device.encode_blocks(jnp.asarray(data), jnp.asarray(lens),
                              capacity=cap, min_count=min_count)
    got = [np.asarray(g) for g in (pb.sym, pb.count, pb.lit_len, pb.lits,
                                   pb.n_cmds, pb.n_lits)]
    for b in range(data.shape[0]):
        ref = planar.host_encode_block(data[b, : lens[b]], cap, B, min_count)
        names = ["sym", "count", "lit_len", "lits", "n_cmds", "n_lits"]
        for i, name in enumerate(names):
            g, r = got[i][b], ref[i]
            if name == "lits":
                nl = int(ref[5])
                g, r = g[:nl], r[:nl]
            np.testing.assert_array_equal(g, r, err_msg=f"block {b} {name}")


@pytest.mark.parametrize("p_zero", [0.0, 0.5, 0.85, 0.99])
def test_random_densities(p_zero):
    rng = np.random.default_rng(int(p_zero * 100))
    data = rng.integers(-4, 5, (2, B)).astype(np.int8).astype(np.uint8)
    data[rng.random(data.shape) < p_zero] = 0
    lens = np.array([B, B - 77], np.int32)
    data[1, lens[1]:] = 0
    _check(data, lens, B)


@pytest.mark.parametrize("case", ["whole_run", "empty", "tiny", "tail_run",
                                  "adjacent", "min_count_edge"])
def test_edges(case):
    d = np.zeros((1, B), np.uint8)
    n = B
    if case == "whole_run":
        d[0, :] = 7
    elif case == "empty":
        n = 0
    elif case == "tiny":
        d[0, :5] = [9, 8, 7, 6, 5]
        n = 5
    elif case == "tail_run":
        n = B - 100
    elif case == "adjacent":
        d[0, :100] = 3
        d[0, 100:200] = 4
    elif case == "min_count_edge":
        # runs of exactly min_count-1 (not emitted) and min_count (emitted)
        d[0, 10:15] = 1     # 5 bytes: literal
        d[0, 20:26] = 2     # 6 bytes: run
    d[0, n:] = 0
    _check(d, np.array([n], np.int32), B)


def test_min_count_parameter():
    d = np.zeros((1, B), np.uint8)
    d[0, 10:14] = 5  # 4-run: emitted at min_count 3, literal at min_count 6
    _check(d, np.array([B], np.int32), B, min_count=3)


def test_single_symbol_filter():
    """only_sym restricts emission to one byte's runs (Single family)."""
    d = np.zeros((2, B), np.uint8)
    d[:, 100:200] = 7
    d[:, 300:400] = 9
    cap = planar.capacity_for(B, 6)
    pb = device.encode_blocks(jnp.asarray(d), jnp.full(2, B, jnp.int32),
                              capacity=cap, min_count=6,
                              only_sym=jnp.array([7, 9], jnp.int32))
    for b, s in enumerate((7, 9)):
        ref = planar.host_encode_block(d[b], cap, B, 6, only_sym=s)
        np.testing.assert_array_equal(np.asarray(pb.sym)[b], ref[0])
        np.testing.assert_array_equal(np.asarray(pb.count)[b], ref[1])
        assert int(pb.n_cmds[b]) == int(ref[4])
