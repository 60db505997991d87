"""Randomized tests for the prefix-sum data movement helpers
(ops/device.distribute: prefix sum + gather; ops/device.compact: prefix
sum + scatter) that the device encoder and the deep-layout resolver are
built from."""

import numpy as np
import pytest

import jax.numpy as jnp

from hypersonic_rle_kit_tpu.ops import device


def _tile(rng, rows, hi=1000):
    return rng.integers(0, hi, (rows, 128)).astype(np.int32)


@pytest.mark.parametrize("rows", [1, 8])
@pytest.mark.parametrize("density", [0.02, 0.3, 0.97])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_distribute(rows, density, seed):
    """distribute(compact, mask)[i] == compact[rank(i)] on mask positions."""
    n = rows * 128
    rng = np.random.default_rng(seed * 31 + rows)
    mask = rng.random((rows, n)) < density
    compact = rng.integers(0, 255, (rows, n)).astype(np.int32)
    got = np.asarray(device.distribute(jnp.asarray(compact),
                                       jnp.asarray(mask)))
    for r in range(rows):
        idx = np.flatnonzero(mask[r])
        np.testing.assert_array_equal(got[r, idx], compact[r, :idx.size])


@pytest.mark.parametrize("rows", [1, 4, 16])
@pytest.mark.parametrize("density", [0.0, 0.1, 0.5, 0.9, 1.0])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compact_flat(rows, density, seed):
    """Compaction of a whole [rows*128] stream keeps kept values in order
    and zero-fills the rest."""
    rng = np.random.default_rng(seed * 131 + rows)
    a = _tile(rng, rows).reshape(-1)
    keep = rng.random(a.size) < density
    got = np.asarray(device.compact(jnp.asarray(a), jnp.asarray(keep),
                                    a.size))
    k = int(keep.sum())
    np.testing.assert_array_equal(got[:k], a[keep])
    assert (got[k:] == 0).all()


@pytest.mark.parametrize("seed", range(4))
def test_compact_batched(seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << 20, (3, 8, 128)).astype(np.int32)
    keep = rng.random((3, 8, 128)) < 0.3
    got = np.asarray(device.compact(jnp.asarray(a), jnp.asarray(keep), 128))
    assert got.shape == (3, 8, 128)
    for g in range(3):
        for r in range(8):
            k = int(keep[g, r].sum())
            np.testing.assert_array_equal(got[g, r, :k], a[g, r][keep[g, r]])


@pytest.mark.parametrize("density", [0.0, 0.15, 0.25, 0.6, 1.0])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compact_rows(density, seed):
    """Per-row compaction into a narrower output drops nothing that fits
    and the kept count matches the mask."""
    rng = np.random.default_rng(seed * 17 + 3)
    a = _tile(rng, 8)
    b = _tile(rng, 8)
    keep = rng.random((8, 128)) < density
    ga = np.asarray(device.compact(jnp.asarray(a), jnp.asarray(keep), 128))
    gb = np.asarray(device.compact(jnp.asarray(b), jnp.asarray(keep), 128))
    for r in range(8):
        n = int(keep[r].sum())
        np.testing.assert_array_equal(ga[r, :n], a[r][keep[r]])
        np.testing.assert_array_equal(gb[r, :n], b[r][keep[r]])
        assert (ga[r, n:] == 0).all()
