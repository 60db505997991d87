"""Device MMTF / Bit-MMTF transforms.

The reference vectorizes MMTF *across* the 16/32 byte lanes while walking the
stream strictly serially (`mmtf.c:112-178` encode, `:253-380` decode): each
lane owns a 256-entry move-to-front history, and every 16/32-byte unit does a
find + rotate on all lanes at once.  The device formulation keeps that exact
lane-parallel shape — one ``lax.scan`` step per unit, each step a fully
vectorized rank lookup and table shift over ``[lanes, 256]`` — and adds the
axis the reference never had: the **block axis**.  A long stream is split
into independent blocks (each with a fresh history, the same convention as
the HRT1 container), so one device runs ``nb`` MTF chains side by side via
``vmap`` and a mesh runs ``nb × n_devices``.  Within a block the chain is
inherently serial (an MTF table is a data-dependent recurrence) — the
parallelism budget goes to lanes × blocks, not to time.

Bit-MMTF (`bit_mmtf.c:18-128`) is the XOR-delta of consecutive 1/2-byte
units; its decode is a prefix-XOR, which on device is one
``lax.associative_scan`` — the textbook case of a serial dependency that is
actually associative.

Byte parity: on inputs whose length is a multiple of ``lanes`` and with a
single block, these match ``formats/mmtf.py`` (and therefore the reference)
byte for byte; the trailing-partial-unit lookup rule (`mmtf.c:161-175`) is
applied host-side by the wrappers.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _mtf_step(table: jnp.ndarray, v_or_d: jnp.ndarray, *, encode: bool):
    """One unit step over all lanes.  ``table`` is [lanes, 256] int32 (a
    permutation per lane); returns (new_table, output [lanes])."""
    lanes = table.shape[0]
    pos = jnp.arange(256, dtype=jnp.int32)[None, :]
    if encode:
        v = v_or_d.astype(jnp.int32)
        d = jnp.argmax(table == v[:, None], axis=1).astype(jnp.int32)
    else:
        d = v_or_d.astype(jnp.int32)
        v = jnp.take_along_axis(table, d[:, None], axis=1)[:, 0]
    out = d if encode else v
    # move-to-front: entries [0, d) shift right by one, slot 0 gets v
    shifted = jnp.concatenate([v[:, None], table[:, :-1]], axis=1)
    new_table = jnp.where(pos <= d[:, None], shifted, table)
    return new_table, out.astype(jnp.uint8)


def _mmtf_block(x: jnp.ndarray, lanes: int, encode: bool) -> jnp.ndarray:
    """Transform one block of ``[units, lanes]`` bytes."""
    init = jnp.broadcast_to(jnp.arange(256, dtype=jnp.int32)[None, :],
                            (lanes, 256))

    def step(table, row):
        return _mtf_step(table, row, encode=encode)

    _, out = jax.lax.scan(step, init, x)
    return out


@functools.partial(jax.jit, static_argnames=("lanes", "encode"))
def mmtf_device(x: jnp.ndarray, *, lanes: int = 16,
                encode: bool = True) -> jnp.ndarray:
    """MMTF transform of ``x[nb, n]`` bytes (n divisible by ``lanes``),
    independent per block.  ``lanes=16`` is MMTF 128, ``lanes=32`` MMTF 256.
    """
    nb, n = x.shape
    assert n % lanes == 0, (n, lanes)
    units = x.reshape(nb, n // lanes, lanes)
    out = jax.vmap(lambda b: _mmtf_block(b, lanes, encode))(units)
    return out.reshape(nb, n)


def mmtf128_device(x, *, encode=True):
    return mmtf_device(x, lanes=16, encode=encode)


def mmtf256_device(x, *, encode=True):
    return mmtf_device(x, lanes=32, encode=encode)


# ---------------------------------------------------------------------------
# Bit-MMTF
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("unit",))
def bitmmtf_encode_device(x: jnp.ndarray, *, unit: int = 1) -> jnp.ndarray:
    """XOR-delta of consecutive ``unit``-byte units of ``x[nb, n]``
    (n divisible by ``unit``); per-block independent (first unit kept)."""
    nb, n = x.shape
    v = x.reshape(nb, n // unit, unit)
    prev = jnp.pad(v[:, :-1], ((0, 0), (1, 0), (0, 0)))
    return (v ^ prev).reshape(nb, n)


@functools.partial(jax.jit, static_argnames=("lanes", "encode"))
def _mtf_scan(units: jnp.ndarray, *, lanes: int, encode: bool):
    """Scan the per-lane MTF over ``[n_units, lanes]`` units; returns the
    final history table and the transformed units.  Module-level jit so the
    compile cache hits across calls (one trace per (lanes, encode))."""
    init = jnp.broadcast_to(jnp.arange(256, dtype=jnp.int32)[None, :],
                            (lanes, 256))
    return jax.lax.scan(
        lambda t, row: _mtf_step(t, row, encode=encode), init, units)


@functools.partial(jax.jit, static_argnames=("unit",))
def bitmmtf_decode_device(x: jnp.ndarray, *, unit: int = 1) -> jnp.ndarray:
    """Prefix-XOR over units — ``lax.associative_scan`` turns the serial
    recurrence into a log-depth tree (bit_mmtf.c's loop is sequential)."""
    nb, n = x.shape
    v = x.reshape(nb, n // unit, unit)
    out = jax.lax.associative_scan(jnp.bitwise_xor, v, axis=1)
    return out.reshape(nb, n)


# ---------------------------------------------------------------------------
# host wrappers: reference-exact semantics (single block, partial tail)
# ---------------------------------------------------------------------------

def mmtf_transform(data, *, lanes: int = 16, encode: bool = True) -> bytes:
    """Reference-exact MMTF of an arbitrary-length byte string, computed on
    the device.  The trailing partial unit is a history *lookup* without an
    MTF update (mmtf.c:161-175), resolved host-side from the final table."""
    arr = np.frombuffer(memoryview(bytes(data)), np.uint8)
    n = arr.size
    if n == 0:
        return b""
    full = n // lanes * lanes
    out = np.empty(n, np.uint8)
    table = np.tile(np.arange(256, dtype=np.int32), (lanes, 1))
    if full:
        units = jnp.asarray(arr[:full].reshape(full // lanes, lanes))
        final_t, res = _mtf_scan(units, lanes=lanes, encode=encode)
        out[:full] = np.asarray(res).reshape(-1)
        table = np.asarray(final_t)
    for i in range(full, n):
        lane = i - full
        if encode:
            out[i] = int(np.flatnonzero(table[lane] == arr[i])[0])
        else:
            out[i] = table[lane, arr[i]]
    return out.tobytes()
