"""Device bit-packing — the data-parallel analog of ``bitpack.h``.

The reference packs byte arrays whose values fit in 1/2/3/4 bits with SSE2
shuffle/shift pipelines (`bitpack.h:15-1216`, the "3_3"/"3_6" block layouts
exist only to keep x86 shuffles cheap).  On the device the natural
formulation is a bit-matrix reshape: every value is expanded to its ``w`` bits, the
bit stream is reshaped to ``[.., 8]`` groups, and each group is folded into
one byte with a tiny iota-weighted sum — fully vectorized, shape-static, and
fused by XLA into surrounding producers/consumers.

Layout (device-native, not the reference's SSE block layout): value ``k`` of a
stream occupies bits ``[k*w, (k+1)*w)``, little-endian within each byte.  The
byte-exact reference layouts live with their only consumer,
``formats/rle8_mmtf.py``; these kernels serve the HRT1 container's packed
columns and any device-resident 1-4 bit payloads.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def packed_size(n_values: int, width: int) -> int:
    """Bytes needed to pack ``n_values`` values of ``width`` bits."""
    return (n_values * width + 7) // 8


@functools.partial(jax.jit, static_argnames=("width",))
def pack_device(x: jnp.ndarray, *, width: int) -> jnp.ndarray:
    """Pack ``x[.., n]`` uint8 values (< 2**width) into ``[.., n*width/8]``
    bytes.  ``n * width`` must be a multiple of 8 (pad with zeros upstream).
    """
    assert 1 <= width <= 8
    n = x.shape[-1]
    assert n * width % 8 == 0, (n, width)
    lead = x.shape[:-1]
    v = x.astype(jnp.uint8)
    # [.., n, width] bit plane, little-endian within each value
    shifts = jnp.arange(width, dtype=jnp.uint8)
    bits = (v[..., None] >> shifts) & 1
    groups = bits.reshape(*lead, n * width // 8, 8)
    weights = (jnp.uint8(1) << jnp.arange(8, dtype=jnp.uint8))
    return (groups * weights).sum(axis=-1).astype(jnp.uint8)


@functools.partial(jax.jit, static_argnames=("width", "n_values"))
def unpack_device(packed: jnp.ndarray, *, width: int,
                  n_values: int) -> jnp.ndarray:
    """Unpack ``packed[.., m]`` bytes into ``[.., n_values]`` uint8 values."""
    assert 1 <= width <= 8
    lead = packed.shape[:-1]
    m = packed.shape[-1]
    assert m * 8 >= n_values * width, (m, n_values, width)
    shifts = jnp.arange(8, dtype=jnp.uint8)
    bits = (packed[..., None] >> shifts) & 1          # [.., m, 8]
    bits = bits.reshape(*lead, m * 8)[..., : n_values * width]
    bits = bits.reshape(*lead, n_values, width)
    weights = (jnp.uint8(1) << jnp.arange(width, dtype=jnp.uint8))
    return (bits * weights).sum(axis=-1).astype(jnp.uint8)


# numpy goldens (used by the container serializer and the tests) -------------

def pack_np(x, width: int):
    import numpy as np
    x = np.asarray(x, np.uint8)
    n = x.shape[-1]
    bits = ((x[..., None] >> np.arange(width, dtype=np.uint8)) & 1)
    groups = bits.reshape(*x.shape[:-1], n * width // 8, 8)
    return (groups << np.arange(8, dtype=np.uint8)).sum(-1).astype(np.uint8)


def unpack_np(packed, width: int, n_values: int):
    import numpy as np
    packed = np.asarray(packed, np.uint8)
    m = packed.shape[-1]
    bits = ((packed[..., None] >> np.arange(8, dtype=np.uint8)) & 1)
    bits = bits.reshape(*packed.shape[:-1], m * 8)[..., : n_values * width]
    bits = bits.reshape(*packed.shape[:-1], n_values, width)
    return (bits << np.arange(width, dtype=np.uint8)).sum(-1).astype(np.uint8)
