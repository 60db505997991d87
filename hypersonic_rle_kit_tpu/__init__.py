"""hypersonic-rle-kit-tpu: a GPU-accelerated run-length compression framework.

A from-scratch reimplementation of the capabilities of
`rainerzufalldererste/hypersonic-rle-kit` (121 RLE/MTF codec variants, a
parallel-decode container, benchmark+fuzz harnesses), re-designed for
data-parallel accelerators in JAX:

- :mod:`~hypersonic_rle_kit_tpu.spec` — the codec registry (CodecSpec dataclass
  replaces the reference's C-preprocessor macro matrix).
- :mod:`~hypersonic_rle_kit_tpu.formats` — byte-exact host implementations of
  every reference bitstream format (golden/interop path).
- :mod:`~hypersonic_rle_kit_tpu.ops` — the XLA device compute path:
  run-scan encode, prefix-sum/expand decode over block-parallel grids.
- :mod:`~hypersonic_rle_kit_tpu.parallel` — the block container plus
  mesh/shard_map distribution (size all-gather, ordered reassembly).
- :mod:`~hypersonic_rle_kit_tpu.api` — user-facing compress/decompress.
"""

__version__ = "0.1.0"

from . import spec  # noqa: F401
from . import formats  # noqa: F401
