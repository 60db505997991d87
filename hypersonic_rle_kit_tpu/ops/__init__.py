"""Device compute path: XLA encode/decode.

The reference's SIMD kernel layer (rleX_extreme_common.h, bitpack.h) maps here:
hand-written x86 intrinsics become data-parallel array programs, and the
scalar command loops become prefix-sum, gather and scatter formulations
that XLA compiles for the device.

Modules:
    planar              columnar command IR + host goldens
    device              XLA block encode/expand (batched, shard_map-safe)
    unpack_device       container payload sections -> bit-unpack -> expand
    ref_device          reference-format streams -> planar -> device decode
    bitpack             1/2/3/4-bit pack/unpack (bitpack.h analog)
    mmtf_device         MMTF 128/256 + Bit-MMTF transforms on device
    low_entropy_device  Low Entropy / rle8m device decode (OpenCL analog)
"""
