"""Multi-chip / multi-host distribution of the block codec.

The reference has no inter-process communication at all (SURVEY.md section
2.4); its only parallel-decode notion is the `rle8m` subsection container
decoded by one OpenCL work-group per subsection (rle8_ocl.c:265-413).  The
device design scales the same shape out over a `jax.sharding.Mesh`:

- the uncompressed stream is split into fixed-size blocks; the block axis is
  sharded over the mesh ("block data parallelism", the long-stream analog of
  sequence parallelism);
- each device encodes/decodes its blocks independently (`shard_map`);
- per-block compressed sizes are exchanged with `all_gather` along the mesh
  axis, and an exclusive prefix sum over them yields every block's byte
  offset in the final container — the parallel analog of the reference's
  serial `index +=` bookkeeping and of the rle8m u32 offset table.

Everything here also runs on a CPU mesh via
``XLA_FLAGS=--xla_force_host_platform_device_count=N`` for tests.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import device as dev_ops
from ..ops.planar import PlanarBlocks

BLOCK_AXIS = "blocks"


def make_mesh(n_devices: int | None = None, axis: str = BLOCK_AXIS) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(devs, (axis,))


def _encode_local(x, block_len, *, capacity: int, min_count: int):
    pb = dev_ops.encode_blocks(x, block_len, capacity=capacity,
                               min_count=min_count)
    # serialized payload size of each block (bytes, bit-packed columns):
    # n_runs syms + bitpacked counts/lit_lens + literals (container.py layout)
    n_runs = pb.n_cmds - 1
    cnt_w = 32 - jax.lax.clz(jnp.maximum(
        jnp.max(pb.count, axis=1) - min_count, 0).astype(jnp.int32))
    lit_w = 32 - jax.lax.clz(jnp.max(pb.lit_len, axis=1).astype(jnp.int32))
    size = ((cnt_w * n_runs + 7) // 8 + (lit_w * pb.n_cmds + 7) // 8
            + n_runs + pb.n_lits)
    return pb, size


@functools.partial(jax.jit, static_argnames=("capacity", "min_count", "mesh"))
def pipeline_step(x, block_len, *, capacity: int, min_count: int, mesh: Mesh):
    """One full sharded compress->size-exchange->decompress step.

    ``x: [nb, B] uint8`` sharded over blocks; returns (decoded blocks, global
    per-block byte offsets, per-block compressed sizes).  This is the
    "training step" analog used by the multi-chip dry run.
    """

    def local(xs, ls):
        pb, size = _encode_local(xs, ls, capacity=capacity, min_count=min_count)
        # exchange sizes: every device learns all block sizes (all-gather over the interconnect)
        all_sizes = jax.lax.all_gather(size, BLOCK_AXIS, tiled=True)
        offsets = jnp.cumsum(all_sizes) - all_sizes   # exclusive prefix sum
        y = dev_ops.decode_blocks(pb)
        # my shard of the global offset table
        idx = jax.lax.axis_index(BLOCK_AXIS)
        nb_local = xs.shape[0]
        my_off = jax.lax.dynamic_slice_in_dim(offsets, idx * nb_local, nb_local)
        return y, my_off, size

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(BLOCK_AXIS), P(BLOCK_AXIS)),
        out_specs=(P(BLOCK_AXIS), P(BLOCK_AXIS), P(BLOCK_AXIS)),
    )(x, block_len)


@functools.partial(jax.jit, static_argnames=("capacity", "min_count", "mesh"))
def encode_sharded(x, block_len, *, capacity: int, min_count: int, mesh: Mesh):
    """Sharded encode with a sizes-only exchange.

    Each device encodes its shard of the block axis and **keeps its planar
    columns local** (returned still sharded over the mesh); only the
    per-block serialized sizes — a few bytes per block — cross the
    interconnect (`all_gather`), and every device derives the global offset
    table from them.  This is the multi-chip generalization of the
    reference's rle8m u32 offset table (rle8_low_entropy_cpu.c:126-191):
    O(n_blocks) metadata moves, never the O(total-stream) column data.
    Returns (PlanarBlocks sharded P(blocks), sizes, offsets) with the size
    and offset tables replicated.
    """

    def local(xs, ls):
        pb, size = _encode_local(xs, ls, capacity=capacity,
                                 min_count=min_count)
        all_sizes = jax.lax.all_gather(size, BLOCK_AXIS, tiled=True)
        offsets = jnp.cumsum(all_sizes) - all_sizes
        return pb, all_sizes, offsets

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(BLOCK_AXIS), P(BLOCK_AXIS)),
        out_specs=(jax.tree.map(lambda _: P(BLOCK_AXIS), PlanarBlocks(
            *[0] * 7)), P(), P()),
        # size/offset tables are tiled all_gathers => replicated by
        # construction; the static varying-axes checker cannot infer that
        check_vma=False,
    )(x, block_len)


def serialize_local_blocks(pb, min_count: int = 6,
                           deep: bool | str = "auto"
                           ) -> tuple[dict[int, tuple], int]:
    """Serialize only the blocks addressable on this process.

    Returns ``({block_index: (table_entry, payload_bytes)}, flags)`` —
    each host ships its parts plus indices out of band (files, an object
    store, DCN), and :func:`container.assemble` (given the same ``flags``)
    stitches them in block order.  Column data never crosses hosts through
    the mesh; what *does* cross is one tiny collective of summable width
    statistics (``container.two_tier_stats``, ~70 ints per host) so every
    host picks the identical container-uniform bit widths and deep/flat
    decision — the assembled bytes equal the single-process
    ``api.compress`` serialization exactly.
    """
    import numpy as np
    from . import container

    cols = (pb.sym, pb.count, pb.lit_len, pb.lits, pb.n_cmds, pb.n_lits)
    shard_sets = [c.addressable_shards for c in cols]
    local = []                          # (block_index, per-block arrays)
    for shards in zip(*shard_sets):
        b0 = shards[0].index[0].start or 0
        arrs = [np.asarray(s.data) for s in shards]
        for j in range(arrs[0].shape[0]):
            local.append((b0 + j, tuple(a[j] for a in arrs[:4]),
                          int(arrs[4][j]), int(arrs[5][j])))

    # local width statistics, summed across hosts (the only communication)
    pooled_c = np.concatenate(
        [blk[1][1][:max(nc - 1, 0)].astype(np.int64) - min_count
         for blk, nc in ((b, b[2]) for b in local)] or [np.zeros(0, np.int64)])
    pooled_l = np.concatenate(
        [blk[1][2][:nc].astype(np.int64)
         for blk, nc in ((b, b[2]) for b in local)] or [np.zeros(0, np.int64)])
    cn, cmax, cge = container.two_tier_stats(pooled_c)
    ln, lmax, lge = container.two_tier_stats(pooled_l)
    lcosts = container.litdict_costs(
        [blk[1][3][:blk[3]] for blk in local])      # summable, 7 ints
    stats = np.concatenate([[cn, cmax], cge, [ln, lmax], lge,
                            lcosts]).astype(np.int64)
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        allstats = np.asarray(multihost_utils.process_allgather(stats))
        summed = allstats.sum(axis=0)
        # maxima must combine as max, not sum
        summed[1] = allstats[:, 1].max()
        summed[36] = allstats[:, 36].max()
        stats = summed
    cn, cmax, cge = int(stats[0]), int(stats[1]), stats[2:35]
    ln, lmax, lge = int(stats[35]), int(stats[36]), stats[37:70]
    lit_k = int(np.argmin(stats[70:77])) + 2
    widths = (container.widths_from_stats(cn, cmax, cge)
              + container.widths_from_stats(ln, lmax, lge))
    flat_cb = container._width_for(cmax)
    flat_lb = container._width_for(lmax)

    flat_parts, deep_parts, ld_parts = {}, {}, {}
    flat_sz = deep_sz = ld_sz = 0
    for b, (sym_b, cnt_b, ll_b, lits_b), nc, nl in local:
        fp = container.block_payload(sym_b, cnt_b, ll_b, lits_b, nc, nl,
                                     min_count, flat_cb, flat_lb)
        flat_parts[b] = fp
        flat_sz += len(fp[1])
        if deep:
            dp = container.block_payload_deep(sym_b, cnt_b, ll_b, lits_b,
                                              nc, nl, min_count, widths)
            deep_parts[b] = dp
            deep_sz += len(dp[1])
            lp = container.block_payload_deep(sym_b, cnt_b, ll_b, lits_b,
                                              nc, nl, min_count, widths,
                                              lit_k=lit_k)
            ld_parts[b] = lp
            ld_sz += len(lp[1])
    if deep:
        # three-way layout vote: a few summed ints over DCN, exactly like
        # the width stats -- every host picks the same flat/deep/litdict
        # winner so the assembled bytes equal api.compress byte-for-byte
        sizes = np.array([flat_sz, deep_sz, ld_sz], np.int64)
        if jax.process_count() > 1:
            from jax.experimental import multihost_utils
            sizes = np.asarray(
                multihost_utils.process_allgather(sizes)).sum(axis=0)
        fs, ds, ls = int(sizes[0]), int(sizes[1]), int(sizes[2])
        if deep is True:
            return ((ld_parts, container.FLAG_DEEP | container.FLAG_LITDICT)
                    if ls < ds else (deep_parts, container.FLAG_DEEP))
        best = min((fs, ds, ls))
        if best == fs:
            return flat_parts, 0
        if best == ds:
            return deep_parts, container.FLAG_DEEP
        return ld_parts, container.FLAG_DEEP | container.FLAG_LITDICT
    return flat_parts, 0


def compress_distributed(data, mesh: Mesh, *,
                         block_size: int = 1 << 16,
                         min_count: int = 6,
                         codec_index: int = 0) -> bytes:
    """Compress a byte stream to HRT1 with the block axis sharded over
    ``mesh``; the output bytes are identical to the single-device
    ``api.compress`` serialization (ordered all-gather + ragged host trim)."""
    import numpy as np
    from ..ops import planar
    from . import container

    arr = (np.frombuffer(memoryview(data), np.uint8)
           if not isinstance(data, np.ndarray) else data.reshape(-1))
    n = arr.size
    n_dev = mesh.devices.size
    nb = max(1, -(-n // block_size))
    nb = -(-nb // n_dev) * n_dev          # pad block count to the mesh size
    padded = np.zeros(nb * block_size, np.uint8)
    padded[:n] = arr
    lens = np.zeros(nb, np.int32)
    full = n // block_size
    lens[:full] = block_size
    if n - full * block_size:
        lens[full] = n - full * block_size
    cap = planar.capacity_for(block_size, min_count)
    pb, sizes, _ = encode_sharded(
        jnp.asarray(padded.reshape(nb, block_size)), jnp.asarray(lens),
        capacity=cap, min_count=min_count, mesh=mesh)
    # ragged trim happens in the serializer (n_cmds/n_lits bound each block);
    # drop all-padding blocks (len 0 => 1 empty tail command) at the end
    real_nb = max(1, -(-n // block_size))
    cols = [np.asarray(v)[:real_nb] for v in
            (pb.sym, pb.count, pb.lit_len, pb.lits, pb.n_cmds, pb.n_lits)]
    return container.serialize_blocks(codec_index, n, block_size, min_count,
                                      *cols)


def initialize_multihost(coordinator: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None) -> None:
    """Multi-host runtime init (`jax.distributed.initialize`); DCN only
    carries the size exchange and the final ordered concatenation.
    Exercised by tests/test_multiprocess.py on a 2-process CPU mesh."""
    if coordinator is not None or jax.process_count() > 1:
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id)
