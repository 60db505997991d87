"""Multi-host runtime test: 2 processes x 4 virtual CPU devices.

Spawns two subprocesses that `jax.distributed.initialize` against a local
coordinator, build one global 8-device mesh, run the sharded
encode->size-exchange pipeline, serialize ONLY their local blocks
(dist.serialize_local_blocks), and ship parts through files.  The parent
assembles the parts in block order (container.assemble) and checks byte
equality with a single-process `api.compress` — the multi-host version of
the rle8m offset-table container (SURVEY.md section 4's prescribed
multi-process CPU-mesh test)."""

import os
import pickle
import socket
import subprocess
import sys
import tempfile

import numpy as np
import pytest

B = 1024
NB = 16
SEED = 123

_WORKER = r"""
import os, pickle, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
if jax.config.jax_platforms != "cpu":
    jax.config.update("jax_platforms", "cpu")
import numpy as np

coord, pid, outdir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
from hypersonic_rle_kit_tpu.parallel import dist
dist.initialize_multihost(coordinator=coord, num_processes=2, process_id=pid)
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 8, len(jax.devices())

import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from hypersonic_rle_kit_tpu.ops import planar

B, NB, SEED = %(B)d, %(NB)d, %(SEED)d
rng = np.random.default_rng(SEED)
x = rng.integers(0, 5, (NB, B), dtype=np.uint8)
x[:, ::3] = 0
lens = np.full(NB, B, np.int32)

mesh = dist.make_mesh()
sh = NamedSharding(mesh, P(dist.BLOCK_AXIS))
gx = jax.make_array_from_process_local_data(sh, x[pid * NB // 2:(pid + 1) * NB // 2])
gl = jax.make_array_from_process_local_data(
    sh, lens[pid * NB // 2:(pid + 1) * NB // 2])
cap = planar.capacity_for(B, 6)
pb, sizes, offsets = dist.encode_sharded(gx, gl, capacity=cap, min_count=6,
                                         mesh=mesh)

# bytes-on-wire accounting for the DCN path (VERDICT r4 #10): the only
# cross-host collectives during serialization are the summable width
# statistics and the flat/deep size vote -- O(1), never column data
from jax.experimental import multihost_utils as _mhu
_orig_ag = _mhu.process_allgather
_WIRE = [0]
def _counting_ag(x, *a, **k):
    _WIRE[0] += np.asarray(x).nbytes
    return _orig_ag(x, *a, **k)
_mhu.process_allgather = _counting_ag
parts, flags = dist.serialize_local_blocks(pb, min_count=6)
_mhu.process_allgather = _orig_ag
assert _WIRE[0] <= 1024, f"serialization moved {_WIRE[0]} bytes over DCN"

# and the in-mesh size exchange (which crosses the host boundary in this
# 2-process global mesh) carries O(n_blocks) metadata
import re
hlo = dist.encode_sharded.lower(gx, gl, capacity=cap, min_count=6,
                                mesh=mesh).as_text()
wire = 0
for m in re.finditer(
        r'"stablehlo\.all_(?:gather|reduce)"[^:]*:[^)]*\)\s*->\s*'
        r'tensor<([0-9x]*)x?([a-z0-9]+)>', hlo):
    dims, dt = m.group(1), m.group(2)
    elems = 1
    for d in filter(None, dims.split("x")):
        elems *= int(d)
    wire += elems * {"i32": 4, "ui32": 4, "i64": 8, "f32": 4,
                     "i8": 1, "ui8": 1, "i1": 1}.get(dt, 4)
assert 0 < wire <= 16 * NB, f"collectives move {wire} bytes for {NB} blocks"
print("WIRE_OK", _WIRE[0], wire, flush=True)
# (the in-mesh sizes exchange models the flat per-block layout; the
# serializer's global width/deep choice may pack tighter, so sizes are an
# upper-bound shipping plan, not asserted equal)
with open(os.path.join(outdir, f"part{pid}.pkl"), "wb") as f:
    pickle.dump({"parts": parts, "flags": flags}, f)
print("WORKER_OK", pid, len(parts), "flags", flags, flush=True)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_cpu_mesh(tmp_path):
    coord = f"localhost:{_free_port()}"
    script = tmp_path / "worker.py"
    script.write_text(_WORKER % dict(B=B, NB=NB, SEED=SEED))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
        + env.get("PYTHONPATH", "").split(os.pathsep))
    procs = [subprocess.Popen(
        [sys.executable, str(script), coord, str(i), str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multi-process worker timed out")
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"WORKER_OK {i}" in out, out[-2000:]
        assert "WIRE_OK" in out, out[-2000:]

    # ordered assembly from both hosts' parts == single-process container:
    # the tiny width-stats collective makes every host pick identical
    # container-uniform widths and the same deep/flat layout, so the
    # assembled bytes match api.compress exactly
    parts: dict[int, tuple] = {}
    flags = set()
    for i in range(2):
        with open(tmp_path / f"part{i}.pkl", "rb") as f:
            got = pickle.load(f)
        parts.update(got["parts"])
        flags.add(got["flags"])
    assert sorted(parts) == list(range(NB))
    assert len(flags) == 1, flags

    from hypersonic_rle_kit_tpu import api
    from hypersonic_rle_kit_tpu.parallel import container
    rng = np.random.default_rng(SEED)
    x = rng.integers(0, 5, (NB, B), dtype=np.uint8)
    x[:, ::3] = 0
    payload = x.reshape(-1).tobytes()
    blob = container.assemble(0, NB * B, B, [parts[b] for b in range(NB)],
                              flags=flags.pop())
    assert blob == api.compress(payload, block_size=B, backend="device")
    assert api.decompress(blob, backend="device") == payload
