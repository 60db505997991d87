import os
import sys

import pytest

# Tests run on the CPU backend with a virtual 8-device mesh so sharding and
# multi-device code paths are exercised without a GPU (SURVEY.md section 4).
# HSRK_GPU_LANE=1 keeps the ambient GPU backend instead, for the
# @pytest.mark.gpu lane on a machine with a card:
#     HSRK_GPU_LANE=1 python -m pytest -m gpu tests/
GPU_LANE = os.environ.get("HSRK_GPU_LANE") == "1"
if not GPU_LANE:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from hypersonic_rle_kit_tpu.utils import jax_cache  # noqa: E402

jax_cache.configure()
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.3")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")

import jax  # noqa: E402

if not GPU_LANE and jax.config.jax_platforms != "cpu":
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu():
    """The first GPU device.  Decided here, at run time, so every test
    worker collects the same tests.  Without a GPU the test skips on the
    CPU run and fails in the GPU lane, so a lane that found no card (for
    example JAX falling back to the CPU) never passes as all-skipped."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        msg = f"needs a GPU (JAX default device: {devs[0].platform})"
        if GPU_LANE:
            pytest.fail(f"HSRK_GPU_LANE=1 but JAX found no GPU: {msg}")
        pytest.skip(f"{msg}; run with HSRK_GPU_LANE=1 on a machine with a "
                    "card")
    return devs[0]
