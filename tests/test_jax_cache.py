"""Where the persistent compilation cache lands (utils/jax_cache.py)."""

import os
import subprocess
import sys

import pytest

from hypersonic_rle_kit_tpu.utils import jax_cache

_PROBE = ("from hypersonic_rle_kit_tpu.utils import jax_cache; import jax; "
          "jax_cache.configure(); "
          "print(jax.config.jax_compilation_cache_dir)")


def _probe(env_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=root,
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize("env_dir", [None, "set"])
def test_cache_dir(env_dir, tmp_path):
    if env_dir is None:
        assert _probe(None) == str(jax_cache.CACHE_DIR)
        assert jax_cache.CACHE_DIR.name == ".jax_cache"
        assert (jax_cache.CACHE_DIR.parent / "hypersonic_rle_kit_tpu").is_dir()
    else:
        assert _probe(str(tmp_path)) == str(tmp_path)
