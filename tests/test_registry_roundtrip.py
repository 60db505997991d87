"""Every codec of the registry round-trips through the HRT1 container on
the device: api.compress -> api.decompress(backend="device")."""

import numpy as np
import pytest

from hypersonic_rle_kit_tpu import api, spec

_rng = np.random.default_rng(21)
_DATA = _rng.integers(0, 4, 20_011, dtype=np.uint8)
_DATA[_rng.random(_DATA.size) < 0.6] = 0
PAYLOAD = _DATA.tobytes()


@pytest.mark.parametrize("index", range(len(spec.REGISTRY)),
                         ids=[cs.name for cs in spec.REGISTRY])
def test_hrt1_roundtrip(index):
    blob = api.compress(PAYLOAD, index)
    assert api.decompress(blob, backend="device") == PAYLOAD
