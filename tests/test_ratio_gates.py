"""Per-family compression-depth gates (VERDICT r3 task #3).

HRT1's deep layout (two-tier escape columns + block symbol dictionary,
parallel/container.py) must compress at least as well as the reference
format of each major family on the bench corpus.  r3 measured HRT1 losing
exactly where the reference's clever formats live (Packed 18.84% vs
17.63%, Low Entropy 18.85% vs 18.19%); these gates pin the fix.

Reference ratios come from our byte-exact format encoders (parity-tested
against the C library in test_*_format.py), so the comparison is honest
on any corpus.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hypersonic_rle_kit_tpu import api
from hypersonic_rle_kit_tpu.formats import registry

import bench

FAMILIES = ["8 Bit", "8 Bit Packed", "8 Bit 3LUT", "8 Bit 3LUT Short",
            "Low Entropy"]
# wide families gated via the byte-lane HRT1 pipeline vs their reference
# formats (VERDICT r4 #4): symbol-aligned and byte-aligned variants
WIDE = ["16 Bit (Symbol)", "16 Bit (Byte)", "32 Bit Packed (Byte)",
        "64 Bit (Symbol)", "64 Bit Packed (Byte)"]


def _corpus():
    return {
        "dct": bench.make_dataset(2).tobytes(),
        "bwt": bench.make_bwt_dataset(2).tobytes(),
        "random": bench.make_random_dataset(1).tobytes(),
    }


@pytest.fixture(scope="module")
def corpus():
    return _corpus()


@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("tag", ["dct", "bwt", "random"])
def test_hrt1_ratio_beats_reference_family(corpus, name, tag):
    payload = corpus[tag]
    hrt1 = len(api.compress(payload, name))
    ref = len(registry.compress(payload, name))
    # on incompressible data both formats pass bytes through; HRT1 pays a
    # 16-byte table entry per block where the reference pays one flat
    # header, so allow 0.05% there -- everywhere the families' techniques
    # actually bite, HRT1 must win outright
    slack = max(64, int(0.0005 * len(payload))) if tag == "random" else 0
    assert hrt1 <= ref + slack, (
        f"HRT1[{name}] on {tag}: {hrt1} bytes > reference format {ref}")


@pytest.mark.parametrize("name", WIDE)
def test_hrt1_wide_ratio_beats_reference_family(corpus, name):
    """Wide codecs decompose into byte lanes (api.hrt1_params); the
    byte-lane container must beat the symbol-aligned reference formats
    outright (measured: 13.7% vs 21.5% at 16-bit, 19.7% vs 36.2% at
    64-bit on the dct corpus).  The byte-aligned *Packed* wide formats
    (rleX_extreme_cpu_encode.h:114-164: partial-symbol tail matching
    with one command per multi-lane run) keep a bounded edge over the
    per-lane view, which fragments each 8-byte run into 8 single-lane
    commands: measured 19.05% vs 17.93% at 64-bit -- conceded up to 10%
    relative, gated so it cannot silently widen."""
    payload = corpus["dct"]
    hrt1 = len(api.compress(payload, name))
    ref = len(registry.compress(payload, name))
    slack = 1.10 if ("(Byte)" in name and "Packed" in name) else 1.0
    assert hrt1 <= ref * slack, (
        f"HRT1[{name}] on dct: {hrt1} bytes > reference format {ref}"
        f" (allowed x{slack})")


def test_sh_regime_priced():
    """The SH-recency regime (VERDICT r4 #8).  On *globally* skewed
    literals HRT1's per-block literal dictionary (container.FLAG_LITDICT)
    beats the reference base format outright; against the SH coder itself
    (rle_sh.c:62-91: an adaptive 3-symbol recency chain with 1-4 bit
    codes) HRT1 concedes on data whose literal distribution only makes
    sense through a *rolling* window, because per-block dictionaries
    adapt per block, not per byte.  The concession is bounded here:
    HRT1 must stay within 25% of SH's size on this corpus and beat the
    reference 8-bit base format."""
    payload = bench.make_sh_dataset(1).tobytes()
    hrt1 = len(api.compress(payload, "8 Bit"))
    sh = len(registry.compress(payload, "8 Bit RLE + Huffman-esque"))
    base = len(registry.compress(payload, "8 Bit"))
    assert hrt1 <= base, (hrt1, base)
    assert hrt1 <= sh * 1.25, (
        f"HRT1 {hrt1} vs SH {sh}: concession bound exceeded")


def test_deep_roundtrips_all_backends(corpus):
    payload = corpus["dct"]
    blob = api.compress(payload, "8 Bit")
    from hypersonic_rle_kit_tpu.parallel import container
    assert container.parse(blob)[0].deep
    for backend in ("auto", "device", "host"):
        assert api.decompress(blob, backend=backend) == payload


def test_incompressible_keeps_flat_layout(corpus):
    blob = api.compress(corpus["random"], "8 Bit")
    from hypersonic_rle_kit_tpu.parallel import container
    info = container.parse(blob)[0]
    assert not info.deep          # deep="auto" picks the smaller container
    assert api.decompress(blob) == corpus["random"]
