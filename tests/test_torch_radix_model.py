"""Kernel F's algorithm (``tests/torch_radix_model.py``, a numpy model of
``csrc/radix_sort.cu``) against ``np.argsort(kind="stable")`` on the main
path's key families (``checks.radix_key_families``), at n = 1 and one
below and one above one and four tiles (1,024 keys each), at the main
path's 135,168 keys on 132 CTAs, and at sizes that need larger tiles and
more than one tile a CTA; and the model's digit width and chunk against
the kernel's build-time defaults. CPU only."""

import re
from pathlib import Path

import numpy as np
import pytest

from ground_fusion2_tpu_torch import checks

import torch_radix_model as model

CHUNK = model.CHUNK
SIZES = [1, CHUNK - 1, CHUNK + 1, 4 * CHUNK - 1, 4 * CHUNK + 1]
SOURCE = (Path(__file__).resolve().parents[1] / "ground_fusion2_tpu_torch"
          / "csrc" / "radix_sort.cu")


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("family", checks.RADIX_FAMILIES)
def test_model_matches_stable_argsort(family, n):
    keys, bits = checks.radix_key_families(n, seed=n)[family]
    want = np.argsort(keys, kind="stable")
    got = model.radix_argsort(keys, bits)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("chunk,max_ctas,n", [(512, 264, 9001),
                                              (CHUNK, 132, 135_168),
                                              (CHUNK, 4, 20_000),
                                              (CHUNK, 2, 40_001)])
@pytest.mark.parametrize("family", ["map_codes", "dist2", "hash_codes"])
def test_model_other_shapes(family, chunk, max_ctas, n):
    """Many CTAs (18 at 9,001 keys of 512), the main path's 132 CTAs of
    1,024 keys, tiles of 4,096 keys two a CTA (20,000 keys on 4 CTAs) and
    five a CTA (40,001 on 2)."""
    keys, bits = checks.radix_key_families(n, seed=7)[family]
    got = model.radix_argsort(keys, bits, chunk, max_ctas)
    np.testing.assert_array_equal(got, np.argsort(keys, kind="stable"))


def test_plan_spreads_keys_over_the_card():
    """Tiles of the chunk while they fit the card's CTAs, then larger
    tiles up to 4,096 keys, then more tiles a CTA: any n sorts."""
    assert model.plan(135_168, 31) == (132, 1024, 1, 4)
    assert model.plan(69_632, 31) == (68, 1024, 1, 4)
    assert model.plan(6, 6) == (1, 1024, 1, 1)
    assert model.plan(300_000, 1, max_ctas=132) == (118, 2560, 1, 1)
    assert model.plan(132 * 4096, 31, max_ctas=132) == (132, 4096, 1, 4)
    assert model.plan(132 * 4096 + 1, 31, max_ctas=132) == (67, 4096, 2, 4)
    assert model.plan(4_000_000, 31) == (245, 4096, 4, 4)
    assert [model.digit_of(p, 4, 31) for p in range(4)] == [
        (0, 255), (8, 255), (16, 255), (24, 127)]


def test_model_defaults_are_the_kernels():
    """The model's digit width and chunk are radix_sort.cu's defaults."""
    src = SOURCE.read_text()
    define = lambda name: int(re.search(rf"#define {name} (\d+)", src)[1])
    assert define("GF2_RADIX_BITS") == model.RADIX_BITS
    assert define("GF2_RADIX_CHUNK") == model.CHUNK
