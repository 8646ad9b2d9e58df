"""``kernels.orb_describe_dense`` (the dense-BRIEF path's describe stage:
K3's window gather, then K4d's bin-grouped product) and the product's rule
for which keypoints a block takes, on the CPU, tolerance 0:

- its plain version against the JAX package's dense branch
  (pislam_tpu/frontend.py:117-124: ``gather_windows_packed`` ->
  ``orb_select_bits`` in Mosaic interpret mode, as
  tests/test_torch_kernels_plain.py runs K3 and K4d, then
  ``_pack_bits_u8`` and the masks by valid) on K3's gather cases, codes that
  decode outside the image, K = 1, every keypoint invalid, a random gm and a
  skew where every window is the same (one bin), at 8, 4 and 1 words;
- K = 0;
- ``dense_tiles`` (the product kernel's rule in plain torch): every
  keypoint of a bin is owned by exactly one (bin, tile), in index order,
  and the tiles fit the grid, for one-bin, 30-singleton and random
  histograms up to K = 8192 (``MAX_TOPK``).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pislam_tpu.ops import brief as jbrief
from pislam_tpu.ops import pallas_kernels as pk
from pislam_tpu_torch.ops import brief as tbrief
from pislam_tpu_torch.ops import kernels
from test_torch_orb_describe import CASES as GATHER_CASES
from test_torch_orb_describe import _codes
from torch_parity import image, t

torch.set_num_threads(1)


def _one_bin_case():
    """Every keypoint at the same (x, y): one window, so one bin."""
    k = 40
    return (image(64, 384, 6), np.full(k, 200, np.int32), np.full(k, 30, np.int32),
            np.ones(k, bool))


def _single_case():
    return image(64, 384, 7), np.array([100], np.int32), np.array([33], np.int32), \
        np.ones(1, bool)


def _all_invalid_case():
    img, xs, ys, _ = GATHER_CASES["64x384"]()
    return img, xs, ys, np.zeros(len(xs), bool)


CASES = {**GATHER_CASES, "one bin": _one_bin_case, "K=1": _single_case,
         "all invalid": _all_invalid_case}
# every case with brief's weights, three with a random gm
CASE_GMS = [(case, "brief") for case in CASES] + [
    (case, "random") for case in ("64x384", "bottom_edge", "one bin")]


def _gm(name):
    if name == "brief":
        return jbrief._gm_packed()
    return np.random.default_rng(5).integers(-128, 128, (1024, pk.ORB_GCOLS)).astype(np.int8)


@functools.lru_cache(maxsize=None)
def _jax_dense(case, gm_name):
    """The JAX package's dense branch on the decoded codes: ((K,) uint8
    angles masked by valid, (K, 256) uint8 bits), and the inputs."""
    img, xs, ys, valid = CASES[case]()
    codes = _codes(xs, ys, valid, len(xs))
    gm = _gm(gm_name)
    jx = jnp.asarray((codes >> 12) & 0xFFF, jnp.int32)
    jy = jnp.asarray(codes & 0xFFF, jnp.int32)
    with pltpu.force_tpu_interpret_mode():
        win = pk.gather_windows_packed(jnp.asarray(img), jx, jy, jnp.asarray(valid))
        flat = (win ^ jnp.uint8(0x80)).astype(jnp.int8)
        ang, bits = pk.orb_select_bits(flat, jnp.asarray(gm))
    ang = np.where(valid, np.asarray(ang).astype(np.uint8), 0).astype(np.uint8)
    return ang, np.asarray(bits), (img, codes, valid, gm)


@pytest.mark.parametrize("words", [8, 4, 1])
@pytest.mark.parametrize("case,gm_name", CASE_GMS)
def test_orb_describe_dense_vs_pallas_interpret(case, gm_name, words):
    want_ang, bits, (img, codes, valid, gm) = _jax_dense(case, gm_name)
    want = np.asarray(jbrief._pack_bits_u8(jnp.asarray(bits), words))
    want = np.where(valid[:, None], want, np.uint32(0))
    ang, desc = kernels.orb_describe_dense(t(img), t(codes), t(valid), t(gm), words)
    assert ang.dtype == torch.uint8 and desc.dtype == torch.int32
    assert desc.shape == (len(codes), words)
    assert np.array_equal(ang.numpy(), want_ang)
    assert np.array_equal(desc.numpy().view(np.uint32), want)
    if valid.any():
        assert desc[t(valid)].any()
    if case == "one bin":
        assert len(set(want_ang.tolist())) == 1


@pytest.mark.parametrize("case", ["64x384", "bottom_edge", "outside"])
def test_orb_describe_dense_equals_orb_describe(case):
    """The dense variant's angles and words are the sorted path's."""
    _, _, (img, codes, valid, gm) = _jax_dense(case, "brief")
    dense = kernels.orb_describe_dense(t(img), t(codes), t(valid), t(gm), 8)
    sorted_ = kernels.orb_describe(t(img), t(codes), t(valid),
                                   *tbrief.OrbTables.build("cpu"), 8)
    for a, b in zip(dense, sorted_):
        assert torch.equal(a, b)


def test_orb_describe_dense_no_keypoints():
    ang, desc = kernels.orb_describe_dense(
        t(image(64, 384, 1)), torch.zeros(0, dtype=torch.int64),
        torch.zeros(0, dtype=torch.bool), tbrief.dense_weights("cpu"), 8)
    assert ang.shape == (0,) and desc.shape == (0, 8)


def _histogram_keys(kind, k, seed):
    rng = np.random.default_rng(seed)
    if kind == "one bin":
        return np.full(k, 17)
    if kind == "30 singletons":
        keys = np.full(k, 255)                      # the rest: no block takes them
        keys[rng.choice(k, 30, replace=False)] = np.arange(30)
        return keys
    keys = rng.integers(0, 30, k)
    keys[rng.random(k) < 0.1] = 255                 # invalid keypoints
    return keys


@pytest.mark.parametrize("tile", [16, 32, 64])
@pytest.mark.parametrize("kind,k", [("one bin", 8192), ("one bin", 1), ("30 singletons", 30),
                                    ("30 singletons", 8192), ("random", 8192),
                                    ("random", 513), ("random", 2)])
def test_dense_tiles_own_every_keypoint_once(kind, k, tile):
    keys = _histogram_keys(kind, k, k + tile)
    members, bins = kernels.dense_tiles(torch.as_tensor(keys), tile)
    assert members.shape == (-(-k // tile) + 29, tile)
    taken = members[members >= 0]
    want = np.nonzero(keys < 30)[0]
    assert torch.equal(taken.sort().values, torch.as_tensor(want))   # each exactly once
    for j in range(members.shape[0]):
        row = members[j][members[j] >= 0]
        if bins[j] < 0:
            assert row.numel() == 0
            continue
        assert row.numel() > 0 and bool((torch.as_tensor(keys)[row] == bins[j]).all())
        assert bool((row[1:] > row[:-1]).all())                      # index order
    n = int((bins >= 0).sum())                                       # tiles first, then none
    assert bool((bins[:n] >= 0).all()) and not bool((bins[n:] >= 0).any())
