"""``kernels.orb_describe`` (K3's window gather and K4's sorted BRIEF in one
launch, codes to masked angles and descriptors) and the frontend's wiring of
it, on the CPU, tolerance 0:

- its plain version against the JAX package's ``gather_windows_packed`` ->
  ``orb_select_bits_sorted`` in Mosaic interpret mode (as
  tests/test_torch_kernels_plain.py runs K3 and K4), masked by valid as the
  JAX frontend masks them, on K3's gather cases (invalid and edge keypoints)
  and codes that decode outside the image, at 8, 4 and 1 words;
- ``_extract_impl`` against the JAX extraction on a committed frame, for
  the fused (K1) and unfused (K6) branches and both BRIEF variants;
- which kernels each branch and variant calls: ``orb_describe`` alone on
  the sorted path, ``orb_describe_dense`` alone on the dense one.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import pislam_tpu_torch
from pislam_tpu.ops import brief as jbrief
from pislam_tpu.ops import pallas_kernels as pk
from pislam_tpu_torch.ops import brief as tbrief
from pislam_tpu_torch.ops import kernels
from pislam_tpu_torch.ops.pyramid import build_pyramid
from test_torch_kernels_plain import GATHER_CASES
from torch_parity import (assert_features_equal, eval_config, eval_frames, image,
                          jax_build_pyramid, jax_extract_fn, port_config, t)

torch.set_num_threads(1)


def _outside_case():
    """Valid codes whose (x, y) decode anywhere in [0, 4095]^2, most of them
    outside the 64x384 image, and the clip limits themselves."""
    rng = np.random.default_rng(11)
    xs = np.concatenate([[0, 15, 16, 367, 368, 383, 4095, 4095],
                         rng.integers(0, 4096, 40)]).astype(np.int32)
    ys = np.concatenate([[0, 15, 47, 16, 48, 63, 0, 4095],
                         rng.integers(0, 4096, 40)]).astype(np.int32)
    return image(64, 384, 5), xs, ys, np.ones(len(xs), bool)


CASES = {**GATHER_CASES, "outside": _outside_case}


def _codes(xs, ys, valid, seed):
    """u32 codes score << 24 | x << 12 | y of 12-bit coordinates (a negative
    or large x wraps, as a code would hold it); invalid keypoints alternate
    between code 0 and a stale nonzero code."""
    rng = np.random.default_rng(seed)
    score = rng.integers(1, 256, len(xs)).astype(np.int64)
    codes = (score << 24) | ((xs.astype(np.int64) & 0xFFF) << 12) | (ys.astype(np.int64) & 0xFFF)
    codes[~valid & (np.arange(len(xs)) % 2 == 0)] = 0
    return codes


@functools.lru_cache(maxsize=None)
def _jax_describe(case):
    """The JAX package's K3 -> K4 (sorted) on the decoded codes, masked by
    valid: ((K,) uint8 angles, (K, 256) uint8 bits), and the inputs."""
    img, xs, ys, valid = CASES[case]()
    codes = _codes(xs, ys, valid, len(xs))
    jx = jnp.asarray((codes >> 12) & 0xFFF, jnp.int32)
    jy = jnp.asarray(codes & 0xFFF, jnp.int32)
    with pltpu.force_tpu_interpret_mode():
        win = pk.gather_windows_packed(jnp.asarray(img), jx, jy, jnp.asarray(valid))
        flat = (win ^ jnp.uint8(0x80)).astype(jnp.int8)
        ang, bits = pk.orb_select_bits_sorted(flat, jnp.asarray(jbrief._gm_packed()))
    ang = np.where(valid, np.asarray(ang), 0).astype(np.uint8)
    return ang, np.asarray(bits), (img, codes, valid)


@pytest.mark.parametrize("words", [8, 4, 1])
@pytest.mark.parametrize("case", CASES)
def test_orb_describe_vs_pallas_interpret(case, words):
    want_ang, bits, (img, codes, valid) = _jax_describe(case)
    want = np.asarray(jbrief._pack_bits_u8(jnp.asarray(bits), words))
    want = np.where(valid[:, None], want, np.uint32(0))
    ang, desc = kernels.orb_describe(t(img), t(codes), t(valid),
                                     *tbrief.OrbTables.build("cpu"), words)
    assert ang.dtype == torch.uint8 and desc.dtype == torch.int32
    assert desc.shape == (len(codes), words)
    assert np.array_equal(ang.numpy(), want_ang)
    assert np.array_equal(desc.numpy().view(np.uint32), want)
    if valid.any():
        assert desc[t(valid)].any()


def test_orb_describe_no_keypoints():
    ang, desc = kernels.orb_describe(t(image(64, 384, 1)), torch.zeros(0, dtype=torch.int64),
                                     torch.zeros(0, dtype=torch.bool),
                                     *tbrief.OrbTables.build("cpu"), 8)
    assert ang.shape == (0,) and desc.shape == (0, 8)


BRANCHES = [pytest.param(fused, variant, id=f"{'fused' if fused else 'unfused'}-{variant}")
            for fused in (True, False) for variant in ("sorted", "dense")]


def _cfg(fused, variant):
    jcfg = eval_config()
    return dataclasses.replace(jcfg, frontend=dataclasses.replace(
        jcfg.frontend, fused_upstream=fused, brief_variant=variant))


@pytest.mark.parametrize("fused,variant", BRANCHES)
def test_extract_impl_vs_jax(fused, variant):
    """A committed frame through each branch and BRIEF variant: the port's
    Features equal the JAX package's."""
    jcfg = _cfg(fused, variant)
    frame = eval_frames()[21]
    jpyr = np.asarray(jax_build_pyramid(jnp.asarray(frame), jcfg.pyramid))
    tpyr = build_pyramid(t(frame), port_config(jcfg).pyramid)
    assert np.array_equal(jpyr, tpyr.numpy())
    tf = pislam_tpu_torch.make_extract_fn(port_config(jcfg), device="cpu")(tpyr)
    assert_features_equal(jax_extract_fn(jcfg)(jnp.asarray(jpyr)), tf)
    assert int(tf.num_valid) > 300


class _Spy:
    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args):
        self.calls += 1
        return self.fn(*args)


@pytest.mark.parametrize("fused,variant", BRANCHES)
def test_extract_calls_orb_describe_on_the_sorted_path(fused, variant):
    """The sorted path calls orb_describe once and neither K3 nor K4; the
    dense one orb_describe_dense once and neither K3, K4d nor orb_describe;
    both give the default path's Features."""
    spies = kernels.KernelSet(*(_Spy(fn) for fn in kernels.PLAIN))
    cfg = port_config(_cfg(fused, variant))
    pyr = build_pyramid(t(eval_frames()[2]), cfg.pyramid)
    got = pislam_tpu_torch.OrbExtractor(cfg, ops=spies)(pyr)
    calls = {name: spy.calls for name, spy in zip(kernels.KernelSet._fields, spies)}
    sorted_path = variant == "sorted"
    assert calls["orb_describe"] == int(sorted_path)
    assert calls["orb_describe_dense"] == int(not sorted_path)
    assert calls["gather_windows_packed"] == calls["orb_select_bits"] == 0
    assert calls["orb_select"] == 0
    assert calls["fused_frontend_codes"] == int(fused)
    assert calls["reduce_codes_4x"] == int(not fused)
    want = pislam_tpu_torch.make_extract_fn(port_config(eval_config()), device="cpu")(pyr)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
