"""Each Hopper kernel's plain PyTorch version against the JAX Pallas kernel
it replaces, run as tests/test_pallas_kernels.py runs it on the CPU (Mosaic
interpret mode, at the same sizes), and against the JAX XLA reference.
Tolerance 0 throughout.

K1 fused_frontend_codes  vs fused_frontend_keys + reduce_keys_2x, and the
                            fast + harris + nms + encode_grid chain
K2 topk_keys             vs topk_keys, and np.sort
K3 gather_windows_packed vs gather_windows_packed, and the CPU branch of
                            patches.gather_patches_packed_s8
K4 orb_select            vs orb_select_bits and orb_select_bits_sorted, and
                            brief._orb_compute_packed_dense
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pislam_tpu.ops import brief as jbrief
from pislam_tpu.ops import fast as jfast
from pislam_tpu.ops import harris as jharris
from pislam_tpu.ops import nms as jnms
from pislam_tpu.ops import pallas_kernels as pk
from pislam_tpu.ops import patches as jpatches
from pislam_tpu_torch.ops import brief as tbrief
from pislam_tpu_torch.ops import kernels
from pislam_tpu_torch.utils import codec as tcodec
from torch_parity import image, t, textured_image

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------

def _border_mask(h, w, b=16):
    m = np.zeros((h, w), bool)
    m[b:h - b, b:w - b] = True
    return m


@functools.partial(jax.jit, static_argnums=(2, 3))
def _xla_encoded(img, mask, fast_t, harris_t):
    score = jharris.harris_score(img, harris_t, mask=jfast.fast_detect(img, fast_t))
    score = jnp.where(mask, score, jnp.uint8(0))
    scored = jnp.where(jnms.nms(score), score, jnp.uint8(0))
    return jnms.encode_grid(scored, scored > 0)


def _xla_code_grid(img, mask, fast_t, harris_t):
    """The XLA chain's u32 code grid, 2x2-max reduced (odd edges padded)."""
    enc = np.asarray(_xla_encoded(jnp.asarray(img), jnp.asarray(mask), fast_t,
                                  harris_t)).astype(np.int64)
    h, w = enc.shape
    enc = np.pad(enc, ((0, h % 2), (0, w % 2)))
    return enc.reshape(enc.shape[0] // 2, 2, enc.shape[1] // 2, 2).max(axis=(1, 3))


def _port_code_grid(img, mask, fast_t, harris_t):
    grid = kernels.fused_frontend_codes(t(img), t(mask.astype(np.uint8)), fast_t, harris_t)
    assert grid.dtype == torch.int32
    return tcodec.i32_to_u32(grid).numpy()


@pytest.mark.parametrize("h", [64, 72])   # 72: ragged against the 16-row blocks
def test_k1_vs_pallas_interpret(h):
    img = image(h, 256, 7)
    mask = _border_mask(h, 256)
    with pltpu.force_tpu_interpret_mode():
        keys = pk.fused_frontend_keys(jnp.asarray(img), jnp.asarray(
            pk.build_mask16(mask, pk.FUSED_NOUT)), 20, 1 << 10, pk.FUSED_NOUT)
    codes = np.asarray(pk.reduce_keys_2x(keys)).astype(np.int64)
    got = _port_code_grid(img, mask, 20, 1 << 10)
    assert got.shape == (h // 2, 128)
    assert np.count_nonzero(got) > 10
    assert np.array_equal(np.sort(codes[codes != 0]), np.sort(got[got != 0]))


@pytest.mark.parametrize("shape,fast_t,harris_t", [
    ((64, 256), 20, 1 << 10), ((72, 256), 20, 1 << 10),
    ((96, 160), 10, 1 << 8), ((61, 77), 10, 1 << 8), ((120, 300), 20, 1 << 15)])
def test_k1_vs_xla_chain(shape, fast_t, harris_t):
    """Codes and their positions on the reduced grid; the textured images
    carry a noise border."""
    img = image(*shape, 7) if shape[1] == 256 else textured_image(*shape, sum(shape))
    mask = _border_mask(*shape)
    want = _xla_code_grid(img, mask, fast_t, harris_t)
    got = _port_code_grid(img, mask, fast_t, harris_t)
    assert np.count_nonzero(want) > 0
    assert np.array_equal(want, got)


# ---------------------------------------------------------------------------
# K2
# ---------------------------------------------------------------------------

def _keys(n, nonzero, seed):
    rng = np.random.default_rng(seed)
    keys = np.full(n, pk.MIN_KEY, np.int32)
    nz = rng.choice(n, nonzero, replace=False)
    keys[nz] = rng.integers(-2**31 + 1, 2**31 - 1, nonzero).astype(np.int32)
    return keys


@pytest.mark.parametrize("n,k,nonzero", [(50_000, 512, 1500), (4096, 256, 1500),
                                         (300, 256, 150), (2000, 512, 100)])
def test_k2_vs_pallas_interpret(n, k, nonzero):
    keys = _keys(n, nonzero, n)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pk.topk_keys(jnp.asarray(keys), k))
    got = kernels.topk_keys(t(keys), k)
    assert got.dtype == torch.int32
    assert np.array_equal(want, got.numpy())
    assert np.array_equal(np.sort(keys)[::-1][:k], got.numpy())


@pytest.mark.parametrize("n,k", [(354_560, 2048), (76_800, 512), (1000, 300),
                                 (100, 256), (9000, 8192)])
def test_k2_vs_sort(n, k):
    """The main path's sizes, k not a power of two, and n < k."""
    keys = _keys(n, min(n // 2, 3000), k)
    expect = np.sort(np.concatenate([keys, np.full(k, pk.MIN_KEY, np.int32)]))[::-1][:k]
    assert np.array_equal(kernels.topk_keys(t(keys), k).numpy(), expect)


def test_k2_rejects_k_above_8192():
    with pytest.raises(ValueError):
        kernels.topk_keys(t(_keys(10_000, 10, 0)), 8193)


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------

def _keypoints(h, w, k, seed):
    rng = np.random.default_rng(seed)
    xs = rng.integers(16, w - 16, k).astype(np.int32)
    ys = rng.integers(16, h - 16, k).astype(np.int32)
    valid = rng.random(k) < 0.9
    xs[~valid] = rng.integers(-50, 5000, (~valid).sum())   # garbage coords
    return xs, ys, valid


GATHER_CASES = {
    "64x384": lambda: (image(64, 384, 1), *_keypoints(64, 384, 96, 1)),
    "48x768": lambda: (image(48, 768, 1), *_keypoints(48, 768, 64, 1)),
    "bottom_edge": lambda: (image(64, 384, 2),
                            np.array([40, 150, 260, 350, 16, 367], np.int32),
                            np.array([47, 46, 45, 44, 16, 47], np.int32),
                            np.ones(6, bool)),
    "invalid": lambda: (image(64, 384, 3),
                        np.array([0, -7, 5000, 100, 383], np.int32),
                        np.array([0, 63, -1, 4000, 30], np.int32),
                        np.zeros(5, bool)),
}


@pytest.mark.parametrize("case", GATHER_CASES)
def test_k3_vs_pallas_interpret(case):
    img, xs, ys, valid = GATHER_CASES[case]()
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pk.gather_windows_packed(
            jnp.asarray(img), jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(valid)))
    got = kernels.gather_windows_packed(t(img), t(xs), t(ys), t(valid))
    assert got.dtype == torch.int8 and got.shape == (len(xs), 1024)
    assert np.array_equal((want ^ 0x80).view(np.int8), got.numpy())


@pytest.mark.parametrize("case", GATHER_CASES)
def test_k3_vs_xla(case):
    img, xs, ys, valid = GATHER_CASES[case]()
    want = np.asarray(jpatches.gather_patches_packed_s8(
        jnp.asarray(img), jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(valid)))
    got = kernels.gather_windows_packed(t(img), t(xs), t(ys), t(valid))
    assert np.array_equal(want, got.numpy())


# ---------------------------------------------------------------------------
# K4
# ---------------------------------------------------------------------------

def _windows(seed, k=300):
    return np.random.default_rng(seed).integers(-128, 128, (k, 1024)).astype(np.int8)


def _port_orb(flat, words):
    ang, desc = kernels.orb_select(t(flat), *tbrief.OrbTables.build("cpu"), words)
    assert ang.dtype == torch.uint8 and desc.dtype == torch.int32
    return ang.numpy(), desc.numpy().view(np.uint32)


@pytest.mark.parametrize("variant", ["dense", "sorted"])
def test_k4_vs_pallas_interpret(variant):
    flat = _windows(7 if variant == "dense" else 17)
    fn = pk.orb_select_bits if variant == "dense" else pk.orb_select_bits_sorted
    with pltpu.force_tpu_interpret_mode():
        ang, bits = fn(jnp.asarray(flat), jnp.asarray(jbrief._gm_packed()))
    for words in (8, 4):
        got_ang, got_desc = _port_orb(flat, words)
        assert np.array_equal(np.asarray(ang), got_ang.astype(np.int32))
        assert np.array_equal(np.asarray(jbrief._pack_bits_u8(bits, words)), got_desc)


@pytest.mark.parametrize("words", [8, 4, 1])
def test_k4_vs_xla_dense(words):
    flat = _windows(27)
    eang, edesc = jbrief._orb_compute_packed_dense(jnp.asarray(flat), words)
    got_ang, got_desc = _port_orb(flat, words)
    assert np.array_equal(np.asarray(eang), got_ang)
    assert np.array_equal(np.asarray(edesc), got_desc)
    dang, ddesc = tbrief._orb_compute_packed_dense(t(flat), words)
    assert np.array_equal(dang.numpy(), got_ang)
    assert np.array_equal(ddesc.numpy().view(np.uint32), got_desc)
    for variant in ("dense", "sorted"):
        vang, vdesc = tbrief.orb_compute_packed(t(flat), words, variant)
        assert np.array_equal(vang.numpy(), got_ang)
        assert np.array_equal(vdesc.numpy().view(np.uint32), got_desc)
