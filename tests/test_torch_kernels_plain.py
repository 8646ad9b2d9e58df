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
K6 reduce_codes_4x       vs reduce_codes_4x (its rows un-permuted), and
                            encode_grid + a 2x2 max
K4d orb_select_bits      vs orb_select_bits, with the real and a random gm
K3c realign_windows      vs realign_windows over every psi and phi, and
                            pack_row_strips vs pack_row_strips
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
from pislam_tpu_torch.ops import nms as tnms
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


# ---------------------------------------------------------------------------
# K6
# ---------------------------------------------------------------------------

def _survivor_grid(h, w, n, seed):
    """A sparse scored grid with NMS's at most one survivor per 2x2 block,
    placed anywhere in its block."""
    rng = np.random.default_rng(seed)
    scored = np.zeros((h, w), np.uint8)
    blocks = rng.choice((h // 2) * (w // 2), n, replace=False)
    ys = 2 * (blocks // (w // 2)) + rng.integers(0, 2, n)
    xs = 2 * (blocks % (w // 2)) + rng.integers(0, 2, n)
    scored[ys, xs] = rng.integers(1, 256, n).astype(np.uint8)
    return scored


def _unpermute_rows(red):
    """The JAX kernel's output row i < H/4 is true row 2i, row H/4 + i is
    true row 2i + 1 (pallas_kernels.py:932-933, 965)."""
    h4 = red.shape[0] // 2
    out = np.empty_like(red)
    out[0::2], out[1::2] = red[:h4], red[h4:]
    return out


@pytest.mark.parametrize("shape,n", [((64, 256), 120), ((800, 384), 3000)])
def test_k6_vs_pallas_interpret(shape, n):
    scored = _survivor_grid(*shape, n, shape[0])
    with pltpu.force_tpu_interpret_mode():
        red = np.asarray(pk.reduce_codes_4x(jnp.asarray(scored)))
    got = kernels.reduce_codes_4x(t(scored))
    assert got.dtype == torch.int32 and got.shape == (shape[0] // 2, shape[1] // 2)
    assert np.array_equal(_unpermute_rows(red), got.numpy().view(np.uint32))
    assert np.count_nonzero(red) == n


@pytest.mark.parametrize("shape", [(64, 256), (61, 77), (800, 384)])
def test_k6_vs_xla_encode(shape):
    """The XLA encode_grid's codes, 2x2-max reduced (odd edges padded)."""
    scored = _survivor_grid(shape[0] - shape[0] % 2, shape[1] - shape[1] % 2, 100, 1)
    scored = np.pad(scored, ((0, shape[0] % 2), (0, shape[1] % 2)))
    scored[-1, -1] = 7                  # a survivor on the ragged corner
    enc = np.asarray(jnms.encode_grid(jnp.asarray(scored), jnp.asarray(scored > 0)))
    enc = np.pad(enc.astype(np.int64), ((0, shape[0] % 2), (0, shape[1] % 2)))
    want = enc.reshape(enc.shape[0] // 2, 2, enc.shape[1] // 2, 2).max(axis=(1, 3))
    got = tcodec.i32_to_u32(kernels.reduce_codes_4x(t(scored))).numpy()
    assert np.array_equal(want, got)


def test_k6_selection_vs_jax():
    """select_topk_scored (K6 then K2) against the JAX package's own."""
    scored = _survivor_grid(800, 384, 3000, 9)
    codes, valid = tnms.select_topk_scored(t(scored), 512)
    jcodes, jvalid = jnms.select_topk_scored(jnp.asarray(scored), 512)
    assert np.array_equal(codes.numpy(), np.asarray(jcodes).astype(np.int64))
    assert np.array_equal(valid.numpy(), np.asarray(jvalid))


# ---------------------------------------------------------------------------
# K4d
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gm", ["brief", "random"])
def test_k4d_vs_pallas_interpret(gm):
    flat = _windows(37, k=256)
    if gm == "brief":
        g = jbrief._gm_packed()
    else:
        g = np.random.default_rng(5).integers(-128, 128, (1024, pk.ORB_GCOLS)).astype(np.int8)
    with pltpu.force_tpu_interpret_mode():
        ang, bits = pk.orb_select_bits(jnp.asarray(flat), jnp.asarray(g))
    got_ang, got_bits = kernels.orb_select_bits(t(flat), t(g))
    assert got_ang.dtype == torch.int32 and got_bits.dtype == torch.uint8
    assert np.array_equal(np.asarray(ang), got_ang.numpy())
    assert np.array_equal(np.asarray(bits), got_bits.numpy())
    if gm == "brief":
        assert np.array_equal(g, tbrief.dense_weights("cpu").numpy())


# ---------------------------------------------------------------------------
# K3c
# ---------------------------------------------------------------------------

def test_k3c_vs_pallas_interpret_every_offset():
    rng = np.random.default_rng(13)
    k = 1024                      # all 4 x 225 (psi, phi), padded to 8 blocks
    psi = np.concatenate([np.repeat(np.arange(4), 225), rng.integers(0, 4, k - 900)])
    phi = np.concatenate([np.tile(np.arange(225), 4), rng.integers(0, 225, k - 900)])
    psi, phi = psi.astype(np.int32), phi.astype(np.int32)
    rows = rng.integers(0, 2**32, (k, pk.NR, 256), dtype=np.uint32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pk.realign_windows(jnp.asarray(rows), jnp.asarray(psi),
                                             jnp.asarray(phi)))
    got = kernels.realign_windows(t(rows.view(np.int32)), t(psi), t(phi))
    assert got.dtype == torch.int32 and got.shape == (k, 8, 32)
    assert np.array_equal(want, got.numpy().view(np.uint32))


@pytest.mark.parametrize("shape", [(64, 384), (48, 768)])
def test_pack_row_strips_vs_pallas_interpret(shape):
    img = image(*shape, 4)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pk.pack_row_strips(jnp.asarray(img)))
    got = kernels.pack_row_strips(t(img))
    assert np.array_equal(want, got.numpy().view(np.uint32))


@pytest.mark.parametrize("case", GATHER_CASES)
def test_k3c_gives_k3s_bytes(case):
    """K3c on strip rows of an image gives K3's windows: the same bytes,
    before K3's XOR to int8."""
    img, xs, ys, valid = (t(a) for a in GATHER_CASES[case]())
    words = kernels.realign_windows(*kernels.strip_window_rows(img, xs, ys, valid))
    b = words.reshape(-1, 256).numpy().view(np.uint8).reshape(-1, 1024)
    want = kernels.gather_windows_packed(img, xs, ys, valid).numpy()
    assert np.array_equal((b ^ 0x80).view(np.int8), want)
