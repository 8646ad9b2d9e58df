"""The port's dense ops against the JAX package's, on the same seeded
inputs, with tolerance 0: every stage of the frontend is integer or
bit-exact."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pislam_tpu.ops import bilinear as jbil
from pislam_tpu.ops import fast as jfast
from pislam_tpu.ops import gaussian as jgauss
from pislam_tpu.ops import harris as jharris
from pislam_tpu.ops import nms as jnms
from pislam_tpu.ops import orientation as jorient
from pislam_tpu_torch.ops import bilinear as tbil
from pislam_tpu_torch.ops import fast as tfast
from pislam_tpu_torch.ops import gaussian as tgauss
from pislam_tpu_torch.ops import harris as tharris
from pislam_tpu_torch.ops import nms as tnms
from pislam_tpu_torch.ops import orientation as torient
from pislam_tpu_torch.ops import pyramid as tpyr
from torch_parity import (eval_config, eval_frames, i64, image, jax_build_pyramid,
                          port_config, t, textured_image)

torch.set_num_threads(1)

IMAGES = {
    "noise": lambda: image(72, 200, 1),
    "texture_noise_border": lambda: textured_image(96, 160, 2),
    "odd": lambda: textured_image(61, 77, 3),
}


@pytest.mark.parametrize("name", IMAGES)
@pytest.mark.parametrize("threshold", [7, 20, 60])
def test_fast_detect(name, threshold):
    img = IMAGES[name]()
    want = np.asarray(jfast.fast_detect(jnp.asarray(img), threshold))
    got = tfast.fast_detect(t(img), threshold).numpy()
    assert want.any() and np.array_equal(want, got)


@pytest.mark.parametrize("name", IMAGES)
def test_harris(name):
    img = IMAGES[name]()
    resp = np.asarray(jharris.harris_response(jnp.asarray(img)))
    assert np.array_equal(resp, tharris.harris_response(t(img)).numpy())
    assert np.array_equal(np.asarray(jharris.quarter_float(jnp.asarray(resp))),
                          tharris.quarter_float(t(resp)).numpy())
    corner = jfast.fast_detect(jnp.asarray(img), 20)
    for thr in (0, 1 << 10, 1 << 15):
        want = np.asarray(jharris.harris_score(jnp.asarray(img), thr, mask=corner))
        got = tharris.harris_score(t(img), thr, mask=t(np.asarray(corner))).numpy()
        assert np.array_equal(want, got)
    assert np.array_equal(np.asarray(jharris.harris_score(jnp.asarray(img), 1 << 10)),
                          tharris.harris_score(t(img), 1 << 10).numpy())


def test_quarter_float_rounds_to_nearest():
    """Scores above 2^24 round to nearest when converted to float32."""
    s = np.array([(1 << 24) + 1, (1 << 25) + 3, 2**31 - 1, -(2**31), 12345,
                  0x7FFFFF80, 0x00FFFFFF], np.int32)
    assert np.array_equal(np.asarray(jharris.quarter_float(jnp.asarray(s))),
                          tharris.quarter_float(t(s)).numpy())


@pytest.mark.parametrize("name", IMAGES)
def test_nms_and_encode(name):
    img = IMAGES[name]()
    score = np.asarray(jharris.harris_score(
        jnp.asarray(img), 1 << 10, mask=jfast.fast_detect(jnp.asarray(img), 20)))
    keep = np.asarray(jnms.nms(jnp.asarray(score)))
    assert keep.any() and np.array_equal(keep, tnms.nms(t(score)).numpy())
    enc = i64(jnms.encode_grid(jnp.asarray(score), jnp.asarray(keep)))
    assert np.array_equal(enc, tnms.encode_grid(t(score), t(keep)).numpy())


def test_nms_ties():
    """Plateaus exercise the >= up/left, > down/right tie rule."""
    rng = np.random.default_rng(4)
    score = rng.integers(0, 3, (40, 48)).astype(np.uint8) * 50
    assert np.array_equal(np.asarray(jnms.nms(jnp.asarray(score))),
                          tnms.nms(t(score)).numpy())


@pytest.mark.parametrize("lbs,limit,border", [(3, 2, 16), (4, 5, 16), (5, 1, 17)])
def test_bucket_topk(lbs, limit, border):
    img = textured_image(96, 160, 5)
    score = np.asarray(jharris.harris_score(
        jnp.asarray(img), 1 << 8, mask=jfast.fast_detect(jnp.asarray(img), 10)))
    enc = np.asarray(jnms.encode_grid(jnp.asarray(score), jnms.nms(jnp.asarray(score))))
    want = i64(jnms.bucket_topk(jnp.asarray(enc), border, lbs, limit))
    got = tnms.bucket_topk(t(enc.astype(np.int64)), border, lbs, limit).numpy()
    assert np.count_nonzero(want) < np.count_nonzero(enc)
    assert np.array_equal(want, got)


@pytest.mark.parametrize("k", [16, 300, 4096])
def test_select_topk(k):
    img = textured_image(96, 160, 6)
    score = np.asarray(jharris.harris_score(
        jnp.asarray(img), 1 << 8, mask=jfast.fast_detect(jnp.asarray(img), 10)))
    enc = np.asarray(jnms.encode_grid(jnp.asarray(score), jnms.nms(jnp.asarray(score))))
    jc, jv = jnms.select_topk(jnp.asarray(enc), k)
    tc, tv = tnms.select_topk(t(enc.astype(np.int64)), k)
    assert np.array_equal(i64(jc), tc.numpy()) and np.array_equal(np.asarray(jv), tv.numpy())
    scored = np.where(np.asarray(jnms.nms(jnp.asarray(score))), score, 0).astype(np.uint8)
    sc, sv = tnms.select_topk_scored(t(scored), k)
    assert np.array_equal(i64(jc), sc.numpy()) and np.array_equal(np.asarray(jv), sv.numpy())


@pytest.mark.parametrize("shape", [(3, 3), (5, 9), (61, 77), (480, 640)])
def test_gaussian5x5(shape):
    img = image(*shape, seed=sum(shape))
    assert np.array_equal(np.asarray(jgauss.gaussian5x5(jnp.asarray(img))),
                          tgauss.gaussian5x5(t(img)).numpy())


@pytest.mark.parametrize("src,dst", [((480, 640), (400, 533)), ((256, 384), (213, 320)),
                                     ((61, 77), (50, 64)), ((10, 10), (3, 17))])
def test_resize_bilinear(src, dst):
    img = image(*src, seed=src[0])
    want = np.asarray(jbil.resize_bilinear(jnp.asarray(img), *dst))
    assert np.array_equal(want, tbil.resize_bilinear(t(img), *dst).numpy())


@pytest.mark.parametrize("fn", ["bilinear7_8", "bilinear13_16"])
def test_fixed_ratio_bilinear(fn):
    img = image(64, 96, 9)
    assert np.array_equal(np.asarray(getattr(jbil, fn)(jnp.asarray(img))),
                          getattr(tbil, fn)(t(img)).numpy())


@pytest.mark.parametrize("which", ["eval_seq", "vga_noise"])
def test_build_pyramid(which):
    if which == "eval_seq":
        jcfg = eval_config()
        frame = eval_frames()[7]
    else:
        from pislam_tpu.config import PislamConfig
        jcfg = PislamConfig()
        frame = image(480, 640, 11)
    want = np.asarray(jax_build_pyramid(jnp.asarray(frame), jcfg.pyramid))
    got = tpyr.build_pyramid(t(frame), port_config(jcfg).pyramid).numpy()
    assert got.shape == want.shape and np.array_equal(want, got)


def test_atan2_bins_sweep():
    """All (m10, m01) in [-300, 300]^2, 10^5 random pairs within +-2^20, and
    the neighbours of every bin edge."""
    m10, m01 = torient.sweep_moments()
    want = np.asarray(jorient.atan2_bins(jnp.asarray(m10), jnp.asarray(m01)))
    got = torient.atan2_bins(t(m10), t(m01)).numpy()
    assert np.array_equal(want, got)
    assert set(np.unique(got)) == set(range(30))


def test_centroids_packed():
    flat = np.random.default_rng(12).integers(-128, 128, (200, 1024)).astype(np.int8)
    jm = jorient.centroids_packed(jnp.asarray(flat))
    tm = torient.centroids_packed(t(flat))
    for a, b in zip(jm, tm):
        assert np.array_equal(np.asarray(a), b.numpy())
