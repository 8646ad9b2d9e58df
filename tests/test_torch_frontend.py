"""The whole slice: frame -> build_pyramid -> extraction, the port
(``pislam_tpu_torch.make_extract_fn(cfg, device="cpu")``) against
``pislam_tpu.make_extract_fn(cfg)`` on the same frames: pyramid bytes,
codes, valid, angles and descriptors, exactly.

On the CPU the JAX package takes its XLA path and the port takes the fused
path through its kernels' plain versions, so the two formulations are held
against each other.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pislam_tpu
import pislam_tpu_torch
from pislam_tpu.config import FrontendConfig, PislamConfig, PyramidConfig
from pislam_tpu_torch.ops import kernels
from pislam_tpu_torch.ops.pyramid import build_pyramid
from torch_parity import (assert_features_equal, eval_config, eval_frames, image,
                          jax_build_pyramid, jax_extract_fn, port_config, t,
                          textured_image)

torch.set_num_threads(1)


def _run_both(jcfg, frame):
    jpyr = np.asarray(jax_build_pyramid(jnp.asarray(frame), jcfg.pyramid))
    tcfg = port_config(jcfg)
    tpyr = build_pyramid(t(frame), tcfg.pyramid)
    assert np.array_equal(jpyr, tpyr.numpy())
    jf = jax_extract_fn(jcfg)(jnp.asarray(jpyr))
    tf = pislam_tpu_torch.make_extract_fn(tcfg, device="cpu")(tpyr)
    assert_features_equal(jf, tf)
    return tf


@pytest.mark.parametrize("index", [0, 13, 29, 47])
def test_eval_sequence_frames(index):
    """Committed frames at tools/eval_ate.py's config (4 levels, 512 kps)."""
    tf = _run_both(eval_config(), eval_frames()[index])
    assert int(tf.num_valid) > 300


def test_vga_default_config():
    """PislamConfig(): the demo's VGA 8-level pyramid, 2048 keypoints."""
    tf = _run_both(PislamConfig(), image(480, 640, 42))
    assert int(tf.num_valid) == 2048   # noise saturates the capacity


SMALL = PislamConfig(
    pyramid=PyramidConfig(base_width=192, base_height=160, num_levels=3),
    frontend=FrontendConfig(fast_threshold=10, harris_threshold=1 << 8,
                            border=16, max_keypoints=1024))


@pytest.mark.parametrize("lbs,limit", [(3, 2), (4, 5), (5, 1)])
def test_bucketed(lbs, limit):
    """Bucketing on K1's reduced grid (even border) == the JAX full grid."""
    cfg = dataclasses.replace(SMALL, frontend=dataclasses.replace(
        SMALL.frontend, log_bucket_size=lbs, bucket_limit=limit))
    frame = textured_image(160, 192, lbs)
    tf = _run_both(cfg, frame)
    unbucketed = _run_both(SMALL, frame)
    assert 0 < int(tf.num_valid) < int(unbucketed.num_valid)


@pytest.mark.parametrize("change", [
    {"fused_upstream": False},
    {"log_bucket_size": 4, "bucket_limit": 3, "border": 17},   # odd border: unfused
    {"brief_variant": "dense"},
    {"words": 4, "max_keypoints": 100},
])
def test_frontend_options(change):
    cfg = dataclasses.replace(SMALL, frontend=dataclasses.replace(SMALL.frontend, **change))
    _run_both(cfg, textured_image(160, 192, 9))


def test_plain_kernel_set_matches():
    """OrbExtractor with the plain versions named explicitly gives the same
    features as the default wrappers."""
    cfg = port_config(eval_config())
    pyr = build_pyramid(t(eval_frames()[3]), cfg.pyramid)
    a = pislam_tpu_torch.make_extract_fn(cfg, device="cpu")(pyr)
    b = pislam_tpu_torch.OrbExtractor(cfg, ops=kernels.PLAIN)(pyr)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


_jax_single_level = jax.jit(pislam_tpu.extract_single_level, static_argnums=1)


@pytest.mark.parametrize("shape", [(120, 301), (97, 200)])
def test_extract_single_level(shape):
    """Odd sizes: the JAX package pads to its lane alignment, the port does
    not; the border mask keeps the features identical."""
    img = textured_image(*shape, 4)
    jcfg = dataclasses.replace(SMALL, frontend=dataclasses.replace(
        SMALL.frontend, max_keypoints=256))
    jf = _jax_single_level(jnp.asarray(img), jcfg)
    tf = pislam_tpu_torch.extract_single_level(t(img), port_config(jcfg))
    assert int(tf.num_valid) > 0
    assert_features_equal(jf, tf)


def test_wrong_shape_raises():
    extract = pislam_tpu_torch.make_extract_fn(port_config(eval_config()), device="cpu")
    with pytest.raises(ValueError):
        extract(torch.zeros((800, 385), dtype=torch.uint8))
