"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*.py).

The same seeded numpy inputs go through the JAX package's function and the
port's; outputs come back as numpy and are compared exactly. Codes are
compared as int64 (the port's representation of a u32), descriptor words
as uint32.
"""

import dataclasses
import functools
from pathlib import Path

import jax
import numpy as np
import torch

import pislam_tpu
import pislam_tpu_torch
from pislam_tpu.config import FrontendConfig, PislamConfig, PyramidConfig
from pislam_tpu.ops import pyramid


DATA = Path(__file__).resolve().parent.parent / "data"


def eval_frames():
    """The committed 48-frame (256, 384) uint8 sequence."""
    return np.load(DATA / "eval_seq.npz")["frames"]


def port_config(jcfg):
    """The port's PislamConfig equal to a JAX one."""
    return pislam_tpu_torch.PislamConfig.from_json(jcfg.to_json())


def eval_config():
    """tools/eval_ate.py's frontend config (384x256, 4 levels, 512 kps)."""
    return PislamConfig(
        pyramid=PyramidConfig(base_width=384, base_height=256, num_levels=4),
        frontend=FrontendConfig(fast_threshold=14, harris_threshold=1 << 9,
                                border=16, max_keypoints=512))


def vo_config(ransac_iters=128, **vo):
    """tools/eval_ate.py's slam_config as VO reads it (frontend, matcher,
    vo), with tests/test_vo_scan.py's 128 RANSAC iterations by default."""
    from pislam_tpu.config import MatcherConfig, VOConfig
    return dataclasses.replace(
        eval_config(), matcher=MatcherConfig(max_distance=64, ratio=0.85),
        vo=VOConfig(ransac_iters=ransac_iters, inlier_threshold=2e-3, min_inliers=20,
                    **vo))


def image(h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w), np.uint8)


def textured_image(h, w, seed=0):
    """Blocky texture with a noise border: corners inside, and every read
    near the edge sees random bytes."""
    rng = np.random.default_rng(seed)
    blocks = rng.integers(0, 256, (h // 6 + 1, w // 6 + 1), np.uint8)
    img = np.kron(blocks, np.ones((6, 6), np.uint8))[:h, :w].copy()
    img[:20] = rng.integers(0, 256, (20, w))
    img[-20:] = rng.integers(0, 256, (20, w))
    img[:, :20] = rng.integers(0, 256, (h, 20))
    img[:, -20:] = rng.integers(0, 256, (h, 20))
    return img


def t(a):
    """numpy -> CPU tensor (a copy, so read-only arrays are fine)."""
    return torch.from_numpy(np.array(a))


def i64(a):
    return np.asarray(a).astype(np.int64)


jax_build_pyramid = jax.jit(pyramid.build_pyramid, static_argnums=1)


@functools.lru_cache(maxsize=None)
def jax_extract_fn(jcfg):
    return pislam_tpu.make_extract_fn(jcfg)


def assert_features_equal(jf, tf):
    """JAX Features vs port Features, field for field, exactly."""
    assert np.array_equal(i64(jf.codes), tf.codes.numpy())
    assert np.array_equal(np.asarray(jf.valid), tf.valid.numpy())
    assert np.array_equal(np.asarray(jf.angles), tf.angles.numpy())
    assert np.array_equal(np.asarray(jf.descriptors),
                          tf.descriptors.numpy().view(np.uint32))
    for prop in ("xs", "ys", "scores", "num_valid"):
        assert np.array_equal(np.asarray(getattr(jf, prop)), getattr(tf, prop).numpy())


class JaxDraws:
    """The port's ``geometry/ransac.sample_indices`` drawing what the JAX
    package draws from ``key``: the next ``jax.random.split`` and
    ``jax.random.categorical`` over the same valid mask
    (pislam_tpu/geometry/ransac.py:31, models/slam.py:382)."""

    def __init__(self, key):
        self.key = jax.numpy.asarray(key)
        self.calls = 0

    def __call__(self, valid, iters, sample_size, generator=None):
        self.key, sub = jax.random.split(self.key)
        self.calls += 1
        logits = jax.numpy.where(jax.numpy.asarray(valid.numpy()), 0.0, -jax.numpy.inf)
        idx = jax.random.categorical(sub, logits[None, :], shape=(iters, sample_size))
        return torch.from_numpy(np.asarray(idx).astype(np.int64))
