"""The frozen reference frontend and matcher against the port's plain path on
the CPU, at the evaluation shape and at a VGA render: bit for bit. This is
the second witness that the reference is the algorithm the port states."""

import numpy as np
import pytest
import torch

from portbench import check, harness
from portbench.reference import orb
from pislam_tpu_torch.models.visual_odometry import _Frontend
from pislam_tpu_torch.ops import kernels
from pislam_tpu_torch.service import build_config
from pislam_tpu_torch import matching


def _port(w, h, levels, k, fx, fy, cx, cy):
    return _Frontend(build_config(w, h, levels, k), fx, fy, cx, cy, None, "cpu", kernels.PLAIN)


def _assert_same(ref: orb.Frame, feats, pts):
    assert torch.equal(ref.codes, feats.codes)
    assert torch.equal(ref.valid, feats.valid)
    assert torch.equal(ref.angles, feats.angles)
    assert torch.equal(ref.descriptors, feats.descriptors)
    assert torch.equal(ref.pts, pts)


@pytest.mark.parametrize("frame", [0, 30])
def test_eval_shape(frame):
    img = torch.as_tensor(np.load(harness.ROOT / "data" / "eval_seq2.npz")["frames"][frame])
    fe = orb.Frontend(384, 256, 4, 5 / 6, 512, 20, 1 << 10, 16, 8, (256, 256, 192, 128), "cpu")
    _assert_same(fe(img), *_port(384, 256, 4, 512, 256, 256, 192, 128)(img))


def test_vga_render():
    cfg = harness.load_json("configs", "tum_fr1_vga")
    mix = dict(harness.load_json("traffic", "chunk8"))
    mix["lap"] = dict(mix["lap"], frames=2)
    stream = harness.Stream(cfg, mix, 2**31 + 3, "cpu")
    fe = check.reference_frontend(cfg, "cpu")
    port = _port(640, 480, 8, 1000, cfg["fx"], cfg["fy"], cfg["cx"], cfg["cy"])
    a, b = fe(stream.frame(0)), fe(stream.frame(1))
    _assert_same(a, *port(stream.frame(0)))
    idx = orb.match(a.descriptors, a.valid, b.descriptors, b.valid, 64, 0.85)
    want, _ = matching.match(a.descriptors, b.descriptors, a.valid, b.valid, max_distance=64,
                             ratio=0.85, cross_check=True, reduce=kernels.match_reduce_plain)
    assert torch.equal(idx, want) and int((idx >= 0).sum()) > 50


def test_bfloat16_pyramid_differs():
    """The control: the pyramid resampled in bfloat16 moves keypoints."""
    img = torch.as_tensor(np.load(harness.ROOT / "data" / "eval_seq.npz")["frames"][5])
    args = (384, 256, 4, 5 / 6, 512, 20, 1 << 10, 16, 8, (256, 256, 192, 128), "cpu")
    exact, low = orb.Frontend(*args)(img), orb.Frontend(*args, precision="bfloat16")(img)
    assert not torch.equal(exact.codes, low.codes)
