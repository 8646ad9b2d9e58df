"""The Hopper kernels on the card against their plain versions, bit-exact.

These need a CUDA card and skip elsewhere. The card's machine has no jax,
so this file imports only the port, and runs there without the suite's
conftest (which imports jax):

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

``chip_smoke.py`` repeats the same checks at the main path's full sizes.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import pislam_tpu_torch
from pislam_tpu_torch import (FrontendConfig, MatcherConfig, PislamConfig, PyramidConfig,
                              VOConfig)
from pislam_tpu_torch.ops import brief, kernels, orientation
from pislam_tpu_torch.ops.pyramid import build_pyramid

torch.set_num_threads(1)

DATA = Path(__file__).resolve().parent.parent / "data"

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def t(a):
    return torch.from_numpy(np.array(a))


def image(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w), np.uint8)


def _same(got, want):
    got, want = (x if isinstance(x, tuple) else (x,) for x in (got, want))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())


@pytest.mark.parametrize("shape", [(64, 256), (61, 77), (800, 384)])
def test_k1(dev, shape):
    img = t(np.kron(image(shape[0] // 4 + 1, shape[1] // 4 + 1, 1),
                    np.ones((4, 4), np.uint8))[:shape[0], :shape[1]]).to(dev)
    img[:20] = t(image(20, shape[1], 2)).to(dev)       # noise border
    mask = torch.zeros(shape, dtype=torch.uint8, device=dev)
    mask[16:-16, 16:-16] = 1
    args = (img, mask, 10, 1 << 8)
    _same(kernels.fused_frontend_codes(*args), kernels.fused_frontend_codes_plain(*args))


@pytest.mark.parametrize("fill", [0, 255])
def test_k1_flat_image_has_no_codes(dev, fill):
    img = torch.full((100, 130), fill, dtype=torch.uint8, device=dev)
    mask = torch.ones_like(img)
    assert not kernels.fused_frontend_codes(img, mask, 1, -(2**31)).any()


@pytest.mark.parametrize("n,k,nonzero", [(354_560, 2048, 3000), (1000, 300, 500),
                                         (100, 256, 50), (9000, 8192, 3000),
                                         (5000, 512, 0), (512, 512, 512), (70, 1, 9)])
def test_k2(dev, n, k, nonzero):
    rng = np.random.default_rng(n)
    keys = np.full(n, -(2**31), np.int32)
    nz = rng.choice(n, nonzero, replace=False)
    keys[nz] = rng.integers(-2**31 + 1, 2**31 - 1, nonzero)
    if nonzero:
        keys[nz[0]] = 2**31 - 1
    args = (t(keys).to(dev), k)
    _same(kernels.topk_keys(*args), kernels.topk_keys_plain(*args))


def test_k3(dev):
    rng = np.random.default_rng(3)
    img = t(image(200, 300, 3)).to(dev)
    xs = t(rng.integers(-20, 320, 500).astype(np.int32)).to(dev)
    ys = t(rng.integers(-20, 220, 500).astype(np.int32)).to(dev)
    valid = t(rng.random(500) < 0.8).to(dev)
    args = (img, xs, ys, valid)
    _same(kernels.gather_windows_packed(*args), kernels.gather_windows_packed_plain(*args))


@pytest.mark.parametrize("words", [8, 4, 1])
def test_k4(dev, words):
    flat = t(np.random.default_rng(words).integers(-128, 128, (700, 1024)).astype(np.int8))
    args = (flat.to(dev), *brief.OrbTables.build(dev), words)
    _same(kernels.orb_select(*args), kernels.orb_select_plain(*args))


def test_k4_atan2_sweep(dev):
    m10, m01 = (t(m).to(dev) for m in orientation.sweep_moments())
    _same(kernels.atan2_bins(m10, m01), orientation.atan2_bins(m10.cpu(), m01.cpu()))


def _match_case(k1, k2, seed, gated):
    """Words using all 32 bits, duplicates within and across the kernel's
    segments, invalid rows and columns; for the gate inf and 1e6 points."""
    rng = np.random.default_rng(seed)
    d1 = rng.integers(0, 2**32, (k1, 8), dtype=np.uint32)
    d2 = rng.integers(0, 2**32, (k2, 8), dtype=np.uint32)
    if k1 >= 3 and k2 >= 7:
        for j in (3, k2 // 2, k2 - 1):               # ties of query row 1
            d2[j] = d1[1]
        d2[k2 // 3] = d1[2] ^ np.uint32(1)
        d2[k2 - 2] = d1[2]                           # a later, better column
        d1[k1 - 1] = d1[1]                           # duplicate query rows
    v1, v2 = rng.random(k1) < 0.9, rng.random(k2) < 0.9
    args = [t(d1.view(np.int32)), t(d2.view(np.int32)), t(v1), t(v2)]
    if gated:
        uv1 = rng.uniform(-0.1, 0.1, (k1, 2)).astype(np.float32)
        uv2 = rng.uniform(-0.1, 0.1, (k2, 2)).astype(np.float32)
        uv2[5], uv2[6], uv1[7] = 1e6, np.inf, np.inf
        uv1[0] = uv2[0] + [0.06, 0.0]                # on the radius
        args += [t(uv1), t(uv2), 0.06]
    return args


@pytest.mark.parametrize("k1,k2,gated", [(512, 512, False), (333, 2048, False),
                                         (2048, 16384, False), (512, 16384, True),
                                         (1, 1, False), (100, 7, True)])
def test_k5(dev, k1, k2, gated):
    args = _match_case(k1, k2, k1 + k2, gated)
    on_card = [a.to(dev) if torch.is_tensor(a) else a for a in args]
    before = kernels.match_reduce.launches
    _same(kernels.match_reduce(*on_card), kernels.match_reduce_plain(*on_card))
    _same(kernels.match_reduce(*on_card), kernels.match_reduce_plain(*args))
    assert kernels.match_reduce.launches == before + 2


def test_vo_on_card_matches_cpu(dev):
    cfg = PislamConfig(
        pyramid=PyramidConfig(base_width=384, base_height=256, num_levels=4),
        frontend=FrontendConfig(fast_threshold=14, harris_threshold=1 << 9,
                                border=16, max_keypoints=512),
        matcher=MatcherConfig(max_distance=64, ratio=0.85),
        vo=VOConfig(ransac_iters=256, inlier_threshold=2e-3, min_inliers=20))
    d = np.load(DATA / "eval_seq.npz")
    intr = [float(d[k]) for k in ("fx", "fy", "cx", "cy")]
    frames = d["frames"][:5]
    kernels.reset_launch_counts()
    card = pislam_tpu_torch.make_vo_scan(cfg, *intr, device=dev)(
        frames, torch.Generator(device=dev).manual_seed(0))
    assert kernels.match_reduce.launches == 4
    cpu = pislam_tpu_torch.make_vo_scan(cfg, *intr, device="cpu")(
        frames, torch.Generator().manual_seed(0))
    assert torch.equal(card["accepted"].cpu(), cpu["accepted"]) and bool(cpu["accepted"].all())
    assert (card["num_inliers"].cpu() - cpu["num_inliers"]).abs().max() <= 2
    for k in ("R", "t"):
        assert (card[k].cpu() - cpu[k]).abs().max() <= 1e-4


def test_frontend_on_card_matches_cpu(dev):
    cfg = PislamConfig(
        pyramid=PyramidConfig(base_width=384, base_height=256, num_levels=4),
        frontend=FrontendConfig(fast_threshold=14, harris_threshold=1 << 9,
                                border=16, max_keypoints=512))
    frame = t(np.load(DATA / "eval_seq.npz")["frames"][5])
    pyr = build_pyramid(frame, cfg.pyramid)
    kernels.reset_launch_counts()
    on_card = pislam_tpu_torch.make_extract_fn(cfg, device=dev)(pyr.to(dev))
    # one launch of each extraction kernel; K5 belongs to matching
    assert kernels.launch_counts() == {"fused_frontend_codes": 1, "topk_keys": 1,
                                       "gather_windows_packed": 1, "orb_select": 1,
                                       "match_reduce": 0}
    _same(tuple(on_card), tuple(pislam_tpu_torch.make_extract_fn(cfg, device="cpu")(pyr)))
