"""The Hopper kernels on the card against their plain versions, bit-exact,
and one SLAM run on the card against the CPU.

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
                                       "match_reduce": 0, "reduce_codes_4x": 0,
                                       "orb_select_bits": 0, "realign_windows": 0}
    _same(tuple(on_card), tuple(pislam_tpu_torch.make_extract_fn(cfg, device="cpu")(pyr)))


@pytest.mark.parametrize("shape", [(64, 256), (61, 77), (800, 384), (2216, 640)])
def test_k6(dev, shape):
    rng = np.random.default_rng(shape[0])
    scored = np.zeros(shape, np.uint8)
    n = shape[0] * shape[1] // 40
    ys, xs = rng.integers(0, shape[0], n), rng.integers(0, shape[1], n)
    scored[ys - ys % 2, xs - xs % 2] = rng.integers(1, 256, n)   # <= 1 per 2x2 block
    args = (t(scored).to(dev),)
    _same(kernels.reduce_codes_4x(*args), kernels.reduce_codes_4x_plain(*args))


@pytest.mark.parametrize("k,gm", [(512, "brief"), (2048, "brief"), (300, "random")])
def test_k4d(dev, k, gm):
    rng = np.random.default_rng(k)
    flat = t(rng.integers(-128, 128, (k, 1024)).astype(np.int8)).to(dev)
    g = (brief.dense_weights(dev) if gm == "brief" else
         t(rng.integers(-128, 128, (1024, kernels.GM_COLS)).astype(np.int8)).to(dev))
    _same(kernels.orb_select_bits(flat, g), kernels.orb_select_bits_plain(flat, g))
    if gm == "brief":
        ang, bits = kernels.orb_select_bits(flat, g)
        k4ang, k4desc = kernels.orb_select(flat, *brief.OrbTables.build(dev), 8)
        _same(ang, k4ang.to(torch.int32))
        _same(brief._pack_bits_u8(bits, 8), k4desc)


def test_k3c(dev):
    rng = np.random.default_rng(9)
    k = 1024
    rows = t(rng.integers(0, 2**32, (k, 9, 256), dtype=np.uint32).view(np.int32)).to(dev)
    psi = t(np.concatenate([np.repeat(np.arange(4), 225), rng.integers(0, 4, k - 900)])
            .astype(np.int32)).to(dev)
    phi = t(np.concatenate([np.tile(np.arange(225), 4), rng.integers(0, 225, k - 900)])
            .astype(np.int32)).to(dev)
    _same(kernels.realign_windows(rows, psi, phi), kernels.realign_windows_plain(rows, psi, phi))
    img = t(image(200, 384, 3)).to(dev)
    xs = t(rng.integers(-20, 400, 500).astype(np.int32)).to(dev)
    ys = t(rng.integers(-20, 220, 500).astype(np.int32)).to(dev)
    valid = t(rng.random(500) < 0.8).to(dev)
    words = kernels.realign_windows(*kernels.strip_window_rows(img, xs, ys, valid))
    win = (words.reshape(-1, 256).view(torch.uint8) ^ 0x80).view(torch.int8)
    _same(win, kernels.gather_windows_packed(img, xs, ys, valid))


def test_slam_on_card_matches_cpu(dev, monkeypatch):
    """Four eval_seq frames of SLAM (the bootstrap keyframe, two tracked
    frames, then an insert with its windowed BA) on the card and on the CPU,
    both drawing their RANSAC samples from one CPU generator: the same
    decisions and counters, poses within 1e-3. (Later frames are not held
    together: the first window's LM turns on float noise, tests/test_torch_slam.py.)"""
    import dataclasses

    from pislam_tpu_torch import BAConfig, MapConfig
    from pislam_tpu_torch.geometry import ransac

    cfg = dataclasses.replace(
        PislamConfig(pyramid=PyramidConfig(base_width=384, base_height=256, num_levels=4),
                     frontend=FrontendConfig(fast_threshold=14, harris_threshold=1 << 9,
                                             border=16, max_keypoints=512),
                     matcher=MatcherConfig(max_distance=64, ratio=0.85),
                     vo=VOConfig(ransac_iters=256, inlier_threshold=2e-3, min_inliers=20)),
        ba=BAConfig(window=6, max_points=1024, max_obs=4096, gn_iters=4),
        map=MapConfig(gate_radius=0.06, keyframe_capacity=16))
    d = np.load(DATA / "eval_seq.npz")
    intr = [float(d[k]) for k in ("fx", "fy", "cx", "cy")]
    draw = ransac.sample_indices
    runs = []
    for device in (dev, "cpu"):
        gen = torch.Generator().manual_seed(0)
        monkeypatch.setattr(ransac, "sample_indices", lambda valid, iters, size, _g=None: draw(
            valid.cpu(), iters, size, gen).to(valid.device))
        kernels.reset_launch_counts()
        slam = pislam_tpu_torch.KeyframeSLAM(cfg, *intr, keyframe_min_inliers=60,
                                             keyframe_max_gap=3, device=device)
        outs = [slam.process(f) for f in d["frames"][:4]]
        runs.append((outs, slam.state.counters.cpu(), slam.keyframe_frames,
                     kernels.launch_counts()))
    (card, c_card, kf_card, n_card), (cpu, c_cpu, kf_cpu, _) = runs
    assert kf_card == kf_cpu == [0, 3] and torch.equal(c_card, c_cpu)
    assert n_card["fused_frontend_codes"] == 4 and n_card["match_reduce"] >= 3
    for a, b in zip(card, cpu):
        assert a["keyframe"] == b["keyframe"]
        assert abs(a["num_inliers"] - b["num_inliers"]) <= 2
        assert np.abs(a["pose_R"] - b["pose_R"]).max() <= 1e-3
        assert np.abs(a["pose_t"] - b["pose_t"]).max() <= 1e-3
