"""The Hopper kernels on the card against their plain versions, bit-exact
(motion-only BA within tests/pnp_cases.py's tolerances), and one SLAM run
on the card against the CPU.

These need a CUDA card and skip elsewhere; the distributed ones at the end
need two or more cards (one NCCL rank per card, under torchrun). The card's
machine has no jax,
so this file imports only the port, and runs there without the suite's
conftest (which imports jax):

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

``chip_smoke.py`` repeats the same checks at the main path's full sizes.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import pislam_tpu_torch
import pnp_cases
from pislam_tpu_torch import (FrontendConfig, MatcherConfig, PislamConfig, PyramidConfig,
                              VOConfig)
from pislam_tpu_torch.backend import pnp
from pislam_tpu_torch.ops import brief, kernels, orientation
from pislam_tpu_torch.ops.pyramid import build_pyramid

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "data"

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


# K1 under the plan's tile and under each tile forced
K1_TILES = [pytest.param(None, id="plan"),
            *(pytest.param(tile, id=f"{tile[0]}x{tile[1]}") for tile in kernels.FRONTEND_TILES)]


def _k1(dev, args, tile):
    """K1's codes under ``tile`` (None: the plan's choice), held bit-exact to
    the plain version."""
    h, w = args[0].shape
    plan = None if tile is None else kernels.frontend_plan(
        h, w, kernels.device_limits(dev)[0], tile)
    got = kernels.fused_frontend_codes(*args, plan=plan)
    _same(got, kernels.fused_frontend_codes_plain(*args))
    return got


def _k1_mask(shape, dev):
    # the plain version wraps at the edges where the kernel clamps; both
    # agree wherever the mask keeps 5 px from an edge (the level mask keeps 16)
    border = 16 if min(shape) >= 40 else 8
    mask = torch.zeros(shape, dtype=torch.uint8, device=dev)
    mask[border:-border, border:-border] = 1
    return mask


@pytest.mark.parametrize("tile", K1_TILES)
@pytest.mark.parametrize("shape", [(64, 256), (61, 77), (800, 384), (15, 31), (17, 33),
                                   (33, 65), (100, 130), (2216, 640)])
def test_k1(dev, shape, tile):
    img = t(np.kron(image(shape[0] // 4 + 1, shape[1] // 4 + 1, 1),
                    np.ones((4, 4), np.uint8))[:shape[0], :shape[1]]).to(dev)
    img[:20] = t(image(min(20, shape[0]), shape[1], 2)).to(dev)       # noise border
    _k1(dev, (img, _k1_mask(shape, dev), 10, 1 << 8), tile)


@pytest.mark.parametrize("tile", K1_TILES)
@pytest.mark.parametrize("shape", [(100, 130), (800, 384)])
def test_k1_every_fast_corner_scores(dev, shape, tile):
    """harris_t = INT32_MIN: every FAST corner the mask keeps scores."""
    img = t(image(*shape, 3)).to(dev)
    got = _k1(dev, (img, _k1_mask(shape, dev), 10, -(2**31)), tile)
    assert got.count_nonzero() > 0


@pytest.mark.parametrize("tile", K1_TILES)
@pytest.mark.parametrize("cell", [1, 2, 3])
@pytest.mark.parametrize("harris_t", [0, -(2**31)])
def test_k1_checkerboard(dev, cell, harris_t, tile):
    """A 0/255 checkerboard: gradients at their extremes, so Harris's uint32
    products and determinant wrap."""
    shape = (100, 130)
    r, c = np.indices(shape)
    img = t((((r // cell + c // cell) % 2) * 255).astype(np.uint8)).to(dev)
    _k1(dev, (img, _k1_mask(shape, dev), 20, harris_t), tile)


@pytest.mark.parametrize("fill", [0, 255])
def test_k1_flat_image_has_no_codes(dev, fill):
    img = torch.full((100, 130), fill, dtype=torch.uint8, device=dev)
    mask = torch.ones_like(img)
    assert not kernels.fused_frontend_codes(img, mask, 1, -(2**31)).any()


@pytest.mark.parametrize("n,k,nonzero", [(354_560, 2048, 3000), (1000, 300, 500),
                                         (100, 256, 50), (9000, 8192, 3000),
                                         (5000, 512, 0), (512, 512, 512), (70, 1, 9),
                                         (8192, 8192, 5000), (8193, 8192, 8193),
                                         (354_560, 512, 0), (354_560, 8192, 20_000),
                                         (76_800, 512, 1500),
                                         # KITTI's and 720p's pyramids: keys in
                                         # device memory
                                         (555_520, 2048, 30_000), (1_062_400, 2048, 60_000),
                                         (1_062_400, 8192, 100_000), (1_062_400, 512, 0),
                                         (555_520, 512, 3000)])
def test_k2(dev, n, k, nonzero):
    rng = np.random.default_rng(n)
    keys = np.full(n, -(2**31), np.int32)
    nz = rng.choice(n, nonzero, replace=False)
    keys[nz] = rng.integers(-2**31 + 1, 2**31 - 1, nonzero)
    if nonzero:
        keys[nz[0]] = 2**31 - 1
    args = (t(keys).to(dev), k)
    _same(kernels.topk_keys(*args), kernels.topk_keys_plain(*args))


@pytest.mark.parametrize("shared", [1, 2, 3])
@pytest.mark.parametrize("n,k", [(76_800, 512), (354_560, 2048), (1_062_400, 2048)])
def test_k2_shared_prefix(dev, n, k, shared):
    """Survivors that share their top 1-3 bytes, so that the radix passes
    run past the first before the candidates fit the sort."""
    rng = np.random.default_rng(n + shared)
    keys = np.full(n, -(2**31), np.int32)
    nz = rng.choice(n, 3 * k, replace=False)
    low = (1 << (32 - 8 * shared)) - 1
    keys[nz] = (rng.integers(0, 2**31, 3 * k) & low) | (0x12345678 & ~low)
    args = (t(keys).to(dev), k)
    _same(kernels.topk_keys(*args), kernels.topk_keys_plain(*args))


@pytest.mark.parametrize("n,k", [(76_800, 512), (1_062_400, 2048)])
def test_k2_unaligned(dev, n, k):
    """Keys that start 4 bytes past a 16-byte boundary take the scalar
    loads, from shared memory and from device memory."""
    rng = np.random.default_rng(n + 1)
    keys = np.full(n + 1, -(2**31), np.int32)
    nz = rng.choice(n + 1, 4 * k, replace=False)
    keys[nz] = rng.integers(-2**31 + 1, 2**31 - 1, 4 * k)
    shifted = t(keys).to(dev)[1:]
    assert shifted.data_ptr() % 16 == 4
    _same(kernels.topk_keys(shifted, k), kernels.topk_keys_plain(shifted, k))


# (H, W), K, base offset: K = 1 (the bottom-right corner), K = 8192, the
# 32x32 image, W % 4 in {1, 2, 3}, the base offset by 1, 2 and 3 bytes
K3_CASES = {"200x300": ((200, 300), 500, 0), "K=1": ((64, 96), 1, 0),
            "K=8192": ((480, 640), 8192, 0), "32x32": ((32, 32), 40, 0),
            "W%4=1": ((61, 97), 300, 0), "W%4=2": ((64, 98), 300, 0),
            "W%4=3": ((67, 99), 300, 0), "base+1": ((64, 97), 300, 1),
            "base+2": ((64, 98), 300, 2), "base+3": ((64, 99), 300, 3)}


@pytest.mark.parametrize("case", list(K3_CASES))
def test_k3(dev, case):
    """The corners, every clip limit and invalid keypoints with stale
    coordinates, then seeded keypoints in and around the image."""
    (h, w), k, off = K3_CASES[case]
    rng = np.random.default_rng(h + w + k + off)
    ex = [w - 1, 0, 15, 16, w - 17, w - 16, w - 1, 0, w + 100, 3000, -5]
    ey = [h - 1, 0, 15, h - 17, 16, h - 16, 0, h - 1, h + 100, -5, 4000]
    xs = np.concatenate([ex, rng.integers(-20, w + 20, k)])[:k].astype(np.int32)
    ys = np.concatenate([ey, rng.integers(-20, h + 20, k)])[:k].astype(np.int32)
    valid = np.concatenate([[True] * 9 + [False] * 2, rng.random(k) < 0.8])[:k]
    args = (_at_offset(image(h, w, k), off, dev), t(xs).to(dev), t(ys).to(dev),
            t(valid).to(dev))
    assert args[0].data_ptr() % 4 == off
    _same(kernels.gather_windows_packed(*args), kernels.gather_windows_packed_plain(*args))


# K, words, base offset, windows: 1 to 8 words, K = 1 and 8192, one window
# repeated (one bin), all -128 and all 127, the base offset by 1 and 4 bytes;
# "tables+2" puts idx0 and idx1 2 bytes and mom_w 1 byte off their alignment
K4_CASES = {**{f"words={n}": (700, n, 0, "random") for n in range(1, 9)},
            "K=1": (1, 8, 0, "random"), "K=8192": (8192, 8, 0, "random"),
            "one bin": (2048, 8, 0, "one"), "all -128": (64, 8, 0, -128),
            "all 127": (64, 8, 0, 127), "base+1": (700, 8, 1, "random"),
            "base+4": (700, 8, 4, "random"), "tables+2": (700, 8, 0, "random")}


def _tables(dev, misaligned):
    tables = brief.OrbTables.build(dev)
    if not misaligned:
        return tables
    return [_at_offset(tb.cpu().numpy().view(np.uint8), off, dev).view(tb.dtype)
            for tb, off in zip(tables, (2, 2, 1))]


@pytest.mark.parametrize("case", list(K4_CASES))
def test_k4(dev, case):
    k, words, off, fill = K4_CASES[case]
    rng = np.random.default_rng(k + words + off)
    if fill == "random":
        flat = rng.integers(-128, 128, (k, 1024)).astype(np.int8)
    elif fill == "one":
        flat = np.repeat(rng.integers(-128, 128, (1, 1024)).astype(np.int8), k, 0)
    else:
        flat = np.full((k, 1024), fill, np.int8)
    args = (_at_offset(flat, off, dev), *_tables(dev, case == "tables+2"), words)
    got = kernels.orb_select(*args)
    _same(got, kernels.orb_select_plain(*args))
    if fill != "random":
        assert torch.unique(got[0]).numel() == 1


def _describe_case(shape, k, seed, dev):
    """Codes anywhere in [0, 4095]^2 (most inside the image), every clip
    limit, code 0, invalid keypoints with stale codes."""
    h, w = shape
    rng = np.random.default_rng(seed)
    xs = np.concatenate([[0, 15, 16, w - 17, w - 16, w - 1, 4095, 0],
                         rng.integers(0, w + 40, k)])[:k]
    ys = np.concatenate([[0, 15, h - 17, 16, h - 16, h - 1, 0, 4095],
                         rng.integers(0, h + 40, k)])[:k]
    codes = (rng.integers(1, 256, k) << 24) | (xs << 12) | ys
    codes[8 % k] = 0
    valid = rng.random(k) < 0.9
    valid[:min(k, 8)] = True
    return (t(image(h, w, seed)).to(dev), t(codes.astype(np.int64)).to(dev),
            t(valid).to(dev))


@pytest.mark.parametrize("shape,k", [((800, 384), 512), ((2216, 640), 2048), ((64, 256), 1),
                                     ((64, 256), 7), ((32, 32), 33)])
@pytest.mark.parametrize("words", [8, 4, 1])
def test_orb_describe(dev, shape, k, words):
    img, codes, valid = _describe_case(shape, k, k + words, dev)
    args = (img, codes, valid, *brief.OrbTables.build(dev), words)
    before = kernels.orb_describe.launches
    got = kernels.orb_describe(*args)
    assert kernels.orb_describe.launches == before + 1
    _same(got, kernels.orb_describe_plain(*args))
    cpu = tuple(a.cpu() if torch.is_tensor(a) else a for a in args)
    _same(got, kernels.orb_describe_plain(*cpu))


def test_orb_describe_all_invalid(dev):
    img, codes, _ = _describe_case((800, 384), 512, 3, dev)
    args = (img, codes, torch.zeros_like(codes, dtype=torch.bool), *brief.OrbTables.build(dev), 8)
    ang, desc = kernels.orb_describe(*args)
    assert not ang.any() and not desc.any()
    _same((ang, desc), kernels.orb_describe_plain(*args))


def test_k4_atan2_sweep(dev):
    m10, m01 = (t(m).to(dev) for m in orientation.sweep_moments())
    _same(kernels.atan2_bins(m10, m01), orientation.atan2_bins(m10.cpu(), m01.cpu()))


def _match_case(k1, k2, seed, gated, words=8):
    """Words using all 32 bits, duplicates within and across the kernel's
    tiles, segments and row tiles, invalid rows and columns; for the gate inf
    and 1e6 points."""
    rng = np.random.default_rng(seed)
    d1 = rng.integers(0, 2**32, (k1, words), dtype=np.uint32)
    d2 = rng.integers(0, 2**32, (k2, words), dtype=np.uint32)
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


@pytest.mark.parametrize("k1,k2,gated,words", [
    (512, 512, False, 8), (333, 2048, False, 8), (2048, 16384, False, 8),
    (512, 16384, True, 8), (1, 1, False, 8), (100, 7, True, 8),
    (512, 8192, True, 8), (499, 8192, True, 8), (65, 300, False, 8), (127, 1000, True, 8),
    (512, 512, False, 1), (2048, 2048, False, 4), (64, 129, True, 4)])
def test_k5(dev, k1, k2, gated, words):
    args = _match_case(k1, k2, k1 + k2, gated, words)
    on_card = [a.to(dev) if torch.is_tensor(a) else a for a in args]
    before = kernels.match_reduce.launches
    _same(kernels.match_reduce(*on_card), kernels.match_reduce_plain(*on_card))
    _same(kernels.match_reduce(*on_card), kernels.match_reduce_plain(*args))
    assert kernels.match_reduce.launches == before + 2


@pytest.mark.parametrize("k1", [65_537, 70_000])
def test_k5_beyond_max_rows(dev, k1):
    """More query rows than one launch holds: one launch per 65,536 rows,
    merged as one call over all rows would give."""
    args = _match_case(k1, 2048, k1, False)
    rows = t(np.arange(k1) % 4000)
    args[0] = args[0][rows]                      # every row repeated: ties across chunks
    on_card = [a.to(dev) for a in args]
    before = kernels.match_reduce.launches
    _same(kernels.match_reduce(*on_card), kernels.match_reduce_plain(*on_card))
    assert kernels.match_reduce.launches == before + 2


def test_k5_two_streams(dev):
    """Calls on two streams at once: each stream has its own merge state."""
    cases = [_match_case(2048, 16384, 1, False), _match_case(512, 8192, 2, True)]
    on_card = [[a.to(dev) if torch.is_tensor(a) else a for a in c] for c in cases]
    streams = [torch.cuda.Stream(dev) for _ in cases]
    torch.cuda.synchronize(dev)
    outs = []
    for _ in range(4):
        for stream, args in zip(streams, on_card):
            with torch.cuda.stream(stream):
                outs.append((args, kernels.match_reduce(*args)))
    torch.cuda.synchronize(dev)
    for args, out in outs:
        _same(out, kernels.match_reduce_plain(*args))


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
    # one launch of each kernel of the sorted-BRIEF extraction (K3 and K4
    # run inside orb_describe); K5 belongs to matching, motion-only BA to tracking
    assert kernels.launch_counts() == {"fused_frontend_codes": 1, "topk_keys": 1,
                                       "gather_windows_packed": 0, "orb_select": 0,
                                       "match_reduce": 0, "reduce_codes_4x": 0,
                                       "orb_select_bits": 0, "orb_describe": 1,
                                       "orb_describe_dense": 0,
                                       "realign_windows": 0, "pack_row_strips": 0,
                                       "motion_only_ba": 0}
    _same(tuple(on_card), tuple(pislam_tpu_torch.make_extract_fn(cfg, device="cpu")(pyr)))


def _at_offset(a, offset, dev):
    """a (uint8 or int8) as a contiguous view on dev that starts `offset`
    bytes into an (aligned) buffer: a misaligned base for the kernels' byte
    paths."""
    buf = torch.zeros(a.size + 16, dtype=t(a).dtype, device=dev)
    view = buf[offset:offset + a.size].view(a.shape)
    view.copy_(t(a))
    return view


# the pyramids; odd H, odd W, W = 2, W % 16 in {2, 8, 14}, bases offset by 1,
# 4 and 8 bytes (the byte path), all zero, every pixel at score 255 up to the
# 4095 coordinate limit
@pytest.mark.parametrize("shape,offset,fill", [
    ((64, 256), 0, None), ((61, 77), 0, None), ((800, 384), 0, None), ((2216, 640), 0, None),
    ((61, 64), 0, None), ((64, 61), 0, None), ((63, 2), 0, None), ((40, 130), 0, None),
    ((41, 136), 0, None), ((40, 142), 0, None), ((64, 256), 1, None), ((64, 256), 4, None),
    ((64, 256), 8, None), ((800, 384), 0, 0), ((4096, 4096), 0, 255), ((4095, 4095), 0, 255),
    ((4095, 4095), 1, 255)])
def test_k6(dev, shape, offset, fill):
    if fill is None:
        rng = np.random.default_rng(shape[0] + offset)
        scored = np.zeros(shape, np.uint8)
        n = max(shape[0] * shape[1] // 40, 1)
        ys, xs = rng.integers(0, shape[0], n), rng.integers(0, shape[1], n)
        scored[ys - ys % 2, xs - xs % 2] = rng.integers(1, 256, n)   # <= 1 per 2x2 block
    else:
        scored = np.full(shape, fill, np.uint8)
    x = _at_offset(scored, offset, dev)
    _same(kernels.reduce_codes_4x(x), kernels.reduce_codes_4x_plain(x))
    _same(kernels.reduce_codes_4x(x), kernels.reduce_codes_4x_plain(t(scored)))


@pytest.mark.parametrize("k,gm,skew", [(512, "brief", False), (2048, "brief", False),
                                       (300, "random", False), (1, "brief", False),
                                       (8192, "brief", False), (2048, "brief", True),
                                       (8192, "random", True)])
def test_k4d(dev, k, gm, skew):
    """K4d on random windows (each bin ~k/30 keypoints) and, skewed, one
    window repeated (every keypoint in one bin)."""
    rng = np.random.default_rng(k)
    flat = rng.integers(-128, 128, (1 if skew else k, 1024)).astype(np.int8)
    flat = t(np.repeat(flat, k, 0) if skew else flat).to(dev)
    g = (brief.dense_weights(dev) if gm == "brief" else
         t(rng.integers(-128, 128, (1024, kernels.GM_COLS)).astype(np.int8)).to(dev))
    got = kernels.orb_select_bits(flat, g)
    _same(got, kernels.orb_select_bits_plain(flat, g))
    if skew:
        assert torch.unique(got[0]).numel() == 1
    if gm == "brief":
        k4ang, k4desc = kernels.orb_select(flat, *brief.OrbTables.build(dev), 8)
        _same(got[0], k4ang.to(torch.int32))
        _same(brief._pack_bits_u8(got[1], 8), k4desc)


@pytest.mark.parametrize("shape,k", [((800, 384), 512), ((2216, 640), 2048), ((64, 256), 1),
                                     ((64, 256), 7), ((32, 32), 33), ((2216, 640), 8192)])
@pytest.mark.parametrize("words", [8, 4, 1])
def test_orb_describe_dense(dev, shape, k, words):
    """The path's shapes with edge, invalid and out-of-image codes: against
    its plain version on the card and the CPU, and against orb_describe."""
    img, codes, valid = _describe_case(shape, k, k + words, dev)
    gm = brief.dense_weights(dev)
    before = kernels.orb_describe_dense.launches
    got = kernels.orb_describe_dense(img, codes, valid, gm, words)
    assert kernels.orb_describe_dense.launches == before + 1
    _same(got, kernels.orb_describe_dense_plain(img, codes, valid, gm, words))
    _same(got, kernels.orb_describe_dense_plain(img.cpu(), codes.cpu(), valid.cpu(),
                                                gm.cpu(), words))
    _same(got, kernels.orb_describe(img, codes, valid, *brief.OrbTables.build(dev), words))


@pytest.mark.parametrize("case", ["all invalid", "one bin", "random gm"])
def test_orb_describe_dense_cases(dev, case):
    img, codes, valid = _describe_case((800, 384), 2048, 5, dev)
    gm = brief.dense_weights(dev)
    if case == "all invalid":
        valid = torch.zeros_like(valid)
    elif case == "one bin":
        codes, valid = codes[9:10].repeat(2048), torch.ones_like(valid)
    else:
        rng = np.random.default_rng(6)
        gm = t(rng.integers(-128, 128, (1024, kernels.GM_COLS)).astype(np.int8)).to(dev)
    for words in (8, 3):
        got = kernels.orb_describe_dense(img, codes, valid, gm, words)
        _same(got, kernels.orb_describe_dense_plain(img, codes, valid, gm, words))
        if case == "all invalid":
            assert not got[0].any() and not got[1].any()


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
    # K = 1, 5 (not a whole block) and 8192, and rows 4 bytes into a buffer
    for k, offset in ((1, 0), (5, 0), (8192, 0), (300, 1)):
        buf = t(rng.integers(0, 2**32, k * 9 * 256 + 4, dtype=np.uint32).view(np.int32)).to(dev)
        rows = buf[offset:offset + k * 9 * 256].view(k, 9, 256)
        psi = t(rng.integers(0, 4, k).astype(np.int32)).to(dev)
        phi = t(rng.integers(0, 225, k).astype(np.int32)).to(dev)
        _same(kernels.realign_windows(rows, psi, phi),
              kernels.realign_windows_plain(rows, psi, phi))


@pytest.mark.parametrize("shape,offset", [
    ((64, 256), 0), ((800, 384), 0), ((2216, 640), 0), ((64, 384), 0), ((64, 640), 0),
    ((4, 384), 0), ((4, 256), 0), ((64, 384), 1), ((64, 384), 8)])
def test_k3a(dev, shape, offset):
    """The pyramids, W = 256 (one strip), 384 and 640, H = 4, and bases
    offset by 1 byte (the byte path) and by 8."""
    img = _at_offset(image(*shape, 4), offset, dev)
    _same(kernels.pack_row_strips(img), kernels.pack_row_strips_plain(img))
    _same(kernels.pack_row_strips(img), kernels.pack_row_strips_plain(img.cpu()))


@pytest.mark.parametrize("name", list(pnp_cases.CASES))
def test_motion_only_ba(dev, name):
    """Motion-only BA's kernel against ``motion_only_ba_plain`` on the card,
    on the same numpy inputs: within tests/pnp_cases.py's tolerances (R, t
    1e-5; inliers 2; costs 1e-5 relative: the kernel sums in another order
    and solves by its own LU), two launches bit-equal (no atomics in its
    sums), one launch a call, the plain version's dtypes and shapes."""
    arrays, params = pnp_cases.case(name)
    args = [torch.from_numpy(a).to(dev) for a in arrays]
    before = pnp.motion_only_ba_kernel.launches
    got = pnp.motion_only_ba(*args, **params)
    again = pnp.motion_only_ba(*args, **params)
    assert pnp.motion_only_ba_kernel.launches - before == 2
    want = pnp.motion_only_ba_plain(*args, **params)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], again[k]), k
    host = {k: v.cpu().numpy() for k, v in got.items()}
    assert not pnp_cases.mismatches(host, {k: v.cpu().numpy() for k, v in want.items()}, arrays)


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


def test_slam_chunk_on_card_matches_cpu(dev, monkeypatch):
    """process_chunk over the same four eval_seq frames as one chunk, on the
    card and on the CPU, both drawing from one CPU generator: the same
    decisions, counters and keyframes, poses within 1e-3; on the card K1,
    K2 and orb_describe once per frame, K5 twice and motion-only BA once per
    tracked frame."""
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
        slam = pislam_tpu_torch.KeyframeSLAM(cfg, *intr, keyframe_min_inliers=60,
                                             keyframe_max_gap=3, device=device)
        kernels.reset_launch_counts()
        out = slam.process_chunk(d["frames"][:4])
        runs.append((out, slam.state.counters.cpu(), slam.keyframe_frames,
                     kernels.launch_counts()))
    (card, c_card, kf_card, n_card), (cpu, c_cpu, kf_cpu, _) = runs
    assert kf_card == kf_cpu == [0, 3] and torch.equal(c_card, c_cpu)
    assert card["keyframe"].tolist() == cpu["keyframe"].tolist()
    assert np.abs(card["num_inliers"] - cpu["num_inliers"]).max() <= 2
    for k in ("pose_R", "pose_t"):
        assert np.abs(card[k] - cpu[k]).max() <= 1e-3
    for k in ("fused_frontend_codes", "topk_keys", "orb_describe"):
        assert n_card[k] == 4
    assert n_card["match_reduce"] == 6
    assert n_card["motion_only_ba"] == 3          # map tracking on every tracked frame


@pytest.fixture
def cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA cards")
    return torch.cuda.device_count()


def _run(*args, ranks=None):
    """``python -m ...`` from the repository root, under torchrun with
    ``ranks`` processes (one per card) where given."""
    launch = ["-m", "torch.distributed.run", f"--nproc-per-node={ranks}"] if ranks else []
    proc = subprocess.run([sys.executable, *launch, *args], cwd=ROOT, capture_output=True,
                          text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def test_dryrun_on_cards(cards):
    """dryrun_multichip over NCCL, one rank per card: mesh (cards / 2) x 2."""
    assert f"dryrun_multichip(n={cards}, " in _run("-m", "pislam_tpu_torch.parallel.dryrun",
                                                  ranks=cards)


def test_service_model_parallel_on_cards(cards, tmp_path):
    """--model-parallel N over N cards (NCCL), eval_seq with the end-of-run
    closure: the TUM rows of the service on one card, bit for bit."""
    seq = str(DATA / "eval_seq.npz")
    _run("-m", "pislam_tpu_torch.service", "--seq", seq, "--model-parallel", str(cards),
         "--traj-out", str(tmp_path / "sharded.txt"), ranks=cards)
    _run("-m", "pislam_tpu_torch.service", "--seq", seq, "--traj-out", str(tmp_path / "one.txt"))
    assert (tmp_path / "sharded.txt").read_text() == (tmp_path / "one.txt").read_text()
