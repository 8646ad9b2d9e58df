"""The pure-Python launch plans of K1 ``fused_frontend_codes``, K5
``match_reduce`` and K2 ``topk_keys``, the arithmetic and merge order
that csrc/match_reduce.cu relies on, and the thread mappings of K6, K3a,
K3b, K4 and K3c, on the CPU (the kernels themselves run
only on the card: test_torch_cuda.py).

- ``frontend_plan``: its grid of tiles covers every pixel and every 2x2
  code block exactly once, the tile is one of the two the kernel is built
  for, and the larger tile is taken where its grid gives at least 4 blocks
  per SM.
- ``match_plan``: every (row, column) pair lies in exactly one (row tile,
  segment) CTA, the map shapes give at least a CTA per SM, and the scratch
  sizes are those the kernel indexes.
- ``topk_plan``: every key count from k up fits the shared memory it is
  given, the keys in it (every count up to the VGA pyramid's 354,560) or in
  device memory (the KITTI and 720p pyramids, and any larger count).
- The kernel's reductions modelled in numpy: each thread's running row keys
  over its columns of each tile, the quad's merge, the segments' merge by
  atomic minima (a displaced best goes to second), and the column keys'
  minimum over row tiles, every merge in a shuffled order, equal
  ``match_reduce_plain`` (tolerance 0) on ties within and across tiles,
  segments and row tiles, duplicate rows, invalid rows and columns and
  gated-out pairs.
- The distance identity (32 words - (+-1 dot)) >> 1 == Hamming, with the
  kernel's bit-to-byte expansion, for 1..8 words.
- K6 ``reduce_codes_4x`` and K3a ``pack_row_strips`` modelled thread by
  thread in numpy (the vector path where the base is aligned, else the
  byte path; K6's 2x2 maximum of 8 codes per row pair, K3a's byte-permute
  transpose and its one-or-two-strip stores) equal their plain versions
  (tolerance 0) at the pyramids and the edge shapes and offsets, every
  output written once.
- K3b ``gather_windows_packed`` (two warps a keypoint, lane c reading
  window column c byte by byte, so no alignment path) and K4
  ``orb_select`` (a warp a keypoint: dp4a moments from a lane's column of
  words, by the vector or the byte path, redux, the lane-to-pair mapping
  and the word packing) modelled lane by lane in numpy equal their plain
  versions (tolerance 0) on chip_smoke's edge cases: K3b at K = 1 and
  8192, the 32x32 image, W % 4 in {1, 2, 3} and bases offset by 1-3
  bytes; K4 at 1-8 words, K = 1 and 8192, one bin, all -128 and 127, and
  windows and weights off their alignment.
- K3c ``realign_windows`` (kSplit warps a keypoint, kPerBlock keypoints a
  block, both read from csrc/realign_windows.cu; lane c's 4-byte loads of
  column phi + c in its rows, one funnel shift an output word) modelled
  lane by lane in numpy equals its plain version (tolerance 0), writes
  every output word once and reads only rows 0-8 and columns 0-255 of its
  own keypoint: on the eval and VGA pyramids' strip rows and chip_smoke's
  edge cases (K = 1, 5 and 8192, every phi 0 or 224, each psi alone, rows
  one int32 into their buffer).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pislam_tpu_torch import PyramidConfig
from pislam_tpu_torch import matching as tm
from pislam_tpu_torch.ops import kernels

torch.set_num_threads(1)

K1S = [1, 13, 64, 65, 512, 2048, 65536]
K2S = [1, 300, 512, 8192, 16384, 200_000]
# an H100 SXM: its SMs and the dynamic shared memory a block can opt into
# (what kernels.device_limits reads from the card)
H100_SMS = 132
H100_SMEM = 232_448


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# K1: the plan
# ---------------------------------------------------------------------------

# the default config's stacked pyramids (padded_height, stride): the eval
# config's 384x256 frame (4 levels), VGA, KITTI (1241x376) and 720p
PYRAMIDS = {"eval": (800, 384), "vga": (2216, 640), "kitti": (1736, 1280),
            "720p": (3320, 1280)}
K1_SHAPES = [(1, 1), (2, 2), (15, 31), (16, 32), (17, 33), (31, 63), (32, 64),
             (33, 65), (61, 77), (100, 130), (1600, 640), (4096, 4096),
             *PYRAMIDS.values()]


def _cover(n, size, count):
    """How often each of n positions lies in one of ``count`` spans of
    ``size``, and that none of the spans is empty."""
    hits = np.zeros(n, np.int64)
    for i in range(count):
        assert i * size < n
        hits[i * size:(i + 1) * size] += 1
    return hits


@pytest.mark.parametrize("shape", K1_SHAPES)
@pytest.mark.parametrize("tile", [None, *kernels.FRONTEND_TILES])
@pytest.mark.parametrize("sms", [114, 132])
def test_frontend_plan_covers_every_pixel(shape, tile, sms):
    """Every pixel in exactly one tile and every code (2x2 block) written
    by exactly one, at odd shapes, shapes below a tile and the pyramids, for
    the plan's choice and each forced tile."""
    h, w = shape
    plan = kernels.frontend_plan(h, w, sms, tile)
    assert (plan.th, plan.tw) in kernels.FRONTEND_TILES
    assert plan.th % 2 == 0 and plan.tw % 2 == 0
    if tile is not None:
        assert (plan.th, plan.tw) == tile
    rows, cols = kernels._cdiv(h, plan.th), kernels._cdiv(w, plan.tw)
    assert plan.ctas == rows * cols
    assert (_cover(h, plan.th, rows) == 1).all() and (_cover(w, plan.tw, cols) == 1).all()
    # a block writes codes (y0/2 + r, x0/2 + c) for r < th/2, c < tw/2 that
    # lie in the (ceil(h/2), ceil(w/2)) grid
    assert (_cover(-(-h // 2), plan.th // 2, rows) == 1).all()
    assert (_cover(-(-w // 2), plan.tw // 2, cols) == 1).all()


@pytest.mark.parametrize("sms", [114, 132])
def test_frontend_plan_fills_the_card(sms):
    """The larger tile exactly where its grid gives 4 blocks per SM: on an
    H100 SXM (132 SMs) 16x32 at the eval pyramid, 32x64 at VGA, KITTI and
    720p; a 1600x640 image takes 32x64 on 114 SMs (an H100 PCIe) but not
    on 132."""
    for h, w in K1_SHAPES:
        plan = kernels.frontend_plan(h, w, sms)
        big = kernels._cdiv(h, 32) * kernels._cdiv(w, 64)
        assert (plan.th, plan.tw) == ((32, 64) if big >= 4 * sms else (16, 32))
        assert plan.ctas >= min(big, 4 * sms)
    assert kernels.frontend_plan(*PYRAMIDS["eval"], sms)[:2] == (16, 32)
    for name in ("vga", "kitti", "720p"):
        assert kernels.frontend_plan(*PYRAMIDS[name], sms)[:2] == (32, 64)
    assert kernels.frontend_plan(1600, 640, sms)[:2] == ((32, 64) if sms == 114 else (16, 32))


@pytest.mark.parametrize("tile", [(8, 16), (32, 32), (15, 32)])
def test_frontend_plan_rejects_unbuilt_tiles(tile):
    with pytest.raises(ValueError):
        kernels.frontend_plan(800, 384, 132, tile)


def test_frontend_pyramid_shapes():
    """PYRAMIDS are the default config's (eval: 384x256, 4 levels)."""
    for name, (w, h, levels) in {"eval": (384, 256, 4), "vga": (640, 480, 8),
                                 "kitti": (1241, 376, 8), "720p": (1280, 720, 8)}.items():
        pc = PyramidConfig(base_width=w, base_height=h, num_levels=levels)
        assert (pc.padded_height, pc.stride) == PYRAMIDS[name]


# ---------------------------------------------------------------------------
# K5: the plan
# ---------------------------------------------------------------------------

def _spans(n, size, count):
    return [(i * size, min(n, (i + 1) * size)) for i in range(count)]


def _check_match_plan(k1, k2, sms):
    plan = kernels.match_plan(k1, k2, sms)
    assert plan.warpgroups in (1, 2) and (plan.warpgroups == 1 or k1 > 64)
    row_spans = _spans(k1, plan.rows, plan.row_tiles)
    seg = plan.tiles_per_segment * kernels.MATCH_TILE
    col_spans = _spans(k2, seg, plan.segments)
    # every row tile and segment is non-empty, and together they tile the
    # rows and the columns exactly once
    for spans, n in ((row_spans, k1), (col_spans, k2)):
        assert all(lo < hi for lo, hi in spans)
        assert spans[0][0] == 0 and spans[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert plan.ctas == plan.row_tiles * plan.segments <= 65535 * 65535
    assert plan.segments <= 65535 and plan.row_tiles <= 65535
    # merge state: words per row, a key per column, a ticket per row tile
    # and per segment; a row key holds the column within its segment in 16
    # bits
    assert plan.row_words == k1
    assert plan.col_keys == k2
    assert plan.tickets == plan.row_tiles + plan.segments
    assert seg <= 1 << 16
    if (k1, k2) in ((512, 8192), (2048, 16384)):
        assert plan.ctas >= sms
    return plan


@pytest.mark.parametrize("k1,k2", [(k1, k2) for k1 in K1S for k2 in K2S]
                         + [(2048, 2048), (65536, 70), (300, 64)])
def test_match_plan_covers_every_pair_once(k1, k2):
    _check_match_plan(k1, k2, H100_SMS)


@pytest.mark.parametrize("sms", [78, 114, 132])
def test_match_plan_fills_the_card(sms):
    """On cards of other SM counts (an H100 PCIe has 114) the plan still
    tiles every pair, and gives a CTA per SM wherever the database has a
    128-column tile for each."""
    for k1, k2 in ((512, 8192), (2048, 16384), (512, 512), (13, 300)):
        plan = _check_match_plan(k1, k2, sms)
        assert plan.ctas >= sms or plan.segments == kernels._cdiv(k2, kernels.MATCH_TILE)


# ---------------------------------------------------------------------------
# K2: the plan
# ---------------------------------------------------------------------------

def _pyramid_keys(w, h):
    """K2's key count at the default config's pyramid of a w x h frame: one
    key per 2x2 block of the stacked pyramid (K1's code grid)."""
    pc = PyramidConfig(base_width=w, base_height=h)
    return kernels._cdiv(pc.padded_height, 2) * kernels._cdiv(pc.stride, 2)


VGA_KEYS = 354_560
MAX_CODE_KEYS = 2048 * 2048     # K1's codes hold 12-bit coordinates: 4096 x 4096 pixels


def _check_topk_plan(n, k, plan, smem_limit):
    p = max(32, 1 << (k - 1).bit_length())
    share = kernels._cdiv(kernels._cdiv(n, kernels.TOPK_GROUP),
                          kernels.TOPK_CLUSTER) * kernels.TOPK_GROUP
    cap = plan.cap
    assert plan.cluster == kernels.TOPK_CLUSTER
    # the sort's capacity: a power of two from max(k, 32) to twice that, at
    # most 8192 (8 keys a thread on 1024 threads), the larger where it fits
    assert cap in (p, 2 * p) and cap <= kernels.MAX_TOPK
    if plan.chunk:
        # each CTA holds its share of the 8-key groups in shared memory
        assert plan.chunk == share and plan.chunk * plan.cluster >= n
    else:
        # the keys stay in device memory only where even the least sort's
        # shares do not fit beside them
        assert 4 * (max(share, p) + p + 2 * 256 + 16) > smem_limit
    assert plan.smem == 4 * (max(plan.chunk, cap) + cap + 2 * 256 + 16) <= smem_limit
    if cap == p and p < kernels.MAX_TOPK:
        assert 4 * (max(plan.chunk, 2 * p) + 2 * p + 2 * 256 + 16) > smem_limit


@pytest.mark.parametrize("k", [1, 512, 2048, 8192])
def test_topk_plan_fits_or_raises(k):
    """Every n from k to VGA's keys (each one), around where the keys leave
    shared memory, and on to the most keys K1's codes give (a sample) and
    the int32 limit: a plan that fits, the keys in shared memory up to VGA;
    ValueError for n < k, n past the limit, or a card too small for the
    sort."""
    boundary = None
    for n in range(k, VGA_KEYS + 1):
        plan = kernels.topk_plan(n, k, H100_SMEM)
        _check_topk_plan(n, k, plan, H100_SMEM)
        assert plan.chunk                            # VGA and the eval pyramid
    for n in range(VGA_KEYS, MAX_CODE_KEYS + 1, 101):
        plan = kernels.topk_plan(n, k, H100_SMEM)
        _check_topk_plan(n, k, plan, H100_SMEM)
        if boundary is None and not plan.chunk:
            boundary = n
    assert boundary is not None
    for n in range(boundary - 2000, boundary + 2000):    # every n where it changes
        _check_topk_plan(n, k, kernels.topk_plan(n, k, H100_SMEM), H100_SMEM)
    _check_topk_plan(kernels.TOPK_MAX_KEYS, k,
                     kernels.topk_plan(kernels.TOPK_MAX_KEYS, k, H100_SMEM), H100_SMEM)
    for n, limit in ((k - 1, H100_SMEM), (kernels.TOPK_MAX_KEYS + 1, H100_SMEM),
                     (max(k, 1000), 4 * (32 + 32 + 2 * 256 + 16) - 1)):
        if n >= 1:
            with pytest.raises(ValueError):
                kernels.topk_plan(n, k, limit)


@pytest.mark.parametrize("frame,n,resident", [
    ((640, 480), VGA_KEYS, True), ((384, 256), None, True),
    ((1241, 376), 555_520, False), ((1280, 720), 1_062_400, False)])
@pytest.mark.parametrize("k", [512, 2048, 8192])
def test_topk_plan_pyramids(frame, n, resident, k):
    """The default config's pyramids of a VGA, a KITTI (1241x376) and a 720p
    frame, and of a 384x256 one: VGA's and 384x256's keys stay in shared
    memory, KITTI's and 720p's in device memory; each plan fits an H100's
    blocks and blocks of less shared memory (99 KB)."""
    got = _pyramid_keys(*frame)
    assert n is None or got == n
    for limit in (H100_SMEM, 101_376):
        plan = kernels.topk_plan(got, k, limit)
        _check_topk_plan(got, k, plan, limit)
        if limit == H100_SMEM:
            assert bool(plan.chunk) == resident


# ---------------------------------------------------------------------------
# K5: the kernel's arithmetic and merge order, modelled
# ---------------------------------------------------------------------------

def _expand_like_kernel(d):
    """(K, W) u32 words -> (K, 32 W) int8 +-1 bytes, as csrc/match_reduce.cu
    expand4 builds them: 4 bits at a time, byte j = bit j ? -1 : +1."""
    out = np.empty((d.shape[0], d.shape[1] * 8), np.uint32)
    for nib in range(8):
        n = (d >> np.uint32(4 * nib)) & np.uint32(0xF)
        out[:, nib::8] = (np.uint32(0x01010101)
                          + ((n * np.uint32(0x00204081)) & np.uint32(0x01010101))
                          * np.uint32(0xFE))
    return out.view(np.int8).reshape(d.shape[0], d.shape[1] * 32)


@pytest.mark.parametrize("words", range(1, 9))
def test_pm1_dot_gives_hamming(words):
    rng = np.random.default_rng(words)
    d1 = rng.integers(0, 2**32, (40, words), dtype=np.uint32)
    d2 = rng.integers(0, 2**32, (70, words), dtype=np.uint32)
    d2[3] = d1[5]                                   # distance 0
    d2[4] = ~d1[6]                                  # distance 32 words
    a, b = _expand_like_kernel(d1), _expand_like_kernel(d2)
    assert set(np.unique(a)) <= {-1, 1}
    dot = a.astype(np.int32) @ b.astype(np.int32).T
    got = (32 * words - dot) >> 1
    want = np.unpackbits((d1[:, None, :] ^ d2[None, :, :]).view(np.uint8),
                         axis=-1).sum(-1)
    assert np.array_equal(got, want)
    assert got[5, 3] == 0 and got[6, 4] == 32 * words
    # and the port's own plain distances
    assert np.array_equal(tm.hamming_matrix(t(d1.view(np.int32)),
                                            t(d2.view(np.int32))).numpy(), want)


def _key_rule(keys, cols):
    """A thread's running row keys over its columns in increasing order:
    best = min(best, key), second = min(second, max(best, key)), keys
    (d << 16) | (column - segment start), from (MAX << 16, MAX << 16)."""
    k1 = keys.shape[0]
    bk = np.full(k1, tm.MAX_DIST << 16, np.int64)
    sk = bk.copy()
    for j in cols:
        sk = np.minimum(sk, np.maximum(bk, keys[:, j]))
        bk = np.minimum(bk, keys[:, j])
    return bk, sk


def _key_merge(a, b):
    """The quad's merge on the same keys (csrc/match_reduce.cu
    key_merge_lanes)."""
    (ba, sa), (bb, sb) = a, b
    return np.minimum(ba, bb), np.minimum(np.minimum(sa, sb), np.maximum(ba, bb))


def kernel_model(case, seed):
    """csrc/match_reduce.cu's reductions in numpy, every merge in a shuffled
    order. Per segment and lane class q (the columns 8i + 2q + {0, 1} of
    each tile, which one thread holds) the running row keys; the four
    classes merged as the quad merges them; each segment's (best, second,
    idx) then put into the row's merge words as the atomics do (merge_row:
    the 64-bit min of (best << 32) | idx, and the value it displaces and
    the segment's second into the min of second); column keys
    (d << 16) | row reduced per row tile, then over row tiles."""
    rng = np.random.default_rng(seed)
    d1, d2, v1, v2 = case["d1"], case["d2"], case["v1"], case["v2"]
    k1, k2, words = d1.shape[0], d2.shape[0], d1.shape[1]
    dot = (_expand_like_kernel(d1).astype(np.int32)
           @ _expand_like_kernel(d2).astype(np.int32).T)
    dist = ((32 * words - dot) >> 1).astype(np.int64)
    ok = np.broadcast_to(v2[None, :], dist.shape).copy()
    if "radius" in case:
        uv1, uv2 = case["uv1"], case["uv2"]
        with np.errstate(invalid="ignore", over="ignore"):   # inf - inf, 1e6**2
            dx = uv1[:, None, 0] - uv2[None, :, 0]
            dy = uv1[:, None, 1] - uv2[None, :, 1]
            ok &= dx * dx + dy * dy <= np.float32(case["radius"] * case["radius"])
    # the row keys see the column penalties and the gate; an invalid row's
    # triple is set when the segment ends
    dist = np.where(ok, dist, tm.MAX_DIST)

    plan = kernels.match_plan(k1, k2, H100_SMS)
    seg = plan.tiles_per_segment * kernels.MATCH_TILE
    best_word = np.full(k1, 2**64 - 1, np.uint64)
    second_word = np.full(k1, 2**32 - 1, np.uint64)
    segments = []
    for lo, hi in _spans(k2, seg, plan.segments):
        keys = (dist[:, lo:hi] << 16) | np.arange(hi - lo)[None, :]
        parts = [_key_rule(keys, [c for c in range(hi - lo) if c % 8 // 2 == q])
                 for q in range(4)]
        order = rng.permutation(4)
        bk, sk = parts[order[0]]
        for i in order[1:]:
            bk, sk = _key_merge((bk, sk), parts[i])
        best = np.where(v1, bk >> 16, tm.MAX_DIST)
        second = np.where(v1, sk >> 16, tm.MAX_DIST)
        idx = lo + np.where(v1, bk & 0xFFFF, 0)
        segments.append((best, second, idx))
    for i in rng.permutation(len(segments)):
        best, second, idx = segments[i]
        mine = (best.astype(np.uint64) << np.uint64(32)) | idx.astype(np.uint64)
        old = best_word
        best_word = np.minimum(old, mine)
        loser = np.maximum(old, mine) >> np.uint64(32)
        second_word = np.minimum(second_word, np.minimum(loser, second.astype(np.uint64)))

    dist = np.where(v1[:, None], dist, tm.MAX_DIST)
    keys = (dist << 16) | np.arange(k1)[:, None]
    tile_min = [keys[lo:hi].min(0) for lo, hi in _spans(k1, plan.rows, plan.row_tiles)]
    col = np.full(k2, 0x7FFFFFFF)
    for i in rng.permutation(len(tile_min)):
        col = np.minimum(col, tile_min[i])
    return ((best_word >> np.uint64(32)).astype(np.int64), second_word.astype(np.int64),
            (best_word & np.uint64(0xFFFFFFFF)).astype(np.int64), col & 0xFFFF)


def _model_case(seed, k1, k2, words=8, gated=False):
    """Ties within a tile, across tiles, across segments and across row
    tiles; duplicate query rows; invalid rows and columns; for the gate a
    perfect match outside it, inf and 1e6 points and a pair on the radius."""
    rng = np.random.default_rng(seed)
    d1 = rng.integers(0, 2**32, (k1, words), dtype=np.uint32)
    d2 = rng.integers(0, 2**32, (k2, words), dtype=np.uint32)
    plan = kernels.match_plan(k1, k2, H100_SMS)
    seg = plan.tiles_per_segment * kernels.MATCH_TILE
    ties = [2, 9, 130 % k2, (seg + 1) % k2, k2 - 1]
    d2[ties] = d1[1]                             # row 1 ties in tiles and segments
    d2[20] = d1[4] ^ np.uint32(1)
    d2[(seg + 20) % k2] = d1[4]                  # a later segment beats an earlier one
    d1[k1 - 1] = d1[1]                           # duplicate rows, also in another
    d1[min(plan.rows, k1 - 1)] = d1[1]           # row tile where there is one
    v1, v2 = rng.random(k1) < 0.85, rng.random(k2) < 0.85
    v1[[1, 4, k1 - 1, min(plan.rows, k1 - 1)]] = True
    v2[ties + [20, (seg + 20) % k2]] = True
    v2[33] = False
    v1[7] = False
    case = {"d1": d1, "d2": d2, "v1": v1, "v2": v2, "ties": sorted(set(ties))}
    if gated:
        uv1 = rng.uniform(-0.1, 0.1, (k1, 2)).astype(np.float32)
        uv2 = rng.uniform(-0.1, 0.1, (k2, 2)).astype(np.float32)
        uv2[ties] = uv1[1]
        uv2[9] = uv1[1] + np.float32([0.3, 0.0])  # a perfect match gated out
        case["ties"] = sorted(set(ties) - {9})
        uv2[40], uv2[41], uv1[11] = 1e6, np.inf, np.inf
        uv1[12] = uv2[12] + np.float32([0.06, 0.0])   # on the radius
        case.update(uv1=uv1, uv2=uv2, radius=0.06)
    return case


def _plain(case):
    args = [t(case["d1"].view(np.int32)), t(case["d2"].view(np.int32)), t(case["v1"]),
            t(case["v2"])]
    if "radius" in case:
        args += [t(case["uv1"]), t(case["uv2"]), case["radius"]]
    return [o.numpy() for o in kernels.match_reduce_plain(*args)]


@pytest.mark.parametrize("k1,k2,words,gated", [
    (200, 700, 8, False), (200, 700, 8, True), (130, 300, 4, False),
    (65, 513, 1, True), (64, 129, 8, False), (300, 1000, 8, True),
    (300, 700, 8, False), (130, 2000, 8, True), (20, 70, 8, False)])
def test_kernel_merge_model_equals_plain(k1, k2, words, gated):
    case = _model_case(k1 * 7 + k2 + words, k1, k2, words, gated)
    want = _plain(case)
    for seed in range(3):                        # three shuffled merge orders
        got = kernel_model(case, seed)
        for name, g, w in zip(("best", "second", "idx", "col_argmin"), got, want):
            assert np.array_equal(g, w), (name, seed)
    # the case exercises what it claims: row 1 ties in several columns and
    # segments, and an all-invalid row keeps (MAX, MAX, 0)
    assert want[0][1] == 0 and want[2][1] == case["ties"][0] and want[1][1] == 0
    assert want[0][7] == want[1][7] == tm.MAX_DIST and want[2][7] == 0


# ---------------------------------------------------------------------------
# K5 beyond MAX_MATCH_ROWS: query rows in chunks, merged
# ---------------------------------------------------------------------------

def _chunk_case(seed, k1, k2, words, gated):
    """Query rows that tie across chunk boundaries (rows 3, 10, 17 and
    k1 - 1 equal, each column 2, 9 and k2 - 1 their perfect match), a later
    chunk's row beating an earlier chunk's near miss in column 5, an
    all-invalid column 6, invalid rows; for the gate inf points and a pair
    on the radius. Returns the plain arguments as CPU tensors."""
    rng = np.random.default_rng(seed)
    d1 = rng.integers(0, 2**32, (k1, words), dtype=np.uint32)
    d2 = rng.integers(0, 2**32, (k2, words), dtype=np.uint32)
    d1[[10, 17, k1 - 1]] = d1[3]
    d2[[2, 9, k2 - 1]] = d1[3]
    d2[5] = d1[k1 - 2]
    d1[1] = d1[k1 - 2] ^ np.uint32(1)
    v1, v2 = rng.random(k1) < 0.85, rng.random(k2) < 0.85
    v1[[1, 3, 10, 17, k1 - 2, k1 - 1]] = True
    v1[[4, 11]] = False
    v2[[2, 5, 9, k2 - 1]] = True
    v2[6] = False
    args = [t(d1.view(np.int32)), t(d2.view(np.int32)), t(v1), t(v2)]
    if gated:
        uv1 = rng.uniform(-0.05, 0.05, (k1, 2)).astype(np.float32)
        uv2 = rng.uniform(-0.05, 0.05, (k2, 2)).astype(np.float32)
        uv2[[2, 9, k2 - 1]] = uv1[3]
        uv1[[10, 17, k1 - 1]] = uv1[3]
        uv2[12], uv1[13] = np.inf, np.inf
        uv1[14] = uv2[15] + np.float32([0.06, 0.0])    # on the radius
        args += [t(uv1), t(uv2), 0.06]
    return args


@pytest.mark.parametrize("chunk", [1, 7, 16, 49, 50, 64])
@pytest.mark.parametrize("k1,k2,words,gated", [
    (50, 40, 8, False), (50, 40, 8, True), (37, 300, 4, True), (23, 129, 1, False)])
def test_match_reduce_chunked_equals_plain(k1, k2, words, gated, chunk):
    """``match_reduce_chunked`` with the plain version on each chunk of
    rows equals the plain version on all rows: ties across chunks go to the
    lowest row, an all-invalid column to row 0, gated or not."""
    args = _chunk_case(k1 + k2 + words, k1, k2, words, gated)
    calls = []

    def per_chunk(*a):
        calls.append(a[0].shape[0])
        return kernels.match_reduce_plain(*a)

    got = kernels.match_reduce_chunked(per_chunk, chunk, *args)
    want = kernels.match_reduce_plain(*args)
    assert calls == [min(chunk, k1 - lo) for lo in range(0, k1, chunk)]
    for name, g, w in zip(("best", "second", "idx", "col_argmin"), got, want):
        assert g.dtype == w.dtype == torch.int32 and torch.equal(g, w), name
    col = want[3].numpy()
    assert col[6] == 0                           # all-invalid column: row 0
    if not gated or k1 > 17:
        assert col[2] == col[9] == 3             # tied rows 3, 10, 17: the lowest


# ---------------------------------------------------------------------------
# K6 reduce_codes_4x and K3a pack_row_strips: each thread's work
# ---------------------------------------------------------------------------

# csrc/reduce_codes.cu's kCols and kThreads; csrc/pack_row_strips.cu's tile
# (4 columns: kLanes = 32 per 128-column segment) and kThreads
K6_COLS, K6_THREADS = 8, 256
K3A_TILE, K3A_THREADS = 4, 256


def _in_buffer(a, offset):
    """a's bytes at byte `offset` of a buffer whose own start is 16-byte
    aligned (the allocator's), with bytes that are not the image's (nonzero)
    around them: (buffer, offset)."""
    return np.concatenate([np.full(offset, 0xA5, np.uint8), a.ravel(),
                           np.full(16, 0xA5, np.uint8)]), offset


def _words(rows, aligned=True):
    """(n, b) bytes -> (n, b / 4) little-endian u32 words: what a vector load
    of b bytes gives (aligned), or what the byte path assembles."""
    if aligned:
        return np.ascontiguousarray(rows).view("<u4").astype(np.uint32)
    b = rows.reshape(rows.shape[0], -1, 4).astype(np.uint32)
    return b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)


def _encode(b, x, y):
    b = b.astype(np.uint32)
    return np.where(b != 0, (b << 24) | (np.uint32(x) << 12) | np.uint32(y), 0).astype(np.uint32)


def divisor(d: int) -> tuple[int, int]:
    """csrc/reduce_codes.cu's make_divisor: (mul, shift) with t / d ==
    umulhi(t, mul) >> shift for 0 <= t < 2^31 (mul = 0: d = 1)."""
    lg = (d - 1).bit_length()
    return (0, 0) if d == 1 else (((1 << (31 + lg)) + d - 1) // d, lg - 1)


def divide(t, mul: int, shift: int):
    """The kernel's divide(): the high 32 bits of t * mul, shifted."""
    if not mul:
        return t
    return ((t.astype(np.uint64) * np.uint64(mul)) >> np.uint64(32 + shift)).astype(np.int64)


def k6_model(buf, off, h, w):
    """csrc/reduce_codes.cu, every thread at once: thread t of the flat grid
    owns row pair r = t / chunks (by the multiply-high) and columns x0 =
    (t - r * chunks) * kCols.
    With the base 16-byte aligned and W % 16 == 0 it loads kCols bytes of
    each row (the bottom row past an odd H as 0), takes each output's 2x2
    maximum of 4 codes and stores kCols / 2 codes; otherwise it reads its
    columns byte by byte within the image. Returns the (ceil(H/2),
    ceil(W/2)) codes as int32 and how often each output was written."""
    cols = K6_COLS
    h2, w2 = (h + 1) // 2, (w + 1) // 2
    chunks = -(-w // cols)
    n = h2 * chunks
    t = np.arange(-(-n // K6_THREADS) * K6_THREADS)
    t = t[t < n]
    r = divide(t, *divisor(chunks))
    x0, y0 = (t - r * chunks) * cols, 2 * r
    out = np.zeros(h2 * w2, np.uint32)
    writes = np.zeros(h2 * w2, np.int64)
    if off % 16 == 0 and w % 16 == 0:
        at = off + y0[:, None] * w + x0[:, None] + np.arange(cols)
        top = _words(buf[at])
        bottom = np.where((y0 + 1 < h)[:, None], _words(buf[np.minimum(at + w, buf.size - 1)]),
                          0).astype(np.uint32)
        for k in range(cols // 2):
            a = top[:, k // 2] >> np.uint32(16 * (k % 2))
            b = bottom[:, k // 2] >> np.uint32(16 * (k % 2))
            x = x0 + 2 * k
            code = np.maximum(
                np.maximum(_encode(a & 0xFF, x, y0), _encode((a >> 8) & 0xFF, x + 1, y0)),
                np.maximum(_encode(b & 0xFF, x, y0 + 1), _encode((b >> 8) & 0xFF, x + 1, y0 + 1)))
            out[r * w2 + x0 // 2 + k] = code
            np.add.at(writes, r * w2 + x0 // 2 + k, 1)
    else:
        for k in range(cols // 2):
            x = x0 + 2 * k
            live = x < w
            best = np.zeros(t.size, np.uint32)
            for dy in (0, 1):
                for dx in (0, 1):
                    ok = live & (y0 + dy < h) & (x + dx < w)
                    px = buf[np.where(ok, off + (y0 + dy) * w + x + dx, 0)]
                    best = np.maximum(best, np.where(ok, _encode(px, x + dx, y0 + dy), 0))
            idx = (r * w2 + x0 // 2 + k)[live]
            out[idx] = best[live]
            np.add.at(writes, idx, 1)
    return out.view(np.int32).reshape(h2, w2), writes


def byte_perm(x, y, s: int):
    """CUDA's __byte_perm(x, y, s): byte n of the result is byte
    (s >> 4n) & 7 of the 8 bytes y:x."""
    v = (y.astype(np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    out = np.zeros(x.shape, np.uint64)
    for n in range(4):
        sel = (s >> (4 * n)) & 7
        out |= ((v >> np.uint64(8 * sel)) & np.uint64(0xFF)) << np.uint64(8 * n)
    return out.astype(np.uint32)


def k3a_model(buf, off, h, w):
    """csrc/pack_row_strips.cu, every thread at once: block (bx, seg) thread
    i owns row group r = bx * kRows + i // kLanes and the 4 columns from x =
    128 seg + (i % kLanes) * 4; it loads 4 bytes of each of its 4 rows (one
    load where the base is 4-byte aligned, else byte by byte: the same
    words), transposes the 4x4 bytes with the 8 byte permutes, and stores
    its 4 words to strip seg at column x % 128 where seg < W/128 - 1 and to
    strip seg - 1 at column 128 + x % 128 where seg > 0. Returns the strips
    as int32 and how often each word was written."""
    tile = K3A_TILE
    lanes = 128 // tile
    rows_per_block = K3A_THREADS // lanes
    h4, segs = h // 4, w // 128
    ns = segs - 1
    bx, seg, i = np.meshgrid(np.arange(-(-h4 // rows_per_block)), np.arange(segs),
                             np.arange(K3A_THREADS), indexing="ij")
    r = (bx * rows_per_block + i // lanes).ravel()
    seg, col = seg.ravel()[r < h4], (i % lanes * tile).ravel()[r < h4]
    r = r[r < h4]
    at = off + 4 * r * w + 128 * seg + col
    rows = [_words(buf[at[:, None] + j * w + np.arange(tile)], off % 4 == 0)
            for j in range(4)]
    words = []
    for g in range(tile // 4):
        a, b, c, d = (rw[:, g] for rw in rows)
        t0, t1 = byte_perm(a, b, 0x5140), byte_perm(c, d, 0x5140)
        t2, t3 = byte_perm(a, b, 0x7362), byte_perm(c, d, 0x7362)
        words += [byte_perm(t0, t1, 0x5410), byte_perm(t0, t1, 0x7632),
                  byte_perm(t2, t3, 0x5410), byte_perm(t2, t3, 0x7632)]
    words = np.stack(words, 1)
    out = np.zeros(ns * h4 * 256, np.uint32)
    writes = np.zeros(out.size, np.int64)
    for keep, base in ((seg < ns, (seg * h4 + r) * 256 + col),
                       (seg > 0, ((seg - 1) * h4 + r) * 256 + 128 + col)):
        idx = base[keep][:, None] + np.arange(tile)
        out[idx] = words[keep]
        np.add.at(writes, idx.ravel(), 1)
    return out.view(np.int32).reshape(ns, h4, 256), writes


def _scored(h, w, seed):
    """A grid with 40 % of its pixels scored (more than one per 2x2 block,
    so every maximum is exercised)."""
    rng = np.random.default_rng(seed)
    s = rng.integers(1, 256, (h, w), dtype=np.uint8)
    s[rng.random((h, w)) >= 0.4] = 0
    return s


# the pyramids, odd H, odd W, W = 2, W % 16 in {2, 8, 14}, bases offset by 0,
# 1, 4 and 8 bytes, all zero, and every pixel at score 255 (2x2 maxima
# decided by x then y) up to the 4095 coordinate limit
K6_CASES = {"eval": ((800, 384), 0), "vga": ((2216, 640), 0), "odd H": ((61, 64), 0),
            "odd W": ((64, 61), 0), "W=2": ((63, 2), 0), "W%16=2": ((40, 130), 0),
            "W%16=8": ((41, 136), 0), "W%16=14": ((40, 142), 0), "base+1": ((64, 256), 1),
            "base+4": ((64, 256), 4), "base+8": ((64, 256), 8), "all zero": ((64, 256), 0),
            "255 at x 4095": ((6, 4096), 0), "255 at y 4095": ((4096, 16), 0),
            "255 at 4095 odd": ((4095, 17), 3)}


@pytest.mark.parametrize("d", [1, 2, 3, 7, 8, 48, 80, 97, 255, 256, 511, 512, 513, 4095])
def test_k6_divisor_is_exact(d):
    """The multiply-high gives t / d exactly for every thread index up to
    the largest grid (2048 row pairs x 512 chunks) and around 2^31."""
    mul, shift = divisor(d)
    assert mul < 2**32
    t = np.concatenate([np.arange(2048 * 512 + 1), np.arange(2**31 - 4096, 2**31)])
    assert np.array_equal(divide(t, mul, shift), t // d)


@pytest.mark.parametrize("case", list(K6_CASES))
def test_k6_thread_model_equals_plain(case):
    (h, w), off = K6_CASES[case]
    if case == "all zero":
        scored = np.zeros((h, w), np.uint8)
    elif case.startswith("255"):
        scored = np.full((h, w), 255, np.uint8)
    else:
        scored = _scored(h, w, h * 7 + w + off)
    got, writes = k6_model(*_in_buffer(scored, off), h, w)
    want = kernels.reduce_codes_4x_plain(t(scored)).numpy()
    assert np.array_equal(got, want)
    assert (writes == 1).all()                   # each code written once
    if case.startswith("255"):                   # the largest x, then y, of each block
        assert got.view(np.uint32)[-1, -1] >> 24 == 255
        assert (got.view(np.uint32)[-1, -1] >> 12) & 0xFFF == w - 1
        assert got.view(np.uint32)[-1, -1] & 0xFFF == h - 1


def test_byte_perm_transposes_4x4_blocks():
    """The 8 permutes turn 4 row words into 4 column words (tolerance 0)."""
    rows = np.random.default_rng(3).integers(0, 2**32, (4, 1000), dtype=np.uint32)
    a, b, c, d = rows
    t0, t1 = byte_perm(a, b, 0x5140), byte_perm(c, d, 0x5140)
    t2, t3 = byte_perm(a, b, 0x7362), byte_perm(c, d, 0x7362)
    got = [byte_perm(t0, t1, 0x5410), byte_perm(t0, t1, 0x7632),
           byte_perm(t2, t3, 0x5410), byte_perm(t2, t3, 0x7632)]
    by = rows.T.copy().view(np.uint8).reshape(-1, 4, 4)      # (n, row, column)
    want = np.ascontiguousarray(by.transpose(0, 2, 1)).view("<u4")[..., 0].T
    assert np.array_equal(np.stack(got), want)


# the pyramids, W = 256 (one strip), 384 and 640, H = 4, bases offset by 1 and 8
K3A_CASES = {"eval": ((800, 384), 0), "vga": ((2216, 640), 0), "W=256": ((64, 256), 0),
             "W=384": ((64, 384), 0), "W=640": ((64, 640), 0), "H=4": ((4, 384), 0),
             "H=4 W=256": ((4, 256), 0), "base+1": ((64, 384), 1), "base+8": ((64, 384), 8)}


@pytest.mark.parametrize("case", list(K3A_CASES))
def test_k3a_thread_model_equals_plain(case):
    (h, w), off = K3A_CASES[case]
    img = np.random.default_rng(h + w + off).integers(0, 256, (h, w), np.uint8)
    got, writes = k3a_model(*_in_buffer(img, off), h, w)
    assert np.array_equal(got, kernels.pack_row_strips_plain(t(img)).numpy())
    assert (writes == 1).all()                   # each strip word written once


# ---------------------------------------------------------------------------
# K3b and K4: a warp per keypoint
# ---------------------------------------------------------------------------

def _window_origin(xs, ys, valid, h, w):
    """The window's origin: invalid to (16, 16), then the clip to [15, w-17]
    x [15, h-17], less 15."""
    x0 = np.clip(np.where(valid, xs, 16), 15, w - 17) - 15
    y0 = np.clip(np.where(valid, ys, 16), 15, h - 17) - 15
    return x0.astype(np.int64), y0.astype(np.int64)


K3B_SPLIT, K3B_PER_BLOCK = 2, 4      # csrc/gather_windows.cu kSplit, kPerBlock


def k3b_model(buf, off, h, w, xs, ys, valid):
    """csrc/gather_windows.cu, every thread at once: block b holds keypoints
    4b..4b+3, two warps each; lane c of a keypoint's warp s (0 or 1) reads
    the keypoint's x, y and valid, then the bytes of window column c in rows
    16s..16s+15, one byte load each (no alignment needed, so every base,
    width and origin takes this path), and stores word a * 32 + c, rows
    4a..4a+3, for its row groups a = 4s..4s+3, 0x80 XORed into each byte.
    Returns the (K, 1024) int8 windows and how often each word was written."""
    k = xs.size
    x0, y0 = _window_origin(xs, ys, valid, h, w)
    threads = 32 * K3B_SPLIT * K3B_PER_BLOCK
    t = np.arange(-(-k // K3B_PER_BLOCK) * threads)
    warp, lane = t % threads // 32, t % 32
    kp = t // threads * K3B_PER_BLOCK + warp // K3B_SPLIT
    half, lane = (warp % K3B_SPLIT)[kp < k], lane[kp < k]
    kp = kp[kp < k]
    out = np.zeros((k, 256), np.uint32)
    writes = np.zeros((k, 256), np.int64)
    groups = 8 // K3B_SPLIT
    for g in range(groups):
        a = half * groups + g
        word = np.zeros(kp.size, np.uint32)
        for b in range(4):
            px = buf[off + (y0[kp] + 4 * a + b) * w + x0[kp] + lane]
            word |= px.astype(np.uint32) << np.uint32(8 * b)
        out[kp, a * 32 + lane] = word ^ np.uint32(0x80808080)
        np.add.at(writes, (kp, a * 32 + lane), 1)
    return out.view(np.int8).reshape(k, 1024), writes


def _k3b_case(h, w, k, seed):
    """chip_smoke.k3b_edge_cases' keypoints: the four corners, every clip
    limit, invalid ones with stale coordinates, then seeded keypoints in and
    around the image."""
    rng = np.random.default_rng(seed)
    ex = [w - 1, 0, 15, 16, w - 17, w - 16, w - 1, 0, w + 100, 3000, -5]
    ey = [h - 1, 0, 15, h - 17, 16, h - 16, 0, h - 1, h + 100, -5, 4000]
    ev = [True] * 9 + [False] * 2
    xs = np.concatenate([ex, rng.integers(-20, w + 20, k)])[:k].astype(np.int32)
    ys = np.concatenate([ey, rng.integers(-20, h + 20, k)])[:k].astype(np.int32)
    valid = np.concatenate([ev, rng.random(k) < 0.8])[:k]
    img = rng.integers(0, 256, (h, w), np.uint8)
    return img, xs, ys, valid


# the pyramids at the path's keypoint counts, then chip_smoke.k3b_edge_cases:
# K = 1 (the bottom-right corner), K = 8192, the 32x32 image, W % 4 in {1, 2,
# 3} and the base offset by 1, 2 and 3 bytes
K3B_CASES = {"eval": ((800, 384), 512, 0), "vga": ((2216, 640), 2048, 0),
             "K=1": ((64, 96), 1, 0), "K=8192": ((480, 640), 8192, 0),
             "32x32": ((32, 32), 40, 0), "W%4=1": ((61, 97), 300, 0),
             "W%4=2": ((64, 98), 300, 0), "W%4=3": ((67, 99), 300, 0),
             "base+1": ((64, 97), 300, 1), "base+2": ((64, 98), 300, 2),
             "base+3": ((64, 99), 300, 3)}


@pytest.mark.parametrize("case", list(K3B_CASES))
def test_k3b_thread_model_equals_plain(case):
    (h, w), k, off = K3B_CASES[case]
    img, xs, ys, valid = _k3b_case(h, w, k, h + w + k + off)
    got, writes = k3b_model(*_in_buffer(img, off), h, w, xs, ys, valid)
    want = kernels.gather_windows_packed_plain(t(img), t(xs), t(ys), t(valid)).numpy()
    assert np.array_equal(got, want)
    assert (writes == 1).all()                   # each word written once


def dp4a(a, b, c):
    """CUDA's __dp4a(a, b, c) on signed bytes: c + the sum of the 4 products."""
    def signed(x, n):
        return ((x.astype(np.int64) >> (8 * n)) & 0xFF) - 256 * ((x.astype(np.int64) >> (8 * n + 7)) & 1)
    return c + sum(signed(a, n) * signed(b, n) for n in range(4))


def k4_model(buf, off, k, idx0, idx1, mw_buf, mw_off, words):
    """csrc/orb_select.cu, every lane of every warp at once: lane c of
    keypoint k takes words c, 32 + c, ..., 224 + c of its window and the 8
    bytes of mom_w beside each. With the windows 4-byte and mom_w 8-byte
    aligned, one 4-byte and one 8-byte load each, the weights split into
    m10 and m01 by two byte permutes; else byte by byte, the weights every
    other byte. dp4a adds 4 products each; one redux per moment sums the
    lanes, each lane computes the bin; lane l compares pairs l + 32 j of the
    bin for all 8 words (the tables from shared memory or through L1: the
    same entries), one ballot per word j, and lane j stores word j for j <
    words. Returns the bins and the (K, words) int32 words."""
    i = np.arange(8)[:, None] * 32 + np.arange(32)          # (a, lane): word index
    vector = off % 4 == 0 and mw_off % 8 == 0
    win = _words(buf[off:off + k * 1024].reshape(k, 1024), vector)[:, i]
    mw = mw_buf[mw_off:mw_off + 2048].reshape(256, 8)
    if vector:
        wt = mw.copy().view("<u4")[i]                        # (a, lane, 2): uint2 x, y
        wx = byte_perm(wt[..., 0], wt[..., 1], 0x6420)
        wy = byte_perm(wt[..., 0], wt[..., 1], 0x7531)
    else:
        wx = _words(mw[:, 0::2], False)[i][..., 0]
        wy = _words(mw[:, 1::2], False)[i][..., 0]
    m10 = dp4a(win, np.broadcast_to(wx, win.shape), 0).sum((1, 2))
    m01 = dp4a(win, np.broadcast_to(wy, win.shape), 0).sum((1, 2))
    from pislam_tpu_torch.ops import orientation
    bins = orientation.atan2_bins(t(m10.astype(np.int32)), t(m01.astype(np.int32))).numpy()
    p = np.ascontiguousarray(win.reshape(k, 256)).view(np.int8)   # word a * 32 + lane
    desc = np.zeros((k, 8), np.uint32)
    for j in range(8):
        pair = 32 * j + np.arange(32)
        i0 = idx0.astype(np.int64)[bins][:, pair]
        i1 = idx1.astype(np.int64)[bins][:, pair]
        bit = np.take_along_axis(p, i1, 1) > np.take_along_axis(p, i0, 1)
        desc[:, j] = (bit.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(1)
    return bins, desc[:, :words].view(np.int32)


# chip_smoke.k4_edge_cases: 1 to 8 words, K = 1 and 8192, one window
# repeated (one bin), all -128 and all 127, the base offset by 1 and 4 bytes,
# and mom_w 1 byte off its alignment ("tables+2": the weights byte by byte)
K4_CASES = {**{f"words={n}": (70, n, 0, "random") for n in range(1, 9)},
            "K=1": (1, 8, 0, "random"), "K=8192": (8192, 8, 0, "random"),
            "one bin": (300, 8, 0, "one"), "all -128": (64, 8, 0, -128),
            "all 127": (64, 8, 0, 127), "base+1": (300, 8, 1, "random"),
            "base+4": (300, 8, 4, "random"), "tables+2": (300, 8, 0, "random")}


@pytest.mark.parametrize("case", list(K4_CASES))
def test_k4_thread_model_equals_plain(case):
    from pislam_tpu_torch.ops import brief
    k, words, off, fill = K4_CASES[case]
    rng = np.random.default_rng(k + 10 * words + off)
    if fill == "random":
        flat = rng.integers(-128, 128, (k, 1024)).astype(np.int8)
    elif fill == "one":
        flat = np.repeat(rng.integers(-128, 128, (1, 1024)).astype(np.int8), k, 0)
    else:
        flat = np.full((k, 1024), fill, np.int8)
    tables = brief.OrbTables.build("cpu")
    idx0, idx1, mom_w = (a.numpy() for a in tables)
    mw = _in_buffer(mom_w.view(np.uint8), 1 if case == "tables+2" else 0)
    bins, desc = k4_model(*_in_buffer(flat.view(np.uint8), off), k, idx0, idx1, *mw, words)
    pang, pdesc = kernels.orb_select_plain(t(flat), *tables, words)
    assert np.array_equal(bins, pang.numpy()) and np.array_equal(desc, pdesc.numpy())
    if fill != "random":
        assert np.unique(bins).size == 1


# ---------------------------------------------------------------------------
# K3c: warps a keypoint over strip rows
# ---------------------------------------------------------------------------

def _cu_constants(source, *names):
    """The ``constexpr int`` values ``names`` of csrc/<source>: the build the
    kernel is compiled with."""
    text = (Path(kernels.__file__).resolve().parent.parent / "csrc" / source).read_text()
    return tuple(int(re.search(rf"constexpr int {n} = (\d+);", text).group(1)) for n in names)


K3C_SPLIT, K3C_PER_BLOCK = _cu_constants("realign_windows.cu", "kSplit", "kPerBlock")


def k3c_model(buf, off, psi, phi):
    """csrc/realign_windows.cu, every lane at once: block b holds keypoints
    b * kPerBlock onwards, kSplit warps each; lane c of a keypoint's warp s
    reads psi and phi, then the words of column phi + c in rows p0 .. p0 + n
    of its keypoint (n = 8 / kSplit, p0 = s n), and stores word (p, c), the
    funnel shift right by 8 psi of rows p + 1 : p, for p = p0 .. p0 + n - 1.
    buf is the flat u32 buffer whose word `off` is row 0 of keypoint 0.
    Returns the (K, 8, 32) int32 words, how often each was written, and the
    (keypoint, row, column) of every read."""
    k = psi.size
    threads = 32 * K3C_SPLIT * K3C_PER_BLOCK
    t_ = np.arange(-(-k // K3C_PER_BLOCK) * threads)
    warp, lane = t_ % threads // 32, t_ % 32
    kp = t_ // threads * K3C_PER_BLOCK + warp // K3C_SPLIT
    live = kp < k
    n = 8 // K3C_SPLIT
    p0, lane, kp = (warp % K3C_SPLIT)[live] * n, lane[live], kp[live]
    col = phi.astype(np.int64)[kp] + lane
    shift = (8 * psi.astype(np.uint64)[kp]) & np.uint64(31)
    reads, r = [], []
    for i in range(n + 1):
        reads.append((kp, p0 + i, col))
        r.append(buf[off + (kp * kernels.STRIP_ROWS + p0 + i) * 256 + col].astype(np.uint64))
    out = np.zeros((k, 8, 32), np.uint32)
    writes = np.zeros((k, 8, 32), np.int64)
    for i in range(n):
        out[kp, p0 + i, lane] = ((r[i] | (r[i + 1] << np.uint64(32))) >> shift) & np.uint64(
            0xFFFFFFFF)
        np.add.at(writes, (kp, p0 + i, lane), 1)
    return out.view(np.int32), writes, reads


# the pyramids' strip rows at the path's keypoint counts (K3b's seeded
# keypoints), then chip_smoke.k3c_edge_cases: K = 1, K = 5 (not a whole
# block), K = 8192, every phi 0, every phi 224, each psi alone, and the rows
# starting one int32 into their buffer (4-byte, not 16-byte aligned)
K3C_CASES = {"eval": {"image": (800, 384), "k": 512}, "vga": {"image": (2216, 640), "k": 2048},
             "K=1": {"k": 1}, "K=5": {"k": 5}, "K=8192": {"k": 8192},
             "phi=0": {"k": 300, "phi": 0}, "phi=224": {"k": 300, "phi": 224},
             **{f"psi={s}": {"k": 300, "psi": s} for s in range(4)},
             "rows+4": {"k": 300, "off": 1}}


def _k3c_case(case, seed):
    """(u32 buffer, word offset, rows as a view of it, psi, phi)."""
    spec = K3C_CASES[case]
    k, off = spec["k"], spec.get("off", 0)
    rng = np.random.default_rng(seed)
    if "image" in spec:
        img, xs, ys, valid = _k3b_case(*spec["image"], k, seed)
        rows, psi, phi = kernels.strip_window_rows(t(img), t(xs), t(ys), t(valid))
        return rows.numpy().reshape(-1).view(np.uint32), 0, rows, psi.numpy(), phi.numpy()
    buf = rng.integers(0, 2**32, k * kernels.STRIP_ROWS * 256 + 4, dtype=np.uint32)
    rows = t(buf.view(np.int32))[off:off + k * kernels.STRIP_ROWS * 256].view(
        k, kernels.STRIP_ROWS, 256)
    psi = rng.integers(0, 4, k) if "psi" not in spec else np.full(k, spec["psi"])
    phi = rng.integers(0, 225, k) if "phi" not in spec else np.full(k, spec["phi"])
    return buf, off, rows, psi.astype(np.int32), phi.astype(np.int32)


@pytest.mark.parametrize("case", list(K3C_CASES))
def test_k3c_thread_model_equals_plain(case):
    buf, off, rows, psi, phi = _k3c_case(case, list(K3C_CASES).index(case) + 17)
    assert rows.storage_offset() == off
    got, writes, reads = k3c_model(buf, off, psi, phi)
    want = kernels.realign_windows_plain(rows, t(psi), t(phi)).numpy()
    assert np.array_equal(got, want)
    assert (writes == 1).all()                   # each word written once
    for kp, row, col in reads:                   # inside its own keypoint's rows
        assert 0 <= row.min() and row.max() < kernels.STRIP_ROWS
        assert 0 <= col.min() and col.max() <= 255
