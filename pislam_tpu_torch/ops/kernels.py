"""The port's Hopper kernels, each beside its plain PyTorch version.

The counterpart of ``pislam_tpu/ops/pallas_kernels.py`` (the frontend's and
matching's kernels), and motion-only BA's kernel. Each wrapper takes
its plain version for a tensor on the CPU and launches its CUDA kernel
(``csrc/*.cu``, built by ``_build``) for a tensor on a CUDA device; any
other device raises. There is no fallback: a kernel that fails to build or
launch raises. ``launches`` on a wrapper counts its kernel launches.

K1 fused_frontend_codes  csrc/fused_frontend.cu
    Replaces ``fused_frontend_keys`` / ``_fused_frontend_kernel``
    (pallas_kernels.py:387) and the XLA ``reduce_keys_2x`` after it.
    Bound: about 40 integer operations per pixel on 1.4 MB of image and
    mask (VGA pyramid), so neither bytes nor operations are large; the
    score chain (6x6 window sums of products) is the work. Design: one
    pass, one pixel tile per block, staged through shared memory with a
    4-before / 5-after halo, so no intermediate reaches device memory;
    out-of-image reads clamp (the level mask zeroes every score within 16
    px of an edge). The tile is 32x64 or 16x32 (``frontend_plan``): the
    smaller one where the larger gives too few blocks to fill the card.
    FAST's ring and Harris run only on the pixels that the mask keeps and
    that pass FAST's exact compass pretest, listed per block. Codes come out
    in true row and column order, so bucketing needs no un-permute.
K2 topk_keys             csrc/topk.cu
    Replaces ``topk_keys`` / ``_bitonic_topk_kernel`` (pallas_kernels.py:892).
    Bound: one read of N keys (1.4 MB at VGA); what costs is latency.
    Design: one launch of one cluster of 8 CTAs (``topk_plan``): 8-key
    groups dealt to the CTAs in turn, read once into shared memory where
    they fit (VGA, eval), else read from device memory by every pass;
    8-bit radix passes with per-CTA histograms summed through distributed
    shared memory (one cluster barrier each) until the candidates fit the
    sort; each CTA sorts its own survivors, and a key's output place is its
    index plus binary searches in the other CTAs' sorted lists.
K3 gather_windows_packed csrc/gather_windows.cu
    Replaces ``pack_row_strips`` + ``realign_windows2d``
    (pallas_kernels.py:73, :145) inside ``gather_windows_packed``
    (pallas_kernels.py:195); the 3-D ``realign_windows`` (K3c below)
    gives the same bytes. Bound: bytes, 1 KB written a keypoint; what
    costs is two dependent trips (the keypoint, then its window) and the
    stores. Design: two warps a keypoint, four keypoints a block: every
    lane loads x, y and valid (one request a warp), then lane c of each
    half issues its 16 byte loads of window column c at once and stores 4
    words, a warp's store a whole line, XOR 0x80 fused in; byte loads take
    any base, width and origin. The TPU's strips and rotates were
    workarounds for its gather cost. No path runs it alone: both describe
    kernels gather their own windows.
K4 orb_select            csrc/orb_select.cu
    Replaces ``orb_select_bits_sorted`` / ``_orb_sorted_kernel``
    (pallas_kernels.py:528); the dense ``orb_select_bits`` (K4d below)
    gives identical bits. No path runs it alone. Bound: bytes, 1 KB of
    window a keypoint and 32 KB of tables; what costs is each keypoint's
    chain of dependent steps. Design: ``orb_describe``'s second half, a
    warp a keypoint, four a block, no block-wide barrier on the chain:
    lane c's 8 window words by dp4a against mom_w, one redux per moment,
    every lane the IEEE-exact atan2 bin (no FMA contraction), the window
    in a 1 KB shared slot, bit i = p[idx1] > p[idx0] for all 8 words at
    once, packed by ballots. The tables reach shared memory by TMA while
    the windows load (through L1 where not 16-byte aligned); windows off
    4-byte alignment load byte by byte. GDIFF's column is onehot(idx1) -
    onehot(idx0), so its sign test is this compare.
K5 match_reduce          csrc/match_reduce.cu
    Replaces ``match_reduce`` / ``_match_reduce_kernel`` and its gated
    variant (pallas_kernels.py:688, :667, :673). Bound: 2*K1*K2*32*words
    int8 operations at 1,979 TOP/s (1.085 us at 512 x 8192); the epilogue's
    ~10-20 operations per pair lie above it. Design: as the TPU did, an int8
    tensor-core product (wgmma m64n128k32) of the +-1 expansions in shared
    memory, d = (32 words - dot) >> 1, with the row and column reductions
    on the accumulator registers; one launch over (row tile, segment) CTAs
    (``match_plan``), the segments merged by atomic minima that keep the
    TPU's exact rule, outputs written by the last CTA of each row tile and
    segment.
K6 reduce_codes_4x       csrc/reduce_codes.cu
    Replaces ``reduce_codes_4x`` / ``_vmerge_kernel`` and ``reduce_keys_2x``
    (pallas_kernels.py:949, :917, :936): the unfused frontend's scored NMS
    grid -> 2x2 code max. Bound: bytes, 1 read + 2 written per pixel; the
    grid sits in L2, so instructions and latency are what cost. Design: a
    thread per row pair x 8-column chunk on a flat grid that fills the card
    in one wave (row pair by a multiply-high, no division): one 8-byte load
    per row, the codes and their 2x2 maxima in registers, one 16-byte
    store, so a warp's loads and stores cover whole lines. Where the base
    is not 16-byte aligned or W % 16 != 0 the same launch reads byte by
    byte (tail columns, odd last column); an odd last row reads as 0.
    Codes in true row and column order.
K4d orb_select_bits      csrc/orb_select_dense.cu
    Replaces ``orb_select_bits`` / ``_orb_select_kernel``
    (pallas_kernels.py:465, :444) under its own contract: any (1024, 7808)
    int8 weight matrix, (K,) int32 bins, (K, 256) uint8 bits. Bound: bytes,
    the selected 256 KB slabs read once (2.5 us at 512 keypoints). Design:
    two launches. A warp per keypoint computes its bin (K4's atan2 bin of
    the moments against gm's columns 7680/7681); then a bin-grouped int8
    tensor-core product (``mma.sync`` m16n8k32) on a fixed grid of
    (ceil(K / 64) + 29) tiles of 64 keypoints x 2 chunks of 128 columns,
    each block finding its (bin, tile) from the bins' histogram and its
    members by a block scan (no host sync, no atomics in device memory),
    loading its slab columns (all 1024 rows of k) by TMA and the members'
    windows by cp.async into shared memory, the slab transposed to K-major
    fragments by ``__byte_perm``. Each slab is read about once per keypoint
    tile instead of once per keypoint. What is left is latency (launches,
    the blocks' key scans, loads and fragment building), not bytes or
    operations.
K3+K4d orb_describe_dense csrc/orb_select_dense.cu
    The dense-BRIEF path's counterpart of ``orb_describe``: replaces
    ``gather_windows_packed`` (pallas_kernels.py:195) then
    ``orb_select_bits`` (:465, :480), the bit packing and the frontend's
    masks (pislam_tpu/frontend.py:117-124). Codes -> masked angles and
    descriptor words. Bound: bytes, the touched windows and the first 32 x
    words columns of the used slabs. Design: ``orb_describe``'s
    warp-per-keypoint gather writes each valid keypoint's window (1 KB) to
    scratch with its bin, then K4d's product packs 32 columns into a word by
    three xor shuffles; invalid keypoints get angle 0 and zero words. The
    tile rule is mirrored in plain torch by ``dense_tiles`` for the tests.
K3a pack_row_strips      csrc/pack_row_strips.cu
    Replaces ``pack_row_strips`` (pallas_kernels.py:73): 4 image rows to one
    u32 per column, in 256-column strips, K3c's input. No path runs it.
    Bound: bytes. Design: a thread per 4-row x 4-column tile, indices by
    shifts and masks: one 4-byte load per row (byte by byte where the base
    is not 4-byte aligned), a 4x4 byte transpose by 8 byte permutes, and a
    16-byte store to each strip that holds the columns (one or two), so the
    image is read once and a warp's store is a whole 512-byte strip row.
K3+K4 orb_describe       csrc/orb_describe.cu
    Replaces ``gather_windows_packed`` (pallas_kernels.py:195: K3a :79 and
    K3b :154) followed by ``orb_select_bits_sorted`` (pallas_kernels.py:528,
    :555), and the frontend's decode and masks around them: the sorted-BRIEF
    path's codes -> masked angles and descriptors in one launch. Bound:
    bytes, the touched windows, the table rows of the bins used, codes and
    outputs (at most ~0.17 us at 512 keypoints; 0.06 us on eval_seq's
    overlapping windows); one launch's fixed cost is what remains. Design: one warp per keypoint, four per block: lane c loads
    column c of the window (K3's packed words c, 32 + c, ...), the moments
    reduce by butterfly shuffles so every lane has the bin, the window sits
    in a 1 KB shared slot for the compares, one ballot per word; the BRIEF
    tables reach shared memory by TMA while the windows load.
K3c realign_windows      csrc/realign_windows.cu
    Replaces ``realign_windows`` / ``_realign_kernel`` (pallas_kernels.py:172,
    :92): strip rows -> packed windows. No path of the JAX package runs it.
    Bound: bytes, 1 KB written per keypoint; what costs is two dependent
    trips (psi and phi, then the row words). Design: two warps a keypoint,
    four keypoints a block (one wave at VGA); every lane loads psi and phi,
    then lane c of half h issues its five 4-byte loads of column phi + c,
    rows 4h..4h+4, at once and stores four words, each one funnel shift,
    the composition of the TPU's rotate and shift rounds.
PnP motion_only_ba       csrc/motion_only_ba.cu
    Replaces no Pallas kernel: the JAX package's ``motion_only_ba``
    (pislam_tpu/backend/pnp.py) is plain JAX that XLA compiles into one
    program, where eager PyTorch made ~800 launches and two host reads of a
    solve status a call (``backend/pnp.motion_only_ba_plain``). Bound: the
    chain of dependent iterations, not bytes or operations (~22 KB in and
    ~1.2 MFLOP at 1000 points and 8 iterations). Design: every iteration in
    one block of 256 threads, each thread's points read through L1 every
    pass (21 KB at 1000 points), its sums of J^T W J, J^T W r and the cost
    reduced by xor shuffles and then over the warps in a fixed order (no
    atomics: the same inputs give the same bits), the 6x6 solve by LU with
    partial pivoting and the se3_exp update on one thread, the pose in
    shared memory. The wrapper beside the plain version is
    ``backend/pnp.motion_only_ba_kernel``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple

import torch

from . import _build, brief, fast, harris, nms, orientation
from ..utils import codec

RADIUS = 15
MAX_TOPK = 8192
INT32_MIN = -(1 << 31)


class HopperKernel:
    """A wrapper: the plain version on CPU tensors, the kernel on CUDA ones."""

    def __init__(self, launch: Callable, plain: Callable, source: str,
                 replaces: str):
        functools.update_wrapper(self, launch)
        self.launch = launch
        self.plain = plain
        self.source = source
        self.replaces = replaces
        self.launches = 0

    def __call__(self, x: torch.Tensor, *args, **launch_options):
        # launch options (K1's plan) choose how the kernel runs, not what it
        # computes, so the plain version takes none
        if x.device.type == "cpu":
            return self.plain(x, *args)
        if x.device.type != "cuda":
            raise ValueError(f"{self.__name__}: no kernel for device {x.device}")
        out = self.launch(x, *args, **launch_options)
        self.launches += 1
        return out


def hopper_kernel(plain, source, replaces):
    return lambda launch: HopperKernel(launch, plain, source, replaces)


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
           device: torch.device):
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: {t.dim()}-D, expected {ndim}-D")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _call(fn_name: str, device: torch.device, *args):
    lib = _build.load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn_name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {err}")


@functools.lru_cache(maxsize=None)
def _device_limits(index: int) -> tuple[int, int]:
    sms, smem = ctypes.c_int(), ctypes.c_int()
    err = _build.load().pislam_device_limits(index, ctypes.byref(sms), ctypes.byref(smem))
    if err != 0:
        raise RuntimeError(f"pislam_device_limits: CUDA error {err}")
    return sms.value, smem.value


def device_limits(dev: torch.device) -> tuple[int, int]:
    """(SMs, bytes of dynamic shared memory one block can opt into) of a
    CUDA device: what the plans of K1, K2 and K5 are sized by."""
    if dev.type != "cuda":
        raise ValueError(f"device_limits: {dev} is no CUDA device")
    _build.load()                     # raises where there is no CUDA device
    return _device_limits(torch.cuda.current_device() if dev.index is None else dev.index)


# ---------------------------------------------------------------------------
# K1: FAST-9 + Harris + level mask + 3x3 NMS + encode + 2x2 code max
# ---------------------------------------------------------------------------

def fused_frontend_codes_plain(img, mask, fast_t: int, harris_t: int):
    """(H, W) u8 image + (H, W) u8 level mask -> (ceil(H/2), ceil(W/2)) int32.

    Entry (r, c) is the u32 code (as an int32 bit pattern) of the sole NMS
    survivor in pixel block (2r..2r+1, 2c..2c+1), or 0: 3x3 NMS leaves at
    most one survivor per 2x2 block, so the block max keeps every survivor.
    """
    corner = fast.fast_detect(img, fast_t)
    score = harris.harris_score(img, harris_t, mask=corner & (mask != 0))
    return _max_2x2(nms.encode_grid(score, nms.nms(score)))


def _max_2x2(enc):
    """(H, W) int64 codes -> (ceil(H/2), ceil(W/2)) int32 bit patterns of
    each 2x2 block's largest code (a ragged edge pads with 0)."""
    h, w = enc.shape
    if h % 2 or w % 2:
        padded = enc.new_zeros((h + h % 2, w + w % 2))
        padded[:h, :w] = enc
        enc = padded
    h2, w2 = enc.shape[0] // 2, enc.shape[1] // 2
    red = enc.reshape(h2, 2, w2, 2).amax(dim=(1, 3))
    return codec.u32_to_i32(red)


def _check_code_size(h: int, w: int):
    if h > 4096 or w > 4096:
        raise ValueError(f"image {h}x{w}: codes hold 12-bit coordinates")


# csrc/fused_frontend.cu's tiles, (rows, cols), the larger first
FRONTEND_TILES = ((32, 64), (16, 32))
# the larger tile wherever its grid gives at least this many blocks per SM
FRONTEND_CTAS_PER_SM = 4


class FrontendPlan(NamedTuple):
    """K1's launch: ``th`` x ``tw`` pixel tiles, one block each, ``ctas``
    blocks."""

    th: int
    tw: int
    ctas: int


def frontend_plan(h: int, w: int, sms: int, tile: tuple[int, int] | None = None
                  ) -> FrontendPlan:
    """The plan for an (h, w) image on a device of ``sms`` SMs: the larger
    tile where its grid gives at least FRONTEND_CTAS_PER_SM blocks per SM,
    else the smaller, whose four times as many blocks fill the card where
    the larger would leave most SMs idle after one block. ``tile`` forces
    one of FRONTEND_TILES (the tests and chip_smoke.py run both)."""
    if tile is None:
        th, tw = FRONTEND_TILES[0]
        if _cdiv(h, th) * _cdiv(w, tw) < FRONTEND_CTAS_PER_SM * sms:
            th, tw = FRONTEND_TILES[1]
    elif tuple(tile) in FRONTEND_TILES:
        th, tw = tile
    else:
        raise ValueError(f"K1: tile {tile} is not one of {FRONTEND_TILES}")
    return FrontendPlan(th, tw, _cdiv(h, th) * _cdiv(w, tw))


@hopper_kernel(fused_frontend_codes_plain, "pislam_tpu_torch/csrc/fused_frontend.cu",
               "pislam_tpu/ops/pallas_kernels.py:387")
def fused_frontend_codes(img, mask, fast_t: int, harris_t: int, *,
                         plan: FrontendPlan | None = None):
    h, w = img.shape
    _check_code_size(h, w)
    _check(img, "img", torch.uint8, 2, img.device)
    _check(mask, "mask", torch.uint8, 2, img.device)
    if mask.shape != img.shape:
        raise ValueError(f"mask {tuple(mask.shape)} != image {tuple(img.shape)}")
    if plan is None:
        plan = frontend_plan(h, w, device_limits(img.device)[0])
    out = torch.empty(((h + 1) // 2, (w + 1) // 2), dtype=torch.int32,
                      device=img.device)
    _call("pislam_fused_frontend", img.device, img.data_ptr(), mask.data_ptr(),
          out.data_ptr(), h, w, int(fast_t), int(harris_t), plan.th, plan.tw)
    return out


# ---------------------------------------------------------------------------
# K2: exact descending top-k of int32 keys
# ---------------------------------------------------------------------------

def _check_k(k: int):
    if not 1 <= k <= MAX_TOPK:
        raise ValueError(f"top-k: k={k} outside [1, {MAX_TOPK}]")


def _pad_keys(keys, k: int):
    """Fill with INT32_MIN (the key of code 0) up to k entries."""
    if keys.numel() >= k:
        return keys
    return torch.cat([keys, keys.new_full((k - keys.numel(),), INT32_MIN)])


def topk_keys_plain(keys, k: int):
    """(N,) int32 keys -> (k,) int32, descending; short inputs fill with
    INT32_MIN."""
    _check_k(k)
    return torch.topk(_pad_keys(keys, k), k).values


TOPK_CLUSTER = 8            # csrc/topk.cu kCluster: CTAs of the one cluster
TOPK_GROUP = 8              # csrc/topk.cu kGroup: keys dealt to the CTAs in turn
TOPK_MAX_KEYS = (1 << 31) - 1 - 1024    # csrc/topk.cu indexes keys in int32


class TopkPlan(NamedTuple):
    """K2's launch: one cluster of ``cluster`` CTAs, each holding at most
    ``chunk`` keys (its share of the 8-key groups) in shared memory, or none
    (``chunk`` 0: every pass reads them from device memory); a sort of at
    most ``cap`` survivors; ``smem`` bytes per CTA."""

    cluster: int
    chunk: int
    cap: int
    smem: int


def _topk_smem(chunk: int, cap: int) -> int:
    # keys (reused as a sort buffer) | survivors | 2 x 256 bins | 8 warp sums | state
    return 4 * (max(chunk, cap) + cap + 2 * 256 + 8 + 8)


def topk_plan(n: int, k: int, smem_limit: int) -> TopkPlan:
    """The plan for the top ``k`` of ``n >= k`` keys on a device whose
    blocks can have ``smem_limit`` bytes of shared memory. The keys stay in
    shared memory where a CTA's share fits, else in device memory; the sort
    takes twice the smallest power of two >= k (at most MAX_TOPK) where that
    fits, so that the radix passes can stop early. ValueError where not even
    the sort of k keys fits."""
    _check_k(k)
    if not k <= n <= TOPK_MAX_KEYS:
        raise ValueError(f"top-k: n={n} outside [k={k}, {TOPK_MAX_KEYS}] "
                         "(the wrapper pads short inputs)")
    p = max(32, 1 << (k - 1).bit_length())
    share = _cdiv(_cdiv(n, TOPK_GROUP), TOPK_CLUSTER) * TOPK_GROUP   # keys a CTA holds
    for chunk in (share, 0):
        for cap in (min(2 * p, MAX_TOPK), p):
            if _topk_smem(chunk, cap) <= smem_limit:
                return TopkPlan(TOPK_CLUSTER, chunk, cap, _topk_smem(chunk, cap))
    raise ValueError(f"top-k: a sort of {p} keys needs {_topk_smem(0, p)} bytes of shared "
                     f"memory per CTA, above {smem_limit}")


@hopper_kernel(topk_keys_plain, "pislam_tpu_torch/csrc/topk.cu",
               "pislam_tpu/ops/pallas_kernels.py:892")
def topk_keys(keys, k: int):
    _check_k(k)
    keys = _pad_keys(keys, k)
    _check(keys, "keys", torch.int32, 1, keys.device)
    plan = topk_plan(keys.numel(), k, device_limits(keys.device)[1])
    out = torch.empty(k, dtype=torch.int32, device=keys.device)
    _call("pislam_topk_keys", keys.device, keys.data_ptr(), keys.numel(), k, plan.cap,
          plan.chunk, plan.smem, out.data_ptr())
    return out


# ---------------------------------------------------------------------------
# K3: per-keypoint packed 32x32 window gather
# ---------------------------------------------------------------------------

def _window_origin(xs, ys, valid, h: int, w: int):
    """Invalid keypoints go to (16, 16); all clip to [15, w-17] x [15, h-17]
    (pallas_kernels.py:219-220), so windows stay inside the image."""
    sx = torch.where(valid, xs, RADIUS + 1).clamp(RADIUS, w - RADIUS - 2)
    sy = torch.where(valid, ys, RADIUS + 1).clamp(RADIUS, h - RADIUS - 2)
    return sx - RADIUS, sy - RADIUS


def gather_windows_packed_plain(img, xs, ys, valid):
    """(H, W) u8 + (K,) xs, ys, valid -> (K, 1024) int8 packed windows.

    Window rows y-15..y+16, cols x-15..x+16; byte (r, c) lands at
    (r >> 2) * 128 + c * 4 + (r & 3), as pixel ^ 0x80 (= pixel - 128).
    """
    h, w = img.shape
    x0, y0 = _window_origin(xs.long(), ys.long(), valid, h, w)
    r = torch.arange(32, device=img.device)
    win = img[(y0[:, None] + r)[:, :, None], (x0[:, None] + r)[:, None, :]]
    flat = win.reshape(-1, 8, 4, 32).permute(0, 1, 3, 2).reshape(-1, 1024)
    return (flat ^ 0x80).view(torch.int8)


@hopper_kernel(gather_windows_packed_plain, "pislam_tpu_torch/csrc/gather_windows.cu",
               "pislam_tpu/ops/pallas_kernels.py:195")
def gather_windows_packed(img, xs, ys, valid):
    h, w = img.shape
    if h < 32 or w < 32:
        raise ValueError(f"image {h}x{w} is smaller than one 32x32 window")
    dev = img.device
    _check(img, "img", torch.uint8, 2, dev)
    _check(xs, "xs", torch.int32, 1, dev)
    _check(ys, "ys", torch.int32, 1, dev)
    _check(valid, "valid", torch.bool, 1, dev)
    k = xs.numel()
    if ys.numel() != k or valid.numel() != k:
        raise ValueError("xs, ys and valid differ in length")
    out = torch.empty((k, 1024), dtype=torch.int8, device=dev)
    _call("pislam_gather_windows", dev, img.data_ptr(), h, w, xs.data_ptr(),
          ys.data_ptr(), valid.view(torch.uint8).data_ptr(), k, out.data_ptr())
    return out


# ---------------------------------------------------------------------------
# K3c: strip rows -> packed windows, under realign_windows' contract
# ---------------------------------------------------------------------------

STRIP_ROWS = 9      # 4-row packs per keypoint: 36 rows cover 32 + 3


def _check_strips(h: int, w: int):
    if h < 4 or h % 4 or w % 128 or w < 256:
        raise ValueError(f"pack_row_strips: image {h}x{w} needs H % 4 == 0, "
                         "W % 128 == 0 and W >= 256")


def pack_row_strips_plain(img):
    """(H, W) uint8 -> (W // 128 - 1, H // 4, 256) int32: strip s, row r,
    column c holds image rows 4r..4r+3 of column 128 s + c, little-endian, as
    a u32 bit pattern (pallas_kernels.py:73)."""
    h, w = img.shape
    _check_strips(h, w)
    b = img.to(torch.int64).reshape(h // 4, 4, w)
    words = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)
    strips = torch.stack([words[:, 128 * s: 128 * s + 256] for s in range(w // 128 - 1)])
    return codec.u32_to_i32(strips)


@hopper_kernel(pack_row_strips_plain, "pislam_tpu_torch/csrc/pack_row_strips.cu",
               "pislam_tpu/ops/pallas_kernels.py:73")
def pack_row_strips(img):
    h, w = img.shape
    _check_strips(h, w)
    _check(img, "img", torch.uint8, 2, img.device)
    out = torch.empty((w // 128 - 1, h // 4, 256), dtype=torch.int32, device=img.device)
    _call("pislam_pack_row_strips", img.device, img.data_ptr(), h, w, out.data_ptr())
    return out


def strip_window_rows(img, xs, ys, valid):
    """K3c's inputs for keypoints of an image, as ``gather_windows_packed``
    of the JAX package builds them (pallas_kernels.py:216-232): (K, 9, 256)
    int32 strip rows, (K,) int32 psi and phi."""
    h, w = img.shape
    h4, ns = h // 4, w // 128 - 1
    strips = pack_row_strips(img).reshape(ns * h4, 256)
    x0, y0 = _window_origin(xs.long(), ys.long(), valid, h, w)
    strip = torch.clamp(x0 >> 7, 0, ns - 1)
    r = torch.arange(STRIP_ROWS, device=img.device)
    ridx = torch.minimum(strip[:, None] * h4 + (y0 >> 2)[:, None] + r,
                         (strip[:, None] + 1) * h4 - 1)
    rows = strips[ridx]
    return rows, (y0 & 3).to(torch.int32), (x0 - 128 * strip).to(torch.int32)


def realign_windows_plain(rows, psi, phi):
    """(K, 9, 256) int32 strip rows + (K,) psi in [0, 4), phi in [0, 225) ->
    (K, 8, 32) int32: word (p, c) is the funnel shift right by 8 psi of rows
    p + 1 : p at column phi + c (the composition of pallas_kernels.py:97-108's
    rotate and byte-shift rounds)."""
    cols = phi.long()[:, None] + torch.arange(32, device=rows.device)
    words = rows.to(torch.int64) & 0xFFFFFFFF          # the u32 values
    sel = words.gather(2, cols[:, None, :].expand(-1, STRIP_ROWS, -1))
    joined = sel[:, :8] | (sel[:, 1:] << 32)
    out = (joined >> (8 * psi.long())[:, None, None]) & 0xFFFFFFFF
    return codec.u32_to_i32(out)


@hopper_kernel(realign_windows_plain, "pislam_tpu_torch/csrc/realign_windows.cu",
               "pislam_tpu/ops/pallas_kernels.py:172")
def realign_windows(rows, psi, phi):
    dev = rows.device
    _check(rows, "rows", torch.int32, 3, dev)
    _check(psi, "psi", torch.int32, 1, dev)
    _check(phi, "phi", torch.int32, 1, dev)
    k = rows.shape[0]
    if rows.shape[1:] != (STRIP_ROWS, 256) or psi.numel() != k or phi.numel() != k:
        raise ValueError(f"realign_windows: rows {tuple(rows.shape)}, psi {psi.numel()}, "
                         f"phi {phi.numel()}: expects (K, 9, 256), (K,), (K,)")
    out = torch.empty((k, 8, 32), dtype=torch.int32, device=dev)
    _call("pislam_realign_windows", dev, rows.data_ptr(), psi.data_ptr(), phi.data_ptr(),
          k, out.data_ptr())
    return out


# ---------------------------------------------------------------------------
# K4: disc moments -> atan2 bin -> the 256 BRIEF bits of that rotation
# ---------------------------------------------------------------------------

def orb_select_plain(flat, idx0, idx1, mom_w, words: int):
    """(K, 1024) int8 windows -> ((K,) u8 angle bins, (K, words) int32).

    idx0/idx1: (30, 256) int16 packed-window indices of each rotation's
    point pairs; mom_w: (1024, 2) int8 disc-moment weights. Descriptor bit i
    = p[idx1[bin, i]] > p[idx0[bin, i]], in word i // 32, bit i % 32;
    words hold the u32 bit pattern.
    """
    angles = orientation.atan2_bins(*orientation.centroids_packed(flat, mom_w))
    a = angles.long()
    p0 = flat.gather(1, idx0.long()[a])
    p1 = flat.gather(1, idx1.long()[a])
    return angles, brief._pack_bits_u8(p1 > p0, words)


@hopper_kernel(orb_select_plain, "pislam_tpu_torch/csrc/orb_select.cu",
               "pislam_tpu/ops/pallas_kernels.py:528")
def orb_select(flat, idx0, idx1, mom_w, words: int):
    dev = flat.device
    _check(flat, "flat", torch.int8, 2, dev)
    _check(idx0, "idx0", torch.int16, 2, dev)
    _check(idx1, "idx1", torch.int16, 2, dev)
    _check(mom_w, "mom_w", torch.int8, 2, dev)
    if flat.shape[1] != 1024 or idx0.shape != (30, 256) or idx1.shape != (30, 256):
        raise ValueError("orb_select: expects (K, 1024) windows, (30, 256) tables")
    if mom_w.shape != (1024, 2) or not 1 <= words <= 8:
        raise ValueError("orb_select: expects (1024, 2) weights, 1..8 words")
    k = flat.shape[0]
    angles = torch.empty(k, dtype=torch.uint8, device=dev)
    desc = torch.empty((k, words), dtype=torch.int32, device=dev)
    _call("pislam_orb_select", dev, flat.data_ptr(), k, idx0.data_ptr(),
          idx1.data_ptr(), mom_w.data_ptr(), words, angles.data_ptr(),
          desc.data_ptr())
    return angles, desc


# ---------------------------------------------------------------------------
# K3 + K4 on the sorted-BRIEF path: codes -> masked angles and descriptors
# ---------------------------------------------------------------------------

def orb_describe_plain(img, codes, valid, idx0, idx1, mom_w, words: int):
    """(H, W) u8 image + (K,) int64 codes and bool valid -> ((K,) u8 angle
    bins, (K, words) int32 descriptor words): K3's windows at the codes'
    (x, y), K4's angles and bits, then angle 0 and zero words where not
    valid (what the frontend did around K3 and K4)."""
    xs = codec.decode_x(codes).to(torch.int32)
    ys = codec.decode_y(codes).to(torch.int32)
    flat = gather_windows_packed_plain(img, xs, ys, valid)
    angles, desc = orb_select_plain(flat, idx0, idx1, mom_w, words)
    return (torch.where(valid, angles, torch.zeros_like(angles)),
            torch.where(valid[:, None], desc, torch.zeros_like(desc)))


@hopper_kernel(orb_describe_plain, "pislam_tpu_torch/csrc/orb_describe.cu",
               "pislam_tpu/ops/pallas_kernels.py:195,528")
def orb_describe(img, codes, valid, idx0, idx1, mom_w, words: int):
    h, w = img.shape
    if h < 32 or w < 32:
        raise ValueError(f"image {h}x{w} is smaller than one 32x32 window")
    dev = img.device
    _check(img, "img", torch.uint8, 2, dev)
    _check(codes, "codes", torch.int64, 1, dev)
    _check(valid, "valid", torch.bool, 1, dev)
    _check(idx0, "idx0", torch.int16, 2, dev)
    _check(idx1, "idx1", torch.int16, 2, dev)
    _check(mom_w, "mom_w", torch.int8, 2, dev)
    k = codes.numel()
    if valid.numel() != k:
        raise ValueError("codes and valid differ in length")
    if idx0.shape != (30, 256) or idx1.shape != (30, 256) or mom_w.shape != (1024, 2):
        raise ValueError("orb_describe: expects (30, 256) tables and (1024, 2) weights")
    if not 1 <= words <= 8:
        raise ValueError(f"orb_describe: words={words} outside 1..8")
    # mom_w is read 8 bytes at a time, the tables by 16-byte bulk copies
    if mom_w.data_ptr() % 8 or idx0.data_ptr() % 16 or idx1.data_ptr() % 16:
        raise ValueError("orb_describe: mom_w must be 8-byte and idx0/idx1 16-byte aligned")
    angles = torch.empty(k, dtype=torch.uint8, device=dev)
    desc = torch.empty((k, words), dtype=torch.int32, device=dev)
    _call("pislam_orb_describe", dev, img.data_ptr(), h, w, codes.data_ptr(),
          valid.view(torch.uint8).data_ptr(), k, idx0.data_ptr(), idx1.data_ptr(),
          mom_w.data_ptr(), words, angles.data_ptr(), desc.data_ptr())
    return angles, desc


def _atan2_bins_plain(m10, m01):
    # a call, not a reference: orientation imports this module
    return orientation.atan2_bins(m10, m01)


@hopper_kernel(_atan2_bins_plain, "pislam_tpu_torch/csrc/orb_select.cu",
               "pislam_tpu/ops/pallas_kernels.py:453")
def atan2_bins(m10, m01):
    """K4's device atan2 bins alone: (N,) int32 moments -> (N,) u8 bins."""
    dev = m10.device
    _check(m10, "m10", torch.int32, 1, dev)
    _check(m01, "m01", torch.int32, 1, dev)
    if m01.numel() != m10.numel():
        raise ValueError("m10 and m01 differ in length")
    out = torch.empty(m10.numel(), dtype=torch.uint8, device=dev)
    _call("pislam_atan2_bins", dev, m10.data_ptr(), m01.data_ptr(), m10.numel(),
          out.data_ptr())
    return out


# ---------------------------------------------------------------------------
# K4d: the dense rotation-select, under orb_select_bits' contract, and the
# dense-BRIEF path's describe stage on the same product
# ---------------------------------------------------------------------------

GM_COLS = 30 * 256 + 128      # 30 slabs of 256 bits + one tile of moment columns
MOMENT_COL = 30 * 256
N_BINS = 30
# keypoints a tile of the product kernel (csrc/orb_select_dense.cu kTile)
DENSE_TILE = 64


def orb_select_bits_plain(flat, gm):
    """(K, 1024) int8 windows + (1024, 7808) int8 weights -> ((K,) int32
    angle bins, (K, 256) uint8 bits).

    The bin comes from the moments in gm's columns 7680 and 7681; bit j is
    dot(window, gm[:, 256 bin + j]) > 0. float32 is exact here: every
    product is at most 2^14 in size and every sum of 1024 of them at most
    2^24, an integer that float32 holds.
    """
    out = (flat.to(torch.float32) @ gm.to(torch.float32)).to(torch.int32)
    angles = orientation.atan2_bins(out[:, MOMENT_COL], out[:, MOMENT_COL + 1])
    a = angles.long()
    cols = (a[:, None] * 256 + torch.arange(256, device=flat.device))
    bits = out.gather(1, cols) > 0
    return a.to(torch.int32), bits.to(torch.uint8)


def dense_tiles(keys, tile: int = DENSE_TILE):
    """The product kernel's rule for which keypoints a block takes, in plain
    torch: (K,) keys (a bin in [0, 30), or anything else for a keypoint no
    block takes) -> (slots, tile) int64 member indices, -1 where empty, and
    (slots,) bins, -1 for a slot with no tile. Slot j of the
    ceil(K / tile) + 29 that the grid has is the j-th tile when the bins'
    ceil(count / tile) tiles are laid out bin by bin; a tile's members are
    its bin's keypoints of rank tile * i .. tile * i + tile - 1, in index
    order."""
    keys = torch.as_tensor(keys).long()
    slots = _cdiv(keys.numel(), tile) + N_BINS - 1
    members = torch.full((slots, tile), -1, dtype=torch.int64)
    bins = torch.full((slots,), -1, dtype=torch.int64)
    j = 0
    for b in range(N_BINS):
        idx = torch.nonzero(keys == b).reshape(-1)
        for i in range(0, idx.numel(), tile):
            if j >= slots:
                raise AssertionError("the grid has fewer slots than the tiles")
            part = idx[i:i + tile]
            members[j, :part.numel()] = part
            bins[j] = b
            j += 1
    return members, bins


def _dense_scratch(dev: torch.device, k: int):
    """The product's scratch for k keypoints: the keys (bins), and the
    windows in the product's byte order."""
    return (torch.empty(k, dtype=torch.uint8, device=dev),
            torch.empty((k, 1024), dtype=torch.int8, device=dev))


def _check_dense(gm, name: str):
    if gm.shape != (1024, GM_COLS):
        raise ValueError(f"{name}: gm {tuple(gm.shape)}, expects (1024, {GM_COLS})")
    if gm.data_ptr() % 16:
        raise ValueError(f"{name}: gm must be 16-byte aligned (TMA)")


@hopper_kernel(orb_select_bits_plain, "pislam_tpu_torch/csrc/orb_select_dense.cu",
               "pislam_tpu/ops/pallas_kernels.py:465")
def orb_select_bits(flat, gm):
    dev = flat.device
    _check(flat, "flat", torch.int8, 2, dev)
    _check(gm, "gm", torch.int8, 2, dev)
    if flat.shape[1] != 1024:
        raise ValueError(f"orb_select_bits: flat {tuple(flat.shape)}, expects (K, 1024)")
    _check_dense(gm, "orb_select_bits")
    if flat.data_ptr() % 4:
        raise ValueError("orb_select_bits: flat must be 4-byte aligned")
    k = flat.shape[0]
    angles = torch.empty(k, dtype=torch.int32, device=dev)
    bits = torch.empty((k, 256), dtype=torch.uint8, device=dev)
    scratch = _dense_scratch(dev, k)
    _call("pislam_orb_select_dense", dev, flat.data_ptr(), k, gm.data_ptr(), GM_COLS,
          angles.data_ptr(), bits.data_ptr(), *(t.data_ptr() for t in scratch))
    return angles, bits


def orb_describe_dense_plain(img, codes, valid, gm, words: int):
    """(H, W) u8 image + (K,) int64 codes and bool valid + (1024, 7808) int8
    weights -> ((K,) u8 angle bins, (K, words) int32 descriptor words): K3's
    windows at the codes' (x, y), K4d's bins and bits, the bits packed, then
    angle 0 and zero words where not valid (the JAX package's dense branch,
    pislam_tpu/frontend.py:117-124)."""
    xs = codec.decode_x(codes).to(torch.int32)
    ys = codec.decode_y(codes).to(torch.int32)
    flat = gather_windows_packed_plain(img, xs, ys, valid)
    angles, bits = orb_select_bits_plain(flat, gm)
    angles = angles.to(torch.uint8)
    desc = brief._pack_bits_u8(bits, words)
    return (torch.where(valid, angles, torch.zeros_like(angles)),
            torch.where(valid[:, None], desc, torch.zeros_like(desc)))


@hopper_kernel(orb_describe_dense_plain, "pislam_tpu_torch/csrc/orb_select_dense.cu",
               "pislam_tpu/ops/pallas_kernels.py:195,465")
def orb_describe_dense(img, codes, valid, gm, words: int):
    h, w = img.shape
    if h < 32 or w < 32:
        raise ValueError(f"image {h}x{w} is smaller than one 32x32 window")
    dev = img.device
    _check(img, "img", torch.uint8, 2, dev)
    _check(codes, "codes", torch.int64, 1, dev)
    _check(valid, "valid", torch.bool, 1, dev)
    _check(gm, "gm", torch.int8, 2, dev)
    _check_dense(gm, "orb_describe_dense")
    k = codes.numel()
    if valid.numel() != k:
        raise ValueError("codes and valid differ in length")
    if not 1 <= words <= 8:
        raise ValueError(f"orb_describe_dense: words={words} outside 1..8")
    angles = torch.empty(k, dtype=torch.uint8, device=dev)
    desc = torch.empty((k, words), dtype=torch.int32, device=dev)
    scratch = _dense_scratch(dev, k)
    _call("pislam_orb_describe_dense", dev, img.data_ptr(), h, w, codes.data_ptr(),
          valid.view(torch.uint8).data_ptr(), k, gm.data_ptr(), GM_COLS, words,
          angles.data_ptr(), desc.data_ptr(), *(t.data_ptr() for t in scratch))
    return angles, desc


def empty_launch(dev: torch.device):
    """One launch of a kernel that does nothing (``csrc/device_limits.cu``):
    what a launch costs the device, the floor of the shortest kernels."""
    _call("pislam_empty", dev)


# ---------------------------------------------------------------------------
# K5: Hamming best / second / first-argmin per row, first-argmin per column
# ---------------------------------------------------------------------------

MAX_MATCH_ROWS = 1 << 16      # per launch: the column keys hold the row in 16 bits
MATCH_TILE = 128              # csrc/match_reduce.cu kTileN: columns per tile
MATCH_WG_ROWS = 64            # csrc/match_reduce.cu kWgRows: rows per warpgroup


def match_reduce_plain(desc1, desc2, valid1, valid2, uv1=None, uv2=None,
                       radius=None):
    """(K1, W), (K2, W) int32 descriptor words + (K1,), (K2,) bool ->
    (best (K1,), second (K1,), idx (K1,), col_argmin (K2,)) int32.

    The dense reductions of the (K1, K2) Hamming matrix with invalid pairs
    at ``matching.MAX_DIST``; with ``uv1`` (K1, 2), ``uv2`` (K2, 2) float32
    and a ``radius``, pairs farther apart than it are invalid too.
    """
    # a call, not a reference: matching imports this module
    from .. import matching
    dist = matching.hamming_matrix(desc1, desc2, valid1, valid2)
    if radius is not None:
        dist = matching.gate(dist, uv1, uv2, radius)
    idx, best, second = matching._best_two(dist)
    return best, second, idx, torch.argmin(dist, dim=0).to(torch.int32)


def _pair_distances(desc1, desc2, valid1, valid2, rows, uv1=None, uv2=None, radius=None):
    """(K2,) int32: entry j of ``match_reduce_plain``'s distance matrix at
    (rows[j], j), the same arithmetic pair by pair."""
    from .. import matching
    nbits = desc1.shape[1] * 32
    dot = (matching.expand_pm1(desc1[rows]).to(torch.int32)
           * matching.expand_pm1(desc2).to(torch.int32)).sum(dim=1)
    dist = (nbits - dot) >> 1
    ok = valid1[rows] & valid2
    if radius is not None:
        d = uv1[rows] - uv2
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
        ok &= d2 <= torch.tensor(float(radius) * float(radius), dtype=torch.float32)
    return torch.where(ok, dist, matching.MAX_DIST).to(torch.int32)


def match_reduce_chunked(call, chunk: int, desc1, desc2, valid1, valid2, uv1=None,
                         uv2=None, radius=None):
    """``match_reduce``'s outputs with ``call`` (K5 or its plain version) run
    on query rows in chunks of at most ``chunk``: best, second and idx per
    row as they come; a column's argmin is the chunk winner of least
    distance, the earliest chunk on a tie, as ``torch.argmin`` over all rows
    takes the lowest row (so an all-invalid column gives row 0)."""
    gated = radius is not None
    rows_out, col, col_d = [], None, None
    for lo in range(0, desc1.shape[0], chunk):
        part = slice(lo, lo + chunk)
        args = (desc1[part], desc2, valid1[part], valid2)
        best, second, idx, c = call(*args, *((uv1[part], uv2, radius) if gated else ()))
        rows_out.append((best, second, idx))
        rows = c.long() + lo
        d = _pair_distances(desc1, desc2, valid1, valid2, rows,
                            *((uv1, uv2, radius) if gated else ()))
        if col is None:
            col, col_d = rows, d
        else:
            better = d < col_d
            col, col_d = torch.where(better, rows, col), torch.where(better, d, col_d)
    best, second, idx = (torch.cat(x) for x in zip(*rows_out))
    return best, second, idx, col.to(torch.int32)


class RowChunkedKernel(HopperKernel):
    """K5's wrapper: on a CUDA device, more than MAX_MATCH_ROWS query rows go
    in chunks of MAX_MATCH_ROWS, one launch (and one count) each, merged by
    ``match_reduce_chunked``; the plain version takes any K1 at once."""

    def __call__(self, desc1, *args, **launch_options):
        if desc1.device.type == "cuda" and desc1.shape[0] > MAX_MATCH_ROWS:
            return match_reduce_chunked(super().__call__, MAX_MATCH_ROWS, desc1, *args)
        return super().__call__(desc1, *args, **launch_options)


class MatchPlan(NamedTuple):
    """K5's launch: a grid of ``row_tiles`` x ``segments`` CTAs, each with
    ``warpgroups`` x 64 query rows over ``tiles_per_segment`` 128-column
    database tiles; scratch sizes in int32 words."""

    warpgroups: int
    row_tiles: int
    segments: int
    tiles_per_segment: int
    row_words: int            # K1 merge words: (best << 32) | idx and second
    col_keys: int             # K2 column keys, 0x7fffffff between calls
    tickets: int              # row_tiles + segments counters, 0 between calls

    @property
    def rows(self) -> int:
        return MATCH_WG_ROWS * self.warpgroups

    @property
    def ctas(self) -> int:
        return self.row_tiles * self.segments


MATCH_MAX_SEGMENT_TILES = 512     # a row key holds the column in 16 bits


def match_plan(k1: int, k2: int, sms: int) -> MatchPlan:
    """The plan on a device of ``sms`` SMs: two 64-row warpgroups per CTA
    where that still gives a CTA per SM, else one; then as many database
    segments as bring the grid to two CTAs per SM (at most one per 128-column
    tile, at most 65536 columns each)."""
    tiles = _cdiv(k2, MATCH_TILE)
    nwg = 2 if k1 > MATCH_WG_ROWS and _cdiv(k1, 2 * MATCH_WG_ROWS) * tiles >= sms else 1
    nrt = _cdiv(k1, MATCH_WG_ROWS * nwg)
    nseg = max(min(tiles, _cdiv(2 * sms, nrt)), _cdiv(tiles, MATCH_MAX_SEGMENT_TILES))
    tps = _cdiv(tiles, nseg)
    nseg = _cdiv(tiles, tps)
    return MatchPlan(nwg, nrt, nseg, tps, k1, k2, nrt + nseg)


class _MatchState(NamedTuple):
    rowbest: torch.Tensor     # int64, all ones: (best << 32) | idx per row
    rowsecond: torch.Tensor   # int32, all ones (u32 max): second per row
    colkey: torch.Tensor      # int32 0x7fffffff: least (d << 16) | row per column
    tickets: torch.Tensor     # int32 0: CTAs done per row tile and segment


# K5's merge state per (device, stream): set once when allocated; each launch
# leaves it as it found it, so calls one after another need no memset. Calls
# on two streams would share its atomics and tickets, so each stream has its
# own; one grown on its stream frees the old tensors to that stream alone,
# after the launches that used them.
_MATCH_STATE: dict = {}


def _match_state(dev: torch.device, plan: MatchPlan) -> _MatchState:
    key = (dev, torch.cuda.current_stream(dev).cuda_stream)
    state = _MATCH_STATE.get(key)
    if (state is None or state.rowbest.numel() < plan.row_words
            or state.colkey.numel() < plan.col_keys or state.tickets.numel() < plan.tickets):
        rows = max(plan.row_words, 2048)
        state = _MatchState(torch.full((rows,), -1, dtype=torch.int64, device=dev),
                            torch.full((rows,), -1, dtype=torch.int32, device=dev),
                            torch.full((max(plan.col_keys, 16384),), 0x7FFFFFFF,
                                       dtype=torch.int32, device=dev),
                            torch.zeros(max(plan.tickets, 1024), dtype=torch.int32, device=dev))
        _MATCH_STATE[key] = state
    return state


@lambda launch: RowChunkedKernel(launch, match_reduce_plain,
                                  "pislam_tpu_torch/csrc/match_reduce.cu",
                                  "pislam_tpu/ops/pallas_kernels.py:688")
def match_reduce(desc1, desc2, valid1, valid2, uv1=None, uv2=None, radius=None):
    """``match_reduce_plain``'s outputs from one launch of K5 on the
    current stream per MAX_MATCH_ROWS query rows (``RowChunkedKernel``). The
    kernel merges its CTAs through scratch state that it leaves as it found
    it; the wrapper keeps that state per (device, stream), so calls on one
    stream run one after another and calls on two streams never share it."""
    dev = desc1.device
    _check(desc1, "desc1", torch.int32, 2, dev)
    _check(desc2, "desc2", torch.int32, 2, dev)
    _check(valid1, "valid1", torch.bool, 1, dev)
    _check(valid2, "valid2", torch.bool, 1, dev)
    (k1, words), k2 = desc1.shape, desc2.shape[0]
    if desc2.shape[1] != words or not 1 <= words <= 8:
        raise ValueError(f"descriptors {tuple(desc1.shape)}, {tuple(desc2.shape)}: "
                         "need equal widths of 1..8 words")
    if not 1 <= k1 <= MAX_MATCH_ROWS or k2 < 1:
        raise ValueError(f"match_reduce: K1={k1} outside [1, {MAX_MATCH_ROWS}] or K2={k2}")
    if valid1.numel() != k1 or valid2.numel() != k2:
        raise ValueError("valid masks differ in length from the descriptors")
    gated = radius is not None
    if gated:
        _check(uv1, "uv1", torch.float32, 2, dev)
        _check(uv2, "uv2", torch.float32, 2, dev)
        if uv1.shape != (k1, 2) or uv2.shape != (k2, 2):
            raise ValueError("uv1/uv2 must be (K1, 2) and (K2, 2)")
    plan = match_plan(k1, k2, device_limits(dev)[0])
    best, second, idx = (torch.empty(k1, dtype=torch.int32, device=dev) for _ in range(3))
    col = torch.empty(k2, dtype=torch.int32, device=dev)
    state = _match_state(dev, plan)
    r2 = float(radius) * float(radius) if gated else 0.0
    _call("pislam_match_reduce", dev, desc1.data_ptr(), desc2.data_ptr(), k1, k2, words,
          valid1.view(torch.uint8).data_ptr(), valid2.view(torch.uint8).data_ptr(),
          uv1.data_ptr() if gated else None, uv2.data_ptr() if gated else None,
          r2, int(gated), plan.warpgroups, plan.tiles_per_segment, plan.row_tiles,
          plan.segments, best.data_ptr(), second.data_ptr(), idx.data_ptr(),
          col.data_ptr(), *(t.data_ptr() for t in state))
    return best, second, idx, col


# ---------------------------------------------------------------------------
# K6: scored NMS survivors -> 2x2 code max
# ---------------------------------------------------------------------------

def reduce_codes_4x_plain(scored):
    """(H, W) uint8 scored survivors (0 = none) -> (ceil(H/2), ceil(W/2))
    int32: the u32 code bit pattern of each 2x2 block's survivor, or 0, in
    true row order (the JAX package's rows come out as two planes, even then
    odd rows)."""
    return _max_2x2(nms.encode_grid(scored, scored > 0))


@hopper_kernel(reduce_codes_4x_plain, "pislam_tpu_torch/csrc/reduce_codes.cu",
               "pislam_tpu/ops/pallas_kernels.py:949")
def reduce_codes_4x(scored):
    h, w = scored.shape
    _check_code_size(h, w)
    _check(scored, "scored", torch.uint8, 2, scored.device)
    out = torch.empty(((h + 1) // 2, (w + 1) // 2), dtype=torch.int32, device=scored.device)
    _call("pislam_reduce_codes", scored.device, scored.data_ptr(), h, w, out.data_ptr())
    return out


# ---------------------------------------------------------------------------
# Motion-only BA: every Gauss-Newton iteration in one launch
# ---------------------------------------------------------------------------

def _check_motion_only_ba(R0, t0, xyz, uv, valid, iters: int):
    """The kernel's inputs: float32 R0 (3, 3), t0 (3,), xyz (N, 3), uv (N, 2)
    and bool valid (N,), contiguous, on R0's device; at least one iteration
    (the plain version stacks the costs of its iterations)."""
    dev = R0.device
    _check(R0, "R0", torch.float32, 2, dev)
    _check(t0, "t0", torch.float32, 1, dev)
    _check(xyz, "xyz", torch.float32, 2, dev)
    _check(uv, "uv", torch.float32, 2, dev)
    _check(valid, "valid", torch.bool, 1, dev)
    n = xyz.shape[0]
    if (R0.shape != (3, 3) or t0.shape != (3,) or xyz.shape != (n, 3) or uv.shape != (n, 2)
            or valid.shape != (n,)):
        raise ValueError(f"motion_only_ba: R0 {tuple(R0.shape)}, t0 {tuple(t0.shape)}, xyz "
                         f"{tuple(xyz.shape)}, uv {tuple(uv.shape)}, valid {tuple(valid.shape)}: "
                         "expects (3, 3), (3,), (N, 3), (N, 2), (N,)")
    if iters < 1 or 3 * n >= 1 << 31:          # the kernel indexes xyz in int32
        raise ValueError(f"motion_only_ba: iters={iters}, N={n}: needs iters >= 1, "
                         "3 N < 2^31")


def motion_only_ba(R0, t0, xyz, uv, valid, iters: int, huber: float, inlier_threshold: float,
                   damping: float):
    """The launch of ``csrc/motion_only_ba.cu``: ``backend/pnp.py``
    ``motion_only_ba_plain``'s outputs from one launch on the current stream;
    nothing is read back. ``backend/pnp.py`` wraps it beside its plain
    version (``pnp.motion_only_ba_kernel``) and registers it in COUNTED."""
    _check_motion_only_ba(R0, t0, xyz, uv, valid, iters)
    dev, n = R0.device, xyz.shape[0]
    R = torch.empty((3, 3), dtype=torch.float32, device=dev)
    t = torch.empty(3, dtype=torch.float32, device=dev)
    costs = torch.empty(iters, dtype=torch.float32, device=dev)
    inliers = torch.empty(n, dtype=torch.bool, device=dev)
    num = torch.empty((), dtype=torch.int64, device=dev)
    _call("pislam_motion_only_ba", dev, R0.data_ptr(), t0.data_ptr(), xyz.data_ptr(),
          uv.data_ptr(), valid.data_ptr(), n, int(iters), float(huber),
          float(inlier_threshold), float(damping), R.data_ptr(), t.data_ptr(),
          costs.data_ptr(), inliers.data_ptr(), num.data_ptr())
    return {"R": R, "t": t, "inliers": inliers, "num_inliers": num, "costs": costs}


class KernelSet(NamedTuple):
    """The kernels of the SLAM path: K1, K2 and ``orb_describe`` of the
    default (fused, sorted BRIEF) frontend, K6 of the unfused one,
    ``orb_describe_dense`` of the dense BRIEF variant, and K5 of matching;
    K3, K4 and K4d alone run on no path."""

    fused_frontend_codes: Callable
    topk_keys: Callable
    gather_windows_packed: Callable
    orb_select: Callable
    match_reduce: Callable
    reduce_codes_4x: Callable
    orb_select_bits: Callable
    orb_describe: Callable
    orb_describe_dense: Callable


# The wrappers: plain on CPU tensors, Hopper kernels on CUDA tensors.
HOPPER = KernelSet(fused_frontend_codes, topk_keys, gather_windows_packed,
                   orb_select, match_reduce, reduce_codes_4x, orb_select_bits,
                   orb_describe, orb_describe_dense)
# The plain versions on any device: the reference the kernels are held to.
PLAIN = KernelSet(fused_frontend_codes_plain, topk_keys_plain,
                  gather_windows_packed_plain, orb_select_plain,
                  match_reduce_plain, reduce_codes_4x_plain, orb_select_bits_plain,
                  orb_describe_plain, orb_describe_dense_plain)
# Every kernel with a launch count: the kernel set's, K3c and K3a, which no
# path runs, and those wrapped beside a plain version of a layer above this
# one, which register with counted() (motion-only BA, backend/pnp.py).
COUNTED = [*HOPPER, realign_windows, pack_row_strips]


def counted(kernel: HopperKernel) -> HopperKernel:
    """Adds a kernel wrapped outside this module to COUNTED."""
    COUNTED.append(kernel)
    return kernel


def reset_launch_counts():
    for k in COUNTED:
        k.launches = 0


def launch_counts() -> dict[str, int]:
    return {k.__name__: k.launches for k in COUNTED}
