"""The frontend's Hopper kernels, each beside its plain PyTorch version.

The counterpart of ``pislam_tpu/ops/pallas_kernels.py``. Each wrapper takes
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
    pass, one 32x64 pixel tile per block, staged through shared memory
    with a 4-before / 5-after halo, so no intermediate reaches device
    memory; out-of-image reads clamp (the level mask zeroes every score
    within 16 px of an edge). Codes come out in true row and column
    order, so bucketing needs no un-permute.
K2 topk_keys             csrc/topk.cu
    Replaces ``topk_keys`` / ``_bitonic_topk_kernel`` (pallas_kernels.py:892).
    Bound: one read of N keys per radix pass (1.4 MB at VGA) and launch
    latency of the short passes. Design: 8-bit radix select of the k-th key
    (shared-memory histograms, one pass per digit), warp-aggregated
    compaction of the k survivors, then one block's bitonic sort of <= 8192
    keys in shared memory.
K3 gather_windows_packed csrc/gather_windows.cu
    Replaces ``pack_row_strips`` + ``realign_windows2d``
    (pallas_kernels.py:73, :145) inside ``gather_windows_packed``
    (pallas_kernels.py:195); also covers the 3-D ``realign_windows``
    (pallas_kernels.py:172), which gives the same bytes. Bound: 2 MB of
    output at K=2048, written once. Design: a direct gather, one thread
    per output word (4 window rows of one column), XOR 0x80 fused in;
    the TPU's strips and rotates were workarounds for its gather cost.
K4 orb_select            csrc/orb_select.cu
    Replaces ``orb_select_bits_sorted`` / ``_orb_sorted_kernel``
    (pallas_kernels.py:528) and the dense ``orb_select_bits``
    (pallas_kernels.py:465): both give identical bits. Bound: 2 MB of
    windows read once; the work is 2x1024 moment products and 256
    compares per keypoint. Design: one block per keypoint, window in
    shared memory, exact int32 moments, IEEE-exact atan2 bins (no FMA
    contraction), then bit i = p[idx1] > p[idx0], packed by warp ballot.
    GDIFF's column is onehot(idx1) - onehot(idx0), so its sign test is
    this compare.
K5 match_reduce          csrc/match_reduce.cu
    Replaces ``match_reduce`` / ``_match_reduce_kernel`` and its gated
    variant (pallas_kernels.py:688, :667, :673). Bound: 2*K1*K2*256 int8
    operations at 1,979 TOP/s if computed as the TPU did (1.1 us at
    2048 x 2048); the popcount route does 8*K1*K2 popcounts at 16 per SM
    per clock (8 us). Bytes are negligible. Design: packed words, XOR and
    popcount, one thread per query row over shared-memory database tiles,
    the database split across blocks and merged with the TPU's exact rule;
    column first-argmins by atomicMin on (distance << 16 | row) keys.
"""

from __future__ import annotations

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

    def __call__(self, x: torch.Tensor, *args):
        if x.device.type == "cpu":
            return self.plain(x, *args)
        if x.device.type != "cuda":
            raise ValueError(f"{self.__name__}: no kernel for device {x.device}")
        out = self.launch(x, *args)
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


def _call(fn_name: str, device: torch.device, *args):
    lib = _build.load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn_name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {err}")


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
    enc = nms.encode_grid(score, nms.nms(score))
    h, w = enc.shape
    if h % 2 or w % 2:
        padded = enc.new_zeros((h + h % 2, w + w % 2))
        padded[:h, :w] = enc
        enc = padded
    h2, w2 = enc.shape[0] // 2, enc.shape[1] // 2
    red = enc.reshape(h2, 2, w2, 2).amax(dim=(1, 3))
    return codec.u32_to_i32(red)


@hopper_kernel(fused_frontend_codes_plain, "pislam_tpu_torch/csrc/fused_frontend.cu",
               "pislam_tpu/ops/pallas_kernels.py:387")
def fused_frontend_codes(img, mask, fast_t: int, harris_t: int):
    h, w = img.shape
    if h > 4096 or w > 4096:
        raise ValueError(f"image {h}x{w}: codes hold 12-bit coordinates")
    _check(img, "img", torch.uint8, 2, img.device)
    _check(mask, "mask", torch.uint8, 2, img.device)
    if mask.shape != img.shape:
        raise ValueError(f"mask {tuple(mask.shape)} != image {tuple(img.shape)}")
    out = torch.empty(((h + 1) // 2, (w + 1) // 2), dtype=torch.int32,
                      device=img.device)
    _call("pislam_fused_frontend", img.device, img.data_ptr(), mask.data_ptr(),
          out.data_ptr(), h, w, int(fast_t), int(harris_t))
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


@hopper_kernel(topk_keys_plain, "pislam_tpu_torch/csrc/topk.cu",
               "pislam_tpu/ops/pallas_kernels.py:892")
def topk_keys(keys, k: int):
    _check_k(k)
    keys = _pad_keys(keys, k)
    _check(keys, "keys", torch.int32, 1, keys.device)
    p = 1 << (k - 1).bit_length()
    out = torch.empty(k, dtype=torch.int32, device=keys.device)
    # 4 histograms of 256 bins, 8 words of selection state, p sort slots
    scratch = torch.empty(4 * 256 + 8 + p, dtype=torch.int32, device=keys.device)
    _call("pislam_topk_keys", keys.device, keys.data_ptr(), keys.numel(), k, p,
          out.data_ptr(), scratch.data_ptr())
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
# K5: Hamming best / second / first-argmin per row, first-argmin per column
# ---------------------------------------------------------------------------

MAX_MATCH_ROWS = 1 << 16      # the column keys hold the row in 16 bits
_MATCH_ROWS = 128             # csrc/match_reduce.cu kRows
_MATCH_BLOCKS = 264           # two blocks per SM on a 132-SM card


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


def _match_segments(k1: int, k2: int) -> tuple[int, int]:
    """Database columns per block and the number of segments: enough blocks
    to fill the card at frame size, at least 64 columns each."""
    def cdiv(a, b):
        return -(-a // b)

    nseg = max(1, min(cdiv(_MATCH_BLOCKS, cdiv(k1, _MATCH_ROWS)), cdiv(k2, 64)))
    seg = cdiv(cdiv(k2, nseg), 32) * 32
    return seg, cdiv(k2, seg)


@hopper_kernel(match_reduce_plain, "pislam_tpu_torch/csrc/match_reduce.cu",
               "pislam_tpu/ops/pallas_kernels.py:688")
def match_reduce(desc1, desc2, valid1, valid2, uv1=None, uv2=None, radius=None):
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
    seg, nseg = _match_segments(k1, k2)
    best, second, idx = (torch.empty(k1, dtype=torch.int32, device=dev) for _ in range(3))
    col = torch.empty(k2, dtype=torch.int32, device=dev)
    part = torch.empty(nseg * k1 * 3, dtype=torch.int32, device=dev)
    r2 = float(radius) * float(radius) if gated else 0.0
    _call("pislam_match_reduce", dev, desc1.data_ptr(), desc2.data_ptr(), k1, k2, words,
          valid1.view(torch.uint8).data_ptr(), valid2.view(torch.uint8).data_ptr(),
          uv1.data_ptr() if gated else None, uv2.data_ptr() if gated else None,
          r2, int(gated), seg, nseg, best.data_ptr(), second.data_ptr(),
          idx.data_ptr(), col.data_ptr(), part.data_ptr())
    return best, second, idx, col


class KernelSet(NamedTuple):
    """The five kernels of the VO path: four of extraction, one of matching."""

    fused_frontend_codes: Callable
    topk_keys: Callable
    gather_windows_packed: Callable
    orb_select: Callable
    match_reduce: Callable


# The wrappers: plain on CPU tensors, Hopper kernels on CUDA tensors.
HOPPER = KernelSet(fused_frontend_codes, topk_keys, gather_windows_packed,
                   orb_select, match_reduce)
# The plain versions on any device: the reference the kernels are held to.
PLAIN = KernelSet(fused_frontend_codes_plain, topk_keys_plain,
                  gather_windows_packed_plain, orb_select_plain,
                  match_reduce_plain)


def reset_launch_counts():
    for k in HOPPER:
        k.launches = 0


def launch_counts() -> dict[str, int]:
    return {k.__name__: k.launches for k in HOPPER}
