"""The card's peaks and the least time of each of the port's CUDA kernels on
the main path, from the shapes and inputs of a launch.

A kernel's least time is the larger of its bytes over the memory rate and
its operations over the peak rate of their type (summed over types). Each
input byte is counted once and each output byte once; operations are those
the algorithm needs for these inputs. The formulas are those of the port's
card check (``chip_smoke.py``: ``bound_ms``, K1's and K2's rows, ``k5_bound``
and ``describe_bound``), copied here so that later changes to the program
cannot move the yardstick.
"""

from __future__ import annotations

import torch

# Published H100 SXM peaks (NVIDIA's data sheet, dense, at 700 W): device
# memory, int8 tensor cores, and float32 outside the tensor cores, which
# also bounds the scalar integer work of K1-K4 (int32 units run at no more
# than the float32 rate, so the bound stays a lower bound).
HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1979e12
SCALAR_OPS_S = 67e12
# K1's scalar operations per pixel, from the algorithm: FAST's 16 ring loads
# and 32 compares and the arc test, Harris's gradients, products, 6x6 window
# sums and score, the 3x3 NMS, the encode and the 2x2 max.
K1_OPS_PER_PIXEL = 100
RADIUS = 15

# the __global__ functions of the main path's kernels, as the profiler names them
KERNELS = {
    "fused_frontend_codes": "fused_frontend_kernel",
    "topk_keys": "topk_cluster_kernel",
    "orb_describe": "orb_describe_kernel",
    "match_reduce": "match_wgmma_kernel",
}


def bound_s(nbytes: float, *work: tuple[float, float]) -> float:
    """Seconds: max(bytes / memory rate, sum of operations / their rate)."""
    return max(nbytes / HBM_BYTES_S, sum(ops / rate for ops, rate in work))


def k1_bound(h: int, w: int) -> float:
    """K1 over an (h, w) pyramid: image and level mask in, the (h/2, w/2)
    int32 code grid out; K1_OPS_PER_PIXEL scalar operations a pixel."""
    n_px = h * w
    return bound_s(2 * n_px + (h + 1) // 2 * ((w + 1) // 2) * 4,
                   (K1_OPS_PER_PIXEL * n_px, SCALAR_OPS_S))


def k2_bound(n_keys: int, k: int) -> float:
    """K2, top-k of n int32 keys: the keys in, k out, 4 scalar operations a key."""
    return bound_s(n_keys * 4 + k * 4, (4 * n_keys, SCALAR_OPS_S))


def k5_bound(k1: int, k2: int, words: int, gated: bool = False) -> float:
    """K5 over (k1, words) x (k2, words) descriptors: both sets and their
    flags in, best / second / index per row and argmin per column out (and
    the points with a gate); 2 k1 k2 (32 words) int8 operations."""
    nbytes = (k1 + k2) * words * 4 + k1 + k2 + (3 * k1 + k2) * 4
    if gated:
        nbytes += (k1 + k2) * 8
    return bound_s(nbytes, (2 * k1 * k2 * words * 32, INT8_OPS_S))


def describe_bound(h: int, w: int, codes, valid, angles, words: int) -> float:
    """``orb_describe`` on these keypoints: the pixels of the valid
    keypoints' windows (their union), the rows of the BRIEF tables of the
    bins they use and the moment weights, the codes and flags in, angles and
    words out; 2 x 1024 int8 moment products per valid keypoint at the int8
    rate and 32 words compares at the scalar rate."""
    k, n = codes.numel(), int(valid.sum())
    x = ((codes >> 12) & 0xFFF).clamp(RADIUS, w - RADIUS - 2)[valid]
    y = (codes & 0xFFF).clamp(RADIUS, h - RADIUS - 2)[valid]
    r = torch.arange(32, device=codes.device) - RADIUS
    touched = torch.zeros(h, w, dtype=torch.bool, device=codes.device)
    touched[(y[:, None] + r)[:, :, None], (x[:, None] + r)[:, None, :]] = True
    bins = torch.unique(angles[valid]).numel()
    nbytes = (int(touched.sum()) + bins * 2 * 32 * words * 2 + 1024 * 2
              + k * (8 + 1) + k * (1 + 4 * words))
    return bound_s(nbytes, (n * 2 * 1024 * 2, INT8_OPS_S), (n * 32 * words, SCALAR_OPS_S))
