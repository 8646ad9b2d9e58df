"""Non-max suppression and fixed-capacity keypoint selection.

The port of ``pislam_tpu/ops/nms.py`` (reference fastExtract, Fast.h:196-355).
A pixel survives NMS iff

    s > 0
    and s >= each of {up-left, up, up-right, left}
    and s >  each of {right, down-left, down, down-right}

i.e. 3x3 NMS with ties broken toward the raster-earlier pixel. Optional
spatial bucketing keeps the top ``bucket_limit`` codes per cell; the
variable-length output becomes a fixed-capacity top-k plus a validity mask.

Code tensors: a grid of codes from ``encode_grid`` is int64 holding the u32
value; a grid from the fused frontend kernel (K1) is int32 holding the u32
bit pattern. Top-k keys are int32 ``code ^ 0x80000000``, whose signed order
is the codes' unsigned order (zero codes map to INT32_MIN).
"""

from __future__ import annotations

import numpy as np
import torch

from . import kernels
from .fast import shift2d
from ..utils import codec

INT32_MIN = -(1 << 31)


def nms(score):
    """(..., H, W) uint8 score map -> bool keep mask (exact reference rule)."""
    s = score

    def ge(dy, dx):
        return s >= shift2d(s, dy, dx)

    def gt(dy, dx):
        return s > shift2d(s, dy, dx)

    return (
        (s > 0)
        & ge(-1, -1) & ge(-1, 0) & ge(-1, 1) & ge(0, -1)
        & gt(0, 1) & gt(1, -1) & gt(1, 0) & gt(1, 1)
    )


def encode_grid(score, keep):
    """int64 packed code per pixel (score<<24 | x<<12 | y), 0 where suppressed."""
    h, w = score.shape[-2], score.shape[-1]
    ys = torch.arange(h, dtype=torch.int64, device=score.device)[:, None]
    xs = torch.arange(w, dtype=torch.int64, device=score.device)[None, :]
    enc = codec.encode(score, xs, ys)
    return torch.where(keep, enc, torch.zeros_like(enc))


def select_topk(enc_grid, k: int):
    """(H, W) int64 codes -> ((k,) int64 codes, (k,) bool valid), strongest
    first by (score, x, y)."""
    codes = torch.topk(enc_grid.reshape(-1), k).values
    return codes, codes != 0


def select_topk_scored(scored, k: int):
    """Fixed-capacity selection from a scored-survivor grid (u8, 0 = none).

    The JAX package runs its K6 kernel (``reduce_codes_4x``) here on the
    accelerator. It has no Hopper kernel yet, so a CUDA tensor raises.
    """
    if scored.device.type != "cpu":
        raise NotImplementedError("K6 reduce_codes_4x not yet ported")
    return select_topk(encode_grid(scored, scored > 0), k)


def select_topk_codes(codes_grid, k: int, topk=None):
    """Top-k of an int32 (u32 bit pattern) code grid: the K2 kernel on CUDA.

    Returns ((k,) int64 codes, (k,) bool valid), strongest first. ``topk``
    replaces ``kernels.topk_keys`` (e.g. with its plain version).
    """
    topk = topk or kernels.topk_keys
    keys = codes_grid.reshape(-1) ^ INT32_MIN
    top = topk(keys, k)
    codes = codec.i32_to_u32(top ^ INT32_MIN)
    return codes, codes != 0


def bucket_topk(enc_grid, border: int, log_bucket_size: int, bucket_limit: int):
    """Per-cell cap: keep the top ``bucket_limit`` int64 codes per
    2^log_bucket_size cell anchored at (border, border) (Fast.h:210-227,
    316-341). Returns the grid with losers zeroed."""
    bs = 1 << log_bucket_size
    h, w = enc_grid.shape[-2], enc_grid.shape[-1]
    g = torch.roll(enc_grid, shifts=(-border, -border), dims=(-2, -1))
    ph = -(-h // bs) * bs
    pw = -(-w // bs) * bs
    padded = g.new_zeros((ph, pw))
    padded[:h, :w] = g
    cells = padded.reshape(ph // bs, bs, pw // bs, bs).permute(0, 2, 1, 3)
    cells = cells.reshape(ph // bs, pw // bs, bs * bs)
    kth = torch.topk(cells, bucket_limit, dim=-1).values[..., -1:]
    cells = torch.where(cells >= kth, cells, torch.zeros_like(cells))
    g = cells.reshape(ph // bs, pw // bs, bs, bs).permute(0, 2, 1, 3)
    g = g.reshape(ph, pw)[:h, :w]
    return torch.roll(g, shifts=(border, border), dims=(-2, -1))


def make_level_mask(level_sizes, level_rows, total_height, stride,
                    border) -> np.ndarray:
    """Static (H, W) bool validity mask for a stacked pyramid.

    Valid pixels of level l (row r, size (w, h)): rows [r+border, r+h-border),
    cols [border, w-border) (Fast.h:60-61, 171-172, 210, 228).
    """
    m = np.zeros((total_height, stride), bool)
    for (w, h), r in zip(level_sizes, level_rows):
        m[r + border:r + h - border, border:w - border] = True
    return m
