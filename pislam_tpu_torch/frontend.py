"""The ORB extraction frontend: one pass over a stacked pyramid.

The port of ``pislam_tpu/frontend.py`` (reference demo.cpp:78-101). FAST,
Harris and NMS run as one dense pass over the whole stacked
(padded_height, stride) buffer, per-level borders are one validity mask,
and keypoint y coordinates are global pyramid rows. On a CUDA device the
steps of the path are Hopper kernels (``ops/kernels.py``): K1 fused frontend
(or, unfused, FAST/Harris/NMS in plain torch then K6's code reduction), K2
top-k, K3 window gather, K4 ORB select (K4d for ``brief_variant="dense"``).

Output is a fixed-capacity ``Features`` batch, strongest first by
(score, x, y).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from .config import PislamConfig
from .ops import brief, fast, harris, kernels, nms, patches
from .utils import codec


class Features(NamedTuple):
    """Extracted keypoints. torch has no uint32 arithmetic on the CPU, so:

    codes        (K,)        int64  the u32 code score<<24 | x<<12 | y
    valid        (K,)        bool
    angles       (K,)        uint8  orientation bin in [0, 30)
    descriptors  (K, words)  int32  the u32 descriptor words' bit patterns

    ``codes`` equal the JAX package's uint32 codes as int64;
    ``descriptors.view(torch.uint32)`` or a numpy ``.view(np.uint32)``
    gives its uint32 words.
    """

    codes: torch.Tensor
    valid: torch.Tensor
    angles: torch.Tensor
    descriptors: torch.Tensor

    @property
    def xs(self):
        return codec.decode_x(self.codes).to(torch.int32)

    @property
    def ys(self):
        return codec.decode_y(self.codes).to(torch.int32)

    @property
    def scores(self):
        return codec.decode_score(self.codes).to(torch.int32)

    @property
    def num_valid(self):
        return self.valid.sum()


def _extract_impl(img, level_mask, cfg: PislamConfig, tables: brief.OrbTables,
                  ops: kernels.KernelSet = kernels.HOPPER) -> Features:
    """img (H, W) uint8 and level_mask (H, W) bool, on one device."""
    fc = cfg.frontend
    if fc.fused_upstream and (fc.log_bucket_size == 0 or fc.border % 2 == 0):
        # K1: FAST + Harris + mask + NMS + encode + 2x2 code max. grid[r, c]
        # is the sole survivor of pixel block (2r..2r+1, 2c..2c+1), in true
        # order; with an even border each block lies whole inside one bucket
        # cell, so bucketing with halved geometry keeps the same codes.
        grid = ops.fused_frontend_codes(img, level_mask.view(torch.uint8),
                                        fc.fast_threshold, fc.harris_threshold)
        # cells of (bs/2)^2 entries cannot exceed the cap: bucketing is a no-op
        if fc.log_bucket_size > 0 and fc.bucket_limit < (1 << (fc.log_bucket_size - 1)) ** 2:
            grid = codec.u32_to_i32(nms.bucket_topk(
                codec.i32_to_u32(grid), fc.border // 2, fc.log_bucket_size - 1,
                fc.bucket_limit))
        codes, valid = nms.select_topk_codes(grid, fc.max_keypoints,
                                             topk=ops.topk_keys)
    else:
        corner = fast.fast_detect(img, fc.fast_threshold)
        score = harris.harris_score(img, fc.harris_threshold,
                                    mask=corner & level_mask)
        keep = nms.nms(score)
        if fc.log_bucket_size > 0:
            enc = nms.bucket_topk(nms.encode_grid(score, keep), fc.border,
                                  fc.log_bucket_size, fc.bucket_limit)
            scored = (enc >> 24).to(torch.uint8)
        else:
            scored = torch.where(keep, score, torch.zeros_like(score))
        # K6: the 2x2 code max of the scored survivors, then K2
        codes, valid = nms.select_topk_scored(scored, fc.max_keypoints,
                                              reduce=ops.reduce_codes_4x,
                                              topk=ops.topk_keys)

    xs = codec.decode_x(codes).to(torch.int32)
    ys = codec.decode_y(codes).to(torch.int32)
    flat = patches.gather_patches_packed_s8(img, xs, ys, valid,
                                            gather=ops.gather_windows_packed)
    angles, desc = brief.orb_compute_packed(flat, fc.words, fc.brief_variant,
                                            tables, ops=ops)
    desc = torch.where(valid[:, None], desc, torch.zeros_like(desc))
    angles = torch.where(valid, angles, torch.zeros_like(angles))
    return Features(codes=codes, valid=valid, angles=angles, descriptors=desc)


class OrbExtractor(nn.Module):
    """extract(pyramid) -> Features for one config, its tables as buffers.

    Buffers: ``level_mask`` (padded_height, stride) bool, ``idx0``/``idx1``
    (30, 256) int16 packed BRIEF indices, ``mom_w`` (1024, 2) int8 packed
    disc-moment weights. ``ops`` picks the kernels: ``kernels.HOPPER``
    (plain versions on the CPU, Hopper kernels on CUDA) or
    ``kernels.PLAIN`` (the plain versions on any device, for comparison).
    """

    def __init__(self, cfg: PislamConfig, ops: kernels.KernelSet = kernels.HOPPER):
        super().__init__()
        self.cfg = cfg
        self.ops = ops
        pc = cfg.pyramid
        mask = nms.make_level_mask(pc.level_sizes, pc.level_rows, pc.padded_height,
                                   pc.stride, cfg.frontend.border)
        self.register_buffer("level_mask", torch.as_tensor(mask))
        for name, table in zip(brief.OrbTables._fields, brief.OrbTables.build("cpu")):
            self.register_buffer(name, table)

    def forward(self, pyramid: torch.Tensor) -> Features:
        pc = self.cfg.pyramid
        if tuple(pyramid.shape) != (pc.padded_height, pc.stride):
            raise ValueError(f"expected {(pc.padded_height, pc.stride)}, "
                             f"got {tuple(pyramid.shape)}")
        if pyramid.device != self.level_mask.device:
            raise ValueError(f"pyramid on {pyramid.device}, extractor on "
                             f"{self.level_mask.device}")
        tables = brief.OrbTables(self.idx0, self.idx1, self.mom_w)
        return _extract_impl(pyramid, self.level_mask, self.cfg, tables, self.ops)


def tables_from_numpy(arrays: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """An ``OrbExtractor`` state dict from the JAX package's own arrays.

    ``arrays``: ``IDX0``, ``IDX1`` (30, 256) patch indices, ``GDIFF``
    (961, 7680), ``gm_packed`` (1024, 7808), ``MOMENT_WEIGHTS`` (961, 2) and
    ``level_mask`` (H, W). The buffers derive from IDX0/IDX1,
    MOMENT_WEIGHTS and level_mask; GDIFF and gm_packed must agree with them.
    """
    idx0, idx1 = (np.asarray(arrays[k]) for k in ("IDX0", "IDX1"))
    mw = np.asarray(arrays["MOMENT_WEIGHTS"])
    mw8 = mw.astype(np.int8)
    if not np.array_equal(mw8, mw):
        raise ValueError("MOMENT_WEIGHTS are not int8 integers")
    mom_w = patches.remap_weights_packed(mw8)
    gdiff = brief._diff_matrix(idx0, idx1)
    if not np.array_equal(np.asarray(arrays["GDIFF"]), gdiff):
        raise ValueError("GDIFF disagrees with IDX0/IDX1")
    if not np.array_equal(np.asarray(arrays["gm_packed"]), brief._gm_packed(gdiff, mom_w)):
        raise ValueError("gm_packed disagrees with GDIFF/MOMENT_WEIGHTS")
    p0, p1 = brief.packed_rotation_tables(idx0, idx1)
    return {
        "level_mask": torch.as_tensor(np.asarray(arrays["level_mask"], bool)),
        "idx0": torch.as_tensor(p0),
        "idx1": torch.as_tensor(p1),
        "mom_w": torch.as_tensor(mom_w),
    }


def make_extract_fn(cfg: PislamConfig, device="cuda") -> OrbExtractor:
    """extract(pyramid_stacked) -> Features for a config, on ``device``.

    ``pyramid_stacked`` is a (padded_height, stride) uint8 tensor on that
    device: the vertically stacked pyramid (reference README.md:56-83).
    """
    return OrbExtractor(cfg).to(device)


def extract_single_level(img, cfg: PislamConfig) -> Features:
    """Extraction over one plain (H, W) uint8 image (no pyramid).

    No lane-alignment padding: the border mask alone keeps every read of a
    valid keypoint >= 16 pixels inside the image.
    """
    h, w = img.shape
    b = cfg.frontend.border
    m = torch.zeros((h, w), dtype=torch.bool, device=img.device)
    m[b:h - b, b:w - b] = True
    return _extract_impl(img, m, cfg, brief.OrbTables.build(img.device))
