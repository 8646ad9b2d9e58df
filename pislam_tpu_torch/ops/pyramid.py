"""Image pyramid construction on the frame's device.

The port of ``pislam_tpu/ops/pyramid.py`` (``build_pyramid`` and
``stack_levels``): one camera frame becomes the stacked
(padded_height, stride) uint8 buffer the frontend consumes, with the demo's
level table round(base * (5/6)^l) (demo.cpp:38-47). Each level is the
previous one blurred with the exact 5x5 binomial, then bilinear-resized.
"""

from __future__ import annotations

import torch

from ..config import PyramidConfig
from .bilinear import resize_bilinear
from .gaussian import gaussian5x5


def build_pyramid(frame, cfg: PyramidConfig):
    """(base_height, base_width) uint8 frame -> (padded_height, stride) stack."""
    if tuple(frame.shape) != (cfg.base_height, cfg.base_width):
        raise ValueError(f"expected {(cfg.base_height, cfg.base_width)}, "
                         f"got {tuple(frame.shape)}")
    sizes = cfg.level_sizes
    levels = [frame]
    for lvl in range(1, cfg.num_levels):
        w, h = sizes[lvl]
        levels.append(resize_bilinear(gaussian5x5(levels[-1]), h, w))
    return stack_levels(levels, cfg)


def stack_levels(levels, cfg: PyramidConfig):
    """Stack per-level images into the (padded_height, stride) buffer."""
    out = torch.zeros((cfg.padded_height, cfg.stride), dtype=torch.uint8,
                      device=levels[0].device)
    row = 0
    for img, (w, h) in zip(levels, cfg.level_sizes):
        if tuple(img.shape) != (h, w):
            raise ValueError(f"level {tuple(img.shape)} != {(h, w)}")
        out[row:row + h, :w] = img
        row += h
    return out
