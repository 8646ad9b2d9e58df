"""FAST-9 corner detection as a dense, whole-image tensor program.

The port of ``pislam_tpu/ops/fast.py`` (reference Fast.h:54-158). A pixel is
a corner iff some circular arc of >= 9 contiguous ring pixels is uniformly
darker than center - t or uniformly lighter than center + t. The 16 ring
tests become a 16-bit ring mask per pixel; a length-9 circular run is found
with a logarithmic shift-AND reduction.
"""

from __future__ import annotations

import torch

# The 16 ring offsets (dy, dx) in circular order (Fast.h:62-128).
RING = (
    (-3, -1), (-3, 0), (-3, 1), (-2, 2),
    (-1, 3), (0, 3), (1, 3), (2, 2),
    (3, 1), (3, 0), (3, -1), (2, -2),
    (1, -3), (0, -3), (-1, -3), (-2, -2),
)


def shift2d(a, dy: int, dx: int):
    """shift2d(a, dy, dx)[..., y, x] = a[..., y+dy, x+dx], wrapping at edges.

    Wrapped values land only inside the border region, which every caller
    masks off (border >= 3 for FAST, Fast.h:46-49).
    """
    return torch.roll(a, shifts=(-dy, -dx), dims=(-2, -1))


def _has_run9(bits):
    """True where the 16-bit circular ring mask holds a run of >= 9 ones."""
    r = bits | (bits << 16)
    r = r & (r >> 1)
    r = r & (r >> 2)
    r = r & (r >> 4)
    r = r & (r >> 1)
    return (r & 0xFFFF) != 0


def fast_detect(img, threshold: int):
    """(..., H, W) uint8 -> bool corner mask (exact FAST-9 semantics)."""
    c = img.to(torch.int32)
    dark_th = c - threshold   # pass-dark:  ring < c - t
    light_th = c + threshold  # pass-light: ring > c + t
    dark_bits = torch.zeros_like(c)
    light_bits = torch.zeros_like(c)
    for p, (dy, dx) in enumerate(RING):
        s = shift2d(c, dy, dx)
        dark_bits |= (s < dark_th).to(torch.int32) << p
        light_bits |= (s > light_th).to(torch.int32) << p
    return _has_run9(dark_bits) | _has_run9(light_bits)
