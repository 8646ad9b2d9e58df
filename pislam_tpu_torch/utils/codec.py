"""Packed keypoint codec: score<<24 | x<<12 | y in one uint32.

The port of ``pislam_tpu/utils/codec.py`` (reference Util.h:27-45). Integer
order of the packed value is (score, x, y) lexicographic order.

torch has no shifts or comparisons for ``torch.uint32`` on the CPU, so a code
is carried in an ``int64`` tensor that holds the u32 value (0 <= code < 2^32).
"""

from __future__ import annotations

import torch

U32_MASK = 0xFFFFFFFF


def encode(score, x, y):
    """(score, x, y) -> int64 score<<24 | x<<12 | y. Reference Util.h:27."""
    score, x, y = (torch.as_tensor(v).to(torch.int64) for v in (score, x, y))
    return (score << 24) | (x << 12) | y


def decode_x(encoded):
    """Reference Util.h:35."""
    return (torch.as_tensor(encoded).to(torch.int64) >> 12) & 0xFFF


def decode_y(encoded):
    """Reference Util.h:39."""
    return torch.as_tensor(encoded).to(torch.int64) & 0xFFF


def decode_score(encoded):
    """Reference Util.h:43."""
    return (torch.as_tensor(encoded).to(torch.int64) >> 24) & 0xFF


def u32_to_i32(codes):
    """int64 u32 values -> int32 tensor with the same bit pattern."""
    codes = codes.to(torch.int64)
    return torch.where(codes >= 1 << 31, codes - (1 << 32), codes).to(torch.int32)


def i32_to_u32(bits):
    """int32 bit pattern -> int64 u32 value."""
    return bits.to(torch.int64) & U32_MASK
