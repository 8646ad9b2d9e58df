"""End-to-end demo: the reference demo.cpp equivalent, on the card.

The port of ``pislam_tpu/demo.py``. Usage:

    python -m pislam_tpu_torch.demo PYRAMID.png [--out out.png] [--cpu]
    python -m pislam_tpu_torch.demo FRAME.png --build-pyramid [--out out.png] [--cpu]

The first form consumes a pre-stacked 640x2210 pyramid PNG (the reference's
demo input, demo.cpp:51-68). The second takes a single 640x480 frame and
builds the 8-level pyramid on the device (``ops/pyramid.build_pyramid``).
Either way: run the ORB frontend, paint crosses at the keypoints
(demo.cpp:119-130 pattern), write the output PNG, and print the extraction
time (a warm-up call first, then one call between two synchronizes) and the
feature count (demo.cpp:113-114). It runs on the CUDA card; ``--cpu`` runs
the kernels' plain versions on the CPU.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def paint_point(img: np.ndarray, x: int, y: int):
    """Cross marker, same strokes as reference paintPoint (demo.cpp:119-130)."""
    h, w = img.shape
    for dy in (-5, -4, 4, 5):
        if 0 <= y + dy < h:
            img[y + dy, x] = 0
    for dx in (-5, -4, 4, 5):
        if 0 <= x + dx < w:
            img[y, x + dx] = 0


def demo_config(threshold: int = 20, harris_threshold: int = 1 << 15,
                max_keypoints: int = 2048):
    """The demo's config: the default VGA 8-level pyramid."""
    from .config import FrontendConfig, PislamConfig, PyramidConfig
    return PislamConfig(
        pyramid=PyramidConfig(),
        frontend=FrontendConfig(fast_threshold=threshold, harris_threshold=harris_threshold,
                                max_keypoints=max_keypoints))


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def annotate(img: np.ndarray, extract, build_pyramid: bool = False):
    """Extract ORB features from ``img`` and paint them.

    ``img`` is a (480, 640) frame with ``build_pyramid``, else the stacked
    (2210, 640) pyramid; ``extract`` an ``OrbExtractor`` (``make_extract_fn``)
    on the device to run on. Returns (the painted (2210, 640) uint8 pyramid,
    the feature count, the extraction's ms on the host clock between two
    synchronizes). The extractor launches its kernels once per call.
    """
    from .ops import pyramid as pyr_ops

    pc = extract.cfg.pyramid
    device = extract.level_mask.device
    if build_pyramid:
        if img.shape != (pc.base_height, pc.base_width):
            raise ValueError(f"frame must be {pc.base_height}x{pc.base_width}, "
                             f"got {img.shape}")
        stack = pyr_ops.build_pyramid(torch.as_tensor(img).to(device), pc)
    else:
        if img.shape != (pc.total_height, pc.base_width):
            raise ValueError(f"pyramid must be {pc.total_height}x{pc.base_width}, "
                             f"got {img.shape}")
        buf = np.zeros((pc.padded_height, pc.stride), np.uint8)
        buf[: img.shape[0], : img.shape[1]] = img
        stack = torch.from_numpy(buf).to(device)

    _sync(device)
    t0 = time.perf_counter()
    feats = extract(stack)
    _sync(device)
    elapsed_ms = (time.perf_counter() - t0) * 1e3

    valid = feats.valid.cpu().numpy()
    xs = feats.xs.cpu().numpy()[valid]
    ys = feats.ys.cpu().numpy()[valid]
    out = stack[: pc.total_height, : pc.base_width].cpu().numpy().copy()
    for x, y in zip(xs.tolist(), ys.tolist()):
        paint_point(out, x, y)
    return out, int(valid.sum()), elapsed_ms


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("input", help="stacked pyramid PNG or single frame PNG")
    ap.add_argument("--out", default="out.png")
    ap.add_argument("--build-pyramid", action="store_true",
                    help="input is a single frame; build the pyramid on the device")
    ap.add_argument("--threshold", type=int, default=20)
    ap.add_argument("--harris-threshold", type=int, default=1 << 15)
    ap.add_argument("--max-keypoints", type=int, default=2048)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU with the kernels' plain versions "
                         "(default: the CUDA card, which must be present)")
    args = ap.parse_args(argv)
    if args.cpu:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda")
    else:
        ap.error("no CUDA card found; pass --cpu to run on the CPU")

    from .frontend import make_extract_fn
    from .io import read_png, write_png

    cfg = demo_config(args.threshold, args.harris_threshold, args.max_keypoints)
    img, extract = read_png(args.input), make_extract_fn(cfg, device)
    annotate(img, extract, args.build_pyramid)          # warm-up
    out, n, elapsed_ms = annotate(img, extract, args.build_pyramid)
    write_png(args.out, out)
    print(f"{'GPU' if device.type == 'cuda' else 'CPU'} Time: {elapsed_ms:.3f} ms "
          "(one call between two synchronizes)")
    print(f"{n} features")
    return 0


if __name__ == "__main__":
    sys.exit(main())
