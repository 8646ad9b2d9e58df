#!/usr/bin/env python3
"""Drive the PyTorch port's ORB extraction on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero and
prints no result line):

1. device: the card's name and power limit (nvidia-smi); no card, no run.
2. build: nvcc compiles the four Hopper kernels from pislam_tpu_torch/csrc.
3. kernels: K1-K4 and K4's atan2 bins against their plain PyTorch versions
   on the card, bit-exact, at the main path's shapes (VGA 8-level pyramid
   with 2048 keypoints, and the eval config's 4-level 384x256 pyramid with
   512), including invalid and edge keypoints and an atan2 sweep.
4. main path: 48 frames of data/eval_seq.npz at the eval config and 8 seeded
   VGA frames at the default config, each frame -> build_pyramid ->
   make_extract_fn(cfg, "cuda"), compared frame by frame with the plain path
   on the card, the first 4 of each also with the plain path on the CPU;
   every kernel's launch count must reach the number of frames.
5. times from CUDA events (median of 30 after warm-up), with the card's
   name and power limit on every line.

The line before the last is {"kernels": [...]}, the last line is
{"ok": true, "device": {...}}. Imports torch, numpy and the port only.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

EVAL_FRAMES = 48
VGA_FRAMES = 8
CPU_FRAMES = 4
REPS = 30


def eval_config():
    """tools/eval_ate.py's frontend config for the committed sequences."""
    from pislam_tpu_torch import FrontendConfig, PislamConfig, PyramidConfig
    return PislamConfig(
        pyramid=PyramidConfig(base_width=384, base_height=256, num_levels=4),
        frontend=FrontendConfig(fast_threshold=14, harris_threshold=1 << 9,
                                border=16, max_keypoints=512))


def card_label() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int = REPS) -> float:
    """Median CUDA-event time of fn() over reps calls, after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_abs_err(a, b) -> int:
    """Largest |a - b| over all elements (int64), and shapes must match."""
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"{a.shape}/{a.dtype} vs {b.shape}/{b.dtype}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item()) if a.numel() else 0


def require_equal(name: str, got, want) -> int:
    err = max_abs_err(got, want)
    if err:
        raise AssertionError(f"{name}: kernel disagrees with plain version "
                             f"(max |diff| {err})")
    return err


def features_equal(a, b) -> bool:
    return all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b))


def kernel_phase(dev, pyramids, cfgs):
    """K1-K4 against their plain versions on the card. Returns per-kernel
    max |error| and, at the VGA shapes, the kernel's and plain version's
    CUDA-event times."""
    import pislam_tpu_torch as pt
    from pislam_tpu_torch.ops import brief, kernels, nms, orientation
    from pislam_tpu_torch.utils import codec

    errs = {k.__name__: 0 for k in kernels.HOPPER}
    times = {}
    for label, cfg in cfgs.items():
        pyr = pyramids[label]
        fc = cfg.frontend
        extractor = pt.make_extract_fn(cfg, dev)
        mask = extractor.level_mask.view(torch.uint8)
        h, w = pyr.shape

        args1 = (pyr, mask, fc.fast_threshold, fc.harris_threshold)
        grid = kernels.fused_frontend_codes(*args1)
        errs["fused_frontend_codes"] = max(errs["fused_frontend_codes"], require_equal(
            f"K1 {label}", grid, kernels.fused_frontend_codes_plain(*args1)))

        keys = (grid.reshape(-1) ^ nms.INT32_MIN).contiguous()
        k = fc.max_keypoints
        top = kernels.topk_keys(keys, k)
        errs["topk_keys"] = max(errs["topk_keys"], require_equal(
            f"K2 {label}", top, kernels.topk_keys_plain(keys, k)))
        few = keys.clone()                       # fewer survivors than k
        few[few.argsort(descending=True)[k // 3:]] = nms.INT32_MIN
        require_equal(f"K2 {label} few", kernels.topk_keys(few, k),
                      kernels.topk_keys_plain(few, k))

        codes = codec.i32_to_u32(top ^ nms.INT32_MIN)
        xs = codec.decode_x(codes).to(torch.int32)
        ys = codec.decode_y(codes).to(torch.int32)
        valid = codes != 0
        # edge and invalid keypoints: every clip boundary, and garbage coords
        ex = torch.tensor([0, 15, 16, w - 17, w - 16, w - 1, 3000, -5],
                          dtype=torch.int32, device=dev)
        ey = torch.tensor([0, 15, h - 17, 16, h - 16, h - 1, -5, 4000],
                          dtype=torch.int32, device=dev)
        ev = torch.tensor([True, True, True, True, False, False, False, False],
                          device=dev)
        xs, ys = torch.cat([xs, ex]), torch.cat([ys, ey])
        valid = torch.cat([valid, ev])
        args3 = (pyr, xs, ys, valid)
        flat = kernels.gather_windows_packed(*args3)
        errs["gather_windows_packed"] = max(errs["gather_windows_packed"], require_equal(
            f"K3 {label}", flat, kernels.gather_windows_packed_plain(*args3)))

        tables = brief.OrbTables.build(dev)
        for words in (fc.words, 4):
            args4 = (flat, *tables, words)
            ang, desc = kernels.orb_select(*args4)
            pang, pdesc = kernels.orb_select_plain(*args4)
            errs["orb_select"] = max(errs["orb_select"],
                                     require_equal(f"K4 {label} angles", ang, pang),
                                     require_equal(f"K4 {label} words={words}", desc, pdesc))

        if label == "vga":
            args2 = (keys, k)
            args4 = (flat[:k], *tables, fc.words)
            for name, args in (("fused_frontend_codes", args1), ("topk_keys", args2),
                               ("gather_windows_packed", args3), ("orb_select", args4)):
                kern = getattr(kernels, name)
                times[name] = (time_ms(lambda: kern(*args)),
                               time_ms(lambda: kern.plain(*args)))

    m10, m01 = (torch.as_tensor(m, device=dev) for m in orientation.sweep_moments())
    bins = kernels.atan2_bins(m10, m01)
    require_equal("K4 atan2 sweep (card plain)", bins, orientation.atan2_bins(m10, m01))
    require_equal("K4 atan2 sweep (CPU plain)", bins.cpu(),
                  orientation.atan2_bins(m10.cpu(), m01.cpu()))
    print(f"phase kernels: ok, K1-K4 bit-exact (tolerance 0) on VGA and eval shapes; "
          f"atan2 sweep of {m10.numel()} moment pairs bit-exact")
    return errs, times


def main_path(dev, frames, cfgs):
    """Every frame through pyramid + extraction on the card, against the plain
    path on the card (and on the CPU for the first frames)."""
    import pislam_tpu_torch as pt
    from pislam_tpu_torch.ops import kernels
    from pislam_tpu_torch.ops.pyramid import build_pyramid

    extract = {k: pt.make_extract_fn(c, dev) for k, c in cfgs.items()}
    plain = {k: pt.OrbExtractor(c, ops=kernels.PLAIN).to(dev) for k, c in cfgs.items()}
    n_frames = sum(len(f) for f in frames.values())

    kernels.reset_launch_counts()
    results = {k: [] for k in cfgs}
    for label, cfg in cfgs.items():
        for frame in frames[label]:
            pyr = build_pyramid(frame.to(dev), cfg.pyramid)
            results[label].append((pyr, extract[label](pyr)))
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    for name, n in launches.items():
        if n < n_frames:
            raise AssertionError(f"{name}: {n} launches for {n_frames} frames")

    for label, cfg in cfgs.items():
        counts = []
        cpu_extract = pt.make_extract_fn(cfg, "cpu")
        for i, (pyr, feats) in enumerate(results[label]):
            if not features_equal(feats, plain[label](pyr)):
                raise AssertionError(f"{label} frame {i}: kernels != plain path on card")
            if i < CPU_FRAMES:
                cpu_pyr = build_pyramid(frames[label][i], cfg.pyramid)
                if not torch.equal(cpu_pyr, pyr.cpu()):
                    raise AssertionError(f"{label} frame {i}: pyramid card != CPU")
                if not features_equal(feats, cpu_extract(cpu_pyr)):
                    raise AssertionError(f"{label} frame {i}: card != CPU plain path")
            k = feats.codes.numel()
            counts.append(int(feats.valid.sum()))
            if feats.descriptors.shape != (k, cfg.frontend.words):
                raise AssertionError(f"{label}: descriptor shape {feats.descriptors.shape}")
            if int(feats.angles.max()) >= 30:
                raise AssertionError(f"{label}: angle bin out of range")
        if min(counts) == 0:
            raise AssertionError(f"{label}: a frame gave no features")
        print(f"phase main path {label}: {len(counts)} frames bit-exact vs plain "
              f"(card), first {CPU_FRAMES} vs plain (CPU); features per frame "
              f"min {min(counts)} mean {statistics.mean(counts):.1f} max {max(counts)}")
    print(f"phase main path launches: {json.dumps(launches)}")
    return launches, extract, results


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs a CUDA card")
    import pislam_tpu_torch as pt
    from pislam_tpu_torch.ops import _build, kernels
    from pislam_tpu_torch.ops.pyramid import build_pyramid

    # phase 1: device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_label()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"devices {torch.cuda.device_count()}")

    # phase 2: build
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    print(f"phase build: {time.perf_counter() - t0:.2f} s -> {lib.relative_to(ROOT)}")
    for line in (lib.parent / "nvcc.log").read_text().splitlines():
        if "Used" in line or "Compiling entry" in line:
            print("  ptxas", line.split("ptxas info    :")[-1].strip())

    cfgs = {"eval": eval_config(), "vga": pt.PislamConfig()}
    seq = np.load(ROOT / "data" / "eval_seq.npz")["frames"][:EVAL_FRAMES]
    rng = np.random.default_rng(0)
    pc = cfgs["vga"].pyramid
    vga = rng.integers(0, 256, (VGA_FRAMES, pc.base_height, pc.base_width), np.uint8)
    frames = {"eval": [torch.from_numpy(f.copy()) for f in seq],
              "vga": [torch.from_numpy(f) for f in vga]}
    pyramids = {k: build_pyramid(frames[k][0].to(dev), c.pyramid) for k, c in cfgs.items()}

    # phase 3: each kernel against its plain version
    errs, ktimes = kernel_phase(dev, pyramids, cfgs)

    # phase 4: the main path
    launches, extract, results = main_path(dev, frames, cfgs)

    # phase 5: times
    for label, cfg in cfgs.items():
        frame = frames[label][0].to(dev)
        pyr = results[label][0][0]
        plain = pt.OrbExtractor(cfg, ops=kernels.PLAIN).to(dev)
        pyr_ms = time_ms(lambda: build_pyramid(frame, cfg.pyramid))
        ext_ms = time_ms(lambda: extract[label](pyr))
        plain_ms = time_ms(lambda: plain(pyr))
        print(f"time {label} ({tuple(pyr.shape)}, k={cfg.frontend.max_keypoints}): "
              f"pyramid {pyr_ms:.4f} ms/frame, extraction {ext_ms:.4f} ms/frame "
              f"(plain path {plain_ms:.4f}) [{card}]")
    for name, (k_ms, p_ms) in ktimes.items():
        print(f"time kernel {name} at VGA shapes: {k_ms:.4f} ms, plain {p_ms:.4f} ms [{card}]")

    rows = [{"name": k.__name__, "route": "cuda", "source": k.source,
             "replaces": k.replaces, "launches": launches[k.__name__],
             "max_abs_err": errs[k.__name__], "ms": ktimes[k.__name__][0],
             "plain_ms": ktimes[k.__name__][1]} for k in kernels.HOPPER]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
