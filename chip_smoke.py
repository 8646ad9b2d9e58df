#!/usr/bin/env python3
"""Drive the PyTorch port's ORB extraction, visual odometry and keyframe SLAM
on one CUDA card and check them.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero and
prints no result line):

1. device: the card's name and power limit (nvidia-smi); no card, no run.
2. build: nvcc compiles the eight Hopper kernels from pislam_tpu_torch/csrc,
   one process per source, all at once.
3. kernels: K1-K4, K4's atan2 bins, K6, K4d and K3c against their plain
   PyTorch versions on the card, bit-exact, at the extraction shapes (VGA
   8-level pyramid with 2048 keypoints, and the eval config's 4-level
   384x256 pyramid with 512), including invalid and edge keypoints and an
   atan2 sweep; K6 on the unfused frontend's scored grid (its top-k gives
   K1's keypoints), K4d at K and 2048 keypoints (also against K4's bits),
   K3c on 2048 keypoints' strip rows (also against K3's bytes); K5
   (ungated and gated) bit-exact at (512, 512) from eval features,
   (2048, 2048) from VGA features, (2048, 16384) tiled as tools/ab_match.py
   tiles it, and gated with radius 0.06 at (512, 16384), each with invalid
   rows and columns, duplicated descriptors and again with a K1 of no block
   multiple.
4. extraction path: 48 frames of data/eval_seq.npz at the eval config and 8
   seeded VGA frames at the default config, each frame -> build_pyramid ->
   make_extract_fn(cfg, "cuda"), compared frame by frame with the plain path
   on the card, the first 4 of each also with the plain path on the CPU;
   K1-K4's launch counts must reach the number of frames. Then, each a path
   of its own, the same frames with fused_upstream=False (K6) and with
   brief_variant="dense" (K4d), bit-exact against the default path, and
   with odd-border bucketing (K6) against its own plain path.
5. VO path: make_vo_scan(vo_config(), device="cuda") over the four
   data/eval_seq*.npz sequences (416 frames); each sequence's ATE must lie
   within 0.005 of the JAX package's (EVAL_r05.json vo_ate_rmse); every
   kernel's launch count must reach the frames (K5: the transitions); on
   eval_seq the plain path on the card gives the same matches and decisions
   frame by frame, and the CPU agrees on the first 4 transitions.
6. SLAM path, the main path: KeyframeSLAM(slam_config(), device="cuda") over
   the four sequences at full length, then close_loop, with exact launch
   counts; the CPU replays every frame and each closure from the card's
   state with the card's RANSAC draws (same decisions, counters, loop and
   branch; poses within 1e-3), every BA and pose graph the card solved is
   audited from its inputs against float32 and float64 on the CPU; no frame
   lost, eval_seq4 inserts more than 64 keyframes and closes against a
   surviving one. The ATEs are printed beside the JAX package's range over
   seeds 7/0/1/2 (SLAM_REFERENCE), which holds nothing. Then SLAM on
   eval_seq with fused_upstream=False: the same Features every frame and
   the same keyframes, K6 once per frame.
7. times from CUDA events (median of 30 after warm-up) and host clocks
   ending in a synchronize, SLAM stage times, torch.profiler windows over
   20 VO and 20 SLAM frames, and which operations make the host wait; the
   card's name and power limit on every line.

The line before the last is {"kernels": [...]}, the last line is
{"ok": true, "device": {...}}. Imports torch, numpy and the port only.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

EVAL_FRAMES = 48
VGA_FRAMES = 8
CPU_FRAMES = 4
CPU_TRANSITIONS = 4
PROFILE_FRAMES = 20
REPS = 30
# VO ATE of the JAX package on each committed sequence (EVAL_r05.json)
SEQUENCES = {"eval_seq": 0.5005, "eval_seq2": 0.6024, "eval_seq3": 0.7923,
             "eval_seq4": 0.7456}
ATE_TOL = 0.005
POSE_TOL = 1e-4          # tests/test_torch_vo.py's R, t tolerance
INLIER_TOL = 2
# Published H100 SXM peaks (NVIDIA's data sheet, at 700 W): device memory,
# int8 tensor cores, and float32 outside the tensor cores, which also serves
# as the ceiling of the scalar integer work of K1-K4 (int32 units run at no
# more than the float32 rate, so the bound stays a lower bound).
HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1979e12
SCALAR_OPS_S = 67e12
# K1's scalar operations per pixel, estimated from the algorithm: FAST's 16
# ring loads and 32 compares and the arc test, Harris's gradients, products,
# 6x6 window sums and score, the 3x3 NMS, the encode and the 2x2 max.
K1_OPS_PER_PIXEL = 100
# the kernels of the default (fused, sorted BRIEF) frontend's VO and SLAM paths
FUSED_PATH_KERNELS = ("fused_frontend_codes", "topk_keys", "gather_windows_packed",
                      "orb_select", "match_reduce")
# The JAX package's KeyframeSLAM on the CPU at slam_config over each committed
# sequence, seeds 7, 0, 1 and 2 of its PRNG key (slam_reference_range.py): per
# ATE (per-frame SLAM, keyframes before and after close_loop) the lowest and
# highest value, rounded outward to 4 decimals; the seed-7 values; in how many
# of the 4 runs the closure took the pose-graph branch. SLAM's keyframe
# decisions and closure branch turn on the draws and on float rounding
# (tests/test_torch_slam.py), so the port's ATEs are printed beside this range
# as a sanity check; what holds the card to the port is the step-by-step
# comparison with the CPU (slam_path).
SLAM_REFERENCE = {
    "eval_seq": {"slam_ate": (0.1431, 0.3092), "kf_ate_pre": (0.1014, 0.2547),
                 "kf_ate_post": (0.1027, 0.2300), "seed7": (0.1431, 0.1015, 0.1027),
                 "used_graph": 0},
    "eval_seq2": {"slam_ate": (0.3238, 0.5769), "kf_ate_pre": (0.3484, 0.5411),
                  "kf_ate_post": (0.3032, 0.5722), "seed7": (0.3511, 0.3520, 0.3509),
                  "used_graph": 1},
    "eval_seq3": {"slam_ate": (0.1090, 0.1420), "kf_ate_pre": (0.0976, 0.1304),
                  "kf_ate_post": (0.0675, 0.0938), "seed7": (0.1419, 0.1304, 0.0938),
                  "used_graph": 0},
    "eval_seq4": {"slam_ate": (0.3576, 0.3662), "kf_ate_pre": (0.3393, 0.3923),
                  "kf_ate_post": (0.3771, 0.3921), "seed7": (0.3583, 0.3393, 0.3881),
                  "used_graph": 3},
}
# card against CPU, step by step: each frame's pose and the pose graph's
# (tests/test_torch_slam.py's pose tolerance)
SLAM_POSE_TOL = 1e-3
# BA's first LM step on the card against float64 on the CPU: the card's
# relative error within this factor of the CPU's float32 error, plus a floor
# of a few float32 ulps; and the dense solve's normwise backward error
BA_ERR_FACTOR = 10.0
BA_ERR_FLOOR = 1e-6
BA_BACKWARD_TOL = 1e-5
SLAM_PROFILE_FRAMES = 20
# the __global__ functions of K1-K5 (the VO path's), as the profiler names them
HOPPER_KERNEL_FUNCTIONS = (
    "fused_frontend_kernel", "histogram_kernel", "select_digit_kernel", "compact_kernel",
    "sort_desc_kernel", "gather_windows_kernel", "orb_select_kernel", "match_rows_kernel",
    "match_finish_kernel")


def eval_config():
    """tools/eval_ate.py's frontend config for the committed sequences."""
    from pislam_tpu_torch import FrontendConfig, PislamConfig, PyramidConfig
    return PislamConfig(
        pyramid=PyramidConfig(base_width=384, base_height=256, num_levels=4),
        frontend=FrontendConfig(fast_threshold=14, harris_threshold=1 << 9,
                                border=16, max_keypoints=512))


def vo_config():
    """tools/eval_ate.py's slam_config as VO reads it: the eval frontend,
    matcher ratio 0.85 / max distance 64 / cross-check, 256 RANSAC
    iterations at Sampson 2e-3, at least 20 inliers."""
    from pislam_tpu_torch import MatcherConfig, VOConfig
    return dataclasses.replace(
        eval_config(), matcher=MatcherConfig(max_distance=64, ratio=0.85),
        vo=VOConfig(ransac_iters=256, inlier_threshold=2e-3, min_inliers=20))


def slam_config():
    """tools/eval_ate.py's slam_config: vo_config() plus windowed BA (6
    cameras, 1024 points, 4096 observations, 4 iterations) and the 0.06
    projection gate; MapConfig's defaults otherwise (64 keyframe slots, 8192
    landmarks, 16384 observations)."""
    from pislam_tpu_torch import BAConfig, MapConfig
    return dataclasses.replace(
        vo_config(), ba=BAConfig(window=6, max_points=1024, max_obs=4096, gn_iters=4),
        map=MapConfig(gate_radius=0.06))


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


def device_us(fn, reps: int = 20) -> float:
    """Device time per call of the CUDA work fn launches (kernels, copies,
    memsets), summed from a torch.profiler trace: what the card spends,
    without the host's launch cost that a CUDA-event time includes."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / reps


def bound_ms(nbytes: float, ops: float, rate: float) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate of their type."""
    by_bytes = nbytes / HBM_BYTES_S * 1e3
    by_ops = ops / rate * 1e3
    return (by_ops, "operations") if by_ops > by_bytes else (by_bytes, "bytes")


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


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

def kernel_phase(dev, pyramids, cfgs):
    """K1-K4 against their plain versions on the card. Returns per-kernel
    max |error|, and per config each kernel's time, plain time, library
    time and bound, with the inputs K5's cases are built from."""
    import pislam_tpu_torch as pt
    from pislam_tpu_torch.ops import brief, kernels, nms, orientation
    from pislam_tpu_torch.utils import codec

    errs = {k.__name__: 0 for k in kernels.COUNTED}
    rows, feats = {}, {}
    for label, cfg in cfgs.items():
        pyr = pyramids[label]
        fc = cfg.frontend
        extractor = pt.make_extract_fn(cfg, dev)
        feats[label] = extractor(pyr)
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
        args3 = (pyr, torch.cat([xs, ex]), torch.cat([ys, ey]), torch.cat([valid, ev]))
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
        flat = flat[:k]

        # K6 on the unfused frontend's scored grid of the same pyramid
        scored = unfused_scored(pyr, extractor.level_mask, fc)
        red = kernels.reduce_codes_4x(scored)
        errs["reduce_codes_4x"] = max(errs["reduce_codes_4x"], require_equal(
            f"K6 {label}", red, kernels.reduce_codes_4x_plain(scored)))
        if not torch.equal(nms.select_topk_codes(red, k)[0], feats[label].codes):
            raise AssertionError(f"K6 {label}: its top-k differs from K1's keypoints")
        # K4d on the path's windows, and at K = 2048 at the eval shape too
        gm = brief.dense_weights(dev)
        for name, f in ((label, flat), (f"{label} x4", flat.repeat(4, 1)[:2048])):
            ang, bits = kernels.orb_select_bits(f, gm)
            pang, pbits = kernels.orb_select_bits_plain(f, gm)
            k4ang, k4desc = kernels.orb_select(f, *tables, 8)
            errs["orb_select_bits"] = max(errs["orb_select_bits"],
                                          require_equal(f"K4d {name} bins", ang, pang),
                                          require_equal(f"K4d {name} bits", bits, pbits))
            require_equal(f"K4d {name} vs K4 bins", ang, k4ang.to(torch.int32))
            require_equal(f"K4d {name} vs K4 bits", brief._pack_bits_u8(bits, 8), k4desc)
        # K3c on the keypoints' strip rows, against K3's bytes
        kx = torch.cat([xs, ex]).repeat(2048 // k + 1)[:2048]
        ky = torch.cat([ys, ey]).repeat(2048 // k + 1)[:2048]
        kv = torch.cat([valid, ev]).repeat(2048 // k + 1)[:2048]
        args3c = kernels.strip_window_rows(pyr, kx, ky, kv)
        words = kernels.realign_windows(*args3c)
        errs["realign_windows"] = max(errs["realign_windows"], require_equal(
            f"K3c {label}", words, kernels.realign_windows_plain(*args3c)))
        win = (words.reshape(-1, 256).view(torch.uint8) ^ 0x80).view(torch.int8)
        require_equal(f"K3c {label} vs K3", win.reshape(-1, 1024),
                      kernels.gather_windows_packed(pyr, kx, ky, kv))

        # times at the main path's shapes (the keypoints alone, no extras)
        args3 = (pyr, xs, ys, valid)
        args4 = (flat, *tables, fc.words)
        args3c = kernels.strip_window_rows(pyr, xs, ys, valid)
        n_px = pyr.numel()
        bins = torch.unique(kernels.orb_select_bits(flat, gm)[0]).numel()
        rows[label] = {
            "fused_frontend_codes": (args1, None, bound_ms(
                2 * n_px + grid.numel() * 4, K1_OPS_PER_PIXEL * n_px, SCALAR_OPS_S)),
            "topk_keys": ((keys, k), lambda: torch.topk(keys, k),
                          bound_ms(keys.numel() * 4 + k * 4, 4 * keys.numel(), SCALAR_OPS_S)),
            "gather_windows_packed": (args3, None, bound_ms(
                n_px + k * (4 + 4 + 1) + k * 1024, 0, SCALAR_OPS_S)),
            "orb_select": (args4, None, bound_ms(
                flat.numel() + sum(tb.numel() * tb.element_size() for tb in tables)
                + k * (1 + 4 * fc.words), k * (2 * 1024 * 2 + 256), SCALAR_OPS_S)),
            "reduce_codes_4x": ((scored,), None, bound_ms(
                scored.numel() + red.numel() * 4, 0, SCALAR_OPS_S)),
            # the slabs of the bins this input selects and the moment columns
            "orb_select_bits": ((flat, gm), None, bound_ms(
                flat.numel() + bins * 1024 * 256 + 1024 * 2 + k * (4 + 256),
                2 * k * 1024 * (256 + 2), INT8_OPS_S)),
            # each keypoint's 9 rows x 32 words, psi and phi; 1 KB out
            "realign_windows": (args3c, None, bound_ms(
                k * (9 * 32 * 4 + 8 + 1024), 0, SCALAR_OPS_S)),
        }

    m10, m01 = (torch.as_tensor(m, device=dev) for m in orientation.sweep_moments())
    bins = kernels.atan2_bins(m10, m01)
    require_equal("K4 atan2 sweep (card plain)", bins, orientation.atan2_bins(m10, m01))
    require_equal("K4 atan2 sweep (CPU plain)", bins.cpu(),
                  orientation.atan2_bins(m10.cpu(), m01.cpu()))
    print(f"phase kernels: ok, K1-K4, K6, K4d (K and 2048 keypoints, also against K4) and "
          f"K3c (2048 keypoints, also against K3's bytes) bit-exact (tolerance 0) on VGA "
          f"and eval shapes; atan2 sweep of {m10.numel()} moment pairs bit-exact")
    return errs, rows, feats


def unfused_scored(pyr, level_mask, fc):
    """The unfused frontend's scored NMS survivors (frontend._extract_impl,
    no bucketing): plain FAST, Harris and NMS on the card."""
    from pislam_tpu_torch.ops import fast, harris, nms
    corner = fast.fast_detect(pyr, fc.fast_threshold)
    score = harris.harris_score(pyr, fc.harris_threshold, mask=corner & level_mask)
    return torch.where(nms.nms(score), score, torch.zeros_like(score)).contiguous()


def _tile_database(d1, v1, k2, rng):
    """tools/ab_match.py's map-scale database: the frame's own descriptors in
    7-row rolls with per-copy bit jitter, validity rolled the same way."""
    reps = -(-k2 // d1.shape[0])
    d2 = np.concatenate([np.roll(d1, 7 * i, axis=0)
                         ^ rng.integers(0, 2, d1.shape, dtype=np.uint32)
                         for i in range(reps)])[:k2]
    v2 = np.concatenate([np.roll(v1, 7 * i) for i in range(reps)])[:k2]
    return d2, v2


def _k5_inputs(d1, v1, d2, v2, rng, uv1=None, uv2=None):
    """Ties within a 128-column tile and across segments, duplicated query
    rows, invalid rows and columns; for the gate inf and 1e6 points and a
    pair exactly on the radius."""
    d1, v1, d2, v2 = (np.array(a) for a in (d1, v1, d2, v2))
    k1, k2 = len(d1), len(d2)
    d2[[3, 40, k2 // 2, k2 - 1]] = d1[1]
    d2[k2 // 3] = d1[2] ^ np.uint32(1 << 31)
    d2[k2 - 2] = d1[2]
    d1[k1 - 1] = d1[1]
    v1[[1, 2, k1 - 1]] = True
    v2[[3, 40, k2 // 2, k2 - 1, k2 // 3, k2 - 2]] = True
    v1[5::37] = False
    v2[6::41] = False
    args = [d1.view(np.int32), d2.view(np.int32), v1, v2]
    if uv1 is not None:
        uv1, uv2 = np.array(uv1, np.float32), np.array(uv2, np.float32)
        uv2[[3, 40]] = uv1[1]
        uv2[11::97] = np.inf
        uv2[12::97] = 1e6
        uv1[4] = np.inf
        uv1[8] = uv2[8] + np.float32([0.06, 0.0])
        args += [uv1, uv2]
    return args


def k5_phase(dev, eval_feats, vga_feats, pts):
    """K5 against its plain version on the card at the main path's and the
    map's shapes: two consecutive eval frames' features (and normalised
    points), one VGA frame's. Returns max |error| and the cases by name."""
    from pislam_tpu_torch.ops import kernels

    rng = np.random.default_rng(5)

    def host(f):
        return (f.descriptors.cpu().numpy().view(np.uint32), f.valid.cpu().numpy())

    (e0, ev0), (e1, ev1) = (host(f) for f in eval_feats)
    g0, gv0 = host(vga_feats)
    gd2, gv2 = _tile_database(g0, gv0, 16384, rng)
    ed2, ev2 = _tile_database(e1, ev1, 16384, rng)
    p0 = pts[0].cpu().numpy()
    puv2 = np.concatenate([np.roll(pts[1].cpu().numpy(), 7 * i, axis=0)
                           for i in range(32)])[:16384]
    puv2 = puv2 + rng.uniform(-0.01, 0.01, puv2.shape).astype(np.float32)
    cases = {
        "512x512": _k5_inputs(e0, ev0, e1, ev1, rng),
        "2048x2048": _k5_inputs(g0, gv0, *_tile_database(g0, gv0, 2048, rng), rng),
        "2048x16384": _k5_inputs(g0, gv0, gd2, gv2, rng),
        "512x16384 gated": _k5_inputs(e0, ev0, ed2, ev2, rng, p0, puv2),
    }
    err = 0
    on_card = {}
    for name, args in cases.items():
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in args]
        if len(args) == 6:
            args.append(0.06)
        on_card[name] = args
        for k1 in (args[0].shape[0], args[0].shape[0] - 13):   # 13: no block multiple
            cut = [args[0][:k1], args[1], args[2][:k1], args[3]] + (
                [args[4][:k1], args[5], args[6]] if len(args) == 7 else [])
            got = kernels.match_reduce(*cut)
            want = kernels.match_reduce_plain(*cut)
            for part, g, w in zip(("best", "second", "idx", "col_argmin"), got, want):
                err = max(err, require_equal(f"K5 {name} K1={k1} {part}", g, w))
    print(f"phase kernels: ok, K5 bit-exact (tolerance 0) at {', '.join(cases)}, "
          f"each also with K1 - 13")
    return err, on_card


def k5_bound(args) -> tuple[float, str]:
    (k1, w), k2 = args[0].shape, args[1].shape[0]
    nbytes = (k1 + k2) * w * 4 + k1 + k2 + (3 * k1 + k2) * 4
    if len(args) == 7:
        nbytes += (k1 + k2) * 8
    return bound_ms(nbytes, 2 * k1 * k2 * w * 32, INT8_OPS_S)


# ---------------------------------------------------------------------------
# phase 4: the extraction path
# ---------------------------------------------------------------------------

def extraction_path(dev, frames, cfgs):
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
    for name in ("fused_frontend_codes", "topk_keys", "gather_windows_packed", "orb_select"):
        if launches[name] < n_frames:
            raise AssertionError(f"{name}: {launches[name]} launches for {n_frames} frames")

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
        print(f"phase extraction path {label}: {len(counts)} frames bit-exact vs plain "
              f"(card), first {CPU_FRAMES} vs plain (CPU); features per frame "
              f"min {min(counts)} mean {statistics.mean(counts):.1f} max {max(counts)}")
    print(f"phase extraction path launches: {json.dumps(launches)}")
    return extract, results


def extraction_variants(dev, cfgs, results):
    """The frontend's other configurations on the same frames, each a path of
    its own (counts set to 0 before it, read after): unfused (plain
    FAST/Harris/NMS, then K6) and dense BRIEF (K4d), each bit-exact against
    the default path's Features; bucketing with an odd border (unfused, so
    K6) against its own plain path. Returns the launch counts per variant."""
    import pislam_tpu_torch as pt
    from pislam_tpu_torch.ops import kernels

    variants = {
        "unfused": (dict(fused_upstream=False), "reduce_codes_4x", "fused_frontend_codes"),
        "dense BRIEF": (dict(brief_variant="dense"), "orb_select_bits", "orb_select"),
        "odd-border bucketing": (dict(log_bucket_size=4, bucket_limit=3, border=17),
                                 "reduce_codes_4x", "fused_frontend_codes"),
    }
    out = {}
    for vname, (change, runs, idle) in variants.items():
        made = {label: dataclasses.replace(cfg, frontend=dataclasses.replace(
            cfg.frontend, **change)) for label, cfg in cfgs.items()}
        extract = {label: pt.make_extract_fn(c, dev) for label, c in made.items()}
        kernels.reset_launch_counts()
        feats = {label: [extract[label](pyr) for pyr, _ in results[label]] for label in cfgs}
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        n = sum(len(f) for f in feats.values())
        if launches[runs] != n or launches[idle] != 0:
            raise AssertionError(f"{vname}: {runs} launched {launches[runs]} times, {idle} "
                                 f"{launches[idle]} times, for {n} frames")
        for label in cfgs:
            ref = [f for _, f in results[label]]
            if vname == "odd-border bucketing":
                plain = pt.OrbExtractor(made[label], ops=kernels.PLAIN).to(dev)
                ref = [plain(pyr) for pyr, _ in results[label]]
            for i, (got, want) in enumerate(zip(feats[label], ref)):
                if not features_equal(got, want):
                    raise AssertionError(f"{vname} {label} frame {i}: Features differ")
        out[vname] = launches
        print(f"phase extraction {vname}: {n} frames (eval and VGA) bit-exact against "
              f"{'its plain path' if vname == 'odd-border bucketing' else 'the default path'}"
              f"; launches {json.dumps(launches)}")
    return out


# ---------------------------------------------------------------------------
# phase 5: the VO path
# ---------------------------------------------------------------------------

def load_sequence(name):
    d = np.load(ROOT / "data" / f"{name}.npz")
    gt = np.stack([-R.T @ t for R, t in zip(d["Rs"], d["ts"])])
    return d["frames"], tuple(float(d[k]) for k in ("fx", "fy", "cx", "cy")), gt


def positions(out) -> np.ndarray:
    R, t = out["R"].cpu().numpy(), out["t"].cpu().numpy()
    return np.stack([-r.T @ tt for r, tt in zip(R, t)])


def compare_runs(label, got, want, n=None):
    """Same matches and decisions per frame; inliers within 2, R and t
    within 1e-4 (tests/test_torch_vo.py's tolerances)."""
    n = n or len(want["accepted"])
    for k in ("idx2", "dist", "accepted"):
        if not torch.equal(got[k][:n].cpu(), want[k][:n].cpu()):
            raise AssertionError(f"{label}: {k} differs")
    d_inl = int((got["num_inliers"][:n].cpu() - want["num_inliers"][:n].cpu()).abs().max())
    d_pose = max(float((got[k][:n + 1].cpu() - want[k][:n + 1].cpu()).abs().max())
                 for k in ("R", "t"))
    if d_inl > INLIER_TOL or d_pose > POSE_TOL:
        raise AssertionError(f"{label}: inliers differ by {d_inl}, R/t by {d_pose}")
    return d_inl, d_pose


def vo_path(dev, seqs, card):
    """make_vo_scan over every sequence on the card, held to the JAX ATEs,
    to the plain path on the card and, for the first transitions, the CPU."""
    import pislam_tpu_torch as pt
    from pislam_tpu_torch import evaluation
    from pislam_tpu_torch.ops import kernels

    cfg = vo_config()

    def gen(seed, device=dev):
        return torch.Generator(device=device).manual_seed(seed)

    runs = {name: pt.make_vo_scan(cfg, *intr, device=dev) for name, (_, intr, _) in seqs.items()}
    runs["eval_seq"](seqs["eval_seq"][0][:3], gen(0))             # warm-up
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    outs, walls = {}, {}
    for name, (frames, _, _) in seqs.items():
        t0 = time.perf_counter()
        outs[name] = runs[name](frames, gen(0))
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
    launches = kernels.launch_counts()
    n_frames = sum(len(f) for f, _, _ in seqs.values())
    n_trans = n_frames - len(seqs)
    for name in FUSED_PATH_KERNELS:
        n = launches[name]
        need = n_trans if name == "match_reduce" else n_frames
        if n < need:
            raise AssertionError(f"{name}: {n} launches for {need} frames or transitions")

    for name, (frames, _, gt) in seqs.items():
        out = outs[name]
        ate = evaluation.ate_rmse(positions(out), gt)
        if not np.isfinite(positions(out)).all() or out["R"].shape != (len(frames), 3, 3):
            raise AssertionError(f"{name}: trajectory not finite or of wrong shape")
        if abs(ate - SEQUENCES[name]) > ATE_TOL:
            raise AssertionError(f"{name}: ATE {ate:.4f}, JAX {SEQUENCES[name]}")
        n_matches = (out["idx2"] >= 0).sum(1)
        print(f"phase VO {name}: {len(frames)} frames, ATE {ate:.4f} (JAX {SEQUENCES[name]}, "
              f"tolerance {ATE_TOL}); accepted {int(out['accepted'].sum())}/"
              f"{len(out['accepted'])}; matches per transition min {int(n_matches.min())} "
              f"mean {float(n_matches.float().mean()):.1f} max {int(n_matches.max())}; "
              f"inliers == matches on {int((out['num_inliers'] == n_matches).sum())} "
              f"transitions")

    frames, intr, _ = seqs["eval_seq"]
    plain = pt.make_vo_scan(cfg, *intr, device=dev, ops=kernels.PLAIN)(frames, gen(0))
    d_inl, d_pose = compare_runs("eval_seq kernels vs plain (card)", outs["eval_seq"], plain)
    print(f"phase VO eval_seq: {len(frames) - 1} transitions, idx2/dist/accepted identical "
          f"to the plain path on the card; inliers differ by <= {d_inl}, R/t by "
          f"{d_pose:.3g}")
    cpu = pt.make_vo_scan(cfg, *intr, device="cpu")(frames[:CPU_TRANSITIONS + 1],
                                                    gen(0, "cpu"))
    d_inl, d_pose = compare_runs("eval_seq card vs CPU", outs["eval_seq"], cpu)
    print(f"phase VO eval_seq: first {CPU_TRANSITIONS} transitions idx2/dist/accepted "
          f"identical to the CPU; inliers differ by <= {d_inl}, R/t by {d_pose:.3g}")
    print(f"phase VO path launches: {json.dumps(launches)}")
    for name, (frames, _, _) in seqs.items():
        print(f"time VO {name}: {walls[name] / len(frames) * 1e3:.4f} ms/frame over "
              f"{len(frames)} frames (host clock to synchronize) [{card}]")
    return launches, outs


def vo_stage_times(dev, seqs, card):
    """CUDA-event times of one eval_seq transition's stages."""
    import pislam_tpu_torch as pt
    from pislam_tpu_torch import matching
    from pislam_tpu_torch.models import visual_odometry as vo
    from pislam_tpu_torch.ops.pyramid import build_pyramid

    cfg = vo_config()
    frames, intr, _ = seqs["eval_seq"]
    odo = pt.VisualOdometry(cfg, *intr, device=dev)
    state = odo.init(frames[0])
    frame = torch.as_tensor(frames[1]).to(dev)
    pyr = build_pyramid(frame, cfg.pyramid)
    feats, pts = odo.frontend(frame)
    fe = odo.frontend
    mc = cfg.matcher
    stages = {
        "pyramid": lambda: build_pyramid(frame, cfg.pyramid),
        "extraction": lambda: fe.extract(pyr),
        "normalise": lambda: vo.normalise_points(feats, *fe.intrinsics, fe.level_rows,
                                                 fe.level_scales),
        "match (K5 + filters)": lambda: matching.match(
            state.prev.descriptors, feats.descriptors, state.prev.valid, feats.valid,
            mc.max_distance, mc.ratio, mc.cross_check),
        "vo_step (match + RANSAC + chain)": lambda: vo.vo_step(mc, cfg.vo, state, feats, pts),
    }
    ms = {name: time_ms(fn) for name, fn in stages.items()}
    ms["RANSAC + chain (vo_step - match)"] = (ms["vo_step (match + RANSAC + chain)"]
                                              - ms["match (K5 + filters)"])
    for name, t in ms.items():
        print(f"time VO stage {name}: {t:.4f} ms [{card}]")

    # which operations make the host wait on the card
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            a = torch.randn(512, 9, device=dev)
            n0 = len(caught)
            torch.linalg.svd(a, full_matrices=False)
            svd_syncs = len(caught) - n0
            n0 = len(caught)
            vo.vo_step(mc, cfg.vo, state, feats, pts)
            step_syncs = [str(w.message).splitlines()[0][:90] for w in caught[n0:]]
        finally:
            torch.cuda.set_sync_debug_mode(0)
    print(f"sync: torch.linalg.svd on (512, 9) makes {svd_syncs} synchronizing call(s); "
          f"one vo_step makes {len(step_syncs)}: {json.dumps(sorted(set(step_syncs)))}")
    return ms


def vo_profile(dev, seqs, card):
    """torch.profiler over PROFILE_FRAMES VO transitions of eval_seq: host
    wall, device busy (summed CUDA-event durations), ops per frame, top
    kernels by device time."""
    import pislam_tpu_torch as pt
    from torch.profiler import ProfilerActivity, profile

    frames, intr, _ = seqs["eval_seq"]
    frames = frames[:PROFILE_FRAMES + 1]
    run = pt.make_vo_scan(vo_config(), *intr, device=dev)
    run(frames, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(frames, torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in cuda)
    n = len(frames)
    print(f"profile VO eval_seq {n} frames: host wall {wall / n * 1e3:.4f} ms/frame, "
          f"device busy {busy_us / n / 1e3:.4f} ms/frame ({busy_us / (wall * 1e6) * 100:.1f} %), "
          f"{len(cuda) / n:.1f} device ops/frame [{card}]")
    by_name = {}
    for e in cuda:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    for name, us in top:
        print(f"profile VO device time {us / n:.2f} us/frame: {name[:100]}")
    for label, fns in (("K1-K5", HOPPER_KERNEL_FUNCTIONS),
                       ("K5", ("match_rows_kernel", "match_finish_kernel"))):
        us = sum(t for name, t in by_name.items() if any(f in name for f in fns))
        print(f"profile VO device time of {label}: {us / n:.2f} us/frame [{card}]")


# ---------------------------------------------------------------------------
# phase 6: the SLAM path
# ---------------------------------------------------------------------------

SLAM_STAGES = ("extract", "track", "map_track", "insert_ba", "loop_detect", "global_ba",
               "cull", "pose_graph")


def make_slam(cfg, intr, dev, metrics=None, record=None):
    """KeyframeSLAM as tools/eval_ate.py runs it, on the card; ``record``
    collects each frame's Features."""
    import pislam_tpu_torch as pt
    slam = pt.KeyframeSLAM(cfg, *intr, keyframe_min_inliers=60, keyframe_max_gap=3,
                           metrics=metrics, device=dev)
    if record is not None:
        extract = slam.vo.frontend.extract

        def recording(pyr):
            feats = extract(pyr)
            record.append(feats)
            return feats

        slam.vo.frontend.extract = recording
    return slam


class Draws:
    """geometry/ransac.sample_indices that logs the draws the main path makes
    (from the state's generator, as it always does) or, with ``queue`` set,
    hands out logged ones: the CPU replays a card step with the card's
    draws."""

    def __init__(self, draw):
        self.draw, self.log, self.queue = draw, [], None

    def __call__(self, valid, iters, sample_size, generator=None):
        if self.queue is None:
            self.log.append(self.draw(valid, iters, sample_size, generator))
            return self.log[-1]
        if not self.queue:
            raise AssertionError("the CPU step draws more RANSAC samples than the card's")
        return self.queue.pop(0)


def snapshot(slam):
    """What a step starts from: the state (counters included) and the two
    host fields that set_state does not rebuild."""
    return slam.state, slam._prev_pose, set(slam._culled_slots)


def adopt(cpu, snap):
    """The CPU KeyframeSLAM takes over a card snapshot."""
    state, prev_pose, culled = snap

    def host(table):
        return type(table)(*(x.cpu() for x in table))

    cpu.set_state(state._replace(store=host(state.store), lmap=host(state.lmap),
                                 obs=host(state.obs), counters=state.counters.cpu(),
                                 generator=torch.Generator()))
    cpu._prev_pose, cpu._culled_slots = prev_pose, set(culled)


def count_plain_k5():
    """Counts calls of K5's plain version (the CPU's matcher calls)."""
    from pislam_tpu_torch.ops import kernels
    plain, calls = kernels.match_reduce.plain, [0]

    def counting(*args):
        calls[0] += 1
        return plain(*args)

    kernels.match_reduce.plain = counting
    return calls, lambda: setattr(kernels.match_reduce, "plain", plain)


def step_against_cpu(cpu, draws, snap, after, frame, want, first_draw, last_draw):
    """One frame on the CPU from the card's state before it, with the card's
    draws: the decisions, the counters after it and every RANSAC call the
    same, inliers within INLIER_TOL, the frame's pose within SLAM_POSE_TOL.
    Returns (mismatches, max |pose diff|, max |keyframe pose diff| after the
    step, max |inlier diff|). Keyframe poses after an insert are not held:
    its windowed BA is audited against float64 instead (ba_audit)."""
    adopt(cpu, snap)
    draws.queue = [d.cpu() for d in draws.log[first_draw:last_draw]]
    got = cpu.process(frame)
    bad = [k for k in ("keyframe", "lost", "relocalised") if got[k] != want[k]]
    if draws.queue:
        bad.append(f"{len(draws.queue)} RANSAC draws unused")
    d_inl = max(abs(got[k] - want[k]) for k in ("num_inliers", "map_inliers"))
    if d_inl > INLIER_TOL:
        bad.append(f"inliers {got['num_inliers']}/{got['map_inliers']} vs card "
                   f"{want['num_inliers']}/{want['map_inliers']}")
    mine, card = cpu.state, after[0]
    if not torch.equal(mine.counters, card.counters.cpu()):
        bad.append(f"counters {mine.counters.tolist()} vs card {card.counters.tolist()}")
    d_pose = max(float(np.abs(got[k] - want[k]).max()) for k in ("pose_R", "pose_t"))
    if d_pose > SLAM_POSE_TOL:
        bad.append(f"pose differs by {d_pose:.3g}")
    valid = card.store.valid.cpu()
    d_store = max(float((getattr(mine.store, k) - getattr(card.store, k).cpu())[valid]
                        .abs().max()) for k in ("R", "t"))
    return bad, d_pose, d_store, d_inl


def closure_against_cpu(cpu, draws, snap, first_draw, want, want_post):
    """close_loop on the CPU from the card's snapshot before it, with the
    card's draws: the same loop, branch and matcher calls. Returns
    (mismatches, the CPU's K5 calls, its closure, max |keyframe position
    diff|); costs and positions come out of global BA and are printed, not
    held (ba_audit holds BA's arithmetic)."""
    adopt(cpu, snap)
    draws.queue = [d.cpu() for d in draws.log[first_draw:]]
    calls, restore = count_plain_k5()
    try:
        got = cpu.close_loop(min_matches=40, exclude_recent=3)
    finally:
        restore()
    bad = [f"{k} {got[k]} vs card {want[k]}" for k in ("loop", "used_graph")
           if got[k] != want[k]]
    d_pos = float(np.abs(cpu.keyframe_positions() - want_post).max())
    return bad, calls[0], got, d_pos


class Recorder:
    """Stands in for a module's function on the main path and keeps the
    arguments of every call made on the card; the tables it is given are
    never written in place, so they can be replayed afterwards."""

    def __init__(self, module, name):
        self.module, self.name, self.fn, self.calls = module, name, getattr(module, name), []
        setattr(module, name, self)

    def __call__(self, graph_or_problem, *args, **kw):
        if graph_or_problem.R.is_cuda:
            self.calls.append((graph_or_problem, args, kw))
        return self.fn(graph_or_problem, *args, **kw)

    def restore(self):
        setattr(self.module, self.name, self.fn)


def _ba_terms(p, damping, huber, n_fixed):
    """The first LM step's normal equations of a BA problem: H_cc, b_c,
    H_pp, b_p and, at 48 cameras or fewer (the dense solver), the reduced
    system S, b and its solution."""
    from pislam_tpu_torch.backend import ba
    r, jc, jp, _ = ba.residuals_and_jacobians(p, huber=huber)
    if p.R.shape[0] > 48:
        hcc, bc, hpp, bp = ba._normal_terms(ba._segments(p), r, jc, jp)
        return {"hcc": hcc, "bc": bc, "hpp": hpp, "bp": bp}
    hcc, bc, hpp, bp, w = ba.gn_normal_blocks(p, r, jc, jp)
    lam = torch.tensor(damping, dtype=p.points.dtype, device=p.points.device)
    s, b, _, _ = ba.schur_reduce(hcc, bc, hpp, bp, w, lam, p.cam_valid, n_fixed=n_fixed)
    return {"hcc": hcc, "bc": bc, "hpp": hpp, "bp": bp, "S": s, "b": b,
            "dc": torch.linalg.solve_ex(s, b)[0]}


def _rel_err(x, ref):
    """Relative Frobenius error of x against a float64 reference, over the
    reference's finite entries (inf where x is not finite there)."""
    x, ref = x.cpu().double(), ref.cpu()
    keep = torch.isfinite(ref)
    if not torch.isfinite(x[keep]).all():
        return float("inf")
    return float((x - ref)[keep].norm() / max(float(ref[keep].norm()), 1e-300))


def ba_audit(calls):
    """Every BA of the card's main path, from the card's own inputs: the
    first LM step's normal equations (and, for the dense solver, the
    reduced system) on the card must be as close to the same terms in
    float64 on the CPU as the CPU's float32 ones are, within
    BA_ERR_FACTOR times their error plus BA_ERR_FLOOR; the card's dense
    solve must solve its own system to a normwise backward error below
    BA_BACKWARD_TOL. Float32 BA is fragile where points are nearly free in
    depth: the same rounding error on both devices then sends the LM
    accept/reject either way, so the runs' BA outputs are not held to each
    other. Returns (failures, worst ratio, worst backward error, calls)."""
    from pislam_tpu_torch.backend import ba
    bad, worst, backward = [], 0.0, 0.0
    for i, (p, _, kw) in enumerate(calls):
        args = (kw["damping"], kw["huber"], kw["n_fixed"])
        card = _ba_terms(p, *args)
        cpu32 = _ba_terms(ba.BAProblem(*(x.cpu() for x in p)), *args)
        cpu64 = _ba_terms(ba.BAProblem(*(x.cpu().double() if x.is_floating_point()
                                         else x.cpu() for x in p)), *args)
        for k in card:
            if k == "dc":
                continue
            e_card, e_cpu = _rel_err(card[k], cpu64[k]), _rel_err(cpu32[k], cpu64[k])
            worst = max(worst, e_card / max(e_cpu, BA_ERR_FLOOR))
            if not e_card <= BA_ERR_FACTOR * e_cpu + BA_ERR_FLOOR:
                bad.append(f"BA {i} ({p.R.shape[0]} cameras) {k}: card error {e_card:.3g}, "
                           f"CPU float32 {e_cpu:.3g} against float64")
        if "dc" in card:
            s, b, dc = card["S"], card["b"], card["dc"]
            # 0 where every camera is pinned (b = 0, dc = 0)
            num = float(torch.linalg.vector_norm(s @ dc - b))
            err = num and num / float(torch.linalg.matrix_norm(s) * torch.linalg.vector_norm(dc)
                                      + torch.linalg.vector_norm(b))
            backward = max(backward, err)
            if not err <= BA_BACKWARD_TOL:
                bad.append(f"BA {i}: the card's solve has backward error {err:.3g}")
    return bad, worst, backward, len(calls)


def pose_graph_audit(graphs):
    """Every pose-graph solve of the card's main path (a Recorder's calls)
    again on the card and on the CPU from the card's inputs: poses within
    SLAM_POSE_TOL. Returns (failures, max |pose diff|)."""
    optimize = graphs.fn
    bad, worst = [], 0.0
    for i, (g, args, kw) in enumerate(graphs.calls):
        card = optimize(g, *args, **kw)[0]
        cpu = optimize(type(g)(*(None if x is None else x.cpu() for x in g)), *args, **kw)[0]
        d = max(float((getattr(card, k).cpu() - getattr(cpu, k)).abs().max())
                for k in ("R", "t"))
        worst = max(worst, d)
        if not d <= SLAM_POSE_TOL:
            bad.append(f"pose graph {i} ({g.R.shape[0]} nodes): card and CPU differ by {d:.3g}")
    return bad, worst


def slam_path(dev, seqs, card):
    """KeyframeSLAM over every sequence at full length, then close_loop: the
    port's main path. Every launch count is exact: K1-K4 once per frame, K5
    once per tracked frame and once more per map-tracked frame (Metrics),
    and in each closure as often as the CPU calls K5's plain version on the
    same closure. Then the CPU replays the run step by step: every frame from
    the card's state before it with the card's RANSAC draws
    (step_against_cpu), and the closure from the card's state before it
    (closure_against_cpu); every BA and pose-graph solve the card made is
    audited from its own inputs (ba_audit, pose_graph_audit). No frame may be
    lost (the JAX package loses none on these sequences at any seed);
    eval_seq4 fills the ring and closes against a surviving keyframe. The
    ATEs are printed beside the JAX package's range over seeds
    (SLAM_REFERENCE), which holds nothing."""
    import pislam_tpu_torch as pt
    from pislam_tpu_torch import evaluation
    from pislam_tpu_torch.backend import ba, pose_graph
    from pislam_tpu_torch.geometry import ransac
    from pislam_tpu_torch.ops import kernels
    from pislam_tpu_torch.utils.metrics import Metrics

    cfg = slam_config()
    on_card = {name: torch.as_tensor(frames).to(dev) for name, (frames, _, _) in seqs.items()}
    warm = make_slam(cfg, seqs["eval_seq"][1], dev)              # warm-up
    for f in on_card["eval_seq"][:5]:
        warm.process(f)
    torch.cuda.synchronize()

    draws = Draws(ransac.sample_indices)
    ransac.sample_indices = draws
    bas, graphs = Recorder(ba, "bundle_adjust"), Recorder(pose_graph, "optimize")
    res, features, launches = {}, [], {k.__name__: 0 for k in kernels.COUNTED}
    failures = []
    try:
        for name, (frames, intr, gt) in seqs.items():
            metrics = Metrics(sink=lambda line: None)
            slam = make_slam(cfg, intr, dev, metrics,
                             record=features if name == "eval_seq" else None)
            draws.log, draws.queue, bas.calls, graphs.calls = [], None, [], []
            snaps, first, outs = [], [], []
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            for f in on_card[name]:
                snaps.append(snapshot(slam))
                first.append(len(draws.log))
                outs.append(slam.process(f))
            torch.cuda.synchronize()
            t_track = time.perf_counter() - t0
            track_launches = kernels.launch_counts()
            kf = slam.keyframe_frames
            pre = slam.keyframe_positions()
            surviving = {v.index for v in slam.keyframes}
            snaps.append(snapshot(slam))
            first.append(len(draws.log))
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            closure = slam.close_loop(min_matches=40, exclude_recent=3)
            torch.cuda.synchronize()
            t_close = time.perf_counter() - t0
            close_launches = kernels.launch_counts()
            for k in launches:
                launches[k] += track_launches[k] + close_launches[k]
            traj = np.stack(slam.trajectory)
            if not np.isfinite(traj).all() or traj.shape != (len(frames), 3):
                raise AssertionError(f"SLAM {name}: trajectory not finite or of wrong shape")
            post = slam.keyframe_positions()
            stages = metrics.snapshot()

            # launches: exact per frame, per map-tracked frame, per closure
            n_k5 = stages.get("calls.track", 0) + stages.get("calls.map_track", 0)
            want = {k: len(frames) for k in FUSED_PATH_KERNELS} | {"match_reduce": n_k5}
            for k, n in track_launches.items():
                if n != want.get(k, 0):
                    failures.append(f"{name}: {k} launched {n} times while tracking, "
                                    f"expected {want.get(k, 0)}")

            # the CPU replays every step and the closure
            cpu = pt.KeyframeSLAM(cfg, *intr, keyframe_min_inliers=60, keyframe_max_gap=3,
                                  device="cpu")
            t0 = time.perf_counter()
            bad_steps, d_pose, d_store, d_inl = [], 0.0, 0.0, 0
            for i, frame in enumerate(frames):
                bad, dp, ds, di = step_against_cpu(cpu, draws, snaps[i], snaps[i + 1], frame,
                                                   outs[i], first[i], first[i + 1])
                d_pose, d_store, d_inl = max(d_pose, dp), max(d_store, ds), max(d_inl, di)
                bad_steps += [f"frame {i}: {b}" for b in bad]
            bad, cpu_k5, cpu_closure, d_pos = closure_against_cpu(
                cpu, draws, snaps[-1], first[-1], closure, post)
            bad += [f"{k} launched {n} times in close_loop" for k, n in close_launches.items()
                    if n != (cpu_k5 if k == "match_reduce" else 0)]
            bad_ba, worst, backward, n_ba = ba_audit(bas.calls)
            bad_graph, d_graph = pose_graph_audit(graphs)
            t_cpu = time.perf_counter() - t0
            bad += bad_ba + bad_graph
            failures += [f"{name} card vs CPU {b}" for b in bad_steps + bad]
            print(f"phase SLAM {name} card vs CPU: {len(frames)} steps from the card's state "
                  f"with its draws, {len(bad_steps)} mismatching (decisions, counters, RANSAC "
                  f"calls; frame poses within {d_pose:.3g}, tolerance {SLAM_POSE_TOL}; inliers "
                  f"within {d_inl}, tolerance {INLIER_TOL}); close_loop: loop, branch and "
                  f"{cpu_k5} K5 calls {'identical' if not bad else 'DIFFER'}; {n_ba} BAs' first "
                  f"step at most {worst:.3g}x the CPU float32's error against float64 (limit "
                  f"{BA_ERR_FACTOR:g}x + {BA_ERR_FLOOR:g}), dense solves' backward error "
                  f"{backward:.3g}; {len(graphs.calls)} pose graphs within {d_graph:.3g}; not "
                  f"held (float32 LM): keyframe poses after an insert within {d_store:.3g}, "
                  f"keyframe positions after close_loop within {d_pos:.3g}, costs "
                  f"{cpu_closure.get('cost_ba', 0):.6g} / {cpu_closure.get('cost_graph', 0):.6g}"
                  f" on the CPU; CPU {t_cpu:.1f} s")
            for b in (bad_steps + bad)[:10]:
                print(f"  mismatch {name}: {b}")
            res[name] = {"ates": {"slam_ate": evaluation.ate_rmse(traj, gt),
                                  "kf_ate_pre": evaluation.ate_rmse(pre, gt[kf]),
                                  "kf_ate_post": evaluation.ate_rmse(post, gt[kf])},
                         "kf": kf, "inserted": slam.keyframes_inserted, "closure": closure,
                         "loop_survives": closure["loop"] in surviving,
                         "lost": slam.frames_lost, "reloc": slam.relocalisations,
                         "t_track": t_track, "t_close": t_close, "frames": len(frames),
                         "stages": stages, "map_tracked": stages.get("calls.map_track", 0)}
    finally:
        ransac.sample_indices = draws.draw
        bas.restore()
        graphs.restore()

    for name, r in res.items():
        ref = SLAM_REFERENCE[name]
        parts = []
        for i, (key, value) in enumerate(r["ates"].items()):
            lo, hi = ref[key]
            parts.append(f"{key} {value:.4f} (JAX seeds 7/0/1/2 [{lo:.4f}, {hi:.4f}], "
                         f"seed 7 {ref['seed7'][i]:.4f}{'' if lo <= value <= hi else ', outside'})")
        c = r["closure"]
        print(f"phase SLAM {name}: {r['frames']} frames, {len(r['kf'])} keyframes "
              f"({r['inserted']} inserted); {'; '.join(parts)}; loop {c['loop']} "
              f"(survives {r['loop_survives']}), used_graph {c['used_graph']} (JAX in "
              f"{ref['used_graph']} of 4 runs), cost_ba {c.get('cost_ba', 0):.6g} "
              f"cost_graph {c.get('cost_graph', 0):.6g}; lost {r['lost']}, "
              f"relocalisations {r['reloc']}; map-tracked frames (gated K5) {r['map_tracked']}")
        print(f"time SLAM {name}: {r['t_track'] / r['frames'] * 1e3:.4f} ms/frame tracking "
              f"(host clock to synchronize), close_loop {r['t_close'] * 1e3:.1f} ms [{card}]")
        st = r["stages"]
        print(f"time SLAM stages {name}: " + ", ".join(
            f"{s} {st.get(f'time_ms.{s}', 0.0):.1f} ms / {st.get(f'calls.{s}', 0)} calls"
            for s in SLAM_STAGES) + f" [{card}]")
        if r["lost"]:
            failures.append(f"{name}: {r['lost']} frames lost")
    r4 = res["eval_seq4"]
    if r4["inserted"] <= 64 or not r4["loop_survives"] or r4["closure"]["loop"] < 0:
        failures.append(f"eval_seq4: inserted {r4['inserted']}, loop "
                        f"{r4['closure']['loop']} survives {r4['loop_survives']}")
    if failures:
        raise AssertionError(f"SLAM path: {len(failures)} failures: " + "; ".join(failures[:20]))
    print(f"phase SLAM path launches: {json.dumps(launches)}")
    return launches, res, features


def slam_unfused(dev, seqs, default):
    """KeyframeSLAM on eval_seq with fused_upstream=False and the default
    run's generator seed: every frame's Features and the keyframes must be
    the default run's; K6 launches once per frame. Returns its launches."""
    from pislam_tpu_torch.ops import kernels

    frames, intr, _ = seqs["eval_seq"]
    cfg = slam_config()
    cfg = dataclasses.replace(cfg, frontend=dataclasses.replace(cfg.frontend,
                                                                fused_upstream=False))
    features = []
    slam = make_slam(cfg, intr, dev, record=features)
    kernels.reset_launch_counts()
    for f in torch.as_tensor(frames).to(dev):
        slam.process(f)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    want_feats, want_kf = default
    for i, (got, want) in enumerate(zip(features, want_feats)):
        if not features_equal(got, want):
            raise AssertionError(f"unfused SLAM frame {i}: Features differ from the default")
    if len(features) != len(frames) or slam.keyframe_frames != want_kf:
        raise AssertionError(f"unfused SLAM: keyframes {slam.keyframe_frames}, default {want_kf}")
    if launches["reduce_codes_4x"] != len(frames) or launches["fused_frontend_codes"]:
        raise AssertionError(f"unfused SLAM: launches {launches}")
    print(f"phase SLAM unfused eval_seq: {len(frames)} frames' Features and the keyframes "
          f"{slam.keyframe_frames} identical to the default run; launches "
          f"{json.dumps(launches)}")
    return launches


def slam_profile(dev, seqs, card):
    """torch.profiler over SLAM_PROFILE_FRAMES eval_seq frames (tracking,
    keyframe inserts and windowed BA) after warm-up, and the synchronizing
    calls per frame."""
    from torch.profiler import ProfilerActivity, profile

    frames, intr, _ = seqs["eval_seq"]
    on_card = torch.as_tensor(frames[:SLAM_PROFILE_FRAMES]).to(dev)
    make_slam(slam_config(), intr, dev).process(on_card[0])
    slam = make_slam(slam_config(), intr, dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in on_card:
            slam.process(f)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in cuda)
    n = len(on_card)
    print(f"profile SLAM eval_seq {n} frames: host wall {wall / n * 1e3:.4f} ms/frame, "
          f"device busy {busy_us / n / 1e3:.4f} ms/frame ({busy_us / (wall * 1e6) * 100:.1f} %), "
          f"{len(cuda) / n:.1f} device ops/frame [{card}]")
    by_name = {}
    for e in cuda:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"profile SLAM device time {us / n:.2f} us/frame: {name[:100]}")

    slam = make_slam(slam_config(), intr, dev)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for f in on_card[:8]:
                slam.process(f)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    kinds = sorted({str(w.message).splitlines()[0][:80] for w in caught})
    print(f"sync: SLAM makes {len(caught) / 8:.1f} synchronizing calls per frame over 8 "
          f"eval_seq frames: {json.dumps(kinds)}")


# ---------------------------------------------------------------------------

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
    seqs = {name: load_sequence(name) for name in SEQUENCES}
    rng = np.random.default_rng(0)
    pc = cfgs["vga"].pyramid
    vga = rng.integers(0, 256, (VGA_FRAMES, pc.base_height, pc.base_width), np.uint8)
    frames = {"eval": [torch.from_numpy(f.copy()) for f in seqs["eval_seq"][0][:EVAL_FRAMES]],
              "vga": [torch.from_numpy(f) for f in vga]}
    pyramids = {k: build_pyramid(frames[k][0].to(dev), c.pyramid) for k, c in cfgs.items()}

    # phase 3: each kernel against its plain version
    errs, rows, feats0 = kernel_phase(dev, pyramids, cfgs)
    odo = pt.VisualOdometry(vo_config(), *seqs["eval_seq"][1], device=dev)
    pairs = [odo.frontend(frames["eval"][i]) for i in (0, 1)]
    errs["match_reduce"], k5_cases = k5_phase(dev, [f for f, _ in pairs], feats0["vga"],
                                              [p for _, p in pairs])

    # phase 4: the extraction path, and the frontend's other configurations
    extract, results = extraction_path(dev, frames, cfgs)
    variant_launches = extraction_variants(dev, cfgs, results)

    # phase 5: the VO path
    vo_path(dev, seqs, card)

    # phase 6: the SLAM path (the main path), and SLAM with the unfused frontend
    launches, slam_res, default_feats = slam_path(dev, seqs, card)
    unfused_launches = slam_unfused(dev, seqs, (default_feats, slam_res["eval_seq"]["kf"]))

    # phase 7: times
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
    k5_shapes = {"eval": "512x512", "vga": "2048x2048"}
    for label in cfgs:
        a5 = k5_cases[k5_shapes[label]]
        rows[label]["match_reduce"] = (a5, None, k5_bound(a5))
    times = {}
    for label in cfgs:
        times[label] = {}
        for name, (args, library, (b_ms, b_by)) in rows[label].items():
            kern = getattr(kernels, name)
            k_ms = time_ms(lambda: kern(*args))
            p_ms = time_ms(lambda: kern.plain(*args))
            l_ms = time_ms(library) if library else None
            d_us = device_us(lambda: kern(*args))
            times[label][name] = (k_ms, p_ms, l_ms, b_ms, b_by)
            lib_txt = f", library {l_ms:.4f} ms" if library else ""
            print(f"time kernel {name} at {label} shapes: {k_ms:.4f} ms (device "
                  f"{d_us:.2f} us), plain {p_ms:.4f} ms{lib_txt}, bound {b_ms * 1e3:.3f} us "
                  f"({b_by}) [{card}]")
    for shape in ("2048x16384", "512x16384 gated"):
        a5 = k5_cases[shape]
        print(f"time kernel match_reduce at {shape}: "
              f"{time_ms(lambda: kernels.match_reduce(*a5)):.4f} ms (device "
              f"{device_us(lambda: kernels.match_reduce(*a5)):.2f} us), plain "
              f"{time_ms(lambda: kernels.match_reduce_plain(*a5)):.4f} ms, bound "
              f"{k5_bound(a5)[0] * 1e3:.3f} us [{card}]")
    vo_stage_times(dev, seqs, card)
    vo_profile(dev, seqs, card)
    slam_profile(dev, seqs, card)

    # the kernels at the eval shapes, each with its launches on its path: the
    # SLAM path for K1-K5, SLAM with the unfused frontend for K6, the dense
    # BRIEF extraction for K4d; no path of the JAX package runs K3c
    paths = {name: ("SLAM", launches) for name in FUSED_PATH_KERNELS}
    paths["reduce_codes_4x"] = ("SLAM unfused", unfused_launches)
    paths["orb_select_bits"] = ("extraction dense BRIEF", variant_launches["dense BRIEF"])
    paths["realign_windows"] = ("none", {"realign_windows": 0})
    out = []
    for k in kernels.COUNTED:
        k_ms, p_ms, l_ms, b_ms, b_by = times["eval"][k.__name__]
        path, counts = paths[k.__name__]
        out.append({"name": k.__name__, "route": "cuda", "source": k.source,
                    "replaces": k.replaces, "launches": counts[k.__name__], "path": path,
                    "max_abs_err": errs[k.__name__], "ms": k_ms, "plain_ms": p_ms,
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": l_ms})
    print(card)
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
