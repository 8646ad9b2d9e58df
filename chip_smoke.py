#!/usr/bin/env python3
"""Drive the PyTorch port's ORB extraction, visual odometry, keyframe SLAM
(per frame and in device-resident chunks), the SLAM service, the demo and
the distributed layer on one CUDA card and check them.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero and
prints no result line):

1. device: the card's name and power limit (nvidia-smi); no card, no run.
2. build: nvcc compiles the Hopper kernels from the twelve .cu sources of
   pislam_tpu_torch/csrc, one process per source, all at once; the
   build's seconds, each kernel's registers and shared memory, and the count
   of IGMMA (int8 wgmma) instructions in the library's SASS.
3. kernels: K1-K4, orb_describe (K3 + K4 in one launch), K4's atan2 bins,
   K6, K4d, orb_describe_dense (K3 + K4d), K3c and K3a against their plain
   PyTorch versions on the card,
   bit-exact, at the extraction shapes (VGA 8-level pyramid with 2048
   keypoints, and the eval config's 4-level 384x256 pyramid with 512),
   including invalid and edge keypoints and an atan2 sweep; orb_describe
   also with every keypoint invalid, code 0, K = 1 and 8, 4 and 1 words;
   K1 under the tile its plan picks and under each of its two
   tiles (32x64, 16x32) forced; K2 also on fewer survivors than k, n = k, n = k + 1, every
   key INT32_MIN, survivors sharing their top byte and k = 8192 over VGA's
   keys; K6 on the unfused
   frontend's scored grid (its top-k gives K1's keypoints), K4d at K, 1,
   2048 and 8192 keypoints and with one window repeated at 2048 and 8192
   (one bin), with the BRIEF weights (also against K4's bits) and a seeded
   random gm; orb_describe_dense on orb_describe's cases, at 2048 and 8192,
   one code repeated at 2048 and 8192 and with a random gm (also against
   orb_describe); K3c on 2048 keypoints' strip
   rows (also against K3's bytes) and on its edge cases (k3c_edge_cases:
   K = 1, 5 and 8192, every phi 0 or 224, each psi alone, rows 4 bytes
   into their buffer), K3a on each pyramid (also against its
   library copy, chip_smoke.strips_by_copy); K6 and K3a on their edge cases
   (k6_edge_cases, k3a_edge_cases: odd and ragged shapes, bases offset by 1,
   4 and 8 bytes, all zero, score 255 at the 4095 coordinate limit); K3
   (K3b) and K4 on theirs (k3b_edge_cases, k4_edge_cases: K = 1 and 8192,
   the 32x32 image, W % 4 in {1, 2, 3}, image and window bases offset by
   1-4 bytes, tables off their alignment, 1 to 8 words, one bin, windows
   of all -128 and all 127); K5 (ungated and
   gated) bit-exact at (512, 512) from eval features, (2048, 2048) from VGA
   features, (2048, 16384) tiled as tools/ab_match.py tiles it, and gated
   with radius 0.06 at (512, 8192), the map-tracking shape, and (512,
   16384), each with invalid rows and columns, duplicated descriptors, ties
   across tiles, segments and row tiles, and again with K1 - 13; then
   K1 = 65 and 127, K2 no multiple of the 128-column tile, and 1 and 4
   descriptor words; K5 on two streams at once, each its own merge state;
   K5 at K1 = 65,537 and 70,000 x K2 = 2048 (two launches, merged).
   motion_only_ba (every Gauss-Newton iteration in one launch) on
   tests/pnp_cases.py's cases (map tracking's, relocalisation's and VO's
   parameters, N = 0, 1, 1001, 2000 and 3000, all invalid, behind the
   camera, beyond the Huber corner) against its plain version on the card,
   within the cases' tolerances (sums in another order), two launches
   bit-equal.
   K1 and K2 also at the default config's pyramids of a KITTI (1241x376:
   555,520 keys) and a 720p frame (1,062,400 keys), K1 under each tile, K2,
   whose keys stay in device memory, at k = 512, 2048 and 8192; both timed
   there.
4. extraction path: 48 frames of data/eval_seq.npz at the eval config and 8
   seeded VGA frames at the default config, each frame -> build_pyramid ->
   make_extract_fn(cfg, "cuda"), compared frame by frame with the plain path
   on the card (K1 also under each tile forced, after the path's counts are
   read), the first 4 of each also with the plain path on the CPU; K1, K2
   and orb_describe launch once per frame, K3 and K4 never. Then, each a
   path of its own with exact launch counts, the same frames with
   fused_upstream=False (K6, orb_describe) and with brief_variant="dense"
   (orb_describe_dense), bit-exact against the default path, and with odd-border
   bucketing (K6) against its own plain path.
5. VO path: make_vo_scan(vo_config(), device="cuda") over the four
   data/eval_seq*.npz sequences (416 frames); each sequence's ATE must lie
   within 0.005 of the JAX package's (EVAL_r05.json vo_ate_rmse); every
   kernel's launch count must reach the frames (K5: the transitions); on
   eval_seq the plain path on the card gives the same matches and decisions
   frame by frame, and the CPU agrees on the first 4 transitions. VO with
   brief_variant="dense" over eval_seq repeats the default path's run bit
   for bit (K1, K2, orb_describe_dense per frame, K5 per transition).
6. SLAM path: KeyframeSLAM(slam_config(), device="cuda") over
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
7. chunk path, the main path: KeyframeSLAM.process_chunk in chunks of 8
   over the four sequences at full length, with exact launch counts (K1,
   K2, orb_describe once per frame plus once per chunk that ends lost; K5
   twice and motion_only_ba once per tracked frame plus the boundary
   relocalisations'), each ATE below max(2.5 x phase 6's, 0.15) and ms/frame beside phase 6's; chunk 1
   against process on eval_seq (Huber off, bootstrap_model_select off and
   on), step by step from process's states with its draws: the same
   decisions, inliers and counters, poses within 5e-2 (free runs printed); the
   E/H bootstrap on the card against the CPU from the same inputs and
   draws; the service's housekeeping on eval_seq4 at small tables and a
   merge of a second session, each operation replayed on the CPU from the
   card's state; and a reading for ROADMAP F1 (eval_seq2 frames 3-4, card
   against CPU stage by stage from one state).
7b. service: pislam_tpu_torch.service.main at its own config over
   eval_seq4 in chunks of 8, with checkpoints every 64 frames, --traj-out,
   --map-out, --metrics and the end-of-run closure, then over eval_seq with
   --loop-every 2 (ATE below 0.5, at least one mid-run closure), each with
   exact launch counts by the chunk path's rule; a kill at frame 112 and
   the rerun that resumes there (its frames make the straight run's
   keyframe decisions, poses within 1e-3; its first chunk equals the
   restored state's, run here); the checkpoint's round trip on the card and
   from the card to the CPU (tables bit-exact; the CUDA generator refused by
   the strict rule, reseeded by the relaxed one); localization-only on the
   map stored before the closure (its counts, no closure); and the demo's
   annotate on the 8 VGA frames in both input forms, bit-exact against the
   plain path on the card, K1, K2 and orb_describe once per frame. ms/frame,
   close_loop ms, the checkpoint's MB and save and restore ms, GPU Time.
7c. distributed layer (parallel/) on the one card, each check an assert:
   world size 1 on NCCL through the entry points (make_mesh -> 1x1; the
   sharded match at 512x8192 and the sharded map tracker on the map phase 6
   leaves after eval_seq4 against the unsharded ones; KeyframeSLAM(mesh=...)
   over eval_seq with close_loop against phase 6's run: decisions,
   counters, keyframes, loop, branch and K5 launches equal, trajectory
   within 1e-4; make_distributed_ba dense and CG on a window of that run
   within 1e-4 of bundle_adjust; make_batch_extract on the VGA frames, VO
   and SLAM streams over the first 48 frames of the four sequences against
   make_vo_scan and the chunk scan; dryrun_multichip(1)); n = 2, 4 and 8
   shards in one process (match_shard on each slice, merge_match_shards)
   bit-exact against one K5 at 512x8192 and for gated map tracking, with
   exactly n K5 launches per call, store counts equal, BA's Schur sums from
   the shards within 1e-4, and the sharded match timed at each n; and a
   probe, two processes on cuda:0, of whether gloo carries CUDA tensors
   (if it does, the 2-rank sharded match and tracker against the unsharded
   path). Its K5 launches on a line of their own.
8. times from CUDA events (median of 30 after warm-up) and host clocks
   ending in a synchronize, device time and device kernels per call from
   torch.profiler (each kernel beside its bound and, where one PyTorch call
   computes its function, that call: torch.topk for K2, the strided copy
   of strips_by_copy for K3a; K1 at the eval, VGA, KITTI and 720p pyramids under the
   plan's tile and under each tile forced; orb_describe against the
   composition it replaced, decode + K3 + K4 + masks, in turns old, new,
   new, old, alone and inside the extraction; orb_describe_dense against
   decode + K3 + K4d + packing + masks the same way, with device operations
   per dense extraction; torch._int_mm over K4d's whole product as a
   superset reference; an empty kernel, the launch floor), SLAM stage times,
   torch.profiler windows over 20 VO and
   20 SLAM frames, and which operations make the host wait (per SLAM frame,
   and per chunk of 8 by line, inside the scan's frame loop and outside);
   the card's name and power limit on every line.

The line before the last is {"kernels": [...]}, the last line is
{"ok": true, "device": {...}}. Imports torch, numpy, the port and
tests/pnp_cases.py (numpy) only.
"""

from __future__ import annotations

import dataclasses
import itertools
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
# a torch.profiler window that records no device work at all (it happens on
# the card's machine) is taken again, up to this many times
PROFILE_TRIES = 3
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
# motion-only BA's float operations per point and iteration, counted in
# csrc/motion_only_ba.cu's accumulate(): the camera point (15), residual, norm
# and Huber weight (~14), the Jacobian (~16), and the 27 weighted products and
# sums (~105)
PNP_FLOPS_PER_POINT = 150
# the kernels of the default (fused, sorted BRIEF) frontend's VO and SLAM paths;
# K3 and K4 run there inside orb_describe, and alone on no path of it
FUSED_PATH_KERNELS = ("fused_frontend_codes", "topk_keys", "orb_describe", "match_reduce")
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
# the __global__ functions of the VO path's kernels, as the profiler names them
HOPPER_KERNEL_FUNCTIONS = (
    "fused_frontend_kernel", "topk_cluster_kernel", "orb_describe_kernel",
    "match_wgmma_kernel")


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


def device_us(fn, reps: int = 20) -> tuple[float, float]:
    """Device time per call of the CUDA work fn launches (kernels, copies,
    memsets), summed from a torch.profiler trace: what the card spends,
    without the host's launch cost that a CUDA-event time includes; and the
    number of device operations per call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ops = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if ops:
            break
    return sum(e.time_range.elapsed_us() for e in ops) / reps, len(ops) / reps


def bound_ms(nbytes: float, *work: tuple[float, float]) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate of their type, summed
    over the (operations, rate) pairs of `work`."""
    by_bytes = nbytes / HBM_BYTES_S * 1e3
    by_ops = sum(ops / rate for ops, rate in work) * 1e3
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

def k1_plans(shape):
    """K1's plan at an image shape, then the plan of each tile forced."""
    from pislam_tpu_torch.ops import kernels

    sms = kernels.device_limits(torch.device("cuda", 0))[0]
    return [kernels.frontend_plan(*shape, sms)] + [
        kernels.frontend_plan(*shape, sms, tile) for tile in kernels.FRONTEND_TILES]


def k1_check(label, args1):
    """K1 under the plan's tile and under each tile, bit-exact against its
    plain version. Returns the plan's codes and max |error|."""
    from pislam_tpu_torch.ops import kernels

    want = kernels.fused_frontend_codes_plain(*args1)
    grid = kernels.fused_frontend_codes(*args1)
    err = require_equal(f"K1 {label}", grid, want)
    for plan in k1_plans(args1[0].shape)[1:]:
        err = max(err, require_equal(f"K1 {label} tile {plan.th}x{plan.tw}",
                                     kernels.fused_frontend_codes(*args1, plan=plan), want))
    return grid, err


def k1_times(cases, card):
    """K1's device time at each pyramid under the plan's tile and under each
    tile forced, beside its bound (the formula of kernel_phase's rows)."""
    from pislam_tpu_torch.ops import kernels

    for label, args1 in cases.items():
        (h, w), n_px = args1[0].shape, args1[0].numel()
        b_ms, b_by = bound_ms(2 * n_px + (h + 1) // 2 * ((w + 1) // 2) * 4,
                              (K1_OPS_PER_PIXEL * n_px, SCALAR_OPS_S))
        plans = k1_plans(args1[0].shape)
        for i, plan in enumerate(plans):
            kw = {} if i == 0 else {"plan": plan}
            d_us, d_n = device_us(lambda: kernels.fused_frontend_codes(*args1, **kw))
            how = "plan's choice" if i == 0 else "forced"
            print(f"time kernel fused_frontend_codes at {label} ({tuple(args1[0].shape)}) "
                  f"tile {plan.th}x{plan.tw} ({how}, {plan.ctas} CTAs): "
                  f"{time_ms(lambda: kernels.fused_frontend_codes(*args1, **kw)):.4f} ms "
                  f"(device {d_us:.2f} us, {d_n:g} device kernels per call), bound "
                  f"{b_ms * 1e3:.3f} us ({b_by}) [{card}]")


def kernel_phase(dev, pyramids, cfgs):
    """K1-K4, orb_describe, K6, K4d, K3c and K3a against their plain
    versions on the card. Returns per-kernel
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
        grid, err = k1_check(label, args1)
        errs["fused_frontend_codes"] = max(errs["fused_frontend_codes"], err)

        keys = (grid.reshape(-1) ^ nms.INT32_MIN).contiguous()
        k = fc.max_keypoints
        top = kernels.topk_keys(keys, k)
        errs["topk_keys"] = max(errs["topk_keys"], require_equal(
            f"K2 {label}", top, kernels.topk_keys_plain(keys, k)))
        few = keys.clone()                       # fewer survivors than k
        few[few.argsort(descending=True)[k // 3:]] = nms.INT32_MIN
        require_equal(f"K2 {label} few", kernels.topk_keys(few, k),
                      kernels.topk_keys_plain(few, k))
        mixed = torch.cat([top[:k // 2], keys[:k + 1 - k // 2]])   # survivors and zeros
        for name, (kk, kn) in {"n=k": (mixed[:k], k), "n=k+1": (mixed, k),
                               "all INT32_MIN": (torch.full_like(keys, nms.INT32_MIN), k),
                               # survivors sharing their top byte: more than one radix pass
                               "shared top byte": (torch.where(keys != nms.INT32_MIN,
                                                               (keys & 0xFFFFFF) | 0x12000000,
                                                               keys), k),
                               f"k={kernels.MAX_TOPK}": (keys, kernels.MAX_TOPK)}.items():
            kk = kk.contiguous()
            require_equal(f"K2 {label} {name}", kernels.topk_keys(kk, kn),
                          kernels.topk_keys_plain(kk, kn))

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
        for words in range(1, 9):
            args4 = (flat, *tables, words)
            ang, desc = kernels.orb_select(*args4)
            pang, pdesc = kernels.orb_select_plain(*args4)
            errs["orb_select"] = max(errs["orb_select"],
                                     require_equal(f"K4 {label} angles", ang, pang),
                                     require_equal(f"K4 {label} words={words}", desc, pdesc))
        flat = flat[:k]

        # orb_describe on the path's codes and the edge keypoints as codes
        # (coordinates wrap to 12 bits, as a code holds them), every keypoint
        # invalid, code 0 valid and not, K = 1; 8, 4 and 1 words
        ecodes = (7 << 24) | ((ex.long() & 0xFFF) << 12) | (ey.long() & 0xFFF)
        dcodes, dvalid = torch.cat([codes, ecodes]), torch.cat([valid, ev])
        for name, (c, v) in {
                "path": (dcodes, dvalid), "all invalid": (dcodes, torch.zeros_like(dvalid)),
                "K=1": (dcodes[:1], dvalid[:1]),
                "code 0": (torch.zeros(3, dtype=torch.int64, device=dev),
                           torch.tensor([True, False, True], device=dev))}.items():
            for words in (fc.words, 4, 1):
                args = (pyr, c, v, *tables, words)
                got, want = kernels.orb_describe(*args), kernels.orb_describe_plain(*args)
                errs["orb_describe"] = max(
                    errs["orb_describe"],
                    require_equal(f"orb_describe {label} {name} words={words} angles",
                                  got[0], want[0]),
                    require_equal(f"orb_describe {label} {name} words={words}", got[1], want[1]))
        fd = feats[label]
        require_equal(f"orb_describe {label} vs the extraction's", torch.cat(
            [a.reshape(k, -1).to(torch.int32) for a in kernels.orb_describe(
                pyr, codes, valid, *tables, fc.words)], 1),
            torch.cat([fd.angles[:, None].to(torch.int32), fd.descriptors], 1))

        # K6 on the unfused frontend's scored grid of the same pyramid
        scored = unfused_scored(pyr, extractor.level_mask, fc)
        red = kernels.reduce_codes_4x(scored)
        errs["reduce_codes_4x"] = max(errs["reduce_codes_4x"], require_equal(
            f"K6 {label}", red, kernels.reduce_codes_4x_plain(scored)))
        if not torch.equal(nms.select_topk_codes(red, k)[0], feats[label].codes):
            raise AssertionError(f"K6 {label}: its top-k differs from K1's keypoints")
        # K4d on the path's windows, K = 1, 2048 and 8192 (the path's repeated),
        # one window repeated (every keypoint in one bin) at 2048 and 8192, the
        # brief weights (also against K4) and a seeded random gm
        gm = brief.dense_weights(dev)
        rand_gm = torch.as_tensor(np.random.default_rng(12).integers(
            -128, 128, (1024, kernels.GM_COLS)).astype(np.int8), device=dev)
        dense_flats = {"path": flat, "K=1": flat[:1].contiguous(),
                       "x4": flat.repeat(4, 1)[:2048], "x16": flat.repeat(16, 1)[:8192],
                       "one bin 2048": flat[:1].repeat(2048, 1),
                       "one bin 8192": flat[:1].repeat(8192, 1)}
        for (name, f), (gname, g) in itertools.product(dense_flats.items(),
                                                        (("brief", gm), ("random gm", rand_gm))):
            ang, bits = kernels.orb_select_bits(f, g)
            pang, pbits = kernels.orb_select_bits_plain(f, g)
            errs["orb_select_bits"] = max(
                errs["orb_select_bits"],
                require_equal(f"K4d {label} {name} {gname} bins", ang, pang),
                require_equal(f"K4d {label} {name} {gname} bits", bits, pbits))
            if name.startswith("one bin") and torch.unique(ang).numel() != 1:
                raise AssertionError(f"K4d {label} {name}: more than one bin")
            if gname == "brief":
                k4ang, k4desc = kernels.orb_select(f, *tables, 8)
                require_equal(f"K4d {label} {name} vs K4 bins", ang, k4ang.to(torch.int32))
                require_equal(f"K4d {label} {name} vs K4 bits", brief._pack_bits_u8(bits, 8),
                              k4desc)
        # orb_describe_dense on the cases of orb_describe, K = 2048 and 8192
        # (the path's codes repeated), one code repeated at 2048 and 8192, and
        # a random gm; with the brief weights also against orb_describe
        for name, (c, v) in {
                "path": (dcodes, dvalid), "all invalid": (dcodes, torch.zeros_like(dvalid)),
                "K=1": (dcodes[:1], dvalid[:1]),
                "code 0": (torch.zeros(3, dtype=torch.int64, device=dev),
                           torch.tensor([True, False, True], device=dev)),
                "x4": (dcodes.repeat(4)[:2048], dvalid.repeat(4)[:2048]),
                "x16": (dcodes.repeat(16)[:8192], dvalid.repeat(16)[:8192]),
                "one bin 2048": (codes[:1].repeat(2048), valid[:1].repeat(2048)),
                "one bin 8192": (codes[:1].repeat(8192), valid[:1].repeat(8192))}.items():
            for (gname, g), words in itertools.product((("brief", gm), ("random gm", rand_gm)),
                                                       (fc.words, 4, 1)):
                if gname == "random gm" and words != fc.words:
                    continue
                args = (pyr, c, v, g, words)
                got = kernels.orb_describe_dense(*args)
                want = kernels.orb_describe_dense_plain(*args)
                errs["orb_describe_dense"] = max(
                    errs["orb_describe_dense"],
                    require_equal(f"orb_describe_dense {label} {name} {gname} words={words} "
                                  f"angles", got[0], want[0]),
                    require_equal(f"orb_describe_dense {label} {name} {gname} words={words}",
                                  got[1], want[1]))
                if gname == "brief":
                    srt = kernels.orb_describe(pyr, c, v, *tables, words)
                    require_equal(f"orb_describe_dense {label} {name} vs orb_describe angles",
                                  got[0], srt[0])
                    require_equal(f"orb_describe_dense {label} {name} vs orb_describe",
                                  got[1], srt[1])
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
        strips = kernels.pack_row_strips(pyr)
        errs["pack_row_strips"] = max(errs["pack_row_strips"], require_equal(
            f"K3a {label}", strips, kernels.pack_row_strips_plain(pyr)))
        require_equal(f"K3a {label} library copy", strips_by_copy(pyr), strips)

        # times at the main path's shapes (the keypoints alone, no extras)
        args3 = (pyr, xs, ys, valid)
        args4 = (flat, *tables, fc.words)
        args3c = kernels.strip_window_rows(pyr, xs, ys, valid)
        n_px = pyr.numel()
        bins = torch.unique(kernels.orb_select_bits(flat, gm)[0]).numel()
        rows[label] = {
            "fused_frontend_codes": (args1, None, bound_ms(
                2 * n_px + grid.numel() * 4, (K1_OPS_PER_PIXEL * n_px, SCALAR_OPS_S))),
            "topk_keys": ((keys, k), lambda keys=keys, k=k: torch.topk(keys, k),
                          bound_ms(keys.numel() * 4 + k * 4, (4 * keys.numel(), SCALAR_OPS_S))),
            "gather_windows_packed": (args3, None, bound_ms(
                n_px + k * (4 + 4 + 1) + k * 1024)),
            "orb_select": (args4, None, bound_ms(
                flat.numel() + sum(tb.numel() * tb.element_size() for tb in tables)
                + k * (1 + 4 * fc.words), (k * 2 * 1024 * 2, INT8_OPS_S),
                (k * 256, SCALAR_OPS_S))),
            "reduce_codes_4x": ((scored,), None, bound_ms(
                scored.numel() + red.numel() * 4)),
            # the slabs of the bins this input selects and the moment columns
            "orb_select_bits": ((flat, gm), None, bound_ms(
                flat.numel() + bins * 1024 * 256 + 1024 * 2 + k * (4 + 256),
                (2 * k * 1024 * (256 + 2), INT8_OPS_S))),
            "orb_describe_dense": ((pyr, codes, valid, gm, fc.words), None,
                                   describe_dense_bound(pyr, codes, valid, fd.angles,
                                                        fc.words)),
            # each keypoint's 9 rows x 32 words, psi and phi; 1 KB out
            "realign_windows": (args3c, None, bound_ms(
                k * (9 * 32 * 4 + 8 + 1024))),
            # the image in, every strip's words out
            "pack_row_strips": ((pyr,), lambda pyr=pyr: strips_by_copy(pyr), bound_ms(
                n_px + strips.numel() * 4)),
            "orb_describe": ((pyr, codes, valid, *tables, fc.words), None,
                             describe_bound(pyr, codes, valid, fd.angles, fc.words)),
        }

    k3b_cases, k4_cases = k3b_edge_cases(dev), k4_edge_cases(dev)
    for name, args in k3b_cases.items():
        errs["gather_windows_packed"] = max(errs["gather_windows_packed"], require_equal(
            f"K3 {name}", kernels.gather_windows_packed(*args),
            kernels.gather_windows_packed_plain(*args)))
    for name, args in k4_cases.items():
        ang, desc = kernels.orb_select(*args)
        pang, pdesc = kernels.orb_select_plain(*args)
        errs["orb_select"] = max(errs["orb_select"],
                                 require_equal(f"K4 {name} angles", ang, pang),
                                 require_equal(f"K4 {name}", desc, pdesc))
        if name.startswith("one bin") and torch.unique(ang).numel() != 1:
            raise AssertionError(f"K4 {name}: more than one bin")
    k3c_cases = k3c_edge_cases(dev)
    for name, args in k3c_cases.items():
        errs["realign_windows"] = max(errs["realign_windows"], require_equal(
            f"K3c {name}", kernels.realign_windows(*args),
            kernels.realign_windows_plain(*args)))
    k6_cases, k3a_cases = k6_edge_cases(dev), k3a_edge_cases(dev)
    for name, scored in k6_cases.items():
        errs["reduce_codes_4x"] = max(errs["reduce_codes_4x"], require_equal(
            f"K6 {name}", kernels.reduce_codes_4x(scored), kernels.reduce_codes_4x_plain(scored)))
    for name, img in k3a_cases.items():
        strips = kernels.pack_row_strips(img)
        errs["pack_row_strips"] = max(errs["pack_row_strips"], require_equal(
            f"K3a {name}", strips, kernels.pack_row_strips_plain(img)))
        require_equal(f"K3a {name} library copy", strips_by_copy(img), strips)

    m10, m01 = (torch.as_tensor(m, device=dev) for m in orientation.sweep_moments())
    bins = kernels.atan2_bins(m10, m01)
    require_equal("K4 atan2 sweep (card plain)", bins, orientation.atan2_bins(m10, m01))
    require_equal("K4 atan2 sweep (CPU plain)", bins.cpu(),
                  orientation.atan2_bins(m10.cpu(), m01.cpu()))
    print(f"phase kernels: ok, K1 (the plan's tile and each of {kernels.FRONTEND_TILES}), "
          f"K2-K4 (K2 "
          f"also at n=k, n=k+1, all INT32_MIN, a shared top "
          f"byte, k=8192), orb_describe (the path's keypoints and edge ones, all invalid, "
          f"code 0, K=1; 8, 4 and 1 words; also against the extraction's Features), K6, "
          f"K4d (the path's windows, K=1, 2048, 8192, one bin at 2048 and 8192; brief "
          f"weights, also against K4, and a random gm), orb_describe_dense (orb_describe's "
          f"cases, 2048, 8192, one bin at 2048 and 8192, a random gm; also against "
          f"orb_describe), K3c (2048 "
          f"keypoints, also against K3's bytes) and K3a (also against its library copy) "
          f"bit-exact (tolerance 0) on VGA and eval shapes; K6 on {len(k6_cases)}, "
          f"K3a on {len(k3a_cases)}, K3 on {len(k3b_cases)} and K4 on {len(k4_cases)} "
          f"edge cases (odd and ragged shapes, misaligned bases and tables, ties at the "
          f"coordinate limit, K = 1 and 8192, 1 to 8 words, one bin) and K3c on "
          f"{len(k3c_cases)} ({', '.join(k3c_cases)}) bit-exact; atan2 "
          f"sweep of "
          f"{m10.numel()} moment pairs bit-exact")
    return errs, rows, feats


def pnp_cases():
    """tests/pnp_cases.py (numpy only): motion-only BA's seeded cases and the
    tolerances its kernel is held to against the plain version."""
    sys.path.insert(0, str(ROOT / "tests"))
    import pnp_cases as cases
    return cases


def pnp_args(dev, n):
    """Motion-only BA at map tracking's parameters on n seeded points."""
    cases = pnp_cases()
    p = cases.MAP_TRACK
    return (*(torch.from_numpy(a).to(dev) for a in cases.make_case(n, 7)), p["iters"],
            p["huber"], p["inlier_threshold"], p["damping"])


def pnp_bound(n: int, iters: int) -> tuple[float, str]:
    """Its least time by bytes or operations: R0, t0 and each point's xyz, uv
    and valid in; R, t, the costs, the inlier flags and count out. The chain
    of dependent iterations, not this, is what bounds the kernel."""
    return bound_ms(48 + 21 * n + 48 + 4 * iters + n + 8,
                    (PNP_FLOPS_PER_POINT * n * iters, SCALAR_OPS_S))


def pnp_phase(dev) -> float:
    """Motion-only BA on every case of tests/pnp_cases.py (map tracking's,
    relocalisation's and VO's parameters; N = 0, 1, 1001, 2000, 3000; all
    invalid, points behind the camera and beyond the Huber corner) against
    its plain version on the card, within the cases' tolerances, two
    launches bit-equal. Returns the largest |R, t difference|."""
    from pislam_tpu_torch.backend import pnp
    from pislam_tpu_torch.ops import kernels

    cases = pnp_cases()
    worst = 0.0
    for name in cases.CASES:
        arrays, params = cases.case(name)
        args = [torch.from_numpy(a).to(dev) for a in arrays]
        before = pnp.motion_only_ba_kernel.launches
        got, again = (pnp.motion_only_ba(*args, **params) for _ in range(2))
        if pnp.motion_only_ba_kernel.launches - before != 2:
            raise AssertionError(f"motion_only_ba {name}: not one launch a call")
        want = pnp.motion_only_ba_plain(*args, **params)
        differ = [k for k in want if not torch.equal(got[k], again[k])]
        bad = cases.mismatches({k: v.cpu().numpy() for k, v in got.items()},
                               {k: v.cpu().numpy() for k, v in want.items()}, arrays)
        if differ or bad:
            raise AssertionError(f"motion_only_ba {name}: {bad}; launches differ in {differ}")
        worst = max(worst, *(float((got[k] - want[k]).abs().max()) for k in ("R", "t")))
    print(f"phase kernels: motion_only_ba on {len(cases.CASES)} cases "
          f"({', '.join(cases.CASES)}) within R/t {cases.POSE_TOL:g} (N = 1: "
          f"{cases.UNDERDETERMINED_POSE_TOL:g}), inliers {cases.INLIER_TOL}, costs "
          f"{cases.COST_RTOL:g} of the plain version on the card (largest R/t difference "
          f"{worst:.3g}); two launches bit-equal; one launch a call")
    return worst


def describe_bound(pyr, codes, valid, angles, words) -> tuple[float, str]:
    """orb_describe's bound on this input: the pixels of the valid keypoints'
    windows (their union), the rows of idx0/idx1 of the bins they use and
    mom_w, the codes and valid flags in, angles and words out; 2 x 1024 int8
    moment products per valid keypoint at the int8 rate, and its 32 words
    compares at the scalar rate."""
    from pislam_tpu_torch.ops import kernels
    h, w = pyr.shape
    k, n = codes.numel(), int(valid.sum())
    x = ((codes >> 12) & 0xFFF).clamp(kernels.RADIUS, w - kernels.RADIUS - 2)[valid]
    y = (codes & 0xFFF).clamp(kernels.RADIUS, h - kernels.RADIUS - 2)[valid]
    r = torch.arange(32, device=pyr.device) - kernels.RADIUS
    touched = torch.zeros(h, w, dtype=torch.bool, device=pyr.device)
    touched[(y[:, None] + r)[:, :, None], (x[:, None] + r)[:, None, :]] = True
    bins = torch.unique(angles[valid]).numel()
    nbytes = (int(touched.sum()) + bins * 2 * 32 * words * 2 + 1024 * 2
              + k * (8 + 1) + k * (1 + 4 * words))
    return bound_ms(nbytes, (n * 2 * 1024 * 2, INT8_OPS_S), (n * 32 * words, SCALAR_OPS_S))


def describe_dense_bound(pyr, codes, valid, angles, words) -> tuple[float, str]:
    """orb_describe_dense's bound on this input: the pixels of the valid
    keypoints' windows (their union), the first 32 x words columns of the
    slabs of the bins they use and the two moment columns, the codes and
    valid flags in, angles and words out; 2 x 1024 x (32 words + 2) int8
    operations per valid keypoint at the int8 rate."""
    from pislam_tpu_torch.ops import kernels
    h, w = pyr.shape
    k, n = codes.numel(), int(valid.sum())
    x = ((codes >> 12) & 0xFFF).clamp(kernels.RADIUS, w - kernels.RADIUS - 2)[valid]
    y = (codes & 0xFFF).clamp(kernels.RADIUS, h - kernels.RADIUS - 2)[valid]
    r = torch.arange(32, device=pyr.device) - kernels.RADIUS
    touched = torch.zeros(h, w, dtype=torch.bool, device=pyr.device)
    touched[(y[:, None] + r)[:, :, None], (x[:, None] + r)[:, None, :]] = True
    bins = torch.unique(angles[valid]).numel()
    nbytes = (int(touched.sum()) + bins * 1024 * 32 * words + 1024 * 2
              + k * (8 + 1) + k * (1 + 4 * words))
    return bound_ms(nbytes, (n * 2 * 1024 * (32 * words + 2), INT8_OPS_S))


def old_describe(img, codes, valid, idx0, idx1, mom_w, words):
    """What orb_describe computes, as the frontend computed it before that
    kernel: the codes decoded, K3's windows, K4's angles and words, then the
    masks by valid (about a dozen device operations)."""
    from pislam_tpu_torch.ops import kernels
    from pislam_tpu_torch.utils import codec
    xs = codec.decode_x(codes).to(torch.int32)
    ys = codec.decode_y(codes).to(torch.int32)
    flat = kernels.gather_windows_packed(img, xs, ys, valid)
    angles, desc = kernels.orb_select(flat, idx0, idx1, mom_w, words)
    desc = torch.where(valid[:, None], desc, torch.zeros_like(desc))
    return torch.where(valid, angles, torch.zeros_like(angles)), desc


def describe_ab(dev, cfgs, results, card):
    """orb_describe against old_describe on each config's first extraction
    frame, bit-exact, then their device time and device operations per call,
    alone and inside the whole extraction (an OrbExtractor whose kernel set
    has old_describe in orb_describe's place), in turns old, new, new, old."""
    import pislam_tpu_torch as pt
    from pislam_tpu_torch.ops import brief, kernels

    tables = brief.OrbTables.build(dev)
    for label, cfg in cfgs.items():
        pyr, feats = results[label][0]
        args = (pyr, feats.codes, feats.valid, *tables, cfg.frontend.words)
        old_ext = pt.OrbExtractor(cfg, ops=kernels.HOPPER._replace(
            orb_describe=old_describe)).to(dev)
        new_ext = pt.make_extract_fn(cfg, dev)
        require_equal(f"old_describe {label} angles", old_describe(*args)[0],
                      kernels.orb_describe(*args)[0])
        require_equal(f"old_describe {label} words", old_describe(*args)[1],
                      kernels.orb_describe(*args)[1])
        if not features_equal(old_ext(pyr), new_ext(pyr)):
            raise AssertionError(f"{label}: the extraction with old_describe differs")
        fns = {"old": (lambda: old_describe(*args), lambda: old_ext(pyr)),
               "new": (lambda: kernels.orb_describe(*args), lambda: new_ext(pyr))}
        for turn, name in enumerate(("old", "new", "new", "old")):
            alone, extraction = fns[name]
            d_us, d_n = device_us(alone)
            e_us, e_n = device_us(extraction)
            print(f"time describe {label} turn {turn} {name}: {d_us:.2f} us, {d_n:g} device "
                  f"ops per call; extraction {e_us:.2f} us, {e_n:g} device ops per frame "
                  f"[{card}]")


def old_describe_dense(img, codes, valid, gm, words):
    """What orb_describe_dense computes, as the frontend computed it before
    that kernel: the codes decoded, K3's windows, K4d's bins and bits, the
    bits packed, then the masks by valid."""
    from pislam_tpu_torch.ops import brief, kernels
    from pislam_tpu_torch.utils import codec
    xs = codec.decode_x(codes).to(torch.int32)
    ys = codec.decode_y(codes).to(torch.int32)
    flat = kernels.gather_windows_packed(img, xs, ys, valid)
    angles, bits = kernels.orb_select_bits(flat, gm)
    angles, desc = angles.to(torch.uint8), brief._pack_bits_u8(bits, words)
    desc = torch.where(valid[:, None], desc, torch.zeros_like(desc))
    return torch.where(valid, angles, torch.zeros_like(angles)), desc


def dense_ab(dev, cfgs, results, card):
    """The dense-BRIEF describe stage: orb_describe_dense against
    old_describe_dense on each config's first extraction frame, bit-exact,
    then their device time and device operations per call, alone and inside
    the dense-BRIEF extraction, in turns old, new, new, old; beside them
    torch._int_mm over the whole (K, 1024) x (1024, 7808) product of the
    path's windows, a superset of K4d's work (every slab, not the selected
    one), and the device time of an empty kernel, the floor of any launch."""
    import pislam_tpu_torch as pt
    from pislam_tpu_torch.ops import brief, kernels

    gm = brief.dense_weights(dev)
    for label, cfg in cfgs.items():
        pyr, feats = results[label][0]
        dcfg = dataclasses.replace(cfg, frontend=dataclasses.replace(
            cfg.frontend, brief_variant="dense"))
        args = (pyr, feats.codes, feats.valid, gm, cfg.frontend.words)
        old_ext = pt.OrbExtractor(dcfg, ops=kernels.HOPPER._replace(
            orb_describe_dense=old_describe_dense)).to(dev)
        new_ext = pt.make_extract_fn(dcfg, dev)
        for i, name in enumerate(("angles", "words")):
            require_equal(f"old_describe_dense {label} {name}", old_describe_dense(*args)[i],
                          kernels.orb_describe_dense(*args)[i])
        if not features_equal(old_ext(pyr), new_ext(pyr)):
            raise AssertionError(f"{label}: the dense extraction with old_describe_dense differs")
        fns = {"old": (lambda: old_describe_dense(*args), lambda: old_ext(pyr)),
               "new": (lambda: kernels.orb_describe_dense(*args), lambda: new_ext(pyr))}
        for turn, name in enumerate(("old", "new", "new", "old")):
            alone, extraction = fns[name]
            d_us, d_n = device_us(alone)
            e_us, e_n = device_us(extraction)
            print(f"time describe dense {label} turn {turn} {name}: {d_us:.2f} us, {d_n:g} "
                  f"device ops per call; dense extraction {e_us:.2f} us, {e_n:g} device ops "
                  f"per frame [{card}]")
        xs = (feats.codes >> 12 & 0xFFF).to(torch.int32)
        ys = (feats.codes & 0xFFF).to(torch.int32)
        flat = kernels.gather_windows_packed(pyr, xs, ys, feats.valid)
        k4d_us, _ = device_us(lambda: kernels.orb_select_bits(flat, gm))
        mm_us, mm_n = device_us(lambda: torch._int_mm(flat, gm))
        print(f"time K4d {label} (K={flat.shape[0]}): orb_select_bits {k4d_us:.2f} us; "
              f"torch._int_mm ({flat.shape[0]}, 1024) x (1024, {kernels.GM_COLS}), a superset "
              f"reference (every slab, not the selected one), {mm_us:.2f} us "
              f"({mm_n:g} device kernels) [{card}]")
    empty_us, empty_n = device_us(lambda: kernels.empty_launch(dev))
    print(f"time empty kernel (the launch floor): {empty_us:.2f} us, {empty_n:g} device "
          f"kernels per call [{card}]")


def strips_by_copy(img):
    """K3a's function as one PyTorch call, its library yardstick (timed here,
    never called by the port): the copy of a strided view of the image."""
    h, w = img.shape
    return torch.as_strided(img, (w // 128 - 1, h // 4, 256, 4),
                            (128, 4 * w, 1, w)).contiguous().view(torch.int32).squeeze(-1)


def at_offset(a: np.ndarray, offset: int, dev):
    """A 2-D array of bytes (uint8 or int8) as a contiguous view on dev that
    starts `offset` bytes into a fresh buffer (whose own start the allocator
    aligns)."""
    src = torch.from_numpy(a)
    buf = torch.zeros(a.size + 16, dtype=src.dtype, device=dev)
    view = buf[offset:offset + a.size].view(a.shape)
    view.copy_(src)
    return view


def k6_edge_cases(dev) -> dict:
    """K6's edge grids, each a case of its vector or its scalar path: odd H,
    odd W, W = 2, W % 16 in {2, 8, 14}, the base offset by 1, 4 and 8 bytes
    (and by 0), all zero, and every pixel a survivor at score 255 (the 2x2
    maxima decided by x, then y) up to the 4095 coordinate limit."""
    rng = np.random.default_rng(13)

    def survivors(h, w):
        s = rng.integers(1, 256, (h, w), dtype=np.uint8)
        s[rng.random((h, w)) < 0.6] = 0
        return s

    shapes = {"odd H": (61, 64), "odd W": (64, 61), "W=2": (63, 2), "W%16=2": (40, 130),
              "W%16=8": (41, 136), "W%16=14": (40, 142)}
    cases = {f"{name} {h}x{w}": torch.from_numpy(survivors(h, w)).to(dev)
             for name, (h, w) in shapes.items()}
    for off in (0, 1, 4, 8):
        cases[f"base +{off} 64x256"] = at_offset(survivors(64, 256), off, dev)
    cases["all zero 800x384"] = torch.zeros((800, 384), dtype=torch.uint8, device=dev)
    for n in (4096, 4095):
        cases[f"all 255 {n}x{n}"] = torch.full((n, n), 255, dtype=torch.uint8, device=dev)
    return cases


def k3a_edge_cases(dev) -> dict:
    """K3a's edge images: W = 256 (one strip), 384 and 640, H = 4, and the
    base offset by 1 byte (the byte path) and by 8 (word loads off a 16-byte
    boundary)."""
    rng = np.random.default_rng(14)
    cases = {f"{h}x{w}": torch.from_numpy(rng.integers(0, 256, (h, w), np.uint8)).to(dev)
             for h, w in ((64, 256), (64, 384), (64, 640), (4, 384), (4, 256))}
    for off in (1, 8):
        cases[f"base +{off} 64x384"] = at_offset(
            rng.integers(0, 256, (64, 384), np.uint8), off, dev)
    return cases


def k3b_edge_cases(dev) -> dict:
    """K3b's edge inputs (image, xs, ys, valid): K = 1 (the bottom-right
    corner), K = 8192, the 32x32 image, W % 4 in {1, 2, 3}, and the image
    base offset by 1, 2 and 3 bytes. Each has keypoints on every clip limit
    and at the four corners, and invalid ones with stale coordinates, among
    seeded keypoints in and around the image: so windows start at every
    byte alignment and reach the image's first and last bytes."""
    rng = np.random.default_rng(15)

    def keypoints(h, w, k):
        ex = [w - 1, 0, 15, 16, w - 17, w - 16, w - 1, 0, w + 100, 3000, -5]
        ey = [h - 1, 0, 15, h - 17, 16, h - 16, 0, h - 1, h + 100, -5, 4000]
        ev = [True] * 9 + [False] * 2
        xs = np.concatenate([ex, rng.integers(-20, w + 20, k)])[:k]
        ys = np.concatenate([ey, rng.integers(-20, h + 20, k)])[:k]
        valid = np.concatenate([ev, rng.random(k) < 0.8])[:k]
        return (torch.as_tensor(xs.astype(np.int32), device=dev),
                torch.as_tensor(ys.astype(np.int32), device=dev),
                torch.as_tensor(valid, device=dev))

    shapes = {"K=1": (64, 96, 1, 0), "K=8192": (480, 640, 8192, 0), "32x32": (32, 32, 40, 0),
              "W%4=1": (61, 97, 300, 0), "W%4=2": (64, 98, 300, 0), "W%4=3": (67, 99, 300, 0),
              "base+1": (64, 97, 300, 1), "base+2": (64, 98, 300, 2),
              "base+3": (64, 99, 300, 3)}
    return {f"{name} {h}x{w}": (at_offset(rng.integers(0, 256, (h, w), np.uint8), off, dev),
                                *keypoints(h, w, k))
            for name, (h, w, k, off) in shapes.items()}


def k3c_edge_cases(dev) -> dict:
    """K3c's edge inputs (rows, psi, phi), seeded random row words: K = 1,
    K = 5 (not a whole block), K = 8192, every phi 0 and every phi 224 (the
    first and the last window of a strip), each psi alone, and the rows as a
    view that starts 4 bytes into a buffer (4-byte, not 16-byte aligned)."""
    rng = np.random.default_rng(17)

    def case(k, psi=None, phi=None, offset=0):
        words = rng.integers(0, 2**32, (k, 9 * 256), dtype=np.uint32).view(np.uint8)
        rows = at_offset(words.reshape(k, -1), offset, dev).view(torch.int32).view(k, 9, 256)
        psi = rng.integers(0, 4, k) if psi is None else np.full(k, psi)
        phi = rng.integers(0, 225, k) if phi is None else np.full(k, phi)
        return (rows, torch.as_tensor(psi.astype(np.int32), device=dev),
                torch.as_tensor(phi.astype(np.int32), device=dev))

    return {"K=1": case(1), "K=5": case(5), "K=8192": case(8192),
            "phi=0": case(300, phi=0), "phi=224": case(300, phi=224),
            **{f"psi={s}": case(300, psi=s) for s in range(4)},
            "rows +4 bytes": case(300, offset=4)}


def k4_edge_cases(dev) -> dict:
    """K4's edge inputs (windows, idx0, idx1, mom_w, words): seeded windows
    at 1 to 8 words, K = 1 and K = 8192, one window repeated 2048 times
    (every keypoint in one bin), windows of all -128 and all 127, windows
    whose base lies 1 and 4 bytes into a buffer (the byte path, and word
    loads off a 16-byte boundary), and the tables 2 bytes (idx0, idx1) and 1
    byte (mom_w) into theirs (the tables read through L1, the weights byte
    by byte)."""
    from pislam_tpu_torch.ops import brief
    rng = np.random.default_rng(16)
    tables = brief.OrbTables.build(dev)

    def windows(k):
        return rng.integers(-128, 128, (k, 1024)).astype(np.int8)

    def offset(t, nbytes):
        return at_offset(t.cpu().numpy().view(np.uint8), nbytes, dev).view(t.dtype)

    cases = {f"words={n}": (at_offset(windows(700), 0, dev), *tables, n)
             for n in range(1, 9)}
    for name, flat in {"K=1": windows(1), "K=8192": windows(8192),
                       "one bin 2048": np.repeat(windows(1), 2048, 0),
                       "all -128": np.full((64, 1024), -128, np.int8),
                       "all 127": np.full((64, 1024), 127, np.int8)}.items():
        cases[name] = (at_offset(flat, 0, dev), *tables, 8)
    for off in (1, 4):
        cases[f"base +{off}"] = (at_offset(windows(700), off, dev), *tables, 8)
    cases["tables +2, mom_w +1"] = (at_offset(windows(700), 0, dev), offset(tables.idx0, 2),
                                    offset(tables.idx1, 2), offset(tables.mom_w, 1), 8)
    return cases


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


def _k5_ties(args, plan) -> tuple[bool, bool]:
    """Whether some column's least distance is reached by rows of two row
    tiles of the plan, and some row's by columns of two segments."""
    from pislam_tpu_torch import matching
    dist = matching.hamming_matrix(*args[:4])
    if len(args) == 7:
        dist = matching.gate(dist, *args[4:])
    k1, k2 = dist.shape
    tile = (torch.arange(k1, device=dist.device) // plan.rows)[:, None].expand(k1, k2)
    seg = (torch.arange(k2, device=dist.device)
           // (plan.tiles_per_segment * 128))[None, :].expand(k1, k2)
    at_col = dist == dist.amin(0, keepdim=True)
    at_row = dist == dist.amin(1, keepdim=True)
    big = 1 << 30
    col_tie = (torch.where(at_col, tile, -1).amax(0) != torch.where(at_col, tile, big).amin(0))
    row_tie = (torch.where(at_row, seg, -1).amax(1) != torch.where(at_row, seg, big).amin(1))
    col_ok = dist.amin(0) < matching.MAX_DIST
    row_ok = dist.amin(1) < matching.MAX_DIST
    return bool((col_tie & col_ok).any()), bool((row_tie & row_ok).any())


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
        # map tracking: slam_config's 8192 landmarks
        "512x8192 gated": _k5_inputs(e0, ev0, ed2[:8192], ev2[:8192], rng, p0, puv2[:8192]),
        "512x16384 gated": _k5_inputs(e0, ev0, ed2, ev2, rng, p0, puv2),
    }
    err = 0
    on_card = {}

    def check(name, args):
        nonlocal err
        got = kernels.match_reduce(*args)
        want = kernels.match_reduce_plain(*args)
        for part, g, w in zip(("best", "second", "idx", "col_argmin"), got, want):
            err = max(err, require_equal(f"K5 {name} {part}", g, w))

    for name, args in cases.items():
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in args]
        if len(args) == 6:
            args.append(0.06)
        on_card[name] = args
        for k1 in (args[0].shape[0], args[0].shape[0] - 13):   # 13: no block multiple
            cut = [args[0][:k1], args[1], args[2][:k1], args[3]] + (
                [args[4][:k1], args[5], args[6]] if len(args) == 7 else [])
            check(f"{name} K1={k1}", cut)
        plan = kernels.match_plan(args[0].shape[0], args[1].shape[0],
                                  kernels.device_limits(dev)[0])
        col_tie, row_tie = _k5_ties(args, plan)
        # the ungated cases tie a column's least distance across two row tiles
        # and a row's across two segments (duplicated rows and descriptors)
        if len(args) == 4 and plan.row_tiles > 1 and plan.segments > 1 and not (
                col_tie and row_tie):
            raise AssertionError(f"K5 {name}: no tie across row tiles and segments")
        print(f"K5 {name}: plan {plan.warpgroups} warpgroup(s) x {plan.row_tiles} row tiles "
              f"x {plan.segments} segments of {plan.tiles_per_segment} tiles = {plan.ctas} "
              f"CTAs; a column tied across row tiles: {col_tie}, a row across segments: "
              f"{row_tie}")

    def words(args, w):
        return [args[0][:, :w].contiguous(), args[1][:, :w].contiguous(), *args[2:]]

    edges = {
        "512x512 K1=65": [a[:65] if i in (0, 2) else a for i, a in enumerate(on_card["512x512"])],
        "512x512 K1=127": [a[:127] if i in (0, 2) else a
                           for i, a in enumerate(on_card["512x512"])],
        "2048x16384 K2=16307": [a[:16307] if i in (1, 3) else a
                                for i, a in enumerate(on_card["2048x16384"])],
        "512x512 words=1": words(on_card["512x512"], 1),
        "2048x2048 words=4": words(on_card["2048x2048"], 4),
        "512x8192 gated words=4": words(on_card["512x8192 gated"], 4),
    }
    for name, args in edges.items():
        check(name, args)

    # more query rows than one launch takes: a launch per 65,536 rows, merged;
    # rows 1 and K1 - 1 (in the second launch) tie in several columns
    d1, v1 = _tile_database(g0, gv0, 70_000, rng)
    for k1 in (65_537, 70_000):
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in _k5_inputs(d1[:k1], v1[:k1], g0, gv0, rng)]
        before = kernels.match_reduce.launches
        check(f"{k1}x2048", args)
        if kernels.match_reduce.launches - before != 2:
            raise AssertionError(f"K5 {k1}x2048: {kernels.match_reduce.launches - before} "
                                 "launches, expected 2")
        edges[f"{k1}x2048 (2 launches)"] = args

    # two streams at once: the wrapper keeps a merge state per stream
    a, b = on_card["2048x16384"], on_card["512x16384 gated"]
    streams = (torch.cuda.Stream(dev), torch.cuda.Stream(dev))
    torch.cuda.synchronize(dev)
    got = []
    for _ in range(4):
        for stream, args in zip(streams, (a, b)):
            with torch.cuda.stream(stream):
                got.append((args, kernels.match_reduce(*args)))
    torch.cuda.synchronize(dev)
    for i, (args, out) in enumerate(got):
        for part, g, w in zip(("best", "second", "idx", "col_argmin"), out,
                              kernels.match_reduce_plain(*args)):
            err = max(err, require_equal(f"K5 two streams call {i} {part}", g, w))
    print(f"phase kernels: ok, K5 bit-exact (tolerance 0) at {', '.join(cases)}, "
          f"each also with K1 - 13, at {', '.join(edges)}, and on two streams at once")
    return err, on_card


# frames larger than VGA at the default config: their pyramids' keys do not
# fit the K2 cluster's shared memory
K2_FRAMES = {"kitti": (1241, 376), "720p": (1280, 720)}


def topk_large_phase(dev):
    """K1 and K2 at the default config's pyramids of KITTI and 720p frames
    (a seeded random frame): K1 under the plan's tile and each tile, K2 on
    K1's keys at k = 512, 2048 (the default) and 8192, and with fewer
    survivors than k, each bit-exact against its plain version. Returns K1's
    and K2's max |error| and, per frame, K1's inputs and K2's keys, default
    k and pyramid shape, for the times of phase 8."""
    import pislam_tpu_torch as pt
    from pislam_tpu_torch.ops import kernels, nms
    from pislam_tpu_torch.ops.pyramid import build_pyramid

    err, k1_err, cases, k1_cases = 0, 0, {}, {}
    for label, (w, h) in K2_FRAMES.items():
        cfg = pt.PislamConfig(pyramid=pt.PyramidConfig(base_width=w, base_height=h))
        fc = cfg.frontend
        frame = np.random.default_rng(w).integers(0, 256, (h, w), np.uint8)
        pyr = build_pyramid(torch.from_numpy(frame).to(dev), cfg.pyramid)
        mask = pt.make_extract_fn(cfg, dev).level_mask.view(torch.uint8)
        k1_cases[label] = (pyr, mask, fc.fast_threshold, fc.harris_threshold)
        grid, e1 = k1_check(label, k1_cases[label])
        k1_err = max(k1_err, e1)
        keys = (grid.reshape(-1) ^ nms.INT32_MIN).contiguous()
        k = fc.max_keypoints
        few = keys.clone()
        few[few.argsort(descending=True)[k // 3:]] = nms.INT32_MIN
        for name, (kk, kn) in {"k=512": (keys, 512), f"k={k}": (keys, k),
                               f"k={kernels.MAX_TOPK}": (keys, kernels.MAX_TOPK),
                               "few": (few, k)}.items():
            err = max(err, require_equal(f"K2 {label} {name}", kernels.topk_keys(kk, kn),
                                         kernels.topk_keys_plain(kk, kn)))
        cases[label] = (keys, k, tuple(pyr.shape))
    print(f"phase kernels: ok, K1 (the plan's tile and each of {kernels.FRONTEND_TILES}) and "
          f"K2 bit-exact (tolerance 0) at the {' and '.join(K2_FRAMES)} pyramids, K2 at "
          f"k = 512, 2048, 8192 and fewer survivors than k")
    return err, k1_err, cases, k1_cases


def topk_large_times(dev, cases, card):
    """K2's times at the KITTI and 720p pyramids, beside torch.topk's."""
    from pislam_tpu_torch.ops import kernels, nms

    for label, (keys, k, shape) in cases.items():
        plan = kernels.topk_plan(keys.numel(), k, kernels.device_limits(dev)[1])
        b_ms, b_by = bound_ms(keys.numel() * 4 + k * 4, (4 * keys.numel(), SCALAR_OPS_S))
        d_us, d_n = device_us(lambda: kernels.topk_keys(keys, k))
        print(f"time kernel topk_keys at {label} ({shape}, {keys.numel()} keys, "
              f"{int((keys != nms.INT32_MIN).sum())} nonzero, k={k}, keys in "
              f"{'shared' if plan.chunk else 'device'} memory): "
              f"{time_ms(lambda: kernels.topk_keys(keys, k)):.4f} ms (device {d_us:.2f} us, "
              f"{d_n:g} device kernels per call), plain "
              f"{time_ms(lambda: kernels.topk_keys_plain(keys, k)):.4f} ms, library "
              f"{time_ms(lambda: torch.topk(keys, k)):.4f} ms, bound {b_ms * 1e3:.3f} us "
              f"({b_by}) [{card}]")


def sass_igmma(lib) -> str:
    """How many int8 wgmma (IGMMA) instructions the library's SASS holds, as
    cuobjdump shows it, or why that was not checked."""
    from pislam_tpu_torch.ops import _build
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return "not checked (no cuobjdump)"
    out = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                         timeout=300)
    n = sum("IGMMA" in line for line in out.stdout.splitlines())
    return f"{n} IGMMA instructions (cuobjdump -sass)"


def k5_bound(args) -> tuple[float, str]:
    (k1, w), k2 = args[0].shape, args[1].shape[0]
    nbytes = (k1 + k2) * w * 4 + k1 + k2 + (3 * k1 + k2) * 4
    if len(args) == 7:
        nbytes += (k1 + k2) * 8
    return bound_ms(nbytes, (2 * k1 * k2 * w * 32, INT8_OPS_S))


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
    for name, n in launches.items():
        want = n_frames if name in FUSED_PATH_KERNELS and name != "match_reduce" else 0
        if n != want:
            raise AssertionError(f"{name}: {n} launches for {n_frames} frames, expected {want}")

    for label, cfg in cfgs.items():
        counts = []
        cpu_extract = pt.make_extract_fn(cfg, "cpu")
        fc = cfg.frontend
        mask = extract[label].level_mask.view(torch.uint8)
        for i, (pyr, feats) in enumerate(results[label]):
            if not features_equal(feats, plain[label](pyr)):
                raise AssertionError(f"{label} frame {i}: kernels != plain path on card")
            k1_check(f"{label} frame {i}", (pyr, mask, fc.fast_threshold, fc.harris_threshold))
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
              f"(card; K1 also under each tile), first {CPU_FRAMES} vs plain (CPU); "
              f"features per frame "
              f"min {min(counts)} mean {statistics.mean(counts):.1f} max {max(counts)}")
    print(f"phase extraction path launches: {json.dumps(launches)}")
    return extract, results


def extraction_variants(dev, cfgs, results):
    """The frontend's other configurations on the same frames, each a path of
    its own (counts set to 0 before it, read after): unfused (plain
    FAST/Harris/NMS, then K6, K2 and orb_describe) and dense BRIEF (K1, K2,
    then orb_describe_dense), each bit-exact against the default path's Features;
    bucketing with an odd border (unfused, so K6) against its own plain
    path. Every kernel's launches per frame are exact. Returns the launch
    counts per variant."""
    import pislam_tpu_torch as pt
    from pislam_tpu_torch.ops import kernels

    unfused = ("reduce_codes_4x", "topk_keys", "orb_describe")
    variants = {
        "unfused": (dict(fused_upstream=False), unfused),
        "dense BRIEF": (dict(brief_variant="dense"),
                        ("fused_frontend_codes", "topk_keys", "orb_describe_dense")),
        "odd-border bucketing": (dict(log_bucket_size=4, bucket_limit=3, border=17), unfused),
    }
    out = {}
    for vname, (change, runs) in variants.items():
        made = {label: dataclasses.replace(cfg, frontend=dataclasses.replace(
            cfg.frontend, **change)) for label, cfg in cfgs.items()}
        extract = {label: pt.make_extract_fn(c, dev) for label, c in made.items()}
        kernels.reset_launch_counts()
        feats = {label: [extract[label](pyr) for pyr, _ in results[label]] for label in cfgs}
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        n = sum(len(f) for f in feats.values())
        wrong = {k: c for k, c in launches.items() if c != (n if k in runs else 0)}
        if wrong:
            raise AssertionError(f"{vname}: launches {wrong} for {n} frames; expected "
                                 f"{n} of {runs} and none of the others")
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
    for name, n in launches.items():
        want = ((n_trans if name == "match_reduce" else n_frames)
                if name in FUSED_PATH_KERNELS else 0)
        if n != want:
            raise AssertionError(f"{name}: {n} launches on the VO path over {n_frames} "
                                 f"frames, expected {want}")

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


def dense_vo(dev, seqs, vo_outs):
    """make_vo_scan with brief_variant="dense" over eval_seq, the same draws
    as phase 5's run: K1, K2 and orb_describe_dense once per frame, K5 once
    per transition, nothing else; every output equal to the default path's
    bit for bit (the dense variant's Features are the sorted path's)."""
    import pislam_tpu_torch as pt
    from pislam_tpu_torch.ops import kernels

    cfg = vo_config()
    cfg = dataclasses.replace(cfg, frontend=dataclasses.replace(cfg.frontend,
                                                                brief_variant="dense"))
    frames, intr, _ = seqs["eval_seq"]
    kernels.reset_launch_counts()
    out = pt.make_vo_scan(cfg, *intr, device=dev)(
        frames, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    n = len(frames)
    runs = {"fused_frontend_codes": n, "topk_keys": n, "orb_describe_dense": n,
            "match_reduce": n - 1}
    wrong = {k: c for k, c in launches.items() if c != runs.get(k, 0)}
    if wrong:
        raise AssertionError(f"dense VO: launches {wrong}, expected {runs} and no others")
    want = vo_outs["eval_seq"]
    differ = [k for k in want if not torch.equal(out[k].cpu(), want[k].cpu())]
    if differ:
        raise AssertionError(f"dense VO eval_seq: {differ} differ from the default path")
    print(f"phase VO dense BRIEF eval_seq: {n} frames, every output ({', '.join(want)}) "
          f"bit-identical to the default path's; launches {json.dumps(launches)}")


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
    for label, fns in (("K1, K2, orb_describe and K5", HOPPER_KERNEL_FUNCTIONS),
                       ("K5", ("match_wgmma_kernel",))):
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


def count_plain(*names):
    """Counts calls of the named kernels' plain versions (the CPU's calls of
    K5 and of motion-only BA), by name."""
    from pislam_tpu_torch.ops import kernels
    by_name = {k.__name__: k for k in kernels.COUNTED}
    calls, saved = dict.fromkeys(names, 0), {n: by_name[n].plain for n in names}

    def counting(name):
        def call(*args):
            calls[name] += 1
            return saved[name](*args)
        return call

    for n in names:
        by_name[n].plain = counting(n)
    return calls, lambda: [setattr(by_name[n], "plain", p) for n, p in saved.items()]


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
    (mismatches, the CPU's K5 and motion-only BA calls by name, its closure,
    max |keyframe position diff|); costs and positions come out of global BA
    and are printed, not held (ba_audit holds BA's arithmetic)."""
    adopt(cpu, snap)
    draws.queue = [d.cpu() for d in draws.log[first_draw:]]
    calls, restore = count_plain("match_reduce", "motion_only_ba")
    try:
        got = cpu.close_loop(min_matches=40, exclude_recent=3)
    finally:
        restore()
    bad = [f"{k} {got[k]} vs card {want[k]}" for k in ("loop", "used_graph")
           if got[k] != want[k]]
    d_pos = float(np.abs(cpu.keyframe_positions() - want_post).max())
    return bad, calls, got, d_pos


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


def decision(out) -> tuple:
    """A SLAM frame's decisions: keyframe, RANSAC inliers, map inliers, lost."""
    return (bool(out["keyframe"]), int(out["num_inliers"]), int(out["map_inliers"]),
            bool(out["lost"]))


def slam_path(dev, seqs, card):
    """KeyframeSLAM over every sequence at full length, then close_loop: the
    port's main path. Every launch count is exact: K1, K2 and orb_describe
    once per frame (K3 and K4 never), K5
    once per tracked frame and once more per map-tracked frame (Metrics),
    motion-only BA once per map-tracked frame and as often as the
    relocalisations launch it, and in each closure K5 and motion-only BA as
    often as the CPU calls their plain versions on the same closure. Then
    the CPU replays the run step by step: every frame from the card's state
    before it with the card's RANSAC draws
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
            reloc = Wrap(slam, "_relocalise_feats").launches
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
            n_pnp = stages.get("calls.map_track", 0) + reloc.get("motion_only_ba", 0)
            want = {k: len(frames) for k in FUSED_PATH_KERNELS} | {"match_reduce": n_k5,
                                                                   "motion_only_ba": n_pnp}
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
            bad, cpu_calls, cpu_closure, d_pos = closure_against_cpu(
                cpu, draws, snaps[-1], first[-1], closure, post)
            bad += [f"{k} launched {n} times in close_loop" for k, n in close_launches.items()
                    if n != cpu_calls.get(k, 0)]
            bad_ba, worst, backward, n_ba = ba_audit(bas.calls)
            bad_graph, d_graph = pose_graph_audit(graphs)
            t_cpu = time.perf_counter() - t0
            bad += bad_ba + bad_graph
            failures += [f"{name} card vs CPU {b}" for b in bad_steps + bad]
            print(f"phase SLAM {name} card vs CPU: {len(frames)} steps from the card's state "
                  f"with its draws, {len(bad_steps)} mismatching (decisions, counters, RANSAC "
                  f"calls; frame poses within {d_pose:.3g}, tolerance {SLAM_POSE_TOL}; inliers "
                  f"within {d_inl}, tolerance {INLIER_TOL}); close_loop: loop, branch, "
                  f"{cpu_calls['match_reduce']} K5 and {cpu_calls['motion_only_ba']} motion-only "
                  f"BA calls {'identical' if not bad else 'DIFFER'}; {n_ba} BAs' first "
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
                         "decisions": [decision(o) for o in outs], "traj": traj, "post": post,
                         "state": slam.state, "counters": slam.state.counters.cpu(),
                         "k5": track_launches["match_reduce"] + close_launches["match_reduce"],
                         "pnp": (track_launches["motion_only_ba"]
                                 + close_launches["motion_only_ba"]),
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
    # per frame K6, K2 and orb_describe, and no other kernel but K5 and
    # motion-only BA (whose counts the tracking decides)
    per_frame = ("reduce_codes_4x", "topk_keys", "orb_describe")
    if any(n != (len(frames) if k in per_frame else 0)
           for k, n in launches.items() if k not in ("match_reduce", "motion_only_ba")):
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
# phase 7: the chunk path
# ---------------------------------------------------------------------------

CHUNK = 8
# tests/test_slam_scan.py's rule for chunked tracking: chunk-8 ATE below
# max(2.5 x the per-frame path's, 0.15); its trajectory tolerance between
# chunk 1 and the per-frame loop
CHUNK_ATE_FACTOR, CHUNK_ATE_FLOOR = 2.5, 0.15
CHUNK_POSE_TOL = 5e-2
# the service's maintenance test (tests/test_service.py): small tables,
# housekeeping every 2 inserts, 256 landmark slots kept free
MAINT_LANDMARKS, MAINT_OBS, MAINT_EVERY, MAINT_MIN_FREE = 768, 3072, 2, 256
MAINT_FRAMES = 112           # session A: eval_seq4 frames 0-111
MERGE_FROM = 96              # session B: eval_seq4 frames 96-223, seed 99
# card against CPU from one state: housekeeping floats (copies and
# permutations) within this; merged poses and landmarks, which come through
# relocalisation (SVD refits, motion-only BA), within it relative to size
MAINT_TOL = 1e-4
HOMOG_TOL = 1e-4


def run_chunks(slam, frames, chunk=CHUNK):
    outs = [slam.process_chunk(frames[i:i + chunk]) for i in range(0, len(frames), chunk)]
    return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}


class Wrap:
    """Stands in for the function ``name`` of ``owner`` (an object; a class,
    for every instance; or a module): counts its calls and the kernel launches made
    inside them, sums their host time (to a synchronize with ``sync``) and
    keeps their results with ``keep``."""

    def __init__(self, owner, name, keep=False, sync=False):
        from pislam_tpu_torch.ops import kernels
        self.owner, self.name, self.fn = owner, name, getattr(owner, name)
        self.calls, self.seconds, self.launches, self.results = 0, 0.0, {}, []
        fn = self.fn

        def wrapped(*args, **kw):
            before, t0 = kernels.launch_counts(), time.perf_counter()
            try:
                out = fn(*args, **kw)
            finally:
                if sync:
                    torch.cuda.synchronize()
                self.seconds += time.perf_counter() - t0
                self.calls += 1
                for k, n in kernels.launch_counts().items():
                    self.launches[k] = self.launches.get(k, 0) + n - before[k]
            if keep:
                self.results.append(out)
            return out

        setattr(owner, name, wrapped)

    def restore(self):
        setattr(self.owner, self.name, self.fn)


def chunk_path(dev, seqs, card, slam_res):
    """process_chunk(8) over every sequence at full length, the slice's main
    path. Launches are exact: K1, K2 and orb_describe once per frame plus
    once per chunk that ends lost (its last frame is extracted again to
    relocalise); K5 twice per tracked frame (the keyframe match, ungated,
    and map tracking, gated, which the scan runs on every tracked frame
    and selects on the device) plus what the boundary relocalisations
    launch; motion-only BA once per tracked frame (map tracking) plus the
    relocalisations'; every other kernel never. ATE held to the per-frame
    path's of phase 6 (tests/test_slam_scan.py's rule); ms/frame on the host clock to
    a synchronize, beside phase 6's. Returns the launches, and each
    sequence's ms/frame and ATE."""
    from pislam_tpu_torch import evaluation
    from pislam_tpu_torch.ops import kernels
    from pislam_tpu_torch.utils.metrics import Metrics

    cfg = slam_config()
    on_card = {name: torch.as_tensor(frames).to(dev) for name, (frames, _, _) in seqs.items()}
    run_chunks(make_slam(cfg, seqs["eval_seq"][1], dev), on_card["eval_seq"][:2 * CHUNK])
    torch.cuda.synchronize()                                     # warm-up
    launches, failures, results = {k.__name__: 0 for k in kernels.COUNTED}, [], {}
    for name, (frames, intr, gt) in seqs.items():
        metrics = Metrics(sink=lambda line: None)
        slam = make_slam(cfg, intr, dev, metrics)
        reloc = Wrap(slam, "_relocalise_feats").launches
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = run_chunks(slam, on_card[name])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = kernels.launch_counts()
        extra = metrics.snapshot().get("calls.relocalise", 0)
        want = {k: len(frames) + extra for k in FUSED_PATH_KERNELS}
        want["match_reduce"] = 2 * (len(frames) - 1) + reloc.get("match_reduce", 0)
        want["motion_only_ba"] = len(frames) - 1 + reloc.get("motion_only_ba", 0)
        for k, n in got.items():
            launches[k] += n
            if n != want.get(k, 0):
                failures.append(f"{name}: {k} launched {n} times, expected {want.get(k, 0)}")
        traj = np.stack(slam.trajectory)
        if not np.isfinite(traj).all() or traj.shape != (len(frames), 3):
            failures.append(f"{name}: trajectory not finite or of wrong shape")
            continue
        ate = evaluation.ate_rmse(traj, gt)
        per_frame = slam_res[name]["ates"]["slam_ate"]
        limit = max(CHUNK_ATE_FACTOR * per_frame, CHUNK_ATE_FLOOR)
        if not ate < limit:
            failures.append(f"{name}: chunk-{CHUNK} ATE {ate:.4f}, limit {limit:.4f}")
        print(f"phase chunk {name}: {len(frames)} frames in chunks of {CHUNK}, "
              f"{len(slam.keyframe_frames)} keyframes ({slam.keyframes_inserted} inserted), "
              f"ATE {ate:.4f} (per-frame path {per_frame:.4f}, limit {limit:.4f}); "
              f"{int(out['keyframe'].sum())} in-scan keyframe decisions, lost at a chunk's "
              f"end {slam.frames_lost}, relocalisations {slam.relocalisations}")
        r = slam_res[name]
        results[name] = {"ms": wall / len(frames) * 1e3, "ate": ate}
        print(f"time chunk {name}: {wall / len(frames) * 1e3:.4f} ms/frame in chunks of "
              f"{CHUNK} (host clock to synchronize; the per-frame path of phase 6 "
              f"{r['t_track'] / r['frames'] * 1e3:.4f}) [{card}]")
    if failures:
        raise AssertionError(f"chunk path: {len(failures)} failures: " + "; ".join(failures))
    print(f"phase chunk path launches: {json.dumps(launches)}")
    return launches, results


def _huber_off(cfg, **vo):
    return dataclasses.replace(cfg, ba=dataclasses.replace(cfg.ba, huber=0.0),
                               vo=dataclasses.replace(cfg.vo, **vo))


def chunk1_vs_process(dev, seqs, card):
    """Chunk 1 against process on the card: eval_seq, Huber off (ROADMAP
    R3), generator seed 7, with the E/H bootstrap off and on. Step by step,
    as phase 6 holds the CPU to the card: chunk 1 from process's state before
    each frame, with the draws process made for it, takes the same keyframe
    decision with the same RANSAC inliers and counters after it, map inliers
    within INLIER_TOL and the pose within CHUNK_POSE_TOL. The two run free
    are compared as well and printed, not held: process chains the frame's
    pose on the host in numpy, the scan on the card, whose float32 products
    round apart, and the gated matches and windowed BA turn that into
    different maps (ROADMAP F1)."""
    from pislam_tpu_torch.geometry import ransac

    frames, intr, _ = seqs["eval_seq"]
    on_card = torch.as_tensor(frames).to(dev)
    draws = Draws(ransac.sample_indices)
    ransac.sample_indices = draws
    try:
        for flag in (False, True):
            cfg = _huber_off(slam_config(), bootstrap_model_select=flag)
            loop = make_slam(cfg, intr, dev)
            draws.log, draws.queue = [], None
            snaps, first, infos = [], [], []
            for f in on_card:
                snaps.append(snapshot(loop))
                first.append(len(draws.log))
                infos.append(loop.process(f))
            snaps.append(snapshot(loop))
            first.append(len(draws.log))
            scan = make_slam(cfg, intr, dev)
            bad, d_map, d_pose = [], 0, 0.0
            for i, f in enumerate(on_card):
                state, prev_pose, culled = snaps[i]
                scan.set_state(state)
                scan._prev_pose, scan._culled_slots = prev_pose, set(culled)
                draws.queue = draws.log[first[i]:first[i + 1]]
                got = scan.process_chunk(f[None])
                want = infos[i]
                if draws.queue or bool(got["keyframe"][0]) != want["keyframe"] or \
                        int(got["num_inliers"][0]) != want["num_inliers"] or \
                        not torch.equal(scan.state.counters, snaps[i + 1][0].counters):
                    bad.append(i)
                d_map = max(d_map, abs(int(got["map_inliers"][0]) - want["map_inliers"]))
                d_pose = max(d_pose, *(float(np.abs(got[k][0] - want[k]).max())
                                       for k in ("pose_R", "pose_t")))
            draws.queue = None
            if bad or d_map > INLIER_TOL or d_pose > CHUNK_POSE_TOL:
                raise AssertionError(f"chunk 1 vs process (bootstrap_model_select={flag}): "
                                     f"frames {bad[:10]} differ, map inliers by {d_map}, "
                                     f"poses by {d_pose:.3g}")
            free = make_slam(cfg, intr, dev)
            steps = [free.process_chunk(f[None]) for f in on_card]
            parted = [i for i, (o, w) in enumerate(zip(steps, infos))
                      if bool(o["keyframe"][0]) != w["keyframe"]
                      or int(o["map_inliers"][0]) != w["map_inliers"]]
            print(f"phase chunk 1 vs process eval_seq (bootstrap_model_select={flag}, huber "
                  f"0): {len(frames)} steps from process's state with its draws, decisions, "
                  f"RANSAC inliers and counters identical, map inliers within {d_map}, poses "
                  f"within {d_pose:.3g} (tolerances {INLIER_TOL}, {CHUNK_POSE_TOL}); run free "
                  f"(not held) keyframes "
                  f"{'equal' if free.keyframe_frames == loop.keyframe_frames else 'differ'}, "
                  f"first frame whose decision or map inliers differ "
                  f"{parted[0] if parted else 'none'}")
    finally:
        ransac.sample_indices = draws.draw


def chunk_syncs(dev, seqs, card):
    """The synchronizing calls of one chunk of CHUNK eval_seq frames (the
    second chunk: tracking, map tracking, inserts) from
    torch.cuda.set_sync_debug_mode, inside the scan's frame loop and in the
    whole process_chunk (its readback, BA), each by the line that made it."""
    frames, intr, _ = seqs["eval_seq"]
    on_card = torch.as_tensor(frames[:2 * CHUNK]).to(dev)
    slam = make_slam(slam_config(), intr, dev)
    slam.process_chunk(on_card[:CHUNK])
    scan, inside = slam._chunk_scan, []

    def watched(*args):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = scan(*args)
        inside.extend(caught)
        return out

    slam._chunk_scan = watched
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            slam.process_chunk(on_card[CHUNK:])
        finally:
            torch.cuda.set_sync_debug_mode(0)
    caught = inside + caught

    def sites(ws):
        out = {}
        for w in ws:
            path = Path(w.filename).resolve()
            key = f"{path.relative_to(ROOT) if path.is_relative_to(ROOT) else path}:{w.lineno}"
            out[key] = out.get(key, 0) + 1
        return dict(sorted(out.items()))

    print(f"sync: one chunk of {CHUNK} eval_seq frames makes {len(caught)} synchronizing calls "
          f"({len(caught) / CHUNK:.1f} per frame), {len(inside)} inside the scan's frame loop "
          f"({len(inside) / CHUNK:.1f} per frame); the per-frame path's are on the "
          f"'sync: SLAM' line")
    print(f"sync: inside the frame loop, by line: {json.dumps(sites(inside))}")
    print(f"sync: the chunk's readback and BA, by line: "
          f"{json.dumps(sites(caught[len(inside):]))}")


def homography_vs_cpu(dev, seqs, card):
    """The E/H bootstrap on the card against the port's CPU from the same
    inputs and draws: every eval_seq frame tracked against the bootstrap
    keyframe alone (frames 1-3), select_model and ransac_homography; R, t
    within HOMOG_TOL, H up to sign within HOMOG_TOL, the same inliers,
    used_homography and ambiguous."""
    from pislam_tpu_torch import matching
    from pislam_tpu_torch.geometry import homography, ransac

    frames, intr, _ = seqs["eval_seq"]
    cfg = slam_config()
    vc, mc = cfg.vo, cfg.matcher
    slam = make_slam(dataclasses.replace(cfg, vo=dataclasses.replace(
        vc, bootstrap_model_select=True)), intr, dev)
    slam.process(frames[0])
    last = slam._last
    worst, used = 0.0, []
    for i in range(1, 4):
        feats, pts = slam._features(frames[i])
        idx2, _ = matching.match(last["desc"], feats.descriptors, last["valid"],
                                 feats.valid, max_distance=mc.max_distance, ratio=mc.ratio,
                                 cross_check=mc.cross_check)
        ok = idx2 >= 0
        p2 = pts[torch.clamp(idx2, min=0).long()]
        gen = torch.Generator(device=dev).manual_seed(i)
        idx_e = ransac.sample_indices(ok, vc.ransac_iters, 8, gen)
        idx_h = ransac.sample_indices(ok, vc.ransac_iters, 4, gen)
        outs = []
        for d in (dev, "cpu"):
            args = [x.to(d) for x in (last["pts"], p2, ok)]
            sel = homography.select_model(*args, iters=vc.ransac_iters,
                                          e_threshold=vc.inlier_threshold,
                                          h_threshold=vc.inlier_threshold,
                                          idx_e=idx_e.to(d), idx_h=idx_h.to(d))
            oh = homography.ransac_homography(*args, iters=vc.ransac_iters,
                                              inlier_threshold=vc.inlier_threshold,
                                              idx=idx_h.to(d))
            outs.append((sel, oh))
        (sel, oh), (sel_c, oh_c) = outs
        for a, b in ((sel, sel_c), (oh, oh_c)):
            for k in ("inliers", "num_inliers", "used_homography", "ambiguous"):
                if k in a and not torch.equal(a[k].cpu(), b[k]):
                    raise AssertionError(f"homography frame {i}: {k} differs card vs CPU")
            for k in ("R", "t", "R2", "t2"):
                worst = max(worst, float((a[k].cpu() - b[k]).abs().max()))
        h, h_c = oh["H"].cpu(), oh_c["H"]
        sign = 1.0 if float((h * h_c).sum()) >= 0 else -1.0
        worst = max(worst, float((sign * h - h_c).abs().max()))
        if worst > HOMOG_TOL:
            raise AssertionError(f"homography frame {i}: card vs CPU differ by {worst:.3g}")
        used.append(bool(sel["used_homography"]))
    print(f"phase chunk homography bootstrap eval_seq frames 1-3: card vs CPU from the same "
          f"inputs and draws, inliers, used_homography {used} and ambiguous identical; R, t "
          f"and H (up to sign) within {worst:.3g} (tolerance {HOMOG_TOL})")


def _states_differ(a, b, rel=False):
    """Integer tables of two states that differ, and the largest float
    difference (relative to size with ``rel``)."""
    bad, worst = [], 0.0
    for tname in ("store", "lmap", "obs"):
        ta, tb = getattr(a, tname), getattr(b, tname)
        for field, x, y in zip(ta._fields, ta, tb):
            x, y = x.cpu(), y.cpu()
            if x.is_floating_point():
                d = (x - y).abs() / (torch.clamp(y.abs(), min=1.0) if rel else 1.0)
                worst = max(worst, float(d.max()) if d.numel() else 0.0)
            elif not torch.equal(x, y):
                bad.append(f"{tname}.{field}")
    if not torch.equal(a.counters.cpu(), b.counters.cpu()):
        bad.append("counters")
    return bad, worst


def log_counts(slam):
    """Wraps a KeyframeSLAM's RANSAC and map-tracking calls; ``pop()`` on the
    returned object gives (RANSAC inliers, map inliers) summed over the
    calls since the last pop (0 for a call not made)."""
    log = {"_localise_against": [], "_track_map": []}
    for name, pick in (("_localise_against", lambda out: int(out[0]["num_inliers"])),
                       ("_track_map", lambda out: int(out[2]))):
        def logging(*args, _fn=getattr(slam, name), _log=log[name], _pick=pick, **kw):
            out = _fn(*args, **kw)
            _log.append(_pick(out))
            return out
        setattr(slam, name, logging)

    class Counts:
        def pop(self):
            out = tuple(sum(v) for v in log.values())
            for v in log.values():
                v.clear()
            return out

    return Counts()


def maintenance_and_merge(dev, seqs, card):
    """The service's long-session housekeeping and a multi-session merge on
    the card, each operation replayed on the CPU from the card's state
    before it (with the card's RANSAC draws): eval_seq4 frames 0-111 in
    chunks of 8 at the small tables of tests/test_service.py, with
    cull_keyframes(max_cull=2), cull_landmarks, evict_stale_landmarks(256)
    and compact every 2 inserts (the eviction must fire); then frames
    96-223 as their own session (seed 99) merged into it. Equal integer
    tables and results, floats within MAINT_TOL; the merge's
    relocalisations each on the CPU (the same anchors, RANSAC inliers within
    INLIER_TOL), then the merge from the card's anchors (floats within
    MAINT_TOL of their size)."""
    import pislam_tpu_torch as pt
    from pislam_tpu_torch import evaluation
    from pislam_tpu_torch.geometry import ransac

    frames, intr, gt = seqs["eval_seq4"]
    on_card = torch.as_tensor(frames).to(dev)
    cfg = slam_config()
    cfg = dataclasses.replace(cfg, map=dataclasses.replace(
        cfg.map, max_landmarks=MAINT_LANDMARKS, max_obs=MAINT_OBS))
    ops = (("cull_keyframes", {"max_cull": 2}), ("cull_landmarks", {}),
           ("evict_stale_landmarks", {"min_free": MAINT_MIN_FREE}), ("compact", {}))
    cpu = pt.KeyframeSLAM(cfg, *intr, keyframe_min_inliers=60, keyframe_max_gap=3,
                          device="cpu")
    draws = Draws(ransac.sample_indices)
    ransac.sample_indices = draws
    try:
        a = make_slam(cfg, intr, dev)
        last, totals, worst, passes = 0, {name: 0 for name, _ in ops}, 0.0, 0
        for i in range(0, MAINT_FRAMES, CHUNK):
            a.process_chunk(on_card[i:i + CHUNK])
            if a.keyframes_inserted - last < MAINT_EVERY:
                continue
            last, passes = a.keyframes_inserted, passes + 1
            for name, kw in ops:
                snap = snapshot(a)
                got = getattr(a, name)(**kw)
                adopt(cpu, snap)
                want = getattr(cpu, name)(**kw)
                bad, d = _states_differ(a.state, cpu.state)
                worst = max(worst, d)
                if got != want or bad or d > MAINT_TOL or a._culled_slots != cpu._culled_slots:
                    raise AssertionError(f"{name} after frame {i + CHUNK - 1}: card {got}, CPU "
                                         f"{want}, tables {bad}, floats by {d:.3g}")
                if name == "cull_keyframes":
                    totals[name] += len(got)
                elif name != "compact":
                    totals[name] += got
        if totals["evict_stale_landmarks"] <= 0:
            raise AssertionError(f"the eviction never fired: {totals}")
        print(f"phase chunk housekeeping eval_seq4 frames 0-{MAINT_FRAMES - 1} (tables "
              f"{MAINT_LANDMARKS}/{MAINT_OBS}): {passes} passes every {MAINT_EVERY} inserts, "
              f"keyframes culled {totals['cull_keyframes']}, landmarks culled "
              f"{totals['cull_landmarks']}, evicted {totals['evict_stale_landmarks']}; "
              f"each operation on the CPU from the card's state: results and integer tables "
              f"identical, floats within {worst:.3g} (tolerance {MAINT_TOL})")

        b = pt.KeyframeSLAM(cfg, *intr, keyframe_min_inliers=60, keyframe_max_gap=3,
                            seed=99, device=dev)
        run_chunks(b, on_card[MERGE_FROM:])
        snap, first, base = snapshot(a), len(draws.log), a.keyframes_inserted
        relocs, counts = [], log_counts(a)
        reloc = a._relocalise_feats

        def logging(feats, pts, min_matches=30):
            rec = reloc(feats, pts, min_matches=min_matches)
            relocs.append((feats, pts, min_matches, rec, counts.pop()))
            return rec

        a._relocalise_feats = logging
        t0 = time.perf_counter()
        merged = a.merge_map(b.state)
        torch.cuda.synchronize()
        t_merge = time.perf_counter() - t0
        for name in ("_relocalise_feats", "_localise_against", "_track_map"):
            delattr(a, name)
        # each relocalisation of the other session's keyframes on the CPU
        # from the card's state and draws: the same anchors, against the same
        # keyframes, RANSAC inliers within INLIER_TOL. Their poses are read,
        # not held: B's first keyframes are A's own frames, so their
        # essential solve has no parallax and an arbitrary translation
        # direction (each SVD picks its own), which map tracking then starts
        # from
        adopt(cpu, snap)
        draws.queue = [d.cpu() for d in draws.log[first:]]
        cpu_counts = log_counts(cpu)
        bad, apart = [], []
        for i, (feats, pts, mm, rec, (n_inl, n_map)) in enumerate(relocs):
            got = cpu._relocalise_feats(type(feats)(*(x.cpu() for x in feats)), pts.cpu(),
                                        min_matches=mm)
            c_inl, c_map = cpu_counts.pop()
            if (got is None) != (rec is None) or (rec is not None and got[2] != rec[2]):
                bad.append(f"keyframe {i}: relocalised against {rec and rec[2]} on the card, "
                           f"{got and got[2]} on the CPU")
            elif rec is not None:
                if abs(n_inl - c_inl) > INLIER_TOL:
                    bad.append(f"keyframe {i}: RANSAC inliers {n_inl} card, {c_inl} CPU")
                d = max(float(np.abs(np.asarray(x) - np.asarray(y)).max())
                        for x, y in zip(got[:2], rec[:2]))
                if d > SLAM_POSE_TOL:
                    apart.append(f"{i}: {d:.2g}, inliers {n_inl}/{n_map} vs {c_inl}/{c_map}")
        for name in ("_localise_against", "_track_map"):
            delattr(cpu, name)
        if draws.queue:
            bad.append(f"{len(draws.queue)} RANSAC draws unused")
        # the merge itself on the CPU from the card's state and anchors
        adopt(cpu, snap)
        anchors = [r[3] for r in relocs]
        cpu._relocalise_feats = lambda *args, **kw: anchors.pop(0)
        want = cpu.merge_map(b.state)
        del cpu._relocalise_feats
        tables, d = _states_differ(a.state, cpu.state, rel=True)
        if merged != want or merged <= 0 or bad or tables or d > MAINT_TOL:
            raise AssertionError(f"merge_map: card {merged}, CPU {want}, {bad[:5]}, tables "
                                 f"{tables}, floats by {d:.3g}")
    finally:
        ransac.sample_indices = draws.draw
    views = a.keyframes
    kgt = gt[[v.frame if v.index < base else v.frame + MERGE_FROM for v in views]]
    ate = evaluation.ate_rmse(a.keyframe_positions(), kgt, with_scale=True)
    print(f"phase chunk merge eval_seq4 frames {MERGE_FROM}-{len(frames) - 1} (seed 99, "
          f"{b.num_keyframes} keyframes) into frames 0-{MAINT_FRAMES - 1}: {merged} keyframes "
          f"merged ({len(views)} in the map), keyframe ATE with scale {ate:.4f}; on the CPU "
          f"from the card's state and draws: {len(relocs)} relocalisations, the same anchors, "
          f"RANSAC inliers within {INLIER_TOL}; not held, {len(apart)} poses apart by more "
          f"than {SLAM_POSE_TOL} (keyframe: max |diff|, RANSAC/map inliers card vs CPU: "
          f"{'; '.join(apart) or '-'}); from the card's anchors "
          f"the same count and integer tables, floats within {d:.3g} of their size "
          f"(tolerance {MAINT_TOL}); merge_map {t_merge * 1e3:.1f} ms [{card}]")


class Tap:
    """Stands in for a module's function and keeps every call's arguments
    and result, on any device, with the index of the first RANSAC draw it
    made."""

    def __init__(self, module, name, draws):
        self.module, self.name, self.fn, self.draws = module, name, getattr(module, name), draws
        self.calls = []
        setattr(module, name, self)

    def __call__(self, *args, **kw):
        first = len(self.draws.log) if self.draws.queue is None else None
        out = self.fn(*args, **kw)
        self.calls.append((args, kw, out, first))
        return out

    def restore(self):
        setattr(self.module, self.name, self.fn)


def _tensors(x, name=""):
    """(name, tensor) pairs of a structure of tensors: dict keys, NamedTuple
    fields and positions name them."""
    if torch.is_tensor(x):
        return [(name, x)]
    if isinstance(x, dict):
        return [p for k, v in x.items() for p in _tensors(v, f"{name}.{k}".lstrip("."))]
    if isinstance(x, (tuple, list)):
        keys = getattr(x, "_fields", range(len(x)))
        return [p for k, v in zip(keys, x) for p in _tensors(v, f"{name}.{k}".lstrip("."))]
    return []


def _diffs(a, b):
    """Per tensor of two matching structures: name=the largest |difference|
    of a float tensor/its largest |value|, or the count of differing elements
    of an integer one."""
    out = []
    for (name, x), (_, y) in zip(_tensors(a), _tensors(b)):
        x, y = x.detach().cpu(), y.detach().cpu()
        if x.shape != y.shape:
            out.append(f"{name}=shape")
        elif x.is_floating_point():
            d = float((x.double() - y.double()).abs().max()) if x.numel() else 0.0
            out.append(f"{name}={d:.2g}/{float(y.abs().max()) if y.numel() else 0.0:.2g}")
        else:
            out.append(f"{name}={int((x != y).sum())}!=")
    return " ".join(out)


def f1_probe(dev, seqs, card):
    """ROADMAP F1, a reading that holds nothing: eval_seq2 from the card's
    state after frame 2 with the card's draws, frames 3 (the first insert
    after the bootstrap: triangulation and the first windowed BA) and 4
    (the first map-tracking PnP), on the card and on the CPU. For each call
    of RANSAC, triangulation, motion-only BA and BA: how far the CPU's
    inputs and outputs lie from the card's (max |diff| / max |value| per
    tensor; n!= for integer tensors), and how far the CPU's outputs lie from
    the card's when the CPU runs the card's own inputs."""
    import pislam_tpu_torch as pt
    from pislam_tpu_torch.backend import ba, pnp, triangulate
    from pislam_tpu_torch.geometry import ransac

    frames, intr, _ = seqs["eval_seq2"]
    cfg = slam_config()
    draws = Draws(ransac.sample_indices)
    ransac.sample_indices = draws
    taps = [Tap(m, n, draws) for m, n in ((ransac, "ransac_essential"),
                                          (triangulate, "triangulate_two_view"),
                                          (pnp, "motion_only_ba"), (ba, "bundle_adjust"))]
    try:
        slam = make_slam(cfg, intr, dev)
        for f in frames[:3]:
            slam.process(f)
        snap, first = snapshot(slam), len(draws.log)
        for tap in taps:
            tap.calls = []
        card_out = [slam.process(f) for f in frames[3:5]]
        card_calls = {tap.name: tap.calls for tap in taps}
        cpu = pt.KeyframeSLAM(cfg, *intr, keyframe_min_inliers=60, keyframe_max_gap=3,
                              device="cpu")
        adopt(cpu, snap)
        draws.queue = [d.cpu() for d in draws.log[first:]]
        for tap in taps:
            tap.calls = []
        cpu_out = [cpu.process(f) for f in frames[3:5]]
        cpu_calls = {tap.name: tap.calls for tap in taps}
        for tap in taps:
            for i, ((a_args, a_kw, a_out, a_first), (b_args, b_kw, b_out, _)) in enumerate(
                    zip(card_calls[tap.name], cpu_calls[tap.name])):
                kw = {k: (v.cpu() if torch.is_tensor(v) else v) for k, v in a_kw.items()}
                if tap.name == "ransac_essential":
                    kw["idx"], kw["generator"] = draws.log[a_first].cpu(), None
                host_args = type(a_args[0])(*(None if x is None else x.cpu() for x in a_args[0])) \
                    if tap.name == "bundle_adjust" else a_args[0].cpu()
                rest = tuple(x.cpu() if torch.is_tensor(x) else x for x in a_args[1:])
                same_in = tap.fn(host_args, *rest, **kw)
                print(f"F1 eval_seq2 {tap.name} call {i}: inputs {_diffs(a_args, b_args)}, "
                      f"outputs {_diffs(a_out, b_out)}; the CPU on the card's inputs: outputs "
                      f"{_diffs(a_out, same_in)}")
    finally:
        ransac.sample_indices = draws.draw
        for tap in taps:
            tap.restore()
    for i, (c, p) in enumerate(zip(card_out, cpu_out)):
        print(f"F1 eval_seq2 frame {3 + i}: keyframe {c['keyframe']}/{p['keyframe']}, inliers "
              f"{c['num_inliers']}/{p['num_inliers']}, map inliers {c['map_inliers']}/"
              f"{p['map_inliers']} (card/CPU); pose differs by "
              f"{max(float(np.abs(c[k] - p[k]).max()) for k in ('pose_R', 'pose_t')):.3g} "
              f"[{card}]")


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 7b: the service
# ---------------------------------------------------------------------------

SERVICE_KILL_AT = 112          # eval_seq4: the first run stops here, the rerun resumes
SERVICE_ATE_LIMIT = 0.5        # tests/test_service.py's bound for eval_seq, --loop-every 2


def run_service(argv):
    """pislam_tpu_torch.service.main(argv) with its KeyframeSLAM's chunks,
    chunk-boundary relocalisations, closures and checkpoint saves wrapped.
    Returns the report, the stderr lines, the host seconds to a synchronize,
    the launches of the whole run, and the wraps."""
    import contextlib
    import io

    from pislam_tpu_torch import KeyframeSLAM, service
    from pislam_tpu_torch.ops import kernels
    from pislam_tpu_torch.utils import checkpoint

    wraps = {"chunk": Wrap(KeyframeSLAM, "process_chunk", keep=True),
             "reloc": Wrap(KeyframeSLAM, "_relocalise_feats"),
             "close": Wrap(KeyframeSLAM, "close_loop", sync=True),
             "save": Wrap(checkpoint, "save", sync=True)}
    out, err = io.StringIO(), io.StringIO()
    try:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            service.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
    finally:
        for w in wraps.values():
            w.restore()
    report = json.loads(out.getvalue().strip().splitlines()[-1])
    return report, err.getvalue().splitlines(), wall, launches, wraps


def service_launches(label, report, launches, wraps):
    """The chunk path's rule, exact: K1, K2 and orb_describe once per frame
    this run processed, plus once per chunk that ended lost (its last frame
    is extracted again to relocalise); K5 twice and motion-only BA once per
    tracked frame, plus what the relocalisations and the closures launched;
    every other kernel 0."""
    frames = report["frames"] - report["resumed_at"]
    tracked = frames - (1 if report["resumed_at"] == 0 else 0)
    lost = wraps["reloc"].calls
    want = {k: frames + lost for k in FUSED_PATH_KERNELS}
    for k, per_frame in (("match_reduce", 2), ("motion_only_ba", 1)):
        want[k] = (per_frame * tracked + wraps["reloc"].launches.get(k, 0)
                   + wraps["close"].launches.get(k, 0))
    bad = [f"{k} launched {n} times, expected {want.get(k, 0)}"
           for k, n in launches.items() if n != want.get(k, 0)]
    if bad:
        raise AssertionError(f"service {label}: " + "; ".join(bad))
    return {k: n for k, n in launches.items() if n}


def chunk_outputs(wrap, first=0):
    outs = wrap.results[first:]
    return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}


def same_decisions(a, b):
    """The largest pose difference of two runs' frames, or None where their
    keyframe decisions differ."""
    if not np.array_equal(a["keyframe"], b["keyframe"]):
        return None
    return max(float(np.abs(a[k] - b[k]).max()) for k in ("pose_R", "pose_t"))


def _service_payload(path, cfg, device, strict=True):
    from pislam_tpu_torch.models.slam import init_state
    from pislam_tpu_torch.utils import checkpoint
    like = {"state": init_state(cfg, 7, device), "steps_done": 0}
    return checkpoint.restore(str(path), like=like, strict_generator=strict)


def _payload_diffs(a, b):
    """Names of the tables, counters and generator states that differ."""
    from pislam_tpu_torch.utils import checkpoint
    la, lb = checkpoint.leaves(a), checkpoint.leaves(b)
    bad = sorted(set(la) ^ set(lb))
    for name in set(la) & set(lb):
        x, y = la[name], lb[name]
        if isinstance(x, dict):
            x, y = x["state"], y["state"]
        if isinstance(x, torch.Tensor) and not (x.dtype == y.dtype and torch.equal(x, y)):
            bad.append(name)
        elif not isinstance(x, torch.Tensor) and x != y:
            bad.append(name)
    return bad


def service_phase(dev, seqs, card, chunk_res, vga):
    """The service at full width (its own build_config: FAST 20, Harris
    1<<10, 256 RANSAC iterations, 64 keyframe slots, 8192 landmarks) over
    eval_seq4 in chunks of 8 with checkpoints and the end-of-run closure,
    eval_seq with mid-run closures, a kill at frame 112 and the rerun that
    resumes, the checkpoint's round trips (card, card to CPU),
    localization-only on the stored map, and the demo against the plain
    path; launches exact by the chunk path's rule."""
    import shutil
    import tempfile

    import pislam_tpu_torch as pt
    from pislam_tpu_torch import demo, service
    from pislam_tpu_torch.ops import kernels
    from pislam_tpu_torch.ops.pyramid import build_pyramid
    from pislam_tpu_torch.utils import checkpoint

    t_phase = time.perf_counter()
    seq4, seq1 = str(ROOT / "data" / "eval_seq4.npz"), str(ROOT / "data" / "eval_seq.npz")
    frames4, intr4, _ = seqs["eval_seq4"]
    cfg = service.build_config(384, 256)
    c4 = chunk_res["eval_seq4"]
    with tempfile.TemporaryDirectory(prefix="pislam_service_") as tmp:
        tmp = Path(tmp)
        d1, d2 = tmp / "d1", tmp / "d2"

        # 1. the service at full width, with the end-of-run closure
        rep, err, wall, got, w = run_service(
            ["--seq", seq4, "--chunk", str(CHUNK), "--checkpoint-dir", str(d1),
             "--checkpoint-every", "64", "--traj-out", str(tmp / "t1.txt"),
             "--map-out", str(tmp / "p1.ply"), "--metrics"])
        used = service_launches("eval_seq4", rep, got, w)
        if rep.get("ate_rmse") is None or rep["frames"] != len(frames4):
            raise AssertionError(f"service eval_seq4: {rep}")
        mlines = [json.loads(line) for line in err if line.startswith("{")]
        if len(mlines) != -(-len(frames4) // CHUNK) or not all(
                "time_ms.scan_chunk" in m for m in mlines):
            raise AssertionError(f"service eval_seq4: {len(mlines)} metric lines")
        straight = chunk_outputs(w["chunk"])
        size_mb = (d1 / "state").stat().st_size / 1e6
        track_s = wall - w["close"].seconds
        print(f"phase service eval_seq4: {rep['frames']} frames in chunks of {CHUNK}, "
              f"{rep['keyframes']} keyframes, {rep['landmarks']} landmarks, lost "
              f"{rep['frames_lost']}, relocalisations {rep['relocalisations']}, closure to "
              f"keyframe {rep['loop_closed_to_kf']}; ATE {rep['ate_rmse']} (phase 7's "
              f"chunk-{CHUNK} path at slam_config {c4['ate']:.4f}, held to nothing: the "
              f"configs differ); launches {json.dumps(used)}")
        print(f"time service eval_seq4: {track_s / rep['frames'] * 1e3:.4f} ms/frame "
              f"(host clock to synchronize, {w['save'].calls} checkpoint saves included; "
              f"phase 7's chunk-{CHUNK} path {c4['ms']:.4f}), close_loop "
              f"{w['close'].seconds * 1e3:.1f} ms, checkpoint {size_mb:.3f} MB saved in "
              f"{w['save'].seconds / w['save'].calls * 1e3:.1f} ms [{card}]")

        # eval_seq whole, with mid-run closures (tests/test_service.py's flags)
        rep1, _, wall1, got1, w1 = run_service(
            ["--seq", seq1, "--chunk", str(CHUNK), "--loop-every", "2", "--no-loop-close"])
        used1 = service_launches("eval_seq", rep1, got1, w1)
        if not (rep1.get("ate_rmse") is not None and rep1["ate_rmse"] < SERVICE_ATE_LIMIT
                and rep1["loops_closed_midrun"] >= 1):
            raise AssertionError(f"service eval_seq --loop-every 2: {rep1}")
        print(f"phase service eval_seq --loop-every 2: {rep1['frames']} frames, ATE "
              f"{rep1['ate_rmse']} (limit {SERVICE_ATE_LIMIT}), {rep1['loops_closed_midrun']} "
              f"mid-run closures of {w1['close'].calls}, {rep1['keyframes']} keyframes; "
              f"launches {json.dumps(used1)}")
        print(f"time service eval_seq --loop-every 2: {wall1 * 1e3 / rep1['frames']:.4f} "
              f"ms/frame with the closures, {w1['close'].seconds * 1e3:.1f} ms in "
              f"{w1['close'].calls} closures [{card}]")

        # 2. kill and resume
        argv2 = ["--seq", seq4, "--chunk", str(CHUNK), "--checkpoint-dir", str(d2),
                 "--checkpoint-every", "64"]
        repk, _, _, gotk, wk = run_service(argv2 + ["--max-frames", str(SERVICE_KILL_AT),
                                                    "--no-loop-close"])
        service_launches("eval_seq4 to the kill", repk, gotk, wk)
        shutil.copy(d2 / "state", tmp / "killed_state")
        repr_, _, wallr, gotr, wr = run_service(argv2)
        usedr = service_launches("eval_seq4 resumed", repr_, gotr, wr)
        if repr_["resumed_at"] != SERVICE_KILL_AT:
            raise AssertionError(f"service resume: resumed_at {repr_['resumed_at']}")
        resumed = chunk_outputs(wr["chunk"])
        tail = {k: v[SERVICE_KILL_AT:] for k, v in straight.items()}
        d_resume = same_decisions(resumed, tail)
        # the rerun's first chunk against the same state, restored, run here
        payload = _service_payload(tmp / "killed_state", cfg, dev)
        ref = pt.KeyframeSLAM(cfg, *intr4, keyframe_min_inliers=60, keyframe_max_gap=3,
                              device=dev)
        ref.set_state(payload["state"])
        first_ref = ref.process_chunk(frames4[SERVICE_KILL_AT:SERVICE_KILL_AT + CHUNK])
        first_got = {k: v[:CHUNK] for k, v in resumed.items()}
        d_first = same_decisions(first_got, first_ref)
        if d_first is None or d_first > SLAM_POSE_TOL:
            raise AssertionError(f"service resume: the first chunk after the restore "
                                 f"differs from the same state run here ({d_first})")
        if d_resume is None or d_resume > SLAM_POSE_TOL:
            head = {k: v[:SERVICE_KILL_AT] for k, v in straight.items()}
            d_repeat = same_decisions(chunk_outputs(wk["chunk"]), head)
            if d_repeat is not None and d_repeat <= SLAM_POSE_TOL:
                raise AssertionError(
                    f"service resume: frames {SERVICE_KILL_AT}-{len(frames4) - 1} differ "
                    f"from the straight run ({d_resume}) though two straight runs repeat "
                    f"({d_repeat})")
            print(f"finding service: the card's SLAM does not repeat itself: two straight "
                  f"runs of eval_seq4 frames 0-{SERVICE_KILL_AT - 1} in this call differ "
                  f"({'keyframe decisions' if d_repeat is None else f'poses by {d_repeat:.3g}'}"
                  f"), so the resume is held to its first chunk after the restore")
        print(f"phase service resume: killed at {repk['frames']} frames, rerun resumed at "
              f"{repr_['resumed_at']}; frames {SERVICE_KILL_AT}-{len(frames4) - 1} against "
              f"the straight run: "
              f"{'keyframe decisions differ' if d_resume is None else f'same keyframe decisions, poses within {d_resume:.3g}'}"
              f"; the first chunk against the restored state run here: poses within "
              f"{d_first:.3g} (tolerance {SLAM_POSE_TOL}); launches {json.dumps(usedr)}")
        print(f"time service resume: {(wallr - wr['close'].seconds) / SERVICE_KILL_AT * 1e3:.4f}"
              f" ms/frame over the resumed frames, close_loop "
              f"{wr['close'].seconds * 1e3:.1f} ms [{card}]")

        # the checkpoint's round trip on the card: restore, save, restore
        t0 = time.perf_counter()
        on_card = _service_payload(d2 / "state", cfg, dev)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        checkpoint.save(str(tmp / "again"), on_card)
        again = _service_payload(tmp / "again", cfg, dev)
        bad = _payload_diffs(on_card, again)
        if bad or on_card["steps_done"] != len(frames4) // CHUNK:
            raise AssertionError(f"service checkpoint round trip on the card: {bad}, "
                                 f"steps_done {on_card['steps_done']}")

        # 3. card -> CPU: the tables exactly; the generator, of another
        # device type, raises under the strict rule and is reseeded without it
        try:
            _service_payload(d2 / "state", cfg, "cpu")
        except ValueError as e:
            refused = str(e)
        else:
            raise AssertionError("service card -> CPU: the cuda generator restored onto the CPU")
        on_cpu = _service_payload(d2 / "state", cfg, "cpu", strict=False)
        bad = [n for n in _payload_diffs(on_cpu, on_card) if n != "state.generator"]
        fresh = torch.Generator().manual_seed(7).get_state()
        if bad or not torch.equal(on_cpu["state"].generator.get_state(), fresh):
            raise AssertionError(f"service card -> CPU: {bad}")
        cpu_slam = pt.KeyframeSLAM(cfg, *intr4, device="cpu")
        cpu_slam.set_state(on_cpu["state"])
        ref.set_state(on_card["state"])
        if (cpu_slam.num_keyframes, cpu_slam.num_landmarks, cpu_slam._culled_slots) != \
                (ref.num_keyframes, ref.num_landmarks, ref._culled_slots):
            raise AssertionError("service card -> CPU: counts differ")
        print(f"phase service checkpoint: round trip on the card bit-exact (tables, counters, "
              f"generator), restore {restore_ms:.1f} ms; card -> CPU tables bit-exact, the "
              f"strict restore refused ({refused.split(':')[0]}: cuda generator onto cpu), "
              f"the relaxed one a generator seeded 7 [{card}]")

        # 4. localization-only on the map stored before step 1's closure
        stored = pt.KeyframeSLAM(cfg, *intr4, device=dev)
        stored.set_state(_service_payload(d1 / "state", cfg, dev)["state"])
        repl, _, walll, gotl, _ = run_service(
            ["--seq", seq4, "--localization-only", "--map-in", str(d1)])
        want = {k: len(frames4) for k in ("fused_frontend_codes", "topk_keys", "orb_describe")}
        bad = [k for k, n in gotl.items()
               if k not in ("match_reduce", "motion_only_ba") and n != want.get(k, 0)]
        if (bad or repl["keyframes"] != stored.num_keyframes
                or repl["landmarks"] != stored.num_landmarks
                or repl["loop_closed_to_kf"] != -1 or repl["resumed_at"] != 0):
            raise AssertionError(f"service localization-only: {repl}, launches {gotl} "
                                 f"({bad}), stored map {stored.num_keyframes} keyframes "
                                 f"{stored.num_landmarks} landmarks")
        print(f"phase service localization-only eval_seq4 on the stored map: "
              f"{repl['keyframes']} keyframes and {repl['landmarks']} landmarks as stored, "
              f"lost {repl['frames_lost']}, relocalisations {repl['relocalisations']}, ATE "
              f"{repl.get('ate_rmse')}; launches {json.dumps({k: n for k, n in gotl.items() if n})}")
        print(f"time service localization-only: {walll / len(frames4) * 1e3:.4f} ms/frame "
              f"(per-frame path) [{card}]")

    # 5. the demo on the card, both input forms, against the plain path
    dcfg = demo.demo_config()
    pc = dcfg.pyramid
    extract = pt.make_extract_fn(dcfg, dev)
    plain = pt.OrbExtractor(dcfg, ops=kernels.PLAIN).to(dev)
    stacks = [build_pyramid(torch.from_numpy(f).to(dev), pc)[:pc.total_height, :pc.base_width]
              .cpu().numpy() for f in vga]
    demo.annotate(vga[0], extract, True)                              # warm-up
    times, counts, painted = {}, [], {}
    for form, imgs in (("frame", vga), ("stacked", stacks)):
        build = form == "frame"
        kernels.reset_launch_counts()
        got = [demo.annotate(img, extract, build) for img in imgs]
        launched = kernels.launch_counts()
        want = {k: len(imgs) for k in ("fused_frontend_codes", "topk_keys", "orb_describe")}
        if any(n != want.get(k, 0) for k, n in launched.items()):
            raise AssertionError(f"demo {form}: launches {launched}, expected {want}")
        for i, (img, (out, n, _)) in enumerate(zip(imgs, got)):
            p_out, p_n, _ = demo.annotate(img, plain, build)
            if n != p_n or not np.array_equal(out, p_out):
                raise AssertionError(f"demo {form} frame {i}: {n} features against the plain "
                                     f"path's {p_n}, images equal {np.array_equal(out, p_out)}")
        times[form] = statistics.median(ms for _, _, ms in got)
        counts.append([n for _, n, _ in got])
        painted[form] = [out for out, _, _ in got]
    if not all(np.array_equal(a, b) for a, b in zip(painted["frame"], painted["stacked"])):
        raise AssertionError("demo: the stacked form paints another image than the frame form")
    print(f"phase service demo: {len(vga)} VGA frames, both forms bit-exact against the plain "
          f"path on the card and against each other, features {counts[0]}; K1, K2 and "
          f"orb_describe once per frame")
    print(f"time service demo: GPU Time {times['frame']:.3f} ms (frame form), "
          f"{times['stacked']:.3f} ms (stacked form), median of {len(vga)}, one call between "
          f"two synchronizes [{card}]")
    print(f"phase service: {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 7c: the distributed layer
# ---------------------------------------------------------------------------

DIST_SHARDS = (2, 4, 8)
DIST_TRACK_TOL = 1e-5      # tests/test_parallel.py's R, t tolerance for the tracker
DIST_TRAJ_TOL = 1e-4
DIST_BA_TOL = 1e-4
DIST_STREAM_FRAMES = 48
GLOO_RANKS = 2
GLOO_TIMEOUT = 180
DIST_BACKEND = "nccl"      # the card's collectives; world size 1 on one card


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _max_diff(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def require_same(name: str, got, want):
    """Equal shapes, dtypes and values (floats bit for bit, but for -0.0)."""
    if got.shape != want.shape or got.dtype != want.dtype or not torch.equal(got, want):
        raise AssertionError(f"{name}: differs ({tuple(got.shape)} {got.dtype} against "
                             f"{tuple(want.shape)} {want.dtype})")


def dist_track_inputs(dev, seqs, slam_res):
    """Map tracking at its full size: the landmark map phase 6 leaves after
    eval_seq4 (slam_config's 8192 slots), the features and points of its
    last keyframe's frame, and that keyframe's pose as the prior."""
    import pislam_tpu_torch as pt
    r = slam_res["eval_seq4"]
    st = r["state"]
    slot = (int(r["counters"][0]) - 1) % slam_config().map.keyframe_capacity
    odo = pt.VisualOdometry(slam_config(), *seqs["eval_seq4"][1], device=dev)
    feats, pts = odo.frontend(torch.as_tensor(seqs["eval_seq4"][0][r["kf"][-1]]))
    return st.lmap, feats, pts, st.store.R[slot], st.store.t[slot]


def dist_world1(dev, seqs, card, slam_res, k5_cases, vga, track):
    """World size 1 on NCCL through the entry points a user calls: the
    sharded match at 512x8192 and the sharded map tracker on eval_seq4's
    map against the unsharded ones, KeyframeSLAM(mesh=...) over eval_seq with
    close_loop against phase 6's run (same decisions, counters, keyframes,
    loop, branch and K5 launches; trajectory within 1e-4), make_distributed_ba
    dense and CG on a window of that run against bundle_adjust, data-parallel
    extraction of the VGA frames, VO and SLAM streams over the first 48
    frames of the four sequences against make_vo_scan and the chunk scan,
    and dryrun_multichip(1). Returns the BA window and the launches of the
    sharded SLAM run."""
    import torch.distributed as tdist
    import pislam_tpu_torch as pt
    from pislam_tpu_torch import matching
    from pislam_tpu_torch.backend import ba
    from pislam_tpu_torch.models.slam import init_state, track_map_state
    from pislam_tpu_torch.models.slam_scan import make_slam_track_scan
    from pislam_tpu_torch.models.visual_odometry import make_vo_scan
    from pislam_tpu_torch.ops import kernels
    from pislam_tpu_torch.ops.pyramid import build_pyramid
    from pislam_tpu_torch.parallel import dist, mesh as meshmod
    from pislam_tpu_torch.parallel.dryrun import dryrun_multichip

    t_part = time.perf_counter()
    torch.cuda.set_device(dev)
    tdist.init_process_group(DIST_BACKEND, init_method=f"tcp://localhost:{_free_port()}",
                             world_size=1, rank=0)
    try:
        mesh = meshmod.make_mesh(pt.MeshConfig())
        if tuple(mesh.shape) != (1, 1) or tdist.get_backend() != DIST_BACKEND:
            raise AssertionError(f"mesh {tuple(mesh.shape)} on {tdist.get_backend()}")
        cfg = slam_config()
        args = k5_cases["512x8192 gated"][:4]
        for name, got, want in zip(("idx", "dist"), dist.make_sharded_match(mesh)(*args),
                                   matching.match(*args)):
            require_equal(f"sharded match 512x8192 {name}", got, want)

        want = track_map_state(cfg, *track)
        got = dist.make_sharded_map_tracker(cfg, mesh)(*track)
        if int(got[2]) != int(want[2]) or not torch.equal(got[3], want[3]):
            raise AssertionError(f"sharded tracker: {int(got[2])} inliers against "
                                 f"{int(want[2])}, or another association")
        d_track = max(_max_diff(got[0], want[0]), _max_diff(got[1], want[1]))
        n_inl = int(got[2])
        if d_track > DIST_TRACK_TOL:
            raise AssertionError(f"sharded tracker: R/t differ by {d_track}")

        frames, intr, _ = seqs["eval_seq"]
        ref = slam_res["eval_seq"]
        bas = Recorder(ba, "bundle_adjust")
        try:
            slam = pt.KeyframeSLAM(cfg, *intr, keyframe_min_inliers=60, keyframe_max_gap=3,
                                   mesh=mesh, device=dev)
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            per_frame = [slam.process(f) for f in torch.as_tensor(frames).to(dev)]
            torch.cuda.synchronize()
            t_track = time.perf_counter() - t0
            closure = slam.close_loop(min_matches=40, exclude_recent=3)
            torch.cuda.synchronize()
            t_close = time.perf_counter() - t0 - t_track
            launches = kernels.launch_counts()
        finally:
            bas.restore()
        bad = [i for i, o in enumerate(per_frame) if decision(o) != ref["decisions"][i]]
        if bad or slam.keyframe_frames != ref["kf"] or not torch.equal(
                slam.state.counters.cpu(), ref["counters"]):
            raise AssertionError(f"sharded SLAM: frames {bad[:10]} decide otherwise, or the "
                                 "keyframes or counters differ from phase 6's run")
        if (closure["loop"], closure["used_graph"]) != (ref["closure"]["loop"],
                                                         ref["closure"]["used_graph"]):
            raise AssertionError(f"sharded SLAM: closure {closure} against {ref['closure']}")
        d_traj = float(np.abs(np.stack(slam.trajectory) - ref["traj"]).max())
        d_post = float(np.abs(slam.keyframe_positions() - ref["post"]).max())
        if max(d_traj, d_post) > DIST_TRAJ_TOL:
            raise AssertionError(f"sharded SLAM: trajectory within {d_traj}, keyframes "
                                 f"within {d_post}")
        # K1, K2 and orb_describe once per frame; K5 and motion-only BA as phase
        # 6's run launched them (K5 once per tracked and once more per
        # map-tracked frame, motion-only BA once per map-tracked frame, and the
        # closure's)
        want = {k: len(frames) for k in FUSED_PATH_KERNELS} | {"match_reduce": ref["k5"],
                                                               "motion_only_ba": ref["pnp"]}
        if any(n != want.get(k, 0) for k, n in launches.items()):
            raise AssertionError(f"sharded SLAM launches {launches}, expected {want}")

        windows = [c for c in bas.calls if c[0].R.shape[0] <= 48]
        if not windows:
            raise AssertionError("sharded SLAM solved no windowed BA")
        window, _, kw = windows[-1]
        d_ba = {}
        for solver in ("dense", "cg"):
            opts = dict(iters=kw["iters"], damping=kw["damping"], huber=kw["huber"],
                        solver=solver)
            single, info_s = ba.bundle_adjust(window, **opts)
            out, info = dist.make_distributed_ba(mesh, **opts)(dist.shard_ba_problem(window, 1))
            d_ba[solver] = max(_max_diff(out.R, single.R), _max_diff(out.t, single.t))
            if d_ba[solver] > DIST_BA_TOL:
                raise AssertionError(f"distributed BA {solver}: R/t differ by {d_ba[solver]}")

        vcfg = pt.PislamConfig()
        pyrs = torch.stack([build_pyramid(torch.from_numpy(f).to(dev), vcfg.pyramid)
                            for f in vga])
        batch = dist.make_batch_extract(vcfg, mesh, dev)(pyrs)
        single = pt.make_extract_fn(vcfg, dev)
        for b in range(len(pyrs)):
            if not features_equal(pt.Features(*(x[b] for x in batch)), single(pyrs[b])):
                raise AssertionError(f"data-parallel extraction: VGA frame {b} differs")

        streams = torch.stack([torch.as_tensor(seqs[name][0][:DIST_STREAM_FRAMES])
                               for name in SEQUENCES]).to(dev)
        nb = len(streams)
        vo = dist.make_vo_streaming(vo_config(), *intr, mesh, device=dev)(
            streams, [torch.Generator(device=dev).manual_seed(b) for b in range(nb)])
        one = make_vo_scan(vo_config(), *intr, device=dev)
        for b in range(nb):
            want = one(streams[b], torch.Generator(device=dev).manual_seed(b))
            for k, v in want.items():
                require_same(f"VO stream {b} {k}", vo[k][b], v)
        states, streamed = dist.make_slam_streaming(cfg, *intr, mesh, keyframe_min_inliers=60,
                                                keyframe_max_gap=3, device=dev)(
            dist.batch_slam_states(cfg, nb, device=dev), streams)
        scan = make_slam_track_scan(cfg, *intr, keyframe_min_inliers=60, keyframe_max_gap=3,
                                    device=dev)
        for b in range(nb):
            st, want = scan(init_state(cfg, 7 + b, dev), streams[b], 0)
            for k, v in want.items():
                require_same(f"SLAM stream {b} {k}", streamed[k][b], v)
            require_same(f"SLAM stream {b} counters", states[b].counters, st.counters)
            for table in ("store", "lmap", "obs"):
                mine, theirs = getattr(states[b], table), getattr(st, table)
                for field, x, y in zip(mine._fields, mine, theirs):
                    require_same(f"SLAM stream {b} {table}.{field}", x, y)

        dryrun_multichip(1, device=dev)
    finally:
        tdist.destroy_process_group()
    print(f"phase distributed world 1 (NCCL, mesh 1x1): sharded match 512x8192 and the "
          f"sharded tracker on eval_seq4's map ({track[0].xyz.shape[0]} slots, "
          f"{n_inl} inliers) equal the unsharded ones (tracker R/t within "
          f"{d_track:.3g}); KeyframeSLAM(mesh) on eval_seq: {len(per_frame)} "
          f"frames, keyframes, counters, loop {closure['loop']} and branch as phase 6's, "
          f"trajectory within {d_traj:.3g}, keyframes after close_loop within {d_post:.3g}, "
          f"K5 {launches['match_reduce']} launches, tracking {t_track / len(frames) * 1e3:.4f} ms/frame "
          f"(phase 6: {ref['t_track'] / len(frames) * 1e3:.4f}), close_loop "
          f"{t_close * 1e3:.1f} ms (phase 6: {ref['t_close'] * 1e3:.1f}; host clock to a "
          f"synchronize); distributed BA on a "
          f"{window.R.shape[0]}-camera window within {d_ba['dense']:.3g} (dense) / "
          f"{d_ba['cg']:.3g} (CG) of bundle_adjust; VGA batch extraction, VO and SLAM "
          f"streams ({nb} x {DIST_STREAM_FRAMES} frames) equal; dryrun_multichip(1) ok; "
          f"{time.perf_counter() - t_part:.1f} s [{card}]")
    return window, launches


def _shard_slices(n: int, rows: int):
    per = rows // n
    return [slice(s * per, (s + 1) * per) for s in range(n)]


def sharded_in_process(n, descA, descB, validA, validB, gate=None):
    """n shards of K5 in one process: match_shard on each slice, the stacks
    an all_gather would make, merge_match_shards."""
    from pislam_tpu_torch.parallel import dist
    parts = []
    for s, rows in enumerate(_shard_slices(n, descB.shape[0])):
        g = None if gate is None else (gate[0], gate[1][rows], gate[2])
        parts.append(dist.match_shard(s, descA, descB[rows], validA, validB[rows], g))
    return dist.merge_match_shards(*(torch.stack(x) for x in zip(*parts)))


def ba_terms(prob, damping):
    """The four Schur sums and the cost of one LM step, as an all-reduce
    would be given them: (H_cc, b_c, sum_p W Hpp^-1 W^T, sum_p W Hpp^-1 b_p,
    sum r^2)."""
    from pislam_tpu_torch.backend import ba
    terms = []

    def record(x):
        terms.append(x.clone())
        return x

    r, jc, jp, _ = ba.residuals_and_jacobians(prob)
    hcc, bc, hpp, bp, w = ba.gn_normal_blocks(prob, r, jc, jp)
    lam = torch.tensor(damping, dtype=prob.points.dtype, device=prob.points.device)
    ba.schur_reduce(hcc, bc, hpp, bp, w, lam, prob.cam_valid, allsum=record)
    return terms + [torch.sum(r * r)]


def dist_shards(card, k5_cases, track, store, window):
    """n = 2, 4 and 8 shards in one process at full width, each against the
    unsharded K5 path bit for bit: the ungated 512x8192 match, gated map
    tracking on eval_seq4's map at slam_config (also the association after
    the ratio and cross-check filter), loop detection's store counts, and
    BA's Schur sums and cost from the shards summed here within 1e-4
    (relative). K5 launches exactly n times per sharded call. Times a
    sharded match at each n beside the unsharded one. Returns this part's
    launches (the timing's excluded)."""
    from pislam_tpu_torch import matching
    from pislam_tpu_torch.models.slam import project_landmarks
    from pislam_tpu_torch.ops import kernels
    from pislam_tpu_torch.parallel import dist

    cfg = slam_config()
    mc = cfg.matcher
    lmap, feats, pts, R0, t0 = track
    args = k5_cases["512x8192 gated"][:4]
    gate = (pts, project_landmarks(lmap, R0, t0), cfg.map.gate_radius)
    cases = {"512x8192": (args, None),
             "map tracking gated": ((feats.descriptors, lmap.descriptors, feats.valid,
                                     lmap.valid), gate)}
    whole = {name: kernels.match_reduce(*a, *(g or ())) for name, (a, g) in cases.items()}
    counts = matching.match_many(store.descriptors, store.kp_valid, feats.descriptors,
                                 feats.valid, max_distance=mc.max_distance, ratio=mc.ratio,
                                 cross_check=mc.cross_check)[1]
    damping = 1e-4
    ba_whole = ba_terms(window, damping)
    kernels.reset_launch_counts()
    worst_ba = 0.0
    for n in DIST_SHARDS:
        for name, (a, g) in cases.items():
            before = kernels.match_reduce.launches
            got = sharded_in_process(n, *a, gate=g)
            if kernels.match_reduce.launches - before != n:
                raise AssertionError(f"{name} over {n} shards: "
                                     f"{kernels.match_reduce.launches - before} K5 launches")
            for part, x, y in zip(("best", "second", "idx", "col"), got, whole[name]):
                require_same(f"{name} over {n} shards: {part}", x, y)
            kw = dict(max_distance=(cfg.map.map_match_max_distance if g else 64),
                      ratio=mc.ratio, cross_check=True)
            for x, y in zip(matching._filter(*got, a[2], **kw),
                            matching._filter(*whole[name], a[2], **kw)):
                require_same(f"{name} over {n} shards: filtered", x, y)
        part_counts = torch.cat([
            matching.match_many(store.descriptors[rows], store.kp_valid[rows], feats.descriptors,
                                feats.valid, max_distance=mc.max_distance, ratio=mc.ratio,
                                cross_check=mc.cross_check)[1]
            for rows in _shard_slices(n, store.descriptors.shape[0])])
        require_same(f"store counts over {n} shards", part_counts, counts)
        sharded = dist.shard_ba_problem(window, n)
        sums = [sum(x) for x in zip(*(ba_terms(dist.ba_shard(sharded, n, s), damping)
                                      for s in range(n)))]
        for i, (x, y) in enumerate(zip(sums, ba_whole)):
            err = _rel_err(x, y.double())
            worst_ba = max(worst_ba, err)
            if err > DIST_BA_TOL:
                raise AssertionError(f"BA over {n} shards: term {i} off by {err:.3g}")
    launches = kernels.launch_counts()
    want = {"match_reduce": len(cases) * sum(DIST_SHARDS)}
    if any(n != want.get(k, 0) for k, n in launches.items()):
        raise AssertionError(f"shards in one process: launches {launches}, expected {want}")
    times = []
    for name, (a, g) in cases.items():
        ms = {n: time_ms(lambda n=n: sharded_in_process(n, *a, gate=g)) for n in DIST_SHARDS}
        ms[1] = time_ms(lambda: kernels.match_reduce(*a, *(g or ())))
        times.append(f"{name} ({a[0].shape[0]}x{a[1].shape[0]}) " + ", ".join(
            f"{n} shard{'s' if n > 1 else ''} {ms[n]:.4f} ms" for n in sorted(ms)))
    print(f"phase distributed shards in one process: n = {', '.join(map(str, DIST_SHARDS))}: "
          f"the 512x8192 match and gated map tracking bit-exact to one K5 (all four outputs "
          f"and the filtered association), n K5 launches per call, store counts over "
          f"{store.descriptors.shape[0]} keyframes equal, BA's Schur sums and cost on a "
          f"{window.R.shape[0]}-camera window within {worst_ba:.3g} (relative, tolerance "
          f"{DIST_BA_TOL:g}) [{card}]")
    print("time distributed sharded match (K5 on each shard + the merge; CUDA-event time "
          "per call, median of 30): " + "; ".join(times) + f" [{card}]")
    return launches


def gloo_child(port: int, rank: int, world: int, workdir: str, device: str = "cuda:0"):
    """One rank of the gloo probe on ``device``: all_gather and all_reduce
    of a tensor there; if gloo carries them, the sharded match and the
    sharded map tracker over the group. Writes its results to
    <workdir>/gloo<rank>.pt."""
    import torch.distributed as tdist
    import pislam_tpu_torch as pt
    from pislam_tpu_torch.backend.keyframes import LandmarkMap
    from pislam_tpu_torch.ops import kernels
    from pislam_tpu_torch.parallel import dist, mesh as meshmod

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    tdist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                             rank=rank)
    x = torch.full((4,), rank + 1, dtype=torch.int32, device=dev)

    def all_gather():
        parts = [torch.empty_like(x) for _ in range(world)]
        tdist.all_gather(parts, x)
        return [p.cpu().tolist() for p in parts]

    def all_reduce():
        y = x.clone()
        tdist.all_reduce(y)
        return y.cpu().tolist()

    out = {"probe": {}, "errors": {}}
    for name, fn in (("all_gather", all_gather), ("all_reduce", all_reduce)):
        try:
            out["probe"][name] = fn()
        except (RuntimeError, ValueError, NotImplementedError) as e:  # what the probe asks
            out["errors"][name] = f"{type(e).__name__}: {e}"
    if not out["errors"]:
        inp = torch.load(Path(workdir) / "inputs.pt", weights_only=True)
        on = {k: v.to(dev) for k, v in inp.items()}
        cfg = slam_config()
        mesh = meshmod.make_mesh(pt.MeshConfig(data_parallel=1, model_parallel=world))
        k5 = kernels.match_reduce.launches
        idx, d = dist.make_sharded_match(mesh)(on["d1"], on["d2"], on["v1"], on["v2"])
        lmap = LandmarkMap(on["xyz"], on["ldesc"], on["obs_count"], on["lvalid"])
        feats = pt.Features(on["codes"], on["fvalid"], on["angles"], on["fdesc"])
        R, t, n, assoc = dist.make_sharded_map_tracker(cfg, mesh)(lmap, feats, on["pts"],
                                                                  on["R0"], on["t0"])
        out.update(idx=idx.cpu(), dist=d.cpu(), R=R.cpu(), t=t.cpu(), n=n.cpu(),
                   assoc=assoc.cpu(), launches=kernels.match_reduce.launches - k5)
    torch.save(out, Path(workdir) / f"gloo{rank}.pt")
    tdist.destroy_process_group()


def gloo_probe(dev, card, k5_cases, track):
    """Whether gloo carries CUDA tensors for all_gather and all_reduce: two
    processes on cuda:0 (NCCL refuses two ranks on one card). Where it does,
    the 2-rank sharded match (512x8192) and sharded map tracker must equal
    the unsharded path here; where it does not, the error is printed.
    Returns the probe's result as text."""
    import tempfile
    from pislam_tpu_torch import matching
    from pislam_tpu_torch.models.slam import track_map_state

    lmap, feats, pts, R0, t0 = track
    d1, d2, v1, v2 = k5_cases["512x8192 gated"][:4]
    inputs = {"d1": d1, "d2": d2, "v1": v1, "v2": v2, "xyz": lmap.xyz,
              "ldesc": lmap.descriptors, "obs_count": lmap.obs_count, "lvalid": lmap.valid,
              "codes": feats.codes, "fvalid": feats.valid, "angles": feats.angles,
              "fdesc": feats.descriptors, "pts": pts, "R0": R0, "t0": t0}
    t_part = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="pislam_gloo_") as tmp:
        torch.save({k: v.cpu() for k, v in inputs.items()}, Path(tmp) / "inputs.pt")
        port = _free_port()
        code = ("import sys; sys.path.insert(0, {root!r}); import chip_smoke; "
                "chip_smoke.gloo_child({port}, {rank}, {world}, {tmp!r}, {dev!r})")
        procs = [subprocess.Popen(
            [sys.executable, "-c", code.format(root=str(ROOT), port=port, rank=r,
                                               world=GLOO_RANKS, tmp=tmp, dev=str(dev))],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(GLOO_RANKS)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=GLOO_TIMEOUT)[0])
        except subprocess.TimeoutExpired:
            logs.append("timed out")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        if any(p.returncode != 0 for p in procs):
            raise AssertionError("gloo probe: a rank failed\n" + "\n".join(
                log[-3000:] for log in logs))
        res = [torch.load(Path(tmp) / f"gloo{r}.pt", weights_only=True)
               for r in range(GLOO_RANKS)]
    if res[0]["errors"]:
        result = "; ".join(
            [f"gloo {name} of a CUDA tensor raises {err}" for name, err in res[0]["errors"].items()]
            + [f"gloo {name} of a CUDA tensor gives {got}" for name, got in res[0]["probe"].items()])
        print(f"phase distributed gloo probe: {result} ({time.perf_counter() - t_part:.1f} s) "
              f"[{card}]")
        return result
    want_idx, want_dist = matching.match(d1, d2, v1, v2)
    cfg = slam_config()
    want = track_map_state(cfg, *track)
    for r, got in enumerate(res):
        if got["probe"] != res[0]["probe"] or got["launches"] != 2:
            raise AssertionError(f"gloo rank {r}: probe {got['probe']}, {got['launches']} K5")
        require_same(f"gloo rank {r} sharded match idx", got["idx"], want_idx.cpu())
        require_same(f"gloo rank {r} sharded match dist", got["dist"], want_dist.cpu())
        require_same(f"gloo rank {r} tracker assoc", got["assoc"], want[3].cpu())
        d = max(_max_diff(got["R"], want[0].cpu()), _max_diff(got["t"], want[1].cpu()))
        if int(got["n"]) != int(want[2]) or d > DIST_TRACK_TOL:
            raise AssertionError(f"gloo rank {r} tracker: {int(got['n'])} inliers, R/t {d}")
    result = (f"gloo carries CUDA tensors (all_gather {res[0]['probe']['all_gather']}, "
              f"all_reduce {res[0]['probe']['all_reduce']})")
    print(f"phase distributed gloo probe: {result}; 2 ranks on cuda:0: the sharded match "
          f"512x8192 and the sharded map tracker equal the unsharded path, K5 twice per rank "
          f"({time.perf_counter() - t_part:.1f} s) [{card}]")
    return result


def dist_phase(dev, seqs, card, slam_res, k5_cases, vga):
    """Phase 7c, the distributed layer on one card. Returns the launches of
    its two counted paths: the sharded SLAM run and the in-process shards."""
    t_phase = time.perf_counter()
    track = dist_track_inputs(dev, seqs, slam_res)
    window, world1 = dist_world1(dev, seqs, card, slam_res, k5_cases, vga, track)
    shards = dist_shards(card, k5_cases, track, slam_res["eval_seq4"]["state"].store,
                         window)
    probe = gloo_probe(dev, card, k5_cases, track)
    launches = {"KeyframeSLAM(mesh) eval_seq, world 1": world1,
                "shards in one process": shards}
    print(f"phase distributed launches: {json.dumps(launches)}")
    print(f"phase distributed: {time.perf_counter() - t_phase:.1f} s; gloo probe: {probe} "
          f"[{card}]")
    return launches


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
    print(f"phase build: SASS of the library: {sass_igmma(lib)}")

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
    errs["motion_only_ba"] = pnp_phase(dev)
    for label, n in (("eval", 1000), ("vga", 2000)):
        rows[label]["motion_only_ba"] = (pnp_args(dev, n), None, pnp_bound(n, 8))
    odo = pt.VisualOdometry(vo_config(), *seqs["eval_seq"][1], device=dev)
    pairs = [odo.frontend(frames["eval"][i]) for i in (0, 1)]
    errs["match_reduce"], k5_cases = k5_phase(dev, [f for f, _ in pairs], feats0["vga"],
                                              [p for _, p in pairs])
    k2_err, k1_err, k2_cases, k1_cases = topk_large_phase(dev)
    errs["topk_keys"] = max(errs["topk_keys"], k2_err)
    errs["fused_frontend_codes"] = max(errs["fused_frontend_codes"], k1_err)

    # phase 4: the extraction path, and the frontend's other configurations
    extract, results = extraction_path(dev, frames, cfgs)
    variant_launches = extraction_variants(dev, cfgs, results)

    # phase 5: the VO path, and VO with dense BRIEF
    _, vo_outs = vo_path(dev, seqs, card)
    dense_vo(dev, seqs, vo_outs)

    # phase 6: the SLAM path, and SLAM with the unfused frontend
    slam_launches, slam_res, default_feats = slam_path(dev, seqs, card)
    unfused_launches = slam_unfused(dev, seqs, (default_feats, slam_res["eval_seq"]["kf"]))

    # phase 7: the chunk path (the main path), chunk 1 against process, the
    # E/H bootstrap, the housekeeping and the merge, card against CPU
    launches, chunk_res = chunk_path(dev, seqs, card, slam_res)
    chunk1_vs_process(dev, seqs, card)
    homography_vs_cpu(dev, seqs, card)
    maintenance_and_merge(dev, seqs, card)
    f1_probe(dev, seqs, card)

    # phase 7b: the service (and the demo) on the card
    service_phase(dev, seqs, card, chunk_res, vga)

    # phase 7c: the distributed layer on one card
    dist_phase(dev, seqs, card, slam_res, k5_cases, vga)

    # phase 8: times
    for label, cfg in cfgs.items():
        frame = frames[label][0].to(dev)
        pyr = results[label][0][0]
        plain = pt.OrbExtractor(cfg, ops=kernels.PLAIN).to(dev)
        pyr_ms = time_ms(lambda: build_pyramid(frame, cfg.pyramid))
        ext_ms = time_ms(lambda: extract[label](pyr))
        plain_ms = time_ms(lambda: plain(pyr))
        ext_us, ext_n = device_us(lambda: extract[label](pyr))
        print(f"time {label} ({tuple(pyr.shape)}, k={cfg.frontend.max_keypoints}): "
              f"pyramid {pyr_ms:.4f} ms/frame, extraction {ext_ms:.4f} ms/frame "
              f"(device {ext_us:.2f} us, {ext_n:g} device ops per frame; plain path "
              f"{plain_ms:.4f}) [{card}]")
    describe_ab(dev, cfgs, results, card)
    dense_ab(dev, cfgs, results, card)
    k5_shapes = {"eval": "512x512", "vga": "2048x2048"}
    for label in cfgs:
        a5 = k5_cases[k5_shapes[label]]
        rows[label]["match_reduce"] = (a5, None, k5_bound(a5))
    times, by_name = {}, {k.__name__: k for k in kernels.COUNTED}
    for label in cfgs:
        times[label] = {}
        for name, (args, library, (b_ms, b_by)) in rows[label].items():
            kern = by_name[name]
            k_ms = time_ms(lambda: kern(*args))
            p_ms = time_ms(lambda: kern.plain(*args))
            l_ms = time_ms(library) if library else None
            d_us, d_n = device_us(lambda: kern(*args))
            times[label][name] = (k_ms, p_ms, l_ms, b_ms, b_by)
            lib_txt = (f", library {l_ms:.4f} ms (device {device_us(library)[0]:.2f} us)"
                       if library else "")
            shapes = (f"N = {args[2].shape[0]}, {args[5]} iterations" if name == "motion_only_ba"
                      else f"{label} shapes")
            print(f"time kernel {name} at {shapes}: {k_ms:.4f} ms (device "
                  f"{d_us:.2f} us, {d_n:g} device kernels per call), plain {p_ms:.4f} ms"
                  f"{lib_txt}, bound {b_ms * 1e3:.3f} us ({b_by}) [{card}]")
    for shape in ("512x8192 gated", "2048x16384", "512x16384 gated"):
        a5 = k5_cases[shape]
        d_us, d_n = device_us(lambda: kernels.match_reduce(*a5))
        print(f"time kernel match_reduce at {shape}: "
              f"{time_ms(lambda: kernels.match_reduce(*a5)):.4f} ms (device "
              f"{d_us:.2f} us, {d_n:g} device kernels per call), plain "
              f"{time_ms(lambda: kernels.match_reduce_plain(*a5)):.4f} ms, bound "
              f"{k5_bound(a5)[0] * 1e3:.3f} us [{card}]")
    topk_large_times(dev, k2_cases, card)
    k1_times({**{label: rows[label]["fused_frontend_codes"][0] for label in cfgs}, **k1_cases},
             card)
    vo_stage_times(dev, seqs, card)
    vo_profile(dev, seqs, card)
    slam_profile(dev, seqs, card)
    chunk_syncs(dev, seqs, card)

    # the kernels at the eval shapes (motion-only BA at 1000 points), each
    # with its launches on its path: the chunk path for K1, K2, orb_describe,
    # K5 and motion-only BA (phase 6's per-frame counts are on its launches
    # line), SLAM with the unfused frontend for K6, the
    # dense BRIEF extraction for orb_describe_dense; K3, K4 and K4d alone,
    # K3c and K3a run on no path
    print(f"SLAM per-frame path launches: {json.dumps(slam_launches)}")
    paths = {name: (f"SLAM chunks of {CHUNK}", launches) for name in FUSED_PATH_KERNELS}
    paths["reduce_codes_4x"] = ("SLAM unfused", unfused_launches)
    paths["orb_describe_dense"] = ("extraction dense BRIEF", variant_launches["dense BRIEF"])
    paths["motion_only_ba"] = (f"SLAM chunks of {CHUNK}", launches)
    for name in ("gather_windows_packed", "orb_select_bits", "orb_select", "realign_windows",
                 "pack_row_strips"):
        paths[name] = ("none", {name: 0})
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
