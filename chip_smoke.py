#!/usr/bin/env python3
"""Drive the PyTorch port's ORB extraction and visual odometry on one CUDA
card and check them.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero and
prints no result line):

1. device: the card's name and power limit (nvidia-smi); no card, no run.
2. build: nvcc compiles the five Hopper kernels from pislam_tpu_torch/csrc,
   one process per source, all at once.
3. kernels: K1-K4 and K4's atan2 bins against their plain PyTorch versions
   on the card, bit-exact, at the extraction shapes (VGA 8-level pyramid with
   2048 keypoints, and the eval config's 4-level 384x256 pyramid with 512),
   including invalid and edge keypoints and an atan2 sweep; K5 (ungated and
   gated) bit-exact at (512, 512) from eval features, (2048, 2048) from VGA
   features, (2048, 16384) tiled as tools/ab_match.py tiles it, and gated
   with radius 0.06 at (512, 16384), each with invalid rows and columns,
   duplicated descriptors and again with a K1 of no block multiple.
4. extraction path: 48 frames of data/eval_seq.npz at the eval config and 8
   seeded VGA frames at the default config, each frame -> build_pyramid ->
   make_extract_fn(cfg, "cuda"), compared frame by frame with the plain path
   on the card, the first 4 of each also with the plain path on the CPU;
   K1-K4's launch counts must reach the number of frames.
5. VO path: make_vo_scan(vo_config(), device="cuda") over the four
   data/eval_seq*.npz sequences (416 frames); each sequence's ATE must lie
   within 0.005 of the JAX package's (EVAL_r05.json vo_ate_rmse); every
   kernel's launch count must reach the frames (K5: the transitions); on
   eval_seq the plain path on the card gives the same matches and decisions
   frame by frame, and the CPU agrees on the first 4 transitions.
6. times from CUDA events (median of 30 after warm-up) and host clocks
   ending in a synchronize, a torch.profiler window over 20 VO frames, and
   which VO operations make the host wait; the card's name and power limit
   on every line.

The line before the last is {"kernels": [...]}, the last line is
{"ok": true, "device": {...}}. Imports torch, numpy and the port only.
"""

from __future__ import annotations

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
# the __global__ functions of pislam_tpu_torch/csrc, as the profiler names them
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
    import dataclasses

    from pislam_tpu_torch import MatcherConfig, VOConfig
    return dataclasses.replace(
        eval_config(), matcher=MatcherConfig(max_distance=64, ratio=0.85),
        vo=VOConfig(ransac_iters=256, inlier_threshold=2e-3, min_inliers=20))


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

    errs = {k.__name__: 0 for k in kernels.HOPPER}
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

        # times at the main path's shapes (the keypoints alone, no extras)
        args3 = (pyr, xs, ys, valid)
        flat = flat[:k]
        args4 = (flat, *tables, fc.words)
        n_px = pyr.numel()
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
        }

    m10, m01 = (torch.as_tensor(m, device=dev) for m in orientation.sweep_moments())
    bins = kernels.atan2_bins(m10, m01)
    require_equal("K4 atan2 sweep (card plain)", bins, orientation.atan2_bins(m10, m01))
    require_equal("K4 atan2 sweep (CPU plain)", bins.cpu(),
                  orientation.atan2_bins(m10.cpu(), m01.cpu()))
    print(f"phase kernels: ok, K1-K4 bit-exact (tolerance 0) on VGA and eval shapes; "
          f"atan2 sweep of {m10.numel()} moment pairs bit-exact")
    return errs, rows, feats


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

    # phase 4: the extraction path
    extract, results = extraction_path(dev, frames, cfgs)

    # phase 5: the VO path
    launches, _ = vo_path(dev, seqs, card)

    # phase 6: times
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

    # the kernels at the VO path's shapes, with its launch counts
    out = []
    for k in kernels.HOPPER:
        k_ms, p_ms, l_ms, b_ms, b_by = times["eval"][k.__name__]
        out.append({"name": k.__name__, "route": "cuda", "source": k.source,
                    "replaces": k.replaces, "launches": launches[k.__name__],
                    "max_abs_err": errs[k.__name__], "ms": k_ms, "plain_ms": p_ms,
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": l_ms})
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
