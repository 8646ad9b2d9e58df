"""Production SLAM service: stream frames -> tracked map + trajectory.

The port of ``pislam_tpu/service.py``. A frame source (native prefetching
PNG stream, TUM/KITTI layouts, or a committed .npz sequence) drives
``KeyframeSLAM`` on the card with

* structured per-frame telemetry (utils/metrics.py JSON lines),
* periodic atomic checkpoints + resume (parallel/elastic.CheckpointedRunner
  over the ``SlamState`` and its generator -- kill the process, rerun the
  same command, it continues from the last checkpoint),
* optional end-of-run loop closure + pose-graph optimisation,
* TUM-format trajectory export (io/datasets.save_tum_trajectory), PLY map
  export, and a final one-line JSON summary (ATE RMSE when ground truth is
  available).

It runs on the CUDA card; ``--cpu`` runs it on the CPU with the kernels'
plain versions. With no card and no ``--cpu`` it exits with an error.
``--model-parallel N`` shards the landmark map and the keyframe store over
N ranks (``KeyframeSLAM(mesh=...)``, one process per card under torchrun,
NCCL; gloo with ``--cpu``): every rank tracks the same frames to the same
result, and rank 0 alone writes the trajectory, the map, the checkpoints and
the report.

Run: python -m pislam_tpu_torch.service --seq data/eval_seq.npz --traj-out traj.txt
     python -m pislam_tpu_torch.service --frames <dir> --fx 525 --fy 525 \\
         --checkpoint-dir slam_ckpt --checkpoint-every 25 --metrics
     torchrun --nproc-per-node 2 -m pislam_tpu_torch.service \\
         --seq data/eval_seq.npz --model-parallel 2 --traj-out traj.txt
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def build_config(w: int, h: int, levels: int = 4, max_keypoints: int = 512,
                 gate_radius: float = 0.0):
    """Serving defaults: demo thresholds, VGA-class pyramid geometry."""
    from .config import (BAConfig, FrontendConfig, MapConfig, MatcherConfig,
                         PislamConfig, PyramidConfig, VOConfig)
    return PislamConfig(
        pyramid=PyramidConfig(base_width=w, base_height=h, num_levels=levels),
        frontend=FrontendConfig(fast_threshold=20, harris_threshold=1 << 10,
                                border=16, max_keypoints=max_keypoints),
        matcher=MatcherConfig(max_distance=64, ratio=0.85),
        vo=VOConfig(ransac_iters=256, inlier_threshold=2e-3, min_inliers=20),
        ba=BAConfig(window=6, max_points=1024, max_obs=4096, gn_iters=4),
        map=MapConfig(gate_radius=gate_radius),
    )


def _frame_source(args):
    """-> (iterable of (H, W) u8 frames, n_frames, (w, h), intrinsics, gt)."""
    import numpy as np

    if args.seq:
        d = np.load(args.seq)
        frames = d["frames"]
        if args.max_frames:
            frames = frames[: args.max_frames]
        h, w = frames.shape[1:]
        intr = ((float(d["fx"]), float(d["fy"]), float(d["cx"]),
                 float(d["cy"])) if "fx" in d.files else None)
        gt = None
        if "Rs" in d.files:
            gt = np.stack([-R.T @ t for R, t in
                           zip(d["Rs"], d["ts"])])[: frames.shape[0]]
        return iter(frames), frames.shape[0], (w, h), intr, gt

    from .io import datasets
    from .io.native import FrameStream

    if args.tum:
        paths, _ts, gt = datasets.tum_dataset(args.tum)
    elif args.kitti:
        paths, _ts, gt = datasets.kitti_dataset(args.kitti, sequence=args.kitti_seq)
    else:
        import glob
        paths = sorted(glob.glob(os.path.join(args.frames, "*.png")))
        if not paths:
            raise FileNotFoundError(f"no *.png in {args.frames}")
        gt = None
    if args.max_frames:
        paths = paths[: args.max_frames]
        gt = gt[: args.max_frames] if gt is not None else None
    first = datasets.read_png(paths[0])
    h, w = first.shape
    return (iter(FrameStream(paths, width=w, height=h)), len(paths),
            (w, h), None, gt)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--frames", help="directory of grayscale PNGs")
    src.add_argument("--seq", help=".npz sequence (frames [, Rs, ts, fx..])")
    src.add_argument("--tum", help="TUM-RGBD dataset root")
    src.add_argument("--kitti", help="KITTI odometry root")
    ap.add_argument("--kitti-seq", default="00")
    ap.add_argument("--fx", type=float)
    ap.add_argument("--fy", type=float)
    ap.add_argument("--cx", type=float)
    ap.add_argument("--cy", type=float)
    ap.add_argument("--k1", type=float, default=0.0,
                    help="lens distortion (OpenCV k1 k2 p1 p2); points are "
                         "undistorted on the normalised plane before any "
                         "geometry (geometry/camera.py)")
    ap.add_argument("--k2", type=float, default=0.0)
    ap.add_argument("--p1", type=float, default=0.0)
    ap.add_argument("--p2", type=float, default=0.0)
    ap.add_argument("--levels", type=int, default=4)
    ap.add_argument("--max-keypoints", type=int, default=512)
    ap.add_argument("--gate-radius", type=float, default=0.0,
                    help="projection gate for map matching (normalised-"
                         "plane radius, 0 = off): resolves repetitive-"
                         "texture descriptor aliasing")
    ap.add_argument("--keyframe-min-inliers", type=int, default=60)
    ap.add_argument("--keyframe-max-gap", type=int, default=3)
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--chunk", type=int, default=1,
                    help="frames per call: 1 = per-frame loop; >1 runs the "
                         "device-resident tracking scan (models/slam_scan.py) "
                         "with window BA at chunk boundaries and one readback "
                         "per chunk")
    ap.add_argument("--checkpoint-dir",
                    help="periodic atomic checkpoints; rerunning the same "
                         "command resumes from the last one")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--metrics", action="store_true",
                    help="per-frame JSON telemetry on stderr. The stage timers "
                         "are spans (utils/metrics.py): each holds the host time "
                         "of its stage, the launches it makes and the waits on "
                         "the card inside it; nothing synchronizes, so the card's "
                         "own time per stage is not in them. While torch.profiler "
                         "runs, every span is also recorded with its start, end, "
                         "parent and frame on the profiler's clock")
    ap.add_argument("--no-loop-close", action="store_true")
    ap.add_argument("--loop-every", type=int, default=0,
                    help="attempt loop closure every N inserted keyframes "
                         "DURING the run (continuous SLAM), not only at "
                         "the end; each successful closure optimises the "
                         "pose graph immediately. Use only when expected "
                         "drift well exceeds the loop-edge noise: at the "
                         "noise floor, periodic closures can regress the "
                         "trajectory")
    ap.add_argument("--cull-every", type=int, default=0,
                    help="every N new keyframes: cull redundant keyframes "
                         "(ORB-SLAM rule) + badly-reprojecting landmarks, "
                         "evict the stalest landmarks when the table is "
                         "near capacity (--min-free-landmarks), then "
                         "compact the map stores to reclaim capacity "
                         "(long-session map maintenance)")
    ap.add_argument("--min-free-landmarks", type=int, default=512,
                    help="freshness floor for --cull-every maintenance: "
                         "keep at least this many landmark slots free so "
                         "triangulation never starves on long sessions "
                         "(0 disables staleness eviction)")
    ap.add_argument("--traj-out", help="write TUM-format trajectory here")
    ap.add_argument("--map-out",
                    help="write the final landmark map + keyframe path as "
                         "an ASCII PLY point cloud here")
    ap.add_argument("--localization-only", action="store_true",
                    help="track/relocalise against a FROZEN map (load one "
                         "with --map-in): no keyframe insertion, no BA, "
                         "no loop closure -- the pre-built-map deployment "
                         "mode")
    ap.add_argument("--map-in",
                    help="load a SLAM map (a save_checkpoint file, or the "
                         "--checkpoint-dir of a run) as the starting map; "
                         "unlike --checkpoint-dir this does NOT resume frame "
                         "progress -- the whole input stream is processed "
                         "against the loaded map. A map saved on another "
                         "device type keeps its tables and gets a fresh "
                         "RANSAC generator")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="shard the landmark map + keyframe store over N "
                         "ranks (run under torchrun --nproc-per-node N): map "
                         "tracking and loop detection match per shard and "
                         "merge with one all_gather")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU with the kernels' plain versions "
                         "(default: the CUDA card, which must be present)")
    return ap


def main(argv=None):
    ap = _parser()
    args = ap.parse_args(argv)
    if args.localization_only and args.chunk > 1:
        ap.error("--localization-only runs the per-frame loop (chunk 1)")
    if args.map_in and args.checkpoint_dir:
        ap.error("--map-in and --checkpoint-dir are mutually exclusive "
                 "(one loads a map, the other resumes frame progress)")

    import numpy as np
    import torch

    if args.cpu:
        device = "cpu"
    elif torch.cuda.is_available():
        device = "cuda"
    else:
        ap.error("no CUDA card found; pass --cpu to run on the CPU")

    from .parallel.elastic import initialize_multihost, process_count
    mesh, primary = None, True
    if args.model_parallel > 1:
        from .config import MeshConfig
        from .parallel.mesh import make_mesh
        primary = initialize_multihost(device=device) == 0
        if process_count() != args.model_parallel:
            ap.error(f"--model-parallel {args.model_parallel} runs on as many ranks: "
                     f"torchrun --nproc-per-node {args.model_parallel} -m "
                     f"pislam_tpu_torch.service ... (this process group has "
                     f"{process_count()})")
        if device == "cuda":
            device = f"cuda:{torch.cuda.current_device()}"
        mesh = make_mesh(MeshConfig(model_parallel=args.model_parallel))

    from .evaluation import ate_rmse
    from .models.slam import KeyframeSLAM, init_state
    from .utils import checkpoint as ckpt
    from .utils.metrics import Metrics, NullMetrics

    frames, n_frames, (w, h), intr, gt = _frame_source(args)
    if args.fx is not None:
        intr = (args.fx, args.fy if args.fy is not None else args.fx,
                args.cx if args.cx is not None else w / 2.0,
                args.cy if args.cy is not None else h / 2.0)
    if intr is None:
        intr = (0.9 * w, 0.9 * w, w / 2.0, h / 2.0)
    fx, fy, cx, cy = intr

    cfg = build_config(w, h, args.levels, args.max_keypoints,
                       gate_radius=args.gate_radius)
    metrics = (Metrics(sink=lambda s: print(s, file=sys.stderr, flush=True))
               if args.metrics else NullMetrics())
    distortion = None
    if args.k1 or args.k2 or args.p1 or args.p2:
        distortion = (args.k1, args.k2, args.p1, args.p2)
    slam = KeyframeSLAM(cfg, fx, fy, cx, cy,
                        keyframe_min_inliers=args.keyframe_min_inliers,
                        keyframe_max_gap=args.keyframe_max_gap,
                        metrics=metrics, dist=distortion,
                        mapping=not args.localization_only, device=device, mesh=mesh)

    if args.map_in:
        # both forms: a save_checkpoint file, or a --checkpoint-dir run
        # (the runner's payload {"state": ..., "steps_done": ...} in <dir>/state)
        if os.path.isdir(args.map_in):
            like = {"state": init_state(cfg, slam.seed, slam.device), "steps_done": 0}
            payload = ckpt.restore(os.path.join(args.map_in, "state"), like=like,
                                   strict_generator=False)
            slam.set_state(payload["state"])
        else:
            slam.restore_checkpoint(args.map_in, strict_generator=False)

    poses = []  # (R, t) world->cam per processed frame
    loops_closed = [0]
    last_loop_kf = [0]
    last_cull_kf = [0]
    kf_culled = [0]
    lm_evicted = [0]

    def step(state, item):
        slam.set_state(state)
        if np.ndim(item) == 3:  # a chunk: one readback for the lot
            outs = slam.process_chunk(item)
            poses.extend(zip(outs["pose_R"], outs["pose_t"]))
        else:
            out = slam.process(item)
            poses.append((out["pose_R"], out["pose_t"]))
        # cadence by TOTAL inserts, not the live count: num_keyframes
        # saturates at the ring capacity, which would stop all mid-run
        # maintenance exactly when long sessions need it
        if (args.loop_every
                and slam.keyframes_inserted - last_loop_kf[0] >= args.loop_every
                and slam.num_keyframes >= 5):
            last_loop_kf[0] = slam.keyframes_inserted
            # close_loop's measured selection makes a mid-run closure safe:
            # the branch that strains the map loses the map_consistency
            # comparison and is rolled back
            if slam.close_loop()["loop"] >= 0:
                loops_closed[0] += 1
        if (args.cull_every and not args.localization_only
                and slam.keyframes_inserted - last_cull_kf[0] >= args.cull_every):
            last_cull_kf[0] = slam.keyframes_inserted
            kf_culled[0] += len(slam.cull_keyframes(max_cull=2))
            slam.cull_landmarks()
            if args.min_free_landmarks:
                lm_evicted[0] += slam.evict_stale_landmarks(min_free=args.min_free_landmarks)
            slam.compact()
        if args.metrics:
            metrics.emit(frames_done=len(poses))
        return slam.state

    if args.chunk > 1:
        def chunked(it, n):
            buf = []
            for f in it:
                buf.append(np.asarray(f))
                if len(buf) == n:
                    yield np.stack(buf)
                    buf = []
            if buf:
                yield np.stack(buf)
        items = chunked(frames, args.chunk)
        ckpt_every = max(1, -(-args.checkpoint_every // args.chunk))
    else:
        items = frames
        ckpt_every = args.checkpoint_every

    if args.checkpoint_dir:
        from .parallel.elastic import CheckpointedRunner
        runner = CheckpointedRunner(step, args.checkpoint_dir, every=ckpt_every)
        state = runner.resume(slam.state)
        slam.set_state(state)
        runner.run(state, items)
    else:
        state = slam.state
        for it in items:
            state = step(state, it)
    skipped = n_frames - len(poses)  # frames covered by a restored checkpoint

    loop = -1
    if (not args.no_loop_close and not args.localization_only
            and slam.num_keyframes >= 5):
        # the full closure pipeline with its measured graph-vs-BA-only
        # selection (KeyframeSLAM.close_loop): global BA + cull included
        loop = slam.close_loop()["loop"]

    if not primary:
        return
    if args.traj_out:
        from .io.datasets import save_tum_trajectory
        save_tum_trajectory(args.traj_out, range(skipped, n_frames),
                            [p[0] for p in poses], [p[1] for p in poses])
    if args.map_out:
        from .io.datasets import save_ply
        save_ply(args.map_out, slam.landmark_positions(),
                 keyframe_positions=(slam.keyframe_positions()
                                     if slam.num_keyframes else None))

    report = {"metric": "slam_service", "frames": n_frames,
              "resumed_at": skipped, "keyframes": slam.num_keyframes,
              "landmarks": slam.num_landmarks,
              "frames_lost": slam.frames_lost,
              "relocalisations": slam.relocalisations,
              "loops_closed_midrun": loops_closed[0],
              "keyframes_culled": kf_culled[0],
              "landmarks_evicted": lm_evicted[0],
              "loop_closed_to_kf": int(loop)}
    if gt is not None and skipped == 0 and len(poses) == n_frames:
        est = np.stack([-R.T @ t for R, t in poses])
        if np.isfinite(est).all():
            report["ate_rmse"] = round(float(ate_rmse(est, gt)), 4)
        else:
            # never crash the summary on a poisoned trajectory: report the
            # poison instead (the aligner's SVD rejects NaNs)
            report["ate_rmse"] = None
            report["nonfinite_pose_frames"] = int(
                (~np.isfinite(est).all(axis=1)).sum())
    print(json.dumps(report))


if __name__ == "__main__":
    main()
