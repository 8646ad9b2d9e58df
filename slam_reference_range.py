#!/usr/bin/env python3
"""The JAX package's keyframe SLAM over the committed sequences, for several
seeds: the reference range that chip_smoke.py prints beside the PyTorch
port's SLAM ATEs.

    JAX_PLATFORMS=cpu python3 slam_reference_range.py [--seq eval_seq ...]
        [--seeds 7 0 1 2] [--port | --replay]

Runs ``pislam_tpu.models.slam.KeyframeSLAM`` at tools/eval_ate.py's
``slam_config`` (``chip_smoke.slam_config``; keyframe_min_inliers=60,
keyframe_max_gap=3, then ``close_loop(40, 3)``) on the CPU, once per
(sequence, seed of the state's PRNG key). Prints one JSON line per run
(keyframes, the per-frame SLAM ATE, the keyframe ATE before and after the
closure, the loop target, ``used_graph``, lost frames, seconds) and, last,
the lowest and highest value of each ATE per sequence: ``chip_smoke.py``
keeps those of the default seeds as ``SLAM_REFERENCE``.

With ``--port`` the same loop runs the PyTorch port's ``KeyframeSLAM`` on
the CPU instead (``device="cpu"``, its own ``torch.Generator`` seeded with
``seed``): the port's free runs that README.md and ROADMAP.md quote.

With ``--replay`` it runs the JAX package at the first seed and, for every frame
after the first, the port on the CPU from the JAX state before that frame
(``slam_state_from_numpy``) with the JAX package's RANSAC draws in place of
its own (``tests/torch_parity.JaxDraws``, as tests/test_torch_slam.py replays
its 16 frames): one JSON line per step whose keyframe decision, map inliers
or counters differ, then the count of such steps and the largest difference
of the pose's translation.

This script imports jax and the JAX package (not with ``--port``); the port
never does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402

from chip_smoke import slam_config  # noqa: E402

SEQUENCES = ("eval_seq", "eval_seq2", "eval_seq3", "eval_seq4")
ATES = ("slam_ate", "kf_ate_pre", "kf_ate_post")
KW = dict(keyframe_min_inliers=60, keyframe_max_gap=3)


def jax_config():
    import pislam_tpu.config as jcfg
    return jcfg.PislamConfig.from_json(slam_config().to_json())


def load(name: str):
    d = np.load(ROOT / "data" / f"{name}.npz")
    gt = np.stack([-R.T @ t for R, t in zip(d["Rs"], d["ts"])])
    return d["frames"], tuple(float(d[k]) for k in ("fx", "fy", "cx", "cy")), gt


def run(name: str, seed: int, port: bool = False) -> dict:
    frames, intr, gt = load(name)
    if port:
        import pislam_tpu_torch as pt
        from pislam_tpu_torch.evaluation import ate_rmse
        slam = pt.KeyframeSLAM(slam_config(), *intr, seed=seed, device="cpu", **KW)
        frame = np.asarray
    else:
        import jax.numpy as jnp

        from pislam_tpu.evaluation import ate_rmse
        from pislam_tpu.models.slam import KeyframeSLAM
        slam = KeyframeSLAM(jax_config(), *intr, seed=seed, **KW)
        frame = jnp.asarray
    t0 = time.perf_counter()
    for f in frames:
        slam.process(frame(f))
    t_track = time.perf_counter() - t0
    kf_frames = slam.keyframe_frames
    kf_pre = slam.keyframe_positions()
    t0 = time.perf_counter()
    out = slam.close_loop(min_matches=40, exclude_recent=3)
    t_close = time.perf_counter() - t0
    gt_kf = gt[np.asarray(kf_frames)]
    surviving = {v.index for v in slam.keyframes}
    return {"seq": name, "package": "port" if port else "jax", "seed": seed,
            "frames": int(len(frames)), "keyframes": len(kf_frames),
            "inserted": slam.keyframes_inserted,
            "slam_ate": float(ate_rmse(np.stack(slam.trajectory), gt)),
            "kf_ate_pre": float(ate_rmse(kf_pre, gt_kf)),
            "kf_ate_post": float(ate_rmse(slam.keyframe_positions(), gt_kf)),
            "loop": int(out["loop"]), "loop_survives": int(out["loop"]) in surviving,
            "used_graph": bool(out["used_graph"]), "lost": slam.frames_lost,
            "track_s": t_track, "close_s": t_close}


def replay(name: str, seed: int = 7) -> dict:
    import jax
    import jax.numpy as jnp

    import pislam_tpu_torch as pt
    from pislam_tpu.models.slam import KeyframeSLAM
    from pislam_tpu_torch.geometry import ransac

    sys.path.insert(0, str(ROOT / "tests"))
    from torch_parity import JaxDraws

    frames, intr, _ = load(name)
    jax_slam = KeyframeSLAM(jax_config(), *intr, seed=seed, **KW)
    bad, max_dt = 0, 0.0
    for i, f in enumerate(frames):
        state = jax.tree_util.tree_map(np.asarray, jax_slam.state)
        want = jax_slam.process(jnp.asarray(f))
        if i == 0:
            continue
        port = pt.KeyframeSLAM(slam_config(), *intr, seed=seed, device="cpu", **KW)
        port.set_state(pt.slam_state_from_numpy(state, device="cpu", seed=seed))
        ransac.sample_indices = JaxDraws(state.key)
        got = port.process(f)
        step = {"keyframe": bool(got["keyframe"]), "map_inliers": int(got["map_inliers"]),
                "counters": np.asarray(port.state.counters).tolist()}
        ref = {"keyframe": bool(want["keyframe"]), "map_inliers": int(want["map_inliers"]),
               "counters": np.asarray(jax_slam.state.counters).tolist()}
        max_dt = max(max_dt, float(np.abs(np.asarray(got["pose_t"])
                                          - np.asarray(want["pose_t"])).max()))
        if step != ref:
            bad += 1
            print(json.dumps({"frame": i, "port": step, "jax": ref}), flush=True)
    return {"seq": name, "steps": len(frames) - 1, "mismatching": bad, "max_dt": max_dt}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", nargs="*", default=list(SEQUENCES))
    ap.add_argument("--seeds", nargs="*", type=int, default=[7, 0, 1, 2])
    ap.add_argument("--port", action="store_true",
                    help="run pislam_tpu_torch on the CPU instead of the JAX package")
    ap.add_argument("--replay", action="store_true",
                    help="replay the port step by step from the JAX package's states")
    args = ap.parse_args()
    if args.replay:
        for name in args.seq:
            print(json.dumps(replay(name, args.seeds[0])), flush=True)
        return
    rows = []
    for name in args.seq:
        for seed in args.seeds:
            rows.append(run(name, seed, args.port))
            print(json.dumps(rows[-1]), flush=True)
    ranges = {}
    for name in args.seq:
        mine = [r for r in rows if r["seq"] == name]
        ranges[name] = {k: [min(r[k] for r in mine), max(r[k] for r in mine)] for k in ATES}
        ranges[name]["used_graph"] = sum(r["used_graph"] for r in mine)
    print(json.dumps({"seeds": args.seeds, "ranges": ranges}))


if __name__ == "__main__":
    main()
