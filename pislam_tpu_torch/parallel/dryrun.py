"""A dry run of the whole distributed layer over an n-rank process group.

The counterpart of ``dryrun_multichip`` in the JAX package's
``__graft_entry__.py``, with its tiny configs and its checks: data-parallel
extraction and matching, the sharded match, the streaming pipeline, VO and
multi-session SLAM streams, sharded-map SLAM and distributed BA (dense and
CG) over a (data, model) mesh, with model parallelism 2 where n is even.
Run it on every rank of an initialised group of n ranks
(``parallel/elastic.initialize_multihost``, or ``init_process_group`` with a
world of one), or from the command line, one process per card:

    torchrun --nproc-per-node N -m pislam_tpu_torch.parallel.dryrun [--cpu]
"""

from __future__ import annotations

import numpy as np
import torch


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    from .. import matching
    from ..backend import ba
    from ..config import FrontendConfig, MeshConfig, PislamConfig, PyramidConfig
    from . import dist, mesh as meshmod
    from .elastic import process_count, process_index

    # a mesh of another size would fall back to all-data and test nothing
    if process_count() != n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}) runs on {n_devices} ranks; "
                           f"this process group has {process_count()}")
    if torch.device(device).type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    say = print if process_index() == 0 else (lambda *a, **k: None)
    mp = 2 if n_devices % 2 == 0 else 1
    dp = n_devices // mp
    mesh = meshmod.make_mesh(MeshConfig(data_parallel=dp, model_parallel=mp))

    pyr = PyramidConfig(base_width=64, base_height=48, num_levels=1)
    fe = FrontendConfig(fast_threshold=10, harris_threshold=1, border=16, max_keypoints=32)
    cfg = PislamConfig(pyramid=pyr, frontend=fe)
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (dp, pyr.padded_height, pyr.stride), dtype=np.uint8)

    # data-parallel extraction, then matching on the gathered result
    feats = dist.make_batch_extract(cfg, mesh, device)(frames)
    idx, _ = matching.match(feats.descriptors[0], feats.descriptors[-1], feats.valid[0],
                            feats.valid[-1])
    if fe.max_keypoints % mp == 0:
        idx_s, _ = dist.make_sharded_match(mesh)(
            feats.descriptors[0], feats.descriptors[-1], feats.valid[0], feats.valid[-1])
        if not torch.equal(idx_s, idx):
            raise AssertionError("sharded matcher diverges from single-device matching")
    say("  dryrun: extract+match ok", flush=True)

    stream_frames = rng.integers(0, 256, (dp, 3, pyr.base_height, pyr.base_width),
                                 dtype=np.uint8)
    nfeat, _ = dist.make_streaming_pipeline(cfg, mesh, device)(stream_frames)
    if nfeat.shape != (dp, 2):
        raise AssertionError(f"streaming counts of shape {tuple(nfeat.shape)}")
    say("  dryrun: streaming scan ok", flush=True)

    gens = [torch.Generator(device=device).manual_seed(b) for b in range(dp)]
    vo_out = dist.make_vo_streaming(cfg, 40.0, 40.0, 32.0, 24.0, mesh,
                                    device=device)(stream_frames, gens)
    if vo_out["t"].shape != (dp, 3, 3):
        raise AssertionError(f"VO trajectories of shape {tuple(vo_out['t'].shape)}")
    say("  dryrun: data-parallel VO ok", flush=True)

    slam_run = dist.make_slam_streaming(cfg, 40.0, 40.0, 32.0, 24.0, mesh,
                                        keyframe_min_inliers=8, keyframe_max_gap=2,
                                        device=device)
    _, slam_outs = slam_run(dist.batch_slam_states(cfg, dp, device=device), stream_frames)
    if not bool(slam_outs["keyframe"][:, 0].all()):
        raise AssertionError("multi-session SLAM failed to bootstrap")
    say("  dryrun: multi-session SLAM ok", flush=True)

    if mp >= 2:
        from ..models.slam import KeyframeSLAM
        frame = rng.integers(0, 256, (pyr.base_height, pyr.base_width), dtype=np.uint8)
        slam = KeyframeSLAM(cfg, 40.0, 40.0, 32.0, 24.0, mesh=mesh, keyframe_min_inliers=8,
                            keyframe_max_gap=2, device=device)
        for _ in range(3):
            slam.process(frame)
        if slam.num_keyframes < 1:
            raise AssertionError("sharded-map SLAM inserted no keyframe")
        say("  dryrun: sharded-map SLAM ok", flush=True)

    # a model-parallel windowed BA: sharded Schur reduction, dense and CG
    C, Pn = 3, 8 * mp
    X = rng.uniform([-1, -1, 4], [1, 1, 8], (Pn, 3)).astype(np.float32)
    Rs = np.broadcast_to(np.eye(3, dtype=np.float32), (C, 3, 3)).copy()
    ts = np.stack([np.float32([0.2 * c, 0, 0]) for c in range(C)])
    cams, pts, uvs = [], [], []
    for c in range(C):
        xc = X @ Rs[c].T + ts[c]
        uv = xc[:, :2] / xc[:, 2:]
        for p in range(Pn):
            cams.append(c)
            pts.append(p)
            uvs.append(uv[p])
    nobs = len(cams)
    pad = -(-nobs // (8 * mp)) * (8 * mp) - nobs
    prob = ba.BAProblem(
        R=Rs, t=ts + 0.01, points=X + 0.02,
        obs_cam=np.concatenate([cams, np.zeros(pad)]).astype(np.int32),
        obs_pt=np.concatenate([pts, np.zeros(pad)]).astype(np.int32),
        obs_uv=np.concatenate([uvs, np.zeros((pad, 2))]).astype(np.float32),
        obs_valid=np.concatenate([np.ones(nobs, bool), np.zeros(pad, bool)]),
        cam_valid=np.ones(C, bool), pt_valid=np.ones(Pn, bool))
    sharded = dist.shard_ba_problem(prob, mp, device=device)
    _, info = dist.make_distributed_ba(mesh, iters=2, damping=1e-3)(sharded)
    _, info_cg = dist.make_distributed_ba(mesh, iters=2, damping=1e-3, solver="cg",
                                          cg_iters=16)(sharded)
    if not torch.isfinite(info_cg["costs"][-1]):
        raise AssertionError("distributed CG BA produced a non-finite cost")
    say("  dryrun: distributed CG BA ok", flush=True)
    c0, c1 = float(info["costs"][0]), float(info["costs"][-1])
    if not np.isfinite(c1):
        raise AssertionError("distributed BA produced a non-finite cost")
    say(f"dryrun_multichip(n={n_devices}, mesh={dp}x{mp}): extract ok ({len(frames)} frames), "
        f"BA cost {c0:.3e} -> {c1:.3e}", flush=True)


def main(argv=None):
    import argparse

    import torch.distributed as tdist

    from .elastic import initialize_multihost, process_count

    ap = argparse.ArgumentParser(description="dryrun_multichip over torchrun's ranks")
    ap.add_argument("--cpu", action="store_true", help="gloo on the CPU (default: NCCL)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    initialize_multihost(device=device)
    if not tdist.is_initialized():          # one process: a group of one
        tdist.init_process_group("gloo" if args.cpu else "nccl", store=tdist.HashStore(),
                                 rank=0, world_size=1)
    try:
        dryrun_multichip(process_count(), device=device)
    finally:
        tdist.destroy_process_group()


if __name__ == "__main__":
    main()
