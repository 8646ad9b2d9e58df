"""One rank of the port's distributed tests (tests/test_torch_parallel.py,
tests/test_torch_multiprocess.py), on the CPU over gloo.

Run as:  python tests/torch_dist_worker.py <suite> <port> <rank> <world> <dir>

``suite`` "parallel" reads ``<dir>/inputs.pkl`` (numpy arrays the parent
made, with the JAX package's RANSAC draws for the SLAM run), runs every check
of ``PARALLEL`` in order on the same group and writes what each returned,
as numpy, to ``<dir>/rank<rank>.pkl``. ``suite`` "multihost" runs the
two-process checks of ``multihost`` and prints ``TORCH_MULTIHOST_OK {json}``.
Imports torch, numpy and the port only: no jax.
"""

from __future__ import annotations

import json
import os
import pickle
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import pislam_tpu_torch as pt  # noqa: E402
from pislam_tpu_torch.backend import ba  # noqa: E402
from pislam_tpu_torch.backend import keyframes as kfs  # noqa: E402
from pislam_tpu_torch.config import MeshConfig, PislamConfig  # noqa: E402
from pislam_tpu_torch.geometry import ransac  # noqa: E402
from pislam_tpu_torch.parallel import dist, elastic, mesh as meshmod  # noqa: E402

# tests/test_models.py's synthetic camera
FX = FY = 320.0
CX, CY = 320.0, 240.0
K_SLOTS = 256


# ---------------------------------------------------------------------------
# port-side helpers, shared with the parent
# ---------------------------------------------------------------------------

def t(a):
    return torch.from_numpy(np.array(a))


def words(a):
    """uint32 descriptor words -> their int32 bit patterns."""
    return t(np.asarray(a, np.uint32).view(np.int32))


def features(desc, valid, codes=None):
    k = len(valid)
    return pt.Features(codes=t(np.zeros(k, np.int64) if codes is None else codes),
                       valid=t(np.asarray(valid, bool)),
                       angles=torch.zeros(k, dtype=torch.uint8), descriptors=words(desc))


def ba_problem(arrays: dict) -> ba.BAProblem:
    """A port BAProblem on the CPU from the JAX problem's arrays."""
    return ba.BAProblem(*(t(arrays[f]) for f in ba.BAProblem._fields))


def landmark_map(arrays: dict) -> kfs.LandmarkMap:
    return kfs.LandmarkMap(xyz=t(arrays["xyz"]), descriptors=words(arrays["descriptors"]),
                           obs_count=t(arrays["obs_count"]), valid=t(arrays["valid"]))


def projector(xyz, desc, Rs, ts):
    """tests/test_models.py's projector: frame index -> the port's Features
    by exact projection and pixel quantisation."""

    def features_fn(frame_idx):
        i = int(frame_idx)
        xc = xyz @ Rs[i].T + ts[i]
        z = xc[:, 2]
        u = FX * xc[:, 0] / np.maximum(z, 1e-6) + CX
        v = FY * xc[:, 1] / np.maximum(z, 1e-6) + CY
        vis = (z > 0.5) & (u >= 16) & (u < 624) & (v >= 16) & (v < 464)
        sel = np.argsort(~vis)[:K_SLOTS]
        ui = np.round(u[sel]).astype(np.int64)
        vi = np.round(v[sel]).astype(np.int64)
        valid = vis[sel]
        codes = ((200 << 24) | (ui << 12) | vi).astype(np.uint32)
        return features(np.where(valid[:, None], desc[sel], 0), valid,
                        np.where(valid, codes, 0).astype(np.int64))

    return features_fn


class Replay:
    """``geometry/ransac.sample_indices`` handing out recorded draws in turn."""

    def __init__(self, draws):
        self.queue = list(draws)

    def __call__(self, valid, iters, sample_size, generator=None):
        if not self.queue:
            raise AssertionError("more RANSAC draws than were recorded")
        idx = self.queue.pop(0)
        if idx.shape != (iters, sample_size):
            raise AssertionError(f"recorded draw {idx.shape}, asked {(iters, sample_size)}")
        return t(idx)


def slam_record(out) -> dict:
    return {"keyframe": bool(out["keyframe"]), "num_inliers": int(out["num_inliers"]),
            "map_inliers": int(out["map_inliers"])}


def run_slam(cfg, world, draws, mesh=None, frames=14) -> dict:
    """KeyframeSLAM over tests/test_models.py's synthetic scene, then
    relocalise(3), with ``draws`` as ``geometry/ransac.sample_indices``."""
    xyz, desc, Rs, ts_ = (world[k] for k in ("xyz", "desc", "Rs", "ts"))
    slam = pt.KeyframeSLAM(cfg, FX, FY, CX, CY, features_fn=projector(xyz, desc, Rs, ts_),
                           keyframe_min_inliers=220, keyframe_max_gap=4, mesh=mesh,
                           device="cpu")
    saved, ransac.sample_indices = ransac.sample_indices, draws
    try:
        per_frame = [slam_record(slam.process(i)) for i in range(frames)]
        pose = slam.relocalise(3, min_matches=30)
    finally:
        ransac.sample_indices = saved
    st = slam.state
    return {"per_frame": per_frame, "trajectory": np.stack(slam.trajectory),
            "num_keyframes": slam.num_keyframes, "keyframe_frames": slam.keyframe_frames,
            "reloc_R": None if pose is None else np.asarray(pose[0]),
            "counters": st.counters.numpy(), "store_R": st.store.R.numpy(),
            "store_t": st.store.t.numpy(), "lmap_xyz": st.lmap.xyz.numpy()}


def free_port() -> int:
    """A free localhost port for the group's store."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def numpy_tree(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {k: numpy_tree(v) for k, v in x._asdict().items()}
    if isinstance(x, dict):
        return {k: numpy_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [numpy_tree(v) for v in x]
    return x


# ---------------------------------------------------------------------------
# the parallel suite: every check on one 4-rank group
# ---------------------------------------------------------------------------

PARALLEL = {}


def check(fn):
    PARALLEL[fn.__name__] = fn
    return fn


@check
def mesh_shapes(ctx, inp):
    m = ctx["m22"]
    return {"shape": tuple(m.shape), "default": tuple(ctx["m41"].shape),
            "data_rows": meshmod.data_sharding(m, 8), "model_rows": meshmod.model_sharding(m, 8),
            "replicated": meshmod.replicated(m, 8)}


def _distributed_ba(ctx, inp, key, **kw):
    sharded = dist.shard_ba_problem(ba_problem(inp[key]), 4, device="cpu")
    out, info = dist.make_distributed_ba(ctx["m14"], **kw)(sharded)
    return out, info


@check
def ba_dense(ctx, inp):
    out, info = _distributed_ba(ctx, inp, "ba_prob", iters=6, damping=1e-3)
    return {"R": out.R, "t": out.t, "costs": info["costs"]}


@check
def ba_cg(ctx, inp):
    out, info = _distributed_ba(ctx, inp, "ba_prob", iters=6, damping=1e-3, solver="cg",
                                cg_iters=64)
    return {"R": out.R, "t": out.t, "costs": info["costs"]}


@check
def ba_cg_256(ctx, inp):
    out, _ = _distributed_ba(ctx, inp, "ba_prob256", iters=6, damping=1e-4, solver="cg",
                             cg_iters=96)
    prob = ba_problem(inp["ba_prob256"])
    cost0, nobs = ba.ba_cost(prob)
    cost1, _ = ba.ba_cost(prob._replace(R=out.R, t=out.t, points=out.points))
    return {"cost0": cost0, "cost1": cost1, "nobs": nobs}


@check
def extraction(ctx, inp):
    cfg = PislamConfig.from_json(inp["small_cfg"])
    f = dist.make_batch_extract(cfg, ctx["m41"], device="cpu")(inp["pyramids"])
    return {"codes": f.codes, "descriptors": f.descriptors, "valid": f.valid,
            "angles": f.angles}


@check
def streaming(ctx, inp):
    cfg = PislamConfig.from_json(inp["small_cfg"])
    nfeat, nmatch = dist.make_streaming_pipeline(cfg, ctx["m22"], device="cpu")(
        inp["stream_frames"])
    return {"nfeat": nfeat, "nmatch": nmatch}


@check
def vo_streaming(ctx, inp):
    cfg = PislamConfig.from_json(inp["small_cfg"])
    frames = inp["vo_frames"]
    gens = [torch.Generator().manual_seed(b) for b in range(len(frames))]
    out = dist.make_vo_streaming(cfg, 80.0, 80.0, 48.0, 40.0, ctx["m22"],
                                 device="cpu")(frames, gens)
    return {k: out[k] for k in ("R", "t", "accepted")}


@check
def slam_streaming(ctx, inp):
    cfg = PislamConfig.from_json(inp["small_cfg"])
    frames = inp["slam_frames"]
    run = dist.make_slam_streaming(cfg, 80.0, 80.0, 48.0, 40.0, ctx["m22"],
                                   keyframe_min_inliers=40, keyframe_max_gap=2, device="cpu")
    states, outs = run(dist.batch_slam_states(cfg, len(frames), device="cpu"), frames)
    return {"outs": outs, "counters": torch.stack([s.counters for s in states]),
            "lmap_xyz": torch.stack([s.lmap.xyz for s in states]),
            "generator": torch.stack([s.generator.get_state() for s in states])}


@check
def sharded_match(ctx, inp):
    qa, base, va, vb = inp["match_args"]
    idx, d = dist.make_sharded_match(ctx["m14"], max_distance=64, ratio=0.8,
                                     cross_check=True)(words(qa), words(base), t(va), t(vb))
    return {"idx": idx, "dist": d}


def _tracker(ctx, inp, key):
    a = inp[key]
    cfg = PislamConfig.from_json(a["cfg"])
    run = dist.make_sharded_map_tracker(cfg, ctx["m14"])
    R, t_, ni, assoc = run(landmark_map(a["lmap"]), features(a["desc"], a["valid"]),
                           t(a["pts"]), t(a["R0"]), t(a["t0"]))
    return {"R": R, "t": t_, "num_inliers": ni, "assoc": assoc}


@check
def tracker(ctx, inp):
    return _tracker(ctx, inp, "tracker")


@check
def tracker_gated(ctx, inp):
    return _tracker(ctx, inp, "tracker_gated")


@check
def store_counts(ctx, inp):
    a = inp["store"]
    cfg = PislamConfig()
    desc = a["descriptors"]
    store = kfs.empty_store(desc.shape[0], desc.shape[1], desc.shape[2], device="cpu")
    store = store._replace(descriptors=words(desc), kp_valid=t(a["kp_valid"]),
                           valid=torch.ones(desc.shape[0], dtype=torch.bool))
    counts = dist.make_sharded_store_counts(cfg, ctx["m14"])(
        store, features(a["query"], np.ones(len(a["query"]), bool)))
    return {"counts": counts}


@check
def slam_e2e(ctx, inp):
    cfg = PislamConfig.from_json(inp["slam"]["cfg"])
    return run_slam(cfg, inp["slam"]["world"], Replay(inp["slam"]["draws"]), mesh=ctx["m14"])


@check
def kernel_branch(ctx, inp):
    a = inp["kernel_branch"]
    m = ctx["m14"]
    rows = meshmod.model_sharding(m, len(a["d2"]))
    d1, d2, v1, v2 = words(a["d1"]), words(a["d2"]), t(a["v1"]), t(a["v2"])
    out = {}
    for radius in (0.0, 0.2):
        gate = (t(a["uv1"]), t(a["uv2"])[rows], radius) if radius else None
        merged = dist.sharded_match_local(m.get_group("model"), meshmod.axis_index(m, "model"),
                                          d1, d2[rows], v1, v2[rows], gate)
        idx, _ = pt.matching._filter(*merged, v1, 64, 0.8, True)
        out[radius] = {"idx": idx, "best": merged[0]}
    return out


@check
def dryrun(ctx, inp):
    from pislam_tpu_torch.parallel.dryrun import dryrun_multichip
    dryrun_multichip(4, device="cpu")
    return {"ok": True}


def parallel_suite(rank: int, world: int, port: str, workdir: str):
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    elastic.initialize_multihost(f"localhost:{port}", world, rank, device="cpu")
    ctx = {"m22": meshmod.make_mesh(MeshConfig(data_parallel=2, model_parallel=2)),
           "m14": meshmod.make_mesh(MeshConfig(data_parallel=1, model_parallel=4)),
           "m41": meshmod.make_mesh(MeshConfig())}
    results, seconds = {}, {}
    for name, fn in PARALLEL.items():
        t0 = time.perf_counter()
        results[name] = numpy_tree(fn(ctx, inp))
        seconds[name] = time.perf_counter() - t0
    results["seconds"] = seconds
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)


# ---------------------------------------------------------------------------
# the two-process suite (tests/test_torch_multiprocess.py)
# ---------------------------------------------------------------------------

SEQ = os.path.join(ROOT, "data", "eval_seq.npz")


def multihost(rank: int, world: int, port: str, workdir: str):
    """The port of tests/multiproc_worker.py's checks across two processes,
    and the service with --model-parallel 2 against --model-parallel 1."""
    import torch.distributed as tdist
    from pislam_tpu_torch import matching, service
    from pislam_tpu_torch.config import FrontendConfig, PyramidConfig

    idx = elastic.initialize_multihost(f"localhost:{port}", num_processes=world,
                                       process_id=rank, device="cpu")
    assert idx == rank == elastic.process_index(), (idx, rank)
    assert elastic.process_count() == world == 2, elastic.process_count()
    assert tdist.get_backend() == "gloo"

    pyr = PyramidConfig(base_width=64, base_height=48, num_levels=1)
    fe = FrontendConfig(fast_threshold=10, harris_threshold=1, border=16, max_keypoints=32)
    cfg = PislamConfig(pyramid=pyr, frontend=fe)
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (2, pyr.padded_height, pyr.stride), dtype=np.uint8)

    # data-parallel extraction across the process boundary: each rank one frame
    data = meshmod.make_mesh(MeshConfig(data_parallel=2, model_parallel=1))
    feats = dist.make_batch_extract(cfg, data, device="cpu")(frames)
    local = pt.make_extract_fn(cfg, "cpu")
    for b in range(2):
        ref = local(t(frames[b]))
        assert torch.equal(feats.codes[b], ref.codes), f"frame {b} diverged"
        assert torch.equal(feats.descriptors[b], ref.descriptors), f"frame {b} diverged"

    # cross-shard matching: the all_gather crosses the process boundary
    model = meshmod.make_mesh(MeshConfig(data_parallel=1, model_parallel=2))
    d0 = words(rng.integers(0, 2**32, (32, 8), dtype=np.uint32))
    d1 = words(rng.integers(0, 2**32, (32, 8), dtype=np.uint32))
    v = torch.ones(32, dtype=torch.bool)
    idx_ref, _ = matching.match(d0, d1, v, v)
    idx_s, _ = dist.make_sharded_match(model)(d0, d1, v, v)
    assert torch.equal(idx_s, idx_ref), "sharded matcher diverged across processes"

    # model-parallel BA: the Schur sums all-reduced over two processes
    C, Pn = 3, 32
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
    prob = ba.BAProblem(R=Rs, t=ts + 0.01, points=X + 0.02, obs_cam=np.int32(cams),
                        obs_pt=np.int32(pts), obs_uv=np.float32(uvs),
                        obs_valid=np.ones(C * Pn, bool), cam_valid=np.ones(C, bool),
                        pt_valid=np.ones(Pn, bool))
    sharded = dist.shard_ba_problem(prob, 2, device="cpu")
    _out, info = dist.make_distributed_ba(model, iters=2, damping=1e-3)(sharded)
    c0, c1 = float(info["costs"][0]), float(info["costs"][-1])
    assert np.isfinite(c1) and c1 < c0, (c0, c1)

    # CheckpointedRunner: steps_done broadcast from rank 0, non-shared dirs
    my_dir = os.path.join(workdir, f"proc{rank}")
    state0 = {"x": torch.arange(4, dtype=torch.float32)}
    runner = elastic.CheckpointedRunner(lambda s, i: s, my_dir, every=100)
    runner.steps_done = 7
    runner._save(state0)             # rank 0 alone writes
    tdist.barrier()
    fresh = elastic.CheckpointedRunner(lambda s, i: s, my_dir, every=100)
    fresh.resume(state0)
    assert fresh.steps_done == 7, f"rank {rank}: steps_done {fresh.steps_done} != 7"
    written = sorted(os.listdir(my_dir)) if os.path.isdir(my_dir) else []

    # the service: --model-parallel 2 on both ranks, against rank 0's
    # --model-parallel 1 run; rank 0 alone writes the trajectory
    common = ["--seq", SEQ, "--max-frames", "12", "--no-loop-close", "--cpu"]
    single = os.path.join(workdir, "single.txt")
    sharded_traj = os.path.join(workdir, f"sharded_rank{rank}.txt")
    if rank == 0:
        service.main([*common, "--traj-out", single])
    tdist.barrier()
    service.main([*common, "--model-parallel", "2", "--traj-out", sharded_traj])
    tdist.barrier()
    print("TORCH_MULTIHOST_OK", json.dumps({
        "process": rank, "processes": elastic.process_count(), "ba_cost": [c0, c1],
        "steps_done": fresh.steps_done, "written": written,
        "traj_written": os.path.exists(sharded_traj)}), flush=True)
    tdist.destroy_process_group()


def main():
    suite, port, rank, world, workdir = sys.argv[1:6]
    torch.set_num_threads(1)
    {"parallel": parallel_suite, "multihost": multihost}[suite](
        int(rank), int(world), port, workdir)
    if suite == "parallel":
        import torch.distributed as tdist
        tdist.destroy_process_group()


if __name__ == "__main__":
    main()
