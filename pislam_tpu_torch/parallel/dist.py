"""Distributed execution on torch.distributed: data-parallel streams,
sharded matching over the landmark map and the keyframe store, and
distributed bundle adjustment.

The port of ``pislam_tpu/parallel/dist.py``. The JAX package runs one SPMD
program over a device mesh (``shard_map``); here each rank of the process
group is one process on one device, and the mesh is a ``DeviceMesh``
(``parallel/mesh.py``). Every rank holds the whole SLAM state, as the JAX
package's ``KeyframeSLAM(mesh=...)`` holds replicated arrays; what is
sharded is the work. Each rank takes its rows of the landmark map, the
keyframe store, the BA problem or the batch of streams, runs its part, and
the parts merge through one collective over the axis's group (NCCL on the
card, gloo on the CPU):

* data axis: a rank runs its B / dp streams; the outputs are all-gathered,
  so that every rank returns the whole (B, ...) result;
* model axis: a rank runs K5 (``ops/kernels.match_reduce``) on its slab of
  database rows; the per-row (best, second, index) and per-column argmins
  are all-gathered and merged into exactly the four outputs K5 gives on the
  whole database (``merge_match_shards``); BA's Schur sums are all-reduced
  (``backend/ba.py``'s ``allsum``).

Decisions read from these results are bit-identical on every rank, so the
ranks take the same branches and meet at the same collectives.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.distributed as tdist

from .. import matching
from ..backend import ba, pnp
from ..config import PislamConfig
from ..frontend import Features, make_extract_fn
from ..ops import kernels
from ..ops.pyramid import build_pyramid
from .mesh import axis_index, axis_size, comm_device, data_sharding, shard_rows


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def gather(x: torch.Tensor, group) -> torch.Tensor:
    """all_gather of ``x`` (the same shape on every rank) over ``group``,
    stacked along a new leading axis in rank order of the group."""
    is_bool = x.dtype == torch.bool
    y = (x.to(torch.uint8) if is_bool else x).contiguous()
    parts = [torch.empty_like(y) for _ in range(tdist.get_world_size(group))]
    tdist.all_gather(parts, y, group=group)
    out = torch.stack(parts)
    return out.to(torch.bool) if is_bool else out


def allsum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over ``group`` (all_reduce, in place on a contiguous x)."""
    y = x.contiguous()
    tdist.all_reduce(y, group=group)
    return y


def _gather_rows(rows: Sequence, group) -> list:
    """This rank's streams' results (like NamedTuples of tensors, dicts of
    tensors, tensors or generators) -> the list over every rank's streams."""
    first = rows[0]
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        cols = [_gather_rows([r[i] for r in rows], group) for i in range(len(first))]
        return [type(first)(*vals) for vals in zip(*cols)]
    if isinstance(first, dict):
        cols = {k: _gather_rows([r[k] for r in rows], group) for k in first}
        return [dict(zip(cols, vals)) for vals in zip(*cols.values())]
    if isinstance(first, torch.Generator):
        states = torch.stack([g.get_state() for g in rows]).to(comm_device(group))
        out = []
        for s in gather(states, group).flatten(0, 1).cpu():
            g = torch.Generator(device=first.device)
            g.set_state(s.clone())    # a view of the gathered rows is refused
            out.append(g)
        return out
    return list(gather(torch.stack(rows), group).flatten(0, 1).unbind(0))


def _stack(rows: list) -> dict:
    return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}


# ---------------------------------------------------------------------------
# data axis: streams
# ---------------------------------------------------------------------------

def _data_group(mesh):
    return mesh.get_group(mesh.mesh_dim_names[0])


def make_batch_extract(cfg: PislamConfig, mesh, device="cuda"):
    """Data-parallel extraction: ``run(frames (B, H, W) uint8 stacked
    pyramids) -> Features`` with a leading batch axis, on every rank. Each
    rank extracts its B / dp frames (``make_extract_fn``); B must divide by
    the data axis."""
    extract = make_extract_fn(cfg, device)
    group = _data_group(mesh)

    def run(frames):
        frames = torch.as_tensor(frames).to(extract.level_mask.device)
        mine = [extract(f) for f in frames[data_sharding(mesh, frames.shape[0])]]
        rows = _gather_rows(mine, group)
        return Features(*(torch.stack(x) for x in zip(*rows)))

    return run


def make_streaming_pipeline(cfg: PislamConfig, mesh, device="cuda"):
    """Data-parallel streaming: ``run(frames (B, T, H, W) uint8) ->
    (num_feats (B, T-1), num_matches (B, T-1))`` int32 on every rank. Each
    rank runs its streams frame by frame: pyramid, extraction and Hamming
    matching against the previous frame. No collective crosses streams but
    the final gather."""
    extract = make_extract_fn(cfg, device)
    dev = extract.level_mask.device
    mc = cfg.matcher
    group = _data_group(mesh)

    def frontend(frame):
        return extract(build_pyramid(frame, cfg.pyramid))

    def seq(frames):
        prev = frontend(frames[0])
        out = []
        for frame in frames[1:]:
            feats = frontend(frame)
            idx2, _ = matching.match(prev.descriptors, feats.descriptors, prev.valid,
                                     feats.valid, max_distance=mc.max_distance,
                                     ratio=mc.ratio, cross_check=mc.cross_check)
            out.append(torch.stack([feats.num_valid.to(torch.int32),
                                    (idx2 >= 0).sum().to(torch.int32)]))
            prev = feats
        return torch.stack(out)            # (T-1, 2)

    def run(frames):
        frames = torch.as_tensor(frames).to(dev)
        counts = torch.stack(_gather_rows(
            [seq(s) for s in frames[data_sharding(mesh, frames.shape[0])]], group))
        return counts[..., 0], counts[..., 1]

    return run


def make_vo_streaming(cfg: PislamConfig, fx: float, fy: float, cx: float, cy: float,
                      mesh, dist=None, device="cuda"):
    """Data-parallel VO, one whole trajectory per stream: ``run(frames (B, T,
    H, W) uint8, generators) -> dict`` of ``make_vo_scan``'s outputs stacked
    (B, ...) on every rank; ``generators`` holds one ``torch.Generator`` on
    the device per stream. Each rank runs ``make_vo_scan`` over its
    streams."""
    from ..models.visual_odometry import make_vo_scan

    one = make_vo_scan(cfg, fx, fy, cx, cy, dist=dist, device=device)
    group = _data_group(mesh)

    def run(frames, generators: Sequence[torch.Generator]):
        if len(generators) != len(frames):
            raise ValueError(f"{len(frames)} streams, {len(generators)} generators")
        rows = data_sharding(mesh, len(frames))
        mine = [one(frames[b], generators[b]) for b in range(rows.start, rows.stop)]
        return _stack(_gather_rows(mine, group))

    return run


def make_slam_streaming(cfg: PislamConfig, fx: float, fy: float, cx: float, cy: float,
                        mesh, keyframe_min_inliers: int = 60, keyframe_max_gap: int = 10,
                        dist=None, device="cuda"):
    """Data-parallel multi-session SLAM, one map per stream: ``run(states,
    frames (B, T, H, W) uint8) -> (states, outs)``. ``states`` is a list of
    B ``SlamState`` (``batch_slam_states``); each rank runs the tracking
    scan (``models/slam_scan.py``) over its streams, and every rank returns
    all B new states (tables, counters and generators) and ``outs`` stacked
    (B, T, ...)."""
    from ..models.slam_scan import make_slam_track_scan

    one = make_slam_track_scan(cfg, fx, fy, cx, cy, keyframe_min_inliers=keyframe_min_inliers,
                               keyframe_max_gap=keyframe_max_gap, dist=dist, device=device)
    group = _data_group(mesh)

    def run(states, frames):
        if len(states) != len(frames):
            raise ValueError(f"{len(frames)} streams, {len(states)} states")
        rows = data_sharding(mesh, len(states))
        mine = [one(states[b], frames[b], int(states[b].counters[0]))
                for b in range(rows.start, rows.stop)]
        new_states = _gather_rows([st for st, _ in mine], group)
        return new_states, _stack(_gather_rows([out for _, out in mine], group))

    return run


def batch_slam_states(cfg: PislamConfig, n: int, seed: int = 7, device="cuda") -> list:
    """n fresh SlamStates, stream i's generator seeded with seed + i."""
    from ..models.slam import init_state
    return [init_state(cfg, seed + i, device) for i in range(n)]


# ---------------------------------------------------------------------------
# model axis: sharded matching
# ---------------------------------------------------------------------------

def match_shard(shard: int, descA, descB_s, validA, validB_s, gate=None):
    """One shard's K5 (``kernels.match_reduce``: the kernel on the card, its
    plain version on the CPU): the query ``descA`` against this shard's
    database rows ``descB_s`` (rows shard * K2s onwards of the whole one),
    optionally gated by ``gate = (uvA, uvB_s, radius)``. Returns (best,
    second, idx, col) int32 with ``idx`` a row of the whole database; ``col``
    is the first-argmin query row of each of the shard's columns."""
    if gate is not None:
        uvA, uvB_s, radius = gate
        best, second, idx, col = kernels.match_reduce(
            descA, descB_s, validA, validB_s, uvA.to(torch.float32),
            uvB_s.to(torch.float32), float(radius))
    else:
        best, second, idx, col = kernels.match_reduce(descA, descB_s, validA, validB_s)
    return best, second, idx + shard * descB_s.shape[0], col


def merge_match_shards(best, second, idx, col):
    """The n shards' ``match_shard`` outputs stacked ((n, K1) best, second,
    idx; (n, K2s) col) -> what K5 gives on the whole database, bit for bit:
    the winner per row is the lowest shard on ties (first-occurrence argmin,
    then the shard's own first argmin), the second best is the least of
    every shard's second and the losing shards' bests, and the columns'
    argmins follow one another in shard order."""
    w = torch.argmin(best, dim=0, keepdim=True)
    shards = torch.arange(best.shape[0], device=best.device)[:, None]
    losing = torch.where(shards == w, matching.MAX_DIST, best)
    second_g = torch.minimum(second.amin(dim=0), losing.amin(dim=0))
    return (best.gather(0, w)[0], second_g, idx.gather(0, w)[0], col.reshape(-1))


def sharded_match_local(group, shard: int, descA, descB_s, validA, validB_s, gate=None):
    """``match_shard`` on this rank's rows, one all_gather over ``group``,
    ``merge_match_shards``: the whole database's (best, second, idx, col)
    on every rank of the group."""
    k1 = descA.shape[0]
    parts = match_shard(shard, descA, descB_s, validA, validB_s, gate)
    stacked = gather(torch.cat(parts), group)
    best, second, idx = (stacked[:, i * k1:(i + 1) * k1] for i in range(3))
    return merge_match_shards(best, second, idx, stacked[:, 3 * k1:])


def make_sharded_match(mesh, axis: str = "model", max_distance: int = 64,
                       ratio: float = 0.8, cross_check: bool = True):
    """Cross-shard Hamming matching: ``run(descA, descB, validA, validB) ->
    (idx, dist)`` with ``matching.match``'s arguments and results, bit for
    bit. Each rank runs K5 on its rows of the database (a contiguous slice,
    no copy); K2 must divide by the axis size."""
    group, shard = mesh.get_group(axis), axis_index(mesh, axis)

    def run(descA, descB, validA, validB):
        rows = shard_rows(mesh, axis, descB.shape[0])
        merged = sharded_match_local(group, shard, descA, descB[rows], validA, validB[rows])
        return matching._filter(*merged, validA, max_distance, ratio, cross_check)

    return run


def make_sharded_map_tracker(cfg: PislamConfig, mesh, axis: str = "model"):
    """Local-map tracking with the landmark map sharded over ``axis``,
    call-compatible with ``models.slam.track_map_state`` bound to ``cfg``:
    ``run(lmap, feats, pts, R0, t0) -> (R, t, num_inliers, assoc)``. Each
    rank matches the frame against its landmark rows (gated K5 where
    cfg.map.gate_radius > 0), the candidates merge through one all_gather,
    the matched landmarks' positions are fetched by the rank that owns them
    and summed over the axis (one all_reduce), and the motion-only BA runs
    on every rank. The association is bit-identical to the whole map's.

    The gate projects the whole map once and slices it, so that each rank's
    projections are the unsharded ones bit for bit (a product over a slice
    can take another path through the BLAS and round otherwise).
    cfg.map.max_landmarks must divide by the axis size."""
    from ..models.slam import project_landmarks

    mc = cfg.map
    n = axis_size(mesh, axis)
    if mc.max_landmarks % n:
        raise ValueError(f"max_landmarks {mc.max_landmarks} does not divide by {n} shards")
    group, shard = mesh.get_group(axis), axis_index(mesh, axis)

    def run(lmap, feats, pts, R0, t0):
        rows = shard_rows(mesh, axis, lmap.xyz.shape[0])
        gate = None
        if mc.gate_radius > 0:
            gate = (pts, project_landmarks(lmap, R0, t0)[rows], mc.gate_radius)
        merged = sharded_match_local(group, shard, feats.descriptors, lmap.descriptors[rows],
                                     feats.valid, lmap.valid[rows], gate)
        idx, _ = matching._filter(*merged, feats.valid, mc.map_match_max_distance,
                                  cfg.matcher.ratio, True)
        ok = idx >= 0
        local = idx - rows.start
        own = ok & (local >= 0) & (local < rows.stop - rows.start)
        xyz_s = lmap.xyz[rows]
        part = torch.where(own[:, None],
                           xyz_s[torch.clamp(local, 0, xyz_s.shape[0] - 1).long()], 0.0)
        xyz = allsum(part, group)
        out = pnp.motion_only_ba(R0, t0, xyz, pts, ok, iters=mc.pnp_iters,
                                 inlier_threshold=mc.pnp_inlier_threshold)
        return out["R"], out["t"], out["num_inliers"], torch.where(out["inliers"], idx, -1)

    return run


def make_sharded_store_counts(cfg: PislamConfig, mesh, axis: str = "model"):
    """Loop-detection counts with the keyframe store sharded over ``axis``,
    call-compatible with ``KeyframeSLAM._store_counts``: ``run(store,
    feats) -> (F,)`` int32, identical values. Each rank runs
    ``matching.match_many`` on its keyframe rows; the counts merge through
    one all_gather. cfg.map.keyframe_capacity must divide by the axis
    size."""
    mc = cfg.matcher
    n = axis_size(mesh, axis)
    if cfg.map.keyframe_capacity % n:
        raise ValueError(f"keyframe_capacity {cfg.map.keyframe_capacity} does not divide "
                         f"by {n} shards")
    group = mesh.get_group(axis)

    def run(store, feats):
        rows = shard_rows(mesh, axis, store.descriptors.shape[0])
        _idx, counts = matching.match_many(
            store.descriptors[rows], store.kp_valid[rows], feats.descriptors, feats.valid,
            max_distance=mc.max_distance, ratio=mc.ratio, cross_check=mc.cross_check)
        return gather(counts, group).reshape(-1)

    return run


# ---------------------------------------------------------------------------
# model axis: distributed bundle adjustment
# ---------------------------------------------------------------------------

def shard_ba_problem(p: ba.BAProblem, n_shards: int, device=None) -> ba.BAProblem:
    """Re-lay out a BA problem for ``n_shards`` landmark shards: landmarks in
    equal slabs, each observation moved into its landmark's shard (its
    ``obs_pt`` then indexes the shard's slab), every shard's observations
    padded with invalid ones to the same multiple of 8. ``p`` holds tensors
    or numpy arrays (the JAX package's problem); the result is tensors on
    ``device``: by default that of ``p``'s tensors, the card for numpy.
    Host work, once per window."""
    def host(x):
        return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)

    if device is None:
        device = p.R.device if torch.is_tensor(p.R) else "cuda"
    P_, O = p.points.shape[0], p.obs_cam.shape[0]
    if P_ % n_shards:
        raise ValueError(f"{P_} landmark slots do not split into {n_shards} shards: pad them")
    pp = P_ // n_shards
    obs_pt = host(p.obs_pt)
    obs_shard = obs_pt // pp
    order = np.argsort(obs_shard, kind="stable")
    counts = np.bincount(obs_shard, minlength=n_shards)
    per = int(np.max(counts)) if O else 1
    per = -(-per // 8) * 8
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])

    def scatter(a, fill=0):
        a = host(a)
        out = np.full((n_shards, per) + a.shape[1:], fill, a.dtype)
        for s in range(n_shards):
            out[s, :counts[s]] = a[order[starts[s]:starts[s] + counts[s]]]
        return torch.as_tensor(out.reshape((n_shards * per,) + a.shape[1:]), device=device)

    def same(a):
        return torch.as_tensor(host(a), device=device)

    return ba.BAProblem(
        R=same(p.R), t=same(p.t), points=same(p.points),
        obs_cam=scatter(p.obs_cam), obs_pt=scatter(obs_pt % pp), obs_uv=scatter(p.obs_uv),
        obs_valid=scatter(p.obs_valid, fill=False), cam_valid=same(p.cam_valid),
        pt_valid=same(p.pt_valid))


def ba_shard(prob: ba.BAProblem, n_shards: int, shard: int) -> ba.BAProblem:
    """Shard ``shard`` of a problem laid out by ``shard_ba_problem`` for
    ``n_shards``: the poses, and the shard's slabs of landmarks and
    observations (slices, no copies)."""
    def rows(n):
        per = n // n_shards
        return slice(shard * per, (shard + 1) * per)

    pts, obs = rows(prob.points.shape[0]), rows(prob.obs_cam.shape[0])
    return ba.BAProblem(
        R=prob.R, t=prob.t, points=prob.points[pts], obs_cam=prob.obs_cam[obs],
        obs_pt=prob.obs_pt[obs], obs_uv=prob.obs_uv[obs], obs_valid=prob.obs_valid[obs],
        cam_valid=prob.cam_valid, pt_valid=prob.pt_valid[pts])


def make_distributed_ba(mesh, iters: int = 8, damping: float = 1e-4, axis: str = "model",
                        solver: str = "dense", cg_iters: int = 64, huber: float = 0.0):
    """Model-parallel bundle adjustment: ``run(prob) -> (prob, info)`` for a
    problem laid out by ``shard_ba_problem`` with the axis size as
    ``n_shards``, on every rank. Each rank solves with its slabs of
    landmarks and observations and the poses replicated
    (``ba.ba_iterations`` with ``allsum`` over the axis); the landmark slabs
    are all-gathered at the end.

    solver="dense" factorises the replicated (6C, 6C) reduced camera matrix
    after one all-reduce of the Schur terms per LM iteration; "cg" never
    forms W or S and all-reduces the (C, 6) camera vectors on every CG
    iteration, the path for global BA over many keyframes."""
    group, n, shard = mesh.get_group(axis), axis_size(mesh, axis), axis_index(mesh, axis)

    def run(prob: ba.BAProblem):
        local = ba_shard(prob, n, shard)
        out, info = ba.ba_iterations(local, iters, damping, solver=solver, cg_iters=cg_iters,
                                     huber=huber, allsum=lambda x: allsum(x, group))
        points = gather(out.points, group).flatten(0, 1)
        return prob._replace(R=out.R, t=out.t, points=points), info

    return run
