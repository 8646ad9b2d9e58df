"""The port's distributed layer (``pislam_tpu_torch/parallel/``) on the CPU,
against the JAX package's (tests/test_parallel.py).

The JAX references come from this process, on conftest's 8 virtual devices:
the JAX package's single-device functions and, for the match, the tracker
and the store counts, its sharded ones too. The port runs in ONE gloo group
of 4 ranks (tests/torch_dist_worker.py, spawned once for the module), which
runs every check; each test below asserts its part, with the JAX tests' own
tolerances: extraction, matching, match indices and store counts bit-exact;
BA R and t within 1e-4 and costs within rtol 1e-3; the 256-camera CG below
1e-8 per observation; sharded-map SLAM with the same keyframes and inlier
counts, map inliers within 2 and the trajectory within 2e-3 of the JAX
package's, replaying the JAX run's RANSAC draws (recorded here as arrays:
``jax.random``'s draws cannot be reproduced in torch). Every rank must
return the same results. The shard body and the merge are also held in this
process, without a group, at 1, 2, 4 and 8 shards.
"""

import dataclasses
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import oracles
import torch_dist_worker as W
from pislam_tpu import matching as jmatching
from pislam_tpu.backend import ba as jba
from pislam_tpu.backend import keyframes as jkfs
from pislam_tpu.config import FrontendConfig, MeshConfig, PislamConfig, PyramidConfig
from pislam_tpu.frontend import Features as JFeatures
from pislam_tpu.frontend import _extract_impl, make_extract_fn
from pislam_tpu.ops import nms
from pislam_tpu.ops import pyramid as jpyr
from pislam_tpu.parallel import dist as jdist
from pislam_tpu.parallel import mesh as jmesh
from pislam_tpu_torch import matching as tmatching
from pislam_tpu_torch.ops import kernels
from pislam_tpu_torch.parallel import dist as tdist_mod
from test_backend import synthetic_ba
from torch_parity import JaxDraws, port_config

torch.set_num_threads(1)

RANKS = 4
TIMEOUT = 300            # seconds for the whole group; it takes ~30 s
SLAM_FRAMES = 14


def small_config():
    return PislamConfig(
        pyramid=PyramidConfig(base_width=96, base_height=80, num_levels=2),
        frontend=FrontendConfig(fast_threshold=20, harris_threshold=1 << 10, border=16,
                                max_keypoints=128))


def np_tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


def jax_mesh(dp, mp):
    return jmesh.make_mesh(MeshConfig(data_parallel=dp, model_parallel=mp))


class RecordingDraws(JaxDraws):
    """The JAX package's draws (torch_parity.JaxDraws), each kept as numpy."""

    def __init__(self, key):
        super().__init__(key)
        self.log = []

    def __call__(self, valid, iters, sample_size, generator=None):
        idx = super().__call__(valid, iters, sample_size, generator)
        self.log.append(idx.numpy())
        return idx


def _pyramid_frames(pyr, n, seed0):
    frames = np.zeros((n, pyr.padded_height, pyr.stride), np.uint8)
    for b in range(n):
        for (w, h), r in zip(pyr.level_sizes, pyr.level_rows):
            frames[b, r:r + h, :w] = oracles.make_test_image(h, w, seed=seed0 + b)
    return frames


def _streams(pyr, nb, t, seed_of):
    return np.stack([np.stack([oracles.make_test_image(pyr.base_height, pyr.base_width,
                                                       seed=seed_of(b, i))
                               for i in range(t)]) for b in range(nb)])


def _match_inputs():
    rng = np.random.default_rng(11)
    k1, k2 = 192, 512
    base = rng.integers(0, 2**31, (k2, 8), dtype=np.int64).astype(np.uint32)
    pick = rng.integers(0, k2, k1)
    noise = (rng.random((k1, 8, 32)) < 0.03).astype(np.uint32)
    noise = (noise << np.arange(32, dtype=np.uint32)).sum(-1).astype(np.uint32)
    return [base[pick] ^ noise, base, rng.random(k1) < 0.9, rng.random(k2) < 0.9]


def _tracker_case(gated):
    """tests/test_parallel.py's tracker scenarios: noisy views of a 300
    landmark map, or a 240 landmark map of aliased descriptors behind the
    0.06 projection gate."""
    base = PislamConfig()
    if gated:
        rng = np.random.default_rng(29)
        cfg = dataclasses.replace(base, map=dataclasses.replace(base.map, gate_radius=0.06))
        K, nlm = 192, 240
        xyz = rng.uniform([-4, -3, 2], [4, 3, 10], (nlm, 3)).astype(np.float32)
        desc = rng.integers(0, 2**31, (nlm // 2, 8), dtype=np.int64).astype(np.uint32)
        desc = np.vstack([desc, desc])
        t0 = np.float32([0.02, 0.01, -0.01])
    else:
        rng = np.random.default_rng(13)
        cfg = base
        K, nlm = 256, 300
        xyz = rng.uniform([-4, -3, 2], [4, 3, 10], (nlm, 3)).astype(np.float32)
        desc = rng.integers(0, 2**31, (nlm, 8), dtype=np.int64).astype(np.uint32)
        t0 = np.float32([0.05, -0.02, 0.01])
    lmap = jkfs.empty_map(cfg.map.max_landmarks, cfg.frontend.words)
    lmap = lmap._replace(xyz=lmap.xyz.at[:nlm].set(xyz),
                         descriptors=lmap.descriptors.at[:nlm].set(desc),
                         valid=lmap.valid.at[:nlm].set(True))
    R0 = np.eye(3, dtype=np.float32)
    pick = rng.integers(0, nlm, K)
    xc = xyz[pick] @ R0.T + t0
    pts = (xc[:, :2] / xc[:, 2:]).astype(np.float32)
    if not gated:
        pts += rng.normal(0, 1e-3, pts.shape).astype(np.float32)
    feats = JFeatures(codes=jnp.zeros(K, jnp.uint32), valid=jnp.ones(K, bool),
                      angles=jnp.zeros(K, jnp.uint8), descriptors=jnp.asarray(desc[pick]))
    return cfg, lmap, feats, pts, R0, t0


def _kernel_branch_inputs():
    rng = np.random.default_rng(31)
    k1, k2 = 192, 1024
    d1 = rng.integers(0, 2**32, (k1, 8), dtype=np.uint32)
    d2 = rng.integers(0, 2**32, (k2, 8), dtype=np.uint32)
    d2[100] = d1[7]
    d2[700] = d1[7]     # a duplicate split across shards
    return {"d1": d1, "d2": d2, "v1": rng.random(k1) < 0.9, "v2": rng.random(k2) < 0.9,
            "uv1": rng.uniform(-0.5, 0.5, (k1, 2)).astype(np.float32),
            "uv2": rng.uniform(-0.5, 0.5, (k2, 2)).astype(np.float32)}


def jax_sharded_local(a, n, radius):
    """The JAX package's _sharded_match_local over n model shards: (idx, best)."""
    def body(b_s, v2_s, uv2_s):
        g = (jnp.asarray(a["uv1"]), uv2_s, radius) if radius else None
        return jdist._sharded_match_local("model", n, jnp.asarray(a["d1"]), b_s,
                                          jnp.asarray(a["v1"]), v2_s, 64, 0.8, True, gate=g)
    f = jax.jit(jax.shard_map(body, mesh=jax_mesh(8 // n, n),
                              in_specs=(P("model"), P("model"), P("model")),
                              out_specs=(P(), P()), check_vma=False))
    return np_tree(f(jnp.asarray(a["d2"]), jnp.asarray(a["v2"]), jnp.asarray(a["uv2"])))


def _jax_slam(world):
    """The JAX package's KeyframeSLAM over the synthetic scene, one device."""
    from test_models import projector, tiny_cfg
    from pislam_tpu.models.slam import KeyframeSLAM

    proj = projector(world["xyz"], world["desc"], world["Rs"], world["ts"])
    slam = KeyframeSLAM(tiny_cfg(), W.FX, W.FY, W.CX, W.CY, features_fn=proj,
                        keyframe_min_inliers=220, keyframe_max_gap=4)
    per_frame = [W.slam_record(slam.process(i)) for i in range(SLAM_FRAMES)]
    return {"per_frame": per_frame, "trajectory": np.stack(slam.trajectory),
            "num_keyframes": slam.num_keyframes, "keyframe_frames": slam.keyframe_frames}


def _inputs():
    """The group's inputs, as numpy. The port's unsharded SLAM run draws the
    JAX package's samples here, and they are recorded for the group."""
    from test_models import make_trajectory, make_world, tiny_cfg

    inp = {}
    prob, _ = synthetic_ba(nc=4, npts=64, seed=5, pad_obs=64)
    inp["ba_prob"] = np_tree(prob._asdict())
    prob256, _ = synthetic_ba(nc=256, npts=256, pose_noise=0.02, point_noise=0.05, seed=3)
    inp["ba_prob256"] = np_tree(prob256._asdict())
    cfg = small_config()
    inp["small_cfg"] = cfg.to_json()
    inp["pyramids"] = _pyramid_frames(cfg.pyramid, 8, 100)
    inp["stream_frames"] = _streams(cfg.pyramid, 4, 4, lambda b, i: 10 * b + i)
    inp["vo_frames"] = _streams(cfg.pyramid, 4, 3, lambda b, i: 100 * b + i)
    inp["slam_frames"] = _streams(cfg.pyramid, 4, 3, lambda b, i: 200 * b + i)
    inp["match_args"] = _match_inputs()
    for key, gated in (("tracker", False), ("tracker_gated", True)):
        tcfg, lmap, feats, pts, R0, t0 = _tracker_case(gated)
        inp[key] = {"cfg": tcfg.to_json(), "lmap": np_tree(lmap._asdict()),
                    "desc": np.asarray(feats.descriptors), "valid": np.asarray(feats.valid),
                    "pts": pts, "R0": R0, "t0": t0}
    rng = np.random.default_rng(17)
    F, K = PislamConfig().map.keyframe_capacity, 128
    desc = rng.integers(0, 2**31, (F, K, 8), dtype=np.int64).astype(np.uint32)
    kv = rng.random((F, K)) < 0.8
    q = desc[5].copy()
    q[::3] = rng.integers(0, 2**31, (len(q[::3]), 8), dtype=np.int64).astype(np.uint32)
    inp["store"] = {"descriptors": desc, "kp_valid": kv, "query": q}
    xyz, wdesc = make_world(seed=21)
    Rs, ts_ = make_trajectory(SLAM_FRAMES)
    world = {"xyz": xyz, "desc": wdesc, "Rs": Rs, "ts": ts_}
    draws = RecordingDraws(jax.random.PRNGKey(7))
    slam_cfg = port_config(tiny_cfg())
    port_slam = W.run_slam(slam_cfg, world, draws, frames=SLAM_FRAMES)
    inp["slam"] = {"cfg": slam_cfg.to_json(), "world": world, "draws": draws.log}
    inp["kernel_branch"] = _kernel_branch_inputs()
    return inp, port_slam


def _jax_references(inp):
    """The JAX package's results on the same inputs."""
    from pislam_tpu.models.slam import track_map_state

    ref = {}
    prob = jba.BAProblem(**{k: jnp.asarray(v) for k, v in inp["ba_prob"].items()})
    for solver in ("dense", "cg"):
        out, info = jba.bundle_adjust(prob, iters=6, damping=1e-3, solver=solver, cg_iters=64)
        ref[f"ba_{solver}"] = {"R": np.asarray(out.R), "t": np.asarray(out.t),
                               "costs": np.asarray(info["costs"])}

    cfg = small_config()
    pyr, mc = cfg.pyramid, cfg.matcher
    extract = make_extract_fn(cfg)
    ref["extraction"] = [np_tree(extract(f)) for f in inp["pyramids"]]
    mask = jnp.asarray(nms.make_level_mask(pyr.level_sizes, pyr.level_rows, pyr.padded_height,
                                           pyr.stride, cfg.frontend.border))
    frontend = jax.jit(lambda f: _extract_impl(jpyr.build_pyramid(f, pyr), mask, cfg))
    counts = []
    for s in inp["stream_frames"]:
        prev, row = frontend(jnp.asarray(s[0])), []
        for f in s[1:]:
            cur = frontend(jnp.asarray(f))
            idx2, _ = jmatching.match(prev.descriptors, cur.descriptors, prev.valid, cur.valid,
                                      max_distance=mc.max_distance, ratio=mc.ratio,
                                      cross_check=mc.cross_check)
            row.append((int(cur.num_valid), int(jnp.sum(idx2 >= 0))))
            prev = cur
        counts.append(row)
    ref["streaming"] = np.array(counts)

    jargs = [jnp.asarray(a) for a in inp["match_args"]]
    kw = dict(max_distance=64, ratio=0.8, cross_check=True)
    ref["match"] = np_tree(jmatching.match(*jargs, **kw))
    ref["match_sharded"] = np_tree(jdist.make_sharded_match(jax_mesh(2, 4), **kw)(*jargs))

    for key, gated in (("tracker", False), ("tracker_gated", True)):
        tcfg, lmap, feats, pts, R0, t0 = _tracker_case(gated)
        args = (lmap, feats, jnp.asarray(pts), jnp.asarray(R0), jnp.asarray(t0))
        ref[key] = np_tree(jax.jit(lambda lm, f, p, R, t, c=tcfg: track_map_state(
            c, lm, f, p, R, t))(*args))
        ref[key + "_sharded"] = np_tree(
            jdist.make_sharded_map_tracker(tcfg, jax_mesh(2, 4))(*args))

    scfg, st = PislamConfig(), inp["store"]
    F, K = st["kp_valid"].shape
    store = jkfs.empty_store(F, K, 8)._replace(descriptors=jnp.asarray(st["descriptors"]),
                                                kp_valid=jnp.asarray(st["kp_valid"]),
                                                valid=jnp.ones(F, bool))
    jfeats = JFeatures(codes=jnp.zeros(K, jnp.uint32), valid=jnp.ones(K, bool),
                       angles=jnp.zeros(K, jnp.uint8), descriptors=jnp.asarray(st["query"]))
    mcs = scfg.matcher
    ref["store_counts"] = np.asarray(jmatching.match_many(
        store.descriptors, store.kp_valid, jfeats.descriptors, jfeats.valid,
        max_distance=mcs.max_distance, ratio=mcs.ratio, cross_check=mcs.cross_check)[1])
    ref["store_counts_sharded"] = np.asarray(
        jdist.make_sharded_store_counts(scfg, jax_mesh(2, 4))(store, jfeats))

    ref["slam"] = _jax_slam(inp["slam"]["world"])
    ref["kernel_branch"] = {r: jax_sharded_local(inp["kernel_branch"], 4, r)
                            for r in (0.0, 0.2)}
    return ref


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """(inputs, the JAX package's results, every rank's results): the gloo
    group of tests/torch_dist_worker.py's parallel suite runs while this
    process computes the JAX references."""
    inp, port_slam = _inputs()
    workdir = tmp_path_factory.mktemp("torch_dist")
    with open(workdir / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    port = W.free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, W.__file__, "parallel", str(port), str(r),
                               str(RANKS), str(workdir)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env)
             for r in range(RANKS)]
    outs = []
    try:
        ref = _jax_references(inp)
        ref["slam_port"] = port_slam
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        pytest.fail("the gloo group timed out\n" + "\n".join(o[-3000:] for o in outs))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    results = []
    for r in range(RANKS):
        with open(workdir / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return inp, ref, results


@pytest.fixture(scope="module")
def group(case):
    return case[2]


def test_mesh_shapes(group):
    """(2, 2) and the default all-data (4, 1) over 4 ranks; each rank's rows."""
    for r, res in enumerate(group):
        m = res["mesh_shapes"]
        assert tuple(m["shape"]) == (2, 2) and tuple(m["default"]) == (4, 1)
        assert m["data_rows"] == slice(4 * (r // 2), 4 * (r // 2) + 4)
        assert m["model_rows"] == slice(4 * (r % 2), 4 * (r % 2) + 4)
        assert m["replicated"] == slice(0, 8)


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_distributed_ba_matches_single(group, case, solver):
    """Four landmark shards, the Schur sums (dense) or the CG camera vectors
    all-reduced: the JAX package's single-device BA."""
    got, want = group[0][f"ba_{solver}"], case[1][f"ba_{solver}"]
    np.testing.assert_allclose(got["R"], want["R"], atol=1e-4)
    np.testing.assert_allclose(got["t"], want["t"], atol=1e-4)
    np.testing.assert_allclose(got["costs"], want["costs"], rtol=1e-3)


def test_distributed_ba_cg_256_cameras(group):
    """256 cameras over four shards, solved matrix-free: the noise-free
    problem converges through the per-iteration all-reduce."""
    res = group[0]["ba_cg_256"]
    assert float(res["cost1"]) / float(res["nobs"]) < 1e-8, (res["cost0"], res["cost1"])


def test_data_parallel_extraction_matches_single(group, case):
    got = group[0]["extraction"]
    for b, want in enumerate(case[1]["extraction"]):
        assert np.array_equal(got["codes"][b], want.codes.astype(np.int64))
        assert np.array_equal(got["descriptors"][b].view(np.uint32), want.descriptors)
        assert np.array_equal(got["valid"][b], want.valid)
        assert np.array_equal(got["angles"][b], want.angles)


def test_streaming_pipeline_matches_single(group, case):
    got = group[0]["streaming"]
    assert got["nfeat"].shape == (4, 3)
    want = case[1]["streaming"]
    assert np.array_equal(got["nfeat"], want[..., 0])
    assert np.array_equal(got["nmatch"], want[..., 1])


def test_vo_streaming_matches_single_scan(group, case):
    """Each stream's trajectory is the port's single-stream make_vo_scan
    with the same generator (the JAX package's draws differ, R4)."""
    from pislam_tpu_torch.models.visual_odometry import make_vo_scan
    got = group[0]["vo_streaming"]
    frames = case[0]["vo_frames"]
    assert got["R"].shape == (4, 3, 3, 3) and got["t"].shape == (4, 3, 3)
    one = make_vo_scan(port_config(small_config()), 80.0, 80.0, 48.0, 40.0, device="cpu")
    for b in range(len(frames)):
        ref = one(frames[b], torch.Generator().manual_seed(b))
        np.testing.assert_allclose(got["R"][b], ref["R"].numpy(), atol=1e-5)
        np.testing.assert_allclose(got["t"][b], ref["t"].numpy(), atol=1e-5)
        assert np.array_equal(got["accepted"][b], ref["accepted"].numpy())


def test_slam_streaming_matches_single_scan(group, case):
    from pislam_tpu_torch.models.slam import init_state
    from pislam_tpu_torch.models.slam_scan import make_slam_track_scan
    got = group[0]["slam_streaming"]
    outs, frames = got["outs"], case[0]["slam_frames"]
    assert outs["pose_R"].shape == (4, 3, 3, 3)
    assert outs["keyframe"][:, 0].all()
    assert (got["counters"][:, 0] >= 1).all()
    cfg = port_config(small_config())
    one = make_slam_track_scan(cfg, 80.0, 80.0, 48.0, 40.0, keyframe_min_inliers=40,
                               keyframe_max_gap=2, device="cpu")
    for b in range(len(frames)):
        st, ref = one(init_state(cfg, seed=7 + b, device="cpu"), frames[b], 0)
        np.testing.assert_allclose(outs["pose_t"][b], ref["pose_t"].numpy(), atol=1e-5)
        assert np.array_equal(outs["keyframe"][b], ref["keyframe"].numpy())
        assert np.array_equal(got["counters"][b], st.counters.numpy())
        assert np.array_equal(got["generator"][b], st.generator.get_state().numpy())


def test_sharded_match_matches_single(group, case):
    """Four database shards: bit-identical to the JAX package's matching.match
    and to its sharded match."""
    got = group[0]["sharded_match"]
    for key in ("match", "match_sharded"):
        idx, d = case[1][key]
        assert np.array_equal(got["idx"], idx) and np.array_equal(got["dist"], d), key


def test_checkpointed_runner_resumes(tmp_path):
    from pislam_tpu_torch.parallel.elastic import CheckpointedRunner, initialize_multihost

    assert initialize_multihost(device="cpu") == 0   # single-process no-op
    calls = []

    def step(state, item):
        calls.append(int(item))
        return {"acc": state["acc"] + float(item)}

    d = str(tmp_path / "ck")
    r = CheckpointedRunner(step, d, every=3)
    s = r.run(r.resume({"acc": torch.zeros(())}), range(5))
    assert float(s["acc"]) == 10.0 and calls == [0, 1, 2, 3, 4]
    calls.clear()
    r2 = CheckpointedRunner(step, d, every=3)       # a restarted worker
    s2 = r2.run(r2.resume({"acc": torch.zeros(())}), range(5))
    assert float(s2["acc"]) == 10.0 and calls == []


def _assert_tracker(got, case, key, min_inliers):
    for want in (case[1][key], case[1][key + "_sharded"]):
        R, t_, ni, assoc = want
        assert int(ni) > min_inliers
        assert int(got["num_inliers"]) == int(ni)
        assert np.array_equal(got["assoc"], assoc)
        np.testing.assert_allclose(got["R"], R, atol=1e-5)
        np.testing.assert_allclose(got["t"], t_, atol=1e-5)


def test_sharded_map_tracker_matches_single(group, case):
    """The 8192-slot map over four shards: the association bit-identical to
    the JAX package's track_map_state and its sharded tracker, the pose
    within 1e-5."""
    _assert_tracker(group[0]["tracker"], case, "tracker", 50)


def test_sharded_map_tracker_gated_matches_single(group, case):
    _assert_tracker(group[0]["tracker_gated"], case, "tracker_gated", 100)


def test_sharded_store_counts_matches_single(group, case):
    got = group[0]["store_counts"]["counts"]
    assert int(np.argmax(case[1]["store_counts"])) == 5
    assert np.array_equal(got, case[1]["store_counts"])
    assert np.array_equal(got, case[1]["store_counts_sharded"])


def test_sharded_map_slam_end_to_end(group, case):
    """KeyframeSLAM(mesh=...) over four shards with the JAX run's draws: the
    JAX package's keyframe decisions and inlier counts, map inliers within
    2, trajectory within 2e-3; the port's unsharded run exactly; loop
    detection against the sharded store relocalises frame 3."""
    got, want, port = group[0]["slam_e2e"], case[1]["slam"], case[1]["slam_port"]
    for i, (a, b) in enumerate(zip(want["per_frame"], got["per_frame"])):
        assert a["keyframe"] == b["keyframe"], i
        assert a["num_inliers"] == b["num_inliers"], i
        assert abs(a["map_inliers"] - b["map_inliers"]) <= 2, i
    assert got["num_keyframes"] == want["num_keyframes"]
    assert got["keyframe_frames"] == want["keyframe_frames"]
    np.testing.assert_allclose(got["trajectory"], want["trajectory"], atol=2e-3)
    assert got["per_frame"] == port["per_frame"]
    np.testing.assert_array_equal(got["trajectory"], port["trajectory"])
    assert got["reloc_R"] is not None
    Rs = case[0]["slam"]["world"]["Rs"]
    assert np.linalg.norm(got["reloc_R"] - Rs[3]) < 0.06


def test_sharded_match_kernel_branch(group, case):
    """The shard body through K5's wrapper (its plain version on CPU
    tensors), gated and ungated, with a duplicate split across shards: the
    JAX package's _sharded_match_local, indices and raw best distances."""
    for radius, (idx, best) in case[1]["kernel_branch"].items():
        got = group[0]["kernel_branch"][radius]
        assert np.array_equal(got["idx"], idx), radius
        assert np.array_equal(got["best"], best), radius


def test_dryrun_multichip(group):
    assert all(res["dryrun"]["ok"] for res in group)


def test_ranks_agree(group):
    """Every rank returns the same results, bit for bit: decisions, poses,
    counters and maps after sharded SLAM, poses and costs after distributed
    BA, the gathered streams."""
    def same(a, b, where):
        if isinstance(a, dict):
            assert a.keys() == b.keys(), where
            for k in a:
                same(a[k], b[k], f"{where}.{k}")
        elif isinstance(a, (list, tuple)):
            assert len(a) == len(b), where
            for i, (x, y) in enumerate(zip(a, b)):
                same(x, y, f"{where}[{i}]")
        elif isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), where
        else:
            assert a == b, where

    for r in range(1, RANKS):
        for name in group[0]:
            if name not in ("seconds", "mesh_shapes"):
                same(group[r][name], group[0][name], f"rank {r} {name}")
    assert group[0]["slam_e2e"]["counters"][0] >= 3


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_shard_merge_in_process(case, n):
    """n shards in one process, no group: match_shard on each slice, the
    stacks an all_gather would make, merge_match_shards. The merged outputs
    are K5's on the whole database bit for bit, and filtered they are the
    JAX package's _sharded_match_local over n devices, gated and ungated."""
    a = case[0]["kernel_branch"]
    d1, d2, v1, v2 = W.words(a["d1"]), W.words(a["d2"]), W.t(a["v1"]), W.t(a["v2"])
    uv1, uv2 = W.t(a["uv1"]), W.t(a["uv2"])
    k2s = d2.shape[0] // n
    for radius in (0.0, 0.2):
        gated = (uv1, uv2, radius) if radius else ()
        parts = [tdist_mod.match_shard(s, d1, d2[s * k2s:(s + 1) * k2s], v1,
                                       v2[s * k2s:(s + 1) * k2s],
                                       (uv1, uv2[s * k2s:(s + 1) * k2s], radius) if radius
                                       else None)
                 for s in range(n)]
        merged = tdist_mod.merge_match_shards(*(torch.stack(x) for x in zip(*parts)))
        whole = kernels.match_reduce_plain(d1, d2, v1, v2, *gated)
        for got, want in zip(merged, whole):
            assert torch.equal(got, want), (n, radius)
        idx, _ = tmatching._filter(*merged, v1, 64, 0.8, True)
        want_idx, want_best = jax_sharded_local(a, n, radius)
        assert np.array_equal(idx.numpy(), want_idx), (n, radius)
        assert np.array_equal(merged[0].numpy(), want_best), (n, radius)
