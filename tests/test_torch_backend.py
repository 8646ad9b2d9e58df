"""The backend, the port against ``pislam_tpu.backend`` on the fixed problems
of tests/test_backend.py: the same numpy problem goes through both.

Tolerances:
- triangulation: 1e-5 (one closed-form float32 solve per point);
- keyframe store, landmark map and observation table operations: exact;
- bundle adjustment: poses 5e-4, points 1e-3, the per-iteration costs
  1e-3 relative. float32 Schur solves and segment sums in another order;
  LM takes the same accept/reject path and the costs agree to 3e-5
  relative. Measured at most 2e-6 on poses and 1e-4 on points without the
  robust kernel; with it, on the six-camera noisy window, 3e-5 on R, 3e-4
  on t and points (depths 4 to 10): each Huber weight switches branch on
  |r| against 6e-3, and a residual on the switch takes the other branch;
- pose graph: 1e-4 (measured about 1e-6 on the noisy 12-node graphs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pislam_tpu.backend import ba as jba
from pislam_tpu.backend import keyframes as jkfs
from pislam_tpu.backend import pose_graph as jpg
from pislam_tpu.backend import triangulate as jtri
from pislam_tpu.frontend import Features as JFeatures
from pislam_tpu_torch.backend import ba as tba
from pislam_tpu_torch.backend import keyframes as tkfs
from pislam_tpu_torch.backend import pose_graph as tpg
from pislam_tpu_torch.backend import triangulate as ttri
from pislam_tpu_torch.frontend import Features
from test_backend import _random_graph, _scale_drift_graph, _toy_map, synthetic_ba
from torch_parity import t

torch.set_num_threads(1)

POSE_TOL = 5e-4
POINT_TOL = 1e-3
GRAPH_TOL = 1e-4


def port_tuple(cls, jtuple):
    """A port NamedTuple from a JAX one, field for field (uint32 words and
    codes to the port's int32 / int64)."""
    out = {}
    for name in cls._fields:
        a = getattr(jtuple, name, None)
        if a is None:
            continue
        a = np.asarray(a)
        if a.dtype == np.uint32:
            a = a.astype(np.int64) if name == "codes" else a.view(np.int32)
        out[name] = t(a)
    return cls(**out)


def assert_tuple_equal(got, want):
    for name in want._fields:
        a, b = getattr(got, name), np.asarray(getattr(want, name))
        if b.dtype == np.uint32:
            b = b.astype(np.int64) if name == "codes" else b.view(np.int32)
        assert np.array_equal(a.numpy(), b), name


# ---------------------------------------------------------------------------
# triangulation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [3, 4])
def test_triangulate_two_view_vs_jax(seed):
    rng = np.random.default_rng(seed)
    X = rng.uniform([-1, -1, 3], [1, 1, 8], (50, 3)).astype(np.float32)
    w = rng.normal(0, 0.2, 3).astype(np.float32)
    R1 = np.eye(3, dtype=np.float32) if seed == 3 else np.asarray(
        jba.se3.so3_exp(jnp.asarray(-w)))
    t1 = rng.normal(0, 0.2, 3).astype(np.float32)
    R2 = np.asarray(jba.se3.so3_exp(jnp.asarray(w)))
    t2 = np.float32([0.5, 0.05, 0.02])
    p1 = (X @ R1.T + t1)[:, :2] / (X @ R1.T + t1)[:, 2:]
    p2 = (X @ R2.T + t2)[:, :2] / (X @ R2.T + t2)[:, 2:]
    p2[0] = p1[0]                      # a degenerate zero-parallax ray
    args = (R1, t1, R2, t2, p1.astype(np.float32), p2.astype(np.float32))
    want = np.asarray(jtri.triangulate_two_view(*(jnp.asarray(a) for a in args)))
    got = ttri.triangulate_two_view(*(t(a) for a in args))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# keyframe store, landmark map, observation table
# ---------------------------------------------------------------------------

def _features(seed, k=8, words=2):
    rng = np.random.default_rng(seed)
    codes = rng.integers(1, 2**32, k, dtype=np.int64).astype(np.uint32)
    desc = rng.integers(0, 2**32, (k, words), dtype=np.uint64).astype(np.uint32)
    valid = rng.random(k) < 0.8
    jf = JFeatures(codes=jnp.asarray(codes), valid=jnp.asarray(valid),
                   angles=jnp.zeros(k, jnp.uint8), descriptors=jnp.asarray(desc))
    tf = Features(codes=t(codes.astype(np.int64)), valid=t(valid),
                  angles=torch.zeros(k, dtype=torch.uint8), descriptors=t(desc.view(np.int32)))
    return jf, tf


def test_keyframe_store_ring_vs_jax():
    """Five inserts into three ring slots through next_slot: oldest evicted."""
    js = jkfs.empty_store(capacity=3, max_kp=8, words=2)
    ts = tkfs.empty_store(capacity=3, max_kp=8, words=2, device="cpu")
    assert_tuple_equal(ts, js)
    rng = np.random.default_rng(0)
    for fid in range(5):
        jf, tf = _features(fid)
        R = np.asarray(jba.se3.so3_exp(jnp.asarray(rng.normal(0, 0.3, 3).astype(np.float32))))
        tr = rng.normal(0, 1, 3).astype(np.float32)
        pts = rng.uniform(-1, 1, (8, 2)).astype(np.float32)
        jslot, tslot = jkfs.next_slot(js), tkfs.next_slot(ts)
        assert int(jslot) == int(tslot)
        js = jkfs.insert_keyframe(js, jslot, jnp.asarray(R), jnp.asarray(tr), jf, fid,
                                  pts=jnp.asarray(pts), ordinal=10 + fid)
        ts = tkfs.insert_keyframe(ts, tslot, t(R), t(tr), tf, fid, pts=t(pts), ordinal=10 + fid)
        assert_tuple_equal(ts, js)
    assert sorted(ts.frame_id.tolist()) == [2, 3, 4]


def _append_case(seed, L=40, O=70, k=32):
    rng = np.random.default_rng(seed)
    return dict(
        xyz=rng.normal(0, 1, (k, 3)).astype(np.float32),
        desc=rng.integers(0, 2**32, (k, 2), dtype=np.uint64).astype(np.uint32),
        mask=rng.random(k) < 0.7,
        uv_a=rng.normal(0, 0.3, (k, 2)).astype(np.float32),
        uv_b=rng.normal(0, 0.3, (k, 2)).astype(np.float32),
        lm_slot=rng.integers(0, L, k).astype(np.int32), L=L, O=O)


@pytest.mark.parametrize("cursors", [(0, 0), (30, 10), (5, 60), (40, 70)])
def test_add_landmarks_and_observations_vs_jax(cursors):
    """Appends from several cursors, past the landmark and observation
    capacities (dropped rows, saturated cursors)."""
    c = _append_case(sum(cursors))
    lm_cur, obs_cur = cursors
    jl, jo = jkfs.empty_map(c["L"], 2), jkfs.empty_obs(c["O"])
    tl, to = tkfs.empty_map(c["L"], 2, device="cpu"), tkfs.empty_obs(c["O"], device="cpu")
    jl, jo, jlc, joc = jkfs.add_landmarks(
        jl, jo, jnp.int32(lm_cur), jnp.int32(obs_cur), jnp.asarray(c["xyz"]),
        jnp.asarray(c["desc"]), jnp.asarray(c["mask"]), 3, 5, jnp.asarray(c["uv_a"]),
        jnp.asarray(c["uv_b"]))
    tl, to, tlc, toc = tkfs.add_landmarks(
        tl, to, torch.tensor(lm_cur, dtype=torch.int32), torch.tensor(obs_cur, dtype=torch.int32),
        t(c["xyz"]), t(c["desc"].view(np.int32)), t(c["mask"]), 3, 5, t(c["uv_a"]), t(c["uv_b"]))
    assert_tuple_equal(tl, jl)
    assert_tuple_equal(to, jo)
    assert (int(tlc), int(toc)) == (int(jlc), int(joc))
    jl, jo, joc = jkfs.add_observations(jl, jo, joc, 7, jnp.asarray(c["lm_slot"]),
                                        jnp.asarray(c["uv_b"]), jnp.asarray(c["mask"]))
    tl, to, toc = tkfs.add_observations(tl, to, toc, 7, t(c["lm_slot"]), t(c["uv_b"]),
                                        t(c["mask"]))
    assert_tuple_equal(tl, jl)
    assert_tuple_equal(to, jo)
    assert int(toc) == int(joc) and toc.dtype == torch.int32


def _random_map(seed, F=6, L=48, O=160):
    """A populated map: poses, landmarks in front of them, observation rows
    with noisy projections, some rows and landmarks invalid or outliers."""
    rng = np.random.default_rng(seed)
    store = jkfs.empty_store(F, 4, 2)
    Rs = np.stack([np.asarray(jba.se3.so3_exp(jnp.asarray(rng.normal(0, 0.1, 3).astype(
        np.float32)))) for _ in range(F)])
    ts = rng.normal(0, 0.3, (F, 3)).astype(np.float32)
    store = store._replace(R=jnp.asarray(Rs), t=jnp.asarray(ts),
                           valid=jnp.asarray(np.arange(F) != 4),
                           ordinal=jnp.arange(F, dtype=jnp.int32),
                           frame_id=jnp.arange(F, dtype=jnp.int32) * 2)
    X = rng.uniform([-2, -2, 4], [2, 2, 9], (L, 3)).astype(np.float32)
    lmap = jkfs.empty_map(L, 2)._replace(xyz=jnp.asarray(X), valid=jnp.asarray(
        rng.random(L) < 0.9))
    kf = rng.integers(0, F, O).astype(np.int32)
    lm = rng.integers(0, L, O).astype(np.int32)
    xc = np.einsum("oij,oj->oi", Rs[kf], X[lm]) + ts[kf]
    uv = (xc[:, :2] / xc[:, 2:] + rng.normal(0, 2e-3, (O, 2))).astype(np.float32)
    uv[rng.random(O) < 0.2] += 0.5                         # gross outliers
    obs = jkfs.ObservationTable(kf=jnp.asarray(kf), lm=jnp.asarray(lm), uv=jnp.asarray(uv),
                                valid=jnp.asarray(rng.random(O) < 0.9))
    lmap = lmap._replace(obs_count=jnp.zeros(L, jnp.int32).at[jnp.asarray(lm)].add(1))
    return store, lmap, obs


MAPS = {"toy": _toy_map, "random": lambda: _random_map(1), "random2": lambda: _random_map(2)}


def _port_map(store, lmap, obs):
    return (port_tuple(tkfs.KeyframeStore, store), port_tuple(tkfs.LandmarkMap, lmap),
            port_tuple(tkfs.ObservationTable, obs))


@pytest.mark.parametrize("case", MAPS)
def test_map_queries_vs_jax(case):
    """covisibility, keyframe_redundancy, cull_landmarks."""
    jm = MAPS[case]()
    tm = _port_map(*jm)
    assert np.array_equal(tkfs.covisibility(*tm).numpy(), np.asarray(jkfs.covisibility(*jm)))
    for got, want in zip(tkfs.keyframe_redundancy(*tm, min_other_obs=2),
                         jkfs.keyframe_redundancy(*jm, min_other_obs=2)):
        assert np.array_equal(got.numpy(), np.asarray(want))
    for thr, min_obs in ((1.2e-2, 2), (0.1, 3)):
        jl, jo = jkfs.cull_landmarks(*jm, thr, min_obs)
        tl, to = tkfs.cull_landmarks(*tm, thr, min_obs)
        assert_tuple_equal(tl, jl)
        assert_tuple_equal(to, jo)


@pytest.mark.parametrize("case", MAPS)
def test_drop_observations_behind(case):
    """close_loop's cheirality step (the JAX package has none): exactly the
    valid rows of valid keyframes and landmarks whose landmark lies at depth
    <= 1e-6 in the keyframe lose their validity; nothing else changes."""
    store, lmap, obs = _port_map(*MAPS[case]())
    xyz = lmap.xyz.clone()
    xyz[::3] *= -1.0                            # a third of the landmarks behind the cameras
    lmap = lmap._replace(xyz=xyz)
    got, n = tkfs.drop_observations_behind(store, lmap, obs)
    kf, lm = obs.kf.numpy(), obs.lm.numpy()
    z = (np.einsum("oj,oj->o", store.R.numpy()[kf][:, 2].astype(np.float64), lmap.xyz.numpy()[lm])
         + store.t.numpy()[kf][:, 2])
    behind = obs.valid.numpy() & store.valid.numpy()[kf] & lmap.valid.numpy()[lm] & (z <= 1e-6)
    assert np.array_equal(got.valid.numpy(), obs.valid.numpy() & ~behind)
    assert int(n) == int(behind.sum())
    assert behind.any() and (obs.valid.numpy() & ~behind).any()
    for name in ("kf", "lm", "uv"):
        assert torch.equal(getattr(got, name), getattr(obs, name))


@pytest.mark.parametrize("case", MAPS)
def test_map_edits_vs_jax(case):
    """cull_one_keyframe, evict_stale_landmarks, compact_map."""
    jm = MAPS[case]()
    tm = _port_map(*jm)
    F = jm[0].capacity
    eligible = np.arange(F) % 2 == 1
    for min_other, frac in ((3, 0.9), (1, 0.5)):
        jout = jkfs.cull_one_keyframe(*jm, jnp.asarray(eligible), min_other, frac)
        tout = tkfs.cull_one_keyframe(*tm, t(eligible), min_other, frac)
        for got, want in zip(tout[:3], jout[:3]):
            assert_tuple_equal(got, want)
        assert int(tout[3]) == int(jout[3])
    for need in (0, 3, 100):
        jl, jo, jn = jkfs.evict_stale_landmarks(*jm, jnp.int32(need))
        tl, to, tn = tkfs.evict_stale_landmarks(*tm, torch.tensor(need, dtype=torch.int32))
        assert_tuple_equal(tl, jl)
        assert_tuple_equal(to, jo)
        assert int(tn) == int(jn)
        jl, jo, jnl, jno = jkfs.compact_map(jl, jo)
        tl, to, tnl, tno = tkfs.compact_map(tl, to)
        assert_tuple_equal(tl, jl)
        assert_tuple_equal(to, jo)
        assert (int(tnl), int(tno)) == (int(jnl), int(jno))


# ---------------------------------------------------------------------------
# bundle adjustment
# ---------------------------------------------------------------------------

BA_CASES = {
    "noise-free": dict(nc=4, npts=60, seed=0),
    "noisy": dict(nc=4, npts=60, seed=1, obs_noise=1e-3),
    "six-cameras": dict(nc=6, npts=80, seed=2, obs_noise=5e-4),
}


@pytest.mark.parametrize("solver", ["dense", "cg"])
@pytest.mark.parametrize("huber,n_fixed", [(0.0, 1), (6e-3, 2)])
@pytest.mark.parametrize("case", BA_CASES)
def test_bundle_adjust_vs_jax(case, huber, n_fixed, solver):
    prob, _ = synthetic_ba(**BA_CASES[case])
    tp = port_tuple(tba.BAProblem, prob)
    kw = dict(iters=6, damping=1e-3, huber=huber, n_fixed=n_fixed, solver=solver)
    want, winfo = jba.bundle_adjust(prob, **kw)
    got, ginfo = tba.bundle_adjust(tp, **kw)
    assert got.R.dtype == torch.float32
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), rtol=0, atol=POSE_TOL)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=0, atol=POSE_TOL)
    np.testing.assert_allclose(got.points.numpy(), np.asarray(want.points), rtol=0,
                               atol=POINT_TOL)
    np.testing.assert_allclose(ginfo["costs"].numpy(), np.asarray(winfo["costs"]),
                               rtol=1e-3, atol=1e-9)
    # the pinned cameras stay put
    np.testing.assert_array_equal(got.R[:n_fixed].numpy(), tp.R[:n_fixed].numpy())


def test_ba_cg_matches_dense():
    prob, _ = synthetic_ba(nc=6, npts=80, pose_noise=0.05)
    tp = port_tuple(tba.BAProblem, prob)
    dense, _ = tba.bundle_adjust(tp, iters=8, solver="dense")
    cg, _ = tba.bundle_adjust(tp, iters=8, solver="cg", cg_iters=64)
    assert float(tba.ba_cost(dense)[0]) < 1e-8 and float(tba.ba_cost(cg)[0]) < 1e-8
    np.testing.assert_allclose(cg.R.numpy(), dense.R.numpy(), atol=1e-4)
    np.testing.assert_allclose(cg.t.numpy(), dense.t.numpy(), atol=1e-4)


def test_ba_auto_takes_cg_above_48_cameras():
    prob, _ = synthetic_ba(nc=50, npts=100, pose_noise=0.02, point_noise=0.05, seed=3)
    tp = port_tuple(tba.BAProblem, prob)
    auto, _ = tba.bundle_adjust(tp, iters=3)
    cg, _ = tba.bundle_adjust(tp, iters=3, solver="cg")
    assert torch.equal(auto.R, cg.R) and torch.equal(auto.points, cg.points)
    want, _ = jba.bundle_adjust(prob, iters=3)
    np.testing.assert_allclose(auto.t.numpy(), np.asarray(want.t), rtol=0, atol=POSE_TOL)


def test_ba_masked_obs_ignored():
    prob, _ = synthetic_ba(seed=1)
    tp = port_tuple(tba.BAProblem, prob)
    bad = tp._replace(obs_uv=torch.where(tp.obs_valid[:, None], tp.obs_uv, 1e3))
    a, _ = tba.bundle_adjust(tp, iters=4)
    b, _ = tba.bundle_adjust(bad, iters=4)
    assert torch.equal(a.points, b.points)


# ---------------------------------------------------------------------------
# pose graph
# ---------------------------------------------------------------------------

def _port_graph(g):
    return port_tuple(tpg.PoseGraph, g)


GRAPHS = {
    "chain+loops": lambda: _random_graph(n=12, m_loop=3, seed=11, noise=0.15)[0],
    "weighted": lambda: _random_graph(n=8, m_loop=2, seed=7, noise=0.1)[0]._replace(
        edge_weight=jnp.asarray(np.float32([1, 5, 2, 9, 1, 3, 4, 20, 7]))),
    "scale-drift": lambda: _scale_drift_graph()[0],
}


@pytest.mark.parametrize("sim3", [False, True])
@pytest.mark.parametrize("solver", ["dense", "cg"])
@pytest.mark.parametrize("case", GRAPHS)
def test_pose_graph_vs_jax(case, solver, sim3):
    g = GRAPHS[case]()
    kw = dict(iters=8, damping=1e-5, solver=solver, sim3=sim3)
    want, wcosts = jpg.optimize(g, **kw)
    got, gcosts = tpg.optimize(_port_graph(g), **kw)
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), rtol=0, atol=GRAPH_TOL)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=0, atol=GRAPH_TOL)
    np.testing.assert_allclose(gcosts.numpy(), np.asarray(wcosts), rtol=1e-2, atol=1e-7)
    if sim3:
        np.testing.assert_allclose(got.node_logs.numpy(), np.asarray(want.node_logs),
                                   rtol=0, atol=GRAPH_TOL)


@pytest.mark.parametrize("sim3", [False, True])
def test_pose_graph_jacobians_vs_jax(sim3):
    g = _random_graph(noise=0.15)[0]
    if sim3:
        g = g._replace(node_logs=jnp.linspace(0, 0.3, 6, dtype=jnp.float32))
        want, got = (jax.jit(jpg._analytic_jacobians_sim3)(g),
                     tpg._analytic_jacobians_sim3(_port_graph(g)))
    else:
        want = jax.jit(jpg._analytic_jacobians)(g)
        got = tpg._analytic_jacobians(_port_graph(g))
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)


def test_pose_graph_jacobians_finite_at_convergence():
    g = _port_graph(_random_graph(noise=0.0)[0])
    ji, jj, r = tpg._analytic_jacobians(g)
    assert torch.isfinite(ji).all() and torch.isfinite(jj).all()
    assert float(torch.sum(r ** 2)) < 1e-8


def test_pose_graph_auto_takes_cg_above_64_nodes():
    g = _random_graph(n=70, m_loop=4, seed=2, noise=0.05)[0]
    got, costs = tpg.optimize(_port_graph(g), iters=6)
    want, wcosts = jpg.optimize(g, iters=6)
    assert float(costs[-1]) < 1e-4
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=0, atol=GRAPH_TOL)
