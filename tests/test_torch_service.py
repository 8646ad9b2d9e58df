"""``pislam_tpu_torch.service`` on the CPU (``--cpu``: the kernels' plain
versions).

Against the JAX service: with Huber BA off in both (ROADMAP R3) and the
port drawing the JAX package's RANSAC samples (``torch_parity.JaxDraws``),
12 eval_seq frames at chunk 1 and chunk 4 give the same report counts and
TUM trajectories within 5e-2 (tests/test_torch_slam_scan.py's TRAJ_TOL).

Kill and resume in chunk mode is bit-exact (tolerance 0): a run of 8 frames
resumed to 12 ends in the state of a straight 12-frame run, tables, counters
and generator, with frames 8-11's poses bit-equal. Then the mirrors of
tests/test_service.py, each assertion kept; the mid-run closure and the
maintenance eviction are in test_torch_service_long.py, the mirrors that
end in the closure in test_torch_service_closure.py.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from pislam_tpu import service as jservice
from pislam_tpu_torch import service
from pislam_tpu_torch.geometry import ransac as transac
from pislam_tpu_torch.io import datasets, native
from pislam_tpu_torch.utils import checkpoint as ckpt
from torch_parity import DATA, JaxDraws

torch.set_num_threads(1)

SEQ = str(DATA / "eval_seq.npz")
SEED = 7
TRAJ_TOL = 5e-2
REPORT_KEYS = ("frames", "keyframes", "landmarks", "frames_lost", "relocalisations")


def run(capsys, *args, module=service, cpu=True):
    """The service's report, and its stderr."""
    module.main(["--seq", SEQ, *args] + (["--cpu"] if cpu else []))
    cap = capsys.readouterr()
    return json.loads(cap.out.strip().splitlines()[-1]), cap.err


def _huber_off(build):
    def cfg(*a, **kw):
        c = build(*a, **kw)
        return dataclasses.replace(c, ba=dataclasses.replace(c.ba, huber=0.0))
    return cfg


@pytest.mark.parametrize("chunk", ["1", "4"])
def test_service_against_jax(tmp_path, capsys, monkeypatch, chunk):
    monkeypatch.setattr(jservice, "build_config", _huber_off(jservice.build_config))
    monkeypatch.setattr(service, "build_config", _huber_off(service.build_config))
    draws = JaxDraws(jax.random.PRNGKey(SEED))
    monkeypatch.setattr(transac, "sample_indices", draws)
    args = ["--max-frames", "12", "--no-loop-close", "--chunk", chunk]
    want, _ = run(capsys, *args, "--traj-out", str(tmp_path / "jax.txt"), module=jservice,
                  cpu=False)
    got, _ = run(capsys, *args, "--traj-out", str(tmp_path / "port.txt"))
    assert draws.calls == 11
    for k in REPORT_KEYS:
        assert got[k] == want[k], k
    assert got["keyframes"] >= 4 and got["landmarks"] > 0
    stamps, xyz = datasets.load_tum_trajectory(str(tmp_path / "port.txt"))
    jstamps, jxyz = datasets.load_tum_trajectory(str(tmp_path / "jax.txt"))
    assert stamps.tolist() == jstamps.tolist() == list(range(12))
    np.testing.assert_allclose(xyz, jxyz, rtol=0, atol=TRAJ_TOL)


def test_chunk_resume_equals_straight_run(tmp_path, capsys, monkeypatch):
    trajs = []
    real = datasets.save_tum_trajectory

    def record(path, stamps, Rs, ts):
        trajs.append((list(stamps), np.stack(Rs), np.stack(ts)))
        real(path, stamps, Rs, ts)

    monkeypatch.setattr(datasets, "save_tum_trajectory", record)
    common = ["--chunk", "4", "--checkpoint-every", "4", "--no-loop-close",
              "--traj-out", str(tmp_path / "traj.txt")]
    killed = ["--checkpoint-dir", str(tmp_path / "killed"), *common]
    first, _ = run(capsys, "--max-frames", "8", *killed)
    resumed, _ = run(capsys, "--max-frames", "12", *killed)
    straight, _ = run(capsys, "--max-frames", "12", "--checkpoint-dir",
                      str(tmp_path / "straight"), *common)
    assert first["resumed_at"] == 0 and resumed["resumed_at"] == 8
    for k in REPORT_KEYS[1:]:
        assert resumed[k] == straight[k], k

    a = ckpt.restore(str(tmp_path / "killed" / "state"))
    b = ckpt.restore(str(tmp_path / "straight" / "state"))
    assert a.keys() == b.keys() and a["steps_done"] == b["steps_done"] == 3
    for name in a:
        if isinstance(a[name], dict):          # the generator
            assert a[name]["generator"] == b[name]["generator"] == "cpu"
            assert torch.equal(a[name]["state"], b[name]["state"]), name
        elif isinstance(a[name], torch.Tensor):
            assert torch.equal(a[name], b[name]), name
    _, (s2, R2, t2), (s3, R3, t3) = trajs
    assert s2 == list(range(8, 12)) and s3 == list(range(12))
    assert np.array_equal(R2, R3[8:]) and np.array_equal(t2, t3[8:])


def test_service_run_and_resume(tmp_path, capsys):
    traj = str(tmp_path / "traj.txt")
    ck = str(tmp_path / "ckpt")
    r1, _ = run(capsys, "--max-frames", "5", "--checkpoint-dir", ck, "--checkpoint-every", "2")
    assert r1["frames"] == 5 and r1["resumed_at"] == 0
    assert r1["keyframes"] >= 2
    r2, err = run(capsys, "--max-frames", "8", "--checkpoint-dir", ck,
                  "--checkpoint-every", "2", "--traj-out", traj, "--metrics")
    assert r2["resumed_at"] == 5
    assert r2["keyframes"] >= r1["keyframes"]
    mlines = [line for line in err.splitlines() if line.startswith("{")]
    assert len(mlines) == 3                       # frames 5..7
    assert all("time_ms.extract" in json.loads(line) for line in mlines)
    stamps, xyz = datasets.load_tum_trajectory(traj)
    assert stamps.tolist() == [5.0, 6.0, 7.0]
    assert np.isfinite(xyz).all()


def test_service_map_export(tmp_path, capsys):
    ply = str(tmp_path / "map.ply")
    rep, _ = run(capsys, "--max-frames", "8", "--map-out", ply, "--no-loop-close")
    lines = open(ply).read().splitlines()
    assert lines[0] == "ply" and "end_header" in lines
    n = int(next(line for line in lines if line.startswith("element vertex")).split()[-1])
    body = lines[lines.index("end_header") + 1:]
    assert len(body) == n
    assert n == rep["landmarks"] + rep["keyframes"]
    reds = [line for line in body if line.endswith(" 255 0 0")]
    assert len(reds) == rep["keyframes"]
    vals = np.array([line.split()[:3] for line in body], dtype=np.float64)
    assert np.isfinite(vals).all()


@pytest.mark.parametrize("layout", ["frames", "tum", "kitti"])
def test_service_png_sources(tmp_path, capsys, layout):
    """The first 6 eval_seq frames as PNGs in a plain directory, a TUM-RGBD
    tree and a KITTI tree (through io/native.FrameStream) give the --seq
    run's report and trajectory exactly; the TUM and KITTI trees' ground
    truth gives an ATE."""
    d = np.load(DATA / "eval_seq.npz")
    frames, n = d["frames"][:6], 6
    gt = np.stack([-R.T @ t for R, t in zip(d["Rs"][:n], d["ts"][:n])])
    intr = [a for k in ("fx", "fy", "cx", "cy") for a in (f"--{k}", repr(float(d[k])))]
    if layout == "frames":
        names = [f"{i:04d}.png" for i in range(n)]
        source = ["--frames", str(tmp_path)]
    elif layout == "tum":
        names = [f"rgb/{i}.png" for i in range(n)]
        (tmp_path / "rgb.txt").write_text("".join(f"{i}.0 {p}\n" for i, p in enumerate(names)))
        (tmp_path / "groundtruth.txt").write_text("".join(
            f"{i}.0 {x!r} {y!r} {z!r} 0 0 0 1\n" for i, (x, y, z) in enumerate(gt.tolist())))
        source = ["--tum", str(tmp_path)]
    else:
        names = [f"sequences/03/image_0/{i:06d}.png" for i in range(n)]
        (tmp_path / "poses").mkdir()
        np.savetxt(tmp_path / "poses" / "03.txt",
                   np.stack([np.hstack([np.eye(3), c[:, None]]).reshape(-1) for c in gt]))
        source = ["--kitti", str(tmp_path), "--kitti-seq", "03"]
    for name, img in zip(names, frames):
        (tmp_path / name).parent.mkdir(parents=True, exist_ok=True)
        native.write_png(str(tmp_path / name), img)
    common = [*intr, "--no-loop-close", "--cpu"]
    service.main([*source, *common, "--traj-out", str(tmp_path / "png.txt")])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want, _ = run(capsys, "--max-frames", str(n), *common[:-1],
                  "--traj-out", str(tmp_path / "seq.txt"))
    for k in REPORT_KEYS:
        assert got[k] == want[k], k
    assert (tmp_path / "png.txt").read_text() == (tmp_path / "seq.txt").read_text()
    if layout == "frames":
        assert "ate_rmse" not in got
    else:
        # the layouts store float32 positions; the report rounds to 4 decimals
        assert got["ate_rmse"] == pytest.approx(want["ate_rmse"], abs=1.5e-4)


@pytest.mark.parametrize("args, message", [
    (["--model-parallel", "2", "--cpu"], "torchrun --nproc-per-node 2"),
    (["--map-in", "m", "--checkpoint-dir", "c", "--cpu"], "mutually exclusive"),
    (["--localization-only", "--chunk", "4", "--cpu"], "per-frame loop"),
    ([], "pass --cpu"),
])
def test_service_argument_errors(capsys, args, message):
    """--model-parallel N needs a process group of N ranks (torchrun; the
    sharded run itself is in tests/test_torch_multiprocess.py); the other
    combinations are refused as the JAX service refuses them; with no card
    and no --cpu the service stops instead of falling back."""
    if not args and torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as e:
        service.main(["--seq", SEQ, *args])
    assert e.value.code == 2
    assert message in capsys.readouterr().err
