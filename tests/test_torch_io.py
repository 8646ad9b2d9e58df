"""``pislam_tpu_torch.io`` (native PNG I/O, the frame stream, dataset layouts,
TUM / PLY export) against ``pislam_tpu.io``.

The same seeded numpy inputs go through both packages. PNG files, TUM
trajectories and PLY maps are compared byte for byte, images and parsed
arrays exactly (tolerance 0); quaternions are equal to the JAX package's
bit for bit and rotate vectors as their rotations do within 1e-12.
"""

import hashlib

import numpy as np
import pytest
from PIL import Image

from pislam_tpu.io import datasets as jdatasets
from pislam_tpu.io import native as jnative
from pislam_tpu_torch.io import datasets, native


def _frames(n, h, w, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w), np.uint8) for _ in range(n)]


def _rotation(w):
    """Rodrigues' formula in float64: the rotation by angle |w| about w."""
    theta = np.linalg.norm(w)
    k = w / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * K @ K


def _quat_rotate(q, v):
    """Rotate v by the unit quaternion q = (x, y, z, w)."""
    x, y, z, w = q
    u = np.array([x, y, z])
    return v + 2 * np.cross(u, np.cross(u, v) + w * v)


def _digest(path):
    return hashlib.sha256(path.read_bytes()).hexdigest()


def test_native_library_builds_into_the_port(tmp_path, monkeypatch):
    """The port builds native/pislam_io.cpp into its own build directory;
    the JAX package's native/build/ is left as it was."""
    jax_build = native.SRC.parent / "build"
    before = {p.name: _digest(p) for p in jax_build.iterdir()}
    assert native.BUILD_DIR == native.SRC.parent.parent / "pislam_tpu_torch" / "_build" / "io"
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "io")
    monkeypatch.setattr(native, "SO", tmp_path / "io" / "libpislam_io.so")
    native._build()
    assert sorted(p.name for p in (tmp_path / "io").iterdir()) == ["libpislam_io.so"]
    assert native.get_lib() is not None
    assert {p.name: _digest(p) for p in jax_build.iterdir()} == before


def test_png_both_ways_against_jax(tmp_path):
    """A PNG the port writes reads back equal in the JAX package and the
    other way round; both encoders write the same bytes."""
    img = _frames(1, 48, 64, seed=0)[0]
    ours, theirs = tmp_path / "ours.png", tmp_path / "theirs.png"
    native.write_png(str(ours), img)
    jnative.write_png(str(theirs), img)
    assert ours.read_bytes() == theirs.read_bytes()
    np.testing.assert_array_equal(jnative.read_png(str(ours)), img)
    np.testing.assert_array_equal(native.read_png(str(theirs)), img)


def test_pil_and_native_decode_the_same(tmp_path, monkeypatch):
    img = _frames(1, 37, 53, seed=1)[0]
    by_native, by_pil = tmp_path / "native.png", tmp_path / "pil.png"
    native.write_png(str(by_native), img)
    Image.fromarray(img, "L").save(by_pil)
    want = [native.read_png(str(p)) for p in (by_native, by_pil)]
    monkeypatch.setattr(native, "get_lib", lambda: None)     # the PIL fallback
    native.write_png(str(tmp_path / "fallback.png"), img)
    got = [native.read_png(str(p)) for p in (by_native, by_pil, tmp_path / "fallback.png")]
    for a in want + got:
        np.testing.assert_array_equal(a, img)


@pytest.mark.parametrize("path", ["native", "pil"])
def test_frame_stream_order_and_size(tmp_path, monkeypatch, path):
    if path == "pil":
        monkeypatch.setattr(native, "get_lib", lambda: None)
    imgs = _frames(10, 32, 40, seed=2)
    paths = []
    for i, img in enumerate(imgs):
        p = str(tmp_path / f"f{i:03d}.png")
        native.write_png(p, img)
        paths.append(p)
    stream = native.FrameStream(paths, width=40, height=32, capacity=3)
    got = list(stream)
    stream.close()
    assert len(got) == 10
    for a, b in zip(got, imgs):
        np.testing.assert_array_equal(a, b)
    bad = native.FrameStream(paths[:1], width=8, height=8)
    with pytest.raises(IOError):
        next(bad)
    bad.close()


def test_rotation_to_quaternion_all_branches():
    """Every Shepperd branch (random rotations and three near 180 degrees)
    gives the JAX function's quaternion."""
    rng = np.random.default_rng(5)
    ws = list(rng.normal(0, 1.5, (8, 3)))
    ws += [np.array([np.pi - 1e-4, 0, 0]), np.array([0, np.pi - 1e-4, 0]),
           np.array([0, 0, np.pi - 1e-4])]
    branches = set()
    for w in ws:
        R = _rotation(w)
        q = datasets.rotation_to_quaternion(R)
        assert np.array_equal(q, jdatasets.rotation_to_quaternion(R))
        tr, diag = np.trace(R), np.diag(R)
        branches.add(-1 if tr > 0 else int(np.argmax(diag)))
        for v in np.eye(3):
            np.testing.assert_allclose(_quat_rotate(q, v), R @ v, rtol=0, atol=1e-12)
    assert branches == {-1, 0, 1, 2}


def test_tum_trajectory_ply_and_kitti_files_equal(tmp_path):
    rng = np.random.default_rng(6)
    Rs = [_rotation(w).astype(np.float32) for w in rng.normal(0, 0.5, (5, 3))]
    ts = [rng.normal(0, 1, 3).astype(np.float32) for _ in range(5)]
    points = rng.normal(0, 2, (7, 3)).astype(np.float32)
    colors = rng.integers(0, 256, (7, 3), np.uint8)
    kf = rng.normal(0, 2, (3, 3))
    for mod, name in ((datasets, "ours"), (jdatasets, "theirs")):
        (tmp_path / name).mkdir()
        mod.save_tum_trajectory(str(tmp_path / name / "traj.txt"), range(3, 8), Rs, ts)
        mod.save_ply(str(tmp_path / name / "map.ply"), points, keyframe_positions=kf)
        mod.save_ply(str(tmp_path / name / "colored.ply"), points, colors=colors)
    for f in ("traj.txt", "map.ply", "colored.ply"):
        assert (tmp_path / "ours" / f).read_bytes() == (tmp_path / "theirs" / f).read_bytes()
    stamps, xyz = datasets.load_tum_trajectory(str(tmp_path / "ours" / "traj.txt"))
    jstamps, jxyz = jdatasets.load_tum_trajectory(str(tmp_path / "ours" / "traj.txt"))
    assert stamps.tolist() == jstamps.tolist() == [3.0, 4.0, 5.0, 6.0, 7.0]
    assert np.array_equal(xyz, jxyz)
    np.testing.assert_allclose(xyz, np.stack([-R.T @ t for R, t in zip(Rs, ts)]),
                               rtol=0, atol=1e-5)

    rows = [np.hstack([_rotation(w), rng.normal(0, 3, (3, 1))]).reshape(-1)
            for w in rng.normal(0, 0.3, (4, 3))]
    np.savetxt(tmp_path / "00.txt", np.stack(rows))
    got = datasets.load_kitti_poses(str(tmp_path / "00.txt"))
    assert got.dtype == np.float32
    assert np.array_equal(got, jdatasets.load_kitti_poses(str(tmp_path / "00.txt")))


def _tree(root, names, shape, seed):
    for p, img in zip(names, _frames(len(names), *shape, seed=seed)):
        (root / p).parent.mkdir(parents=True, exist_ok=True)
        native.write_png(str(root / p), img)


def test_image_dir_against_jax(tmp_path):
    names = [f"{i:04d}.png" for i in (3, 0, 2, 1, 4)]
    _tree(tmp_path, names, (24, 32), seed=7)
    got = list(datasets.image_dir(str(tmp_path)))
    want = list(jdatasets.image_dir(str(tmp_path)))
    assert len(got) == len(want) == 5
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, native.read_png(str(tmp_path / f"{i:04d}.png")))
    with pytest.raises(FileNotFoundError):
        datasets.image_dir(str(tmp_path / "none"))


def test_tum_dataset_against_jax(tmp_path):
    _tree(tmp_path, [f"rgb/{i}.png" for i in range(4)], (8, 8), seed=8)
    rgb = ["# comment"] + [f"{100.0 + i * 0.1:.4f} rgb/{i}.png" for i in range(4)]
    (tmp_path / "rgb.txt").write_text("\n".join(rgb))
    gt = ["# gt"] + [f"{100.0 + i * 0.05:.4f} {i * 0.1} {i * 0.2} 0 0 0 0 1"
                     for i in range(8)]
    (tmp_path / "groundtruth.txt").write_text("\n".join(gt))
    paths, ts, pos = datasets.tum_dataset(str(tmp_path))
    jpaths, jts, jpos = jdatasets.tum_dataset(str(tmp_path))
    assert paths == jpaths and len(paths) == 4
    assert np.array_equal(ts, jts) and np.array_equal(pos, jpos)
    assert pos.shape == (4, 3) and pos[1, 0] > pos[0, 0]


@pytest.mark.parametrize("with_meta", [True, False])
def test_kitti_dataset_against_jax(tmp_path, with_meta):
    _tree(tmp_path, [f"sequences/05/image_0/{i:06d}.png" for i in range(3)], (8, 8), seed=9)
    if with_meta:
        np.savetxt(tmp_path / "sequences" / "05" / "times.txt", [0.0, 0.1, 0.2])
        (tmp_path / "poses").mkdir()
        rows = [np.hstack([np.eye(3), np.full((3, 1), i, float)]).reshape(-1)
                for i in range(3)]
        np.savetxt(tmp_path / "poses" / "05.txt", np.stack(rows))
    got = datasets.kitti_dataset(str(tmp_path), sequence="05")
    want = jdatasets.kitti_dataset(str(tmp_path), sequence="05")
    assert got[0] == want[0] and len(got[0]) == 3
    assert np.array_equal(got[1], want[1])
    if with_meta:
        assert np.array_equal(got[2], want[2])
        np.testing.assert_array_equal(got[2][:, 0], [0, 1, 2])
    else:
        assert got[2] is None and want[2] is None
