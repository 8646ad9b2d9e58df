"""Dataset loaders: image directories, TUM-RGBD, KITTI odometry; TUM and PLY
export.

The reference's perf charts use 200 frames of New College Sample 3 upscaled
to VGA (README.md:109-112) -- i.e. a plain directory of grayscale images;
`image_dir` covers that. TUM-RGBD and KITTI loaders serve configs[2-4]
(BASELINE.json). All return lazy frame sources (native prefetch stream when
available) plus ground-truth trajectories when present on disk.
"""

from __future__ import annotations

import glob
import os
from typing import Optional, Tuple

import numpy as np

from .native import FrameStream, read_png


def image_dir(path: str, pattern: str = "*.png",
              width: Optional[int] = None, height: Optional[int] = None,
              capacity: int = 8):
    """Sorted image-directory dataset (New College style). Returns a
    FrameStream (native prefetch) sized from the first image."""
    paths = sorted(glob.glob(os.path.join(path, pattern)))
    if not paths:
        raise FileNotFoundError(f"no {pattern} in {path}")
    if width is None or height is None:
        first = read_png(paths[0])
        height, width = first.shape
    return FrameStream(paths, width=width, height=height, capacity=capacity)


def load_tum_trajectory(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """TUM groundtruth.txt: lines 't x y z qx qy qz qw'. Returns
    (timestamps (N,), positions (N, 3))."""
    ts, xyz = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            v = line.split()
            ts.append(float(v[0]))
            xyz.append([float(v[1]), float(v[2]), float(v[3])])
    return np.asarray(ts), np.asarray(xyz, np.float32)


def tum_dataset(root: str, capacity: int = 8):
    """TUM-RGBD layout: rgb.txt ('t path'), optional groundtruth.txt.

    Returns (frame_paths, timestamps, gt_positions_or_None) where
    gt positions are nearest-timestamp associated to the frames.
    """
    rgb_txt = os.path.join(root, "rgb.txt")
    paths, ts = [], []
    with open(rgb_txt) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            t, rel = line.split()[:2]
            ts.append(float(t))
            paths.append(os.path.join(root, rel))
    ts = np.asarray(ts)
    gt = None
    gt_file = os.path.join(root, "groundtruth.txt")
    if os.path.exists(gt_file):
        gts, gxyz = load_tum_trajectory(gt_file)
        idx = np.searchsorted(gts, ts)
        idx = np.clip(idx, 0, len(gts) - 1)
        gt = gxyz[idx]
    return paths, ts, gt


def rotation_to_quaternion(R: np.ndarray) -> np.ndarray:
    """(3, 3) rotation -> (x, y, z, w) unit quaternion (TUM convention).

    Shepperd's method: branch on the largest diagonal combination for
    numerical stability near 180-degree rotations.
    """
    m00, m11, m22 = R[0, 0], R[1, 1], R[2, 2]
    tr = m00 + m11 + m22
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif m00 >= m11 and m00 >= m22:
        s = np.sqrt(1.0 + m00 - m11 - m22) * 2
        x = 0.25 * s
        w = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif m11 >= m22:
        s = np.sqrt(1.0 + m11 - m00 - m22) * 2
        y = 0.25 * s
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m22 - m00 - m11) * 2
        z = 0.25 * s
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
    q = np.array([x, y, z, w], np.float64)
    return q / np.linalg.norm(q)


def save_tum_trajectory(path: str, timestamps, Rs, ts):
    """Write a TUM-format trajectory: 't x y z qx qy qz qw' per line.

    Rs/ts are world->camera (the estimator's convention); TUM stores the
    camera pose in the world frame, so each line is c = -R^T t and the
    quaternion of R^T. Round-trips with load_tum_trajectory (positions).
    """
    with open(path, "w") as f:
        f.write("# pislam-tpu trajectory: timestamp tx ty tz qx qy qz qw\n")
        for stamp, R, t in zip(timestamps, Rs, ts):
            R = np.asarray(R, np.float64)
            t = np.asarray(t, np.float64)
            c = -R.T @ t
            q = rotation_to_quaternion(R.T)
            f.write(f"{float(stamp):.6f} {c[0]:.6f} {c[1]:.6f} {c[2]:.6f} "
                    f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n")


def save_ply(path: str, points, colors=None, keyframe_positions=None):
    """Write an ASCII PLY point cloud of the SLAM map.

    points (N, 3) landmark world positions; optional colors (N, 3) uint8;
    keyframe_positions (M, 3) are appended painted red so standard viewers
    (MeshLab, CloudCompare, Open3D) show the camera path alongside the map.
    The reference persists nothing but a painted PNG (demo.cpp:111); a
    mapping system needs its map to leave the process.
    """
    points = np.asarray(points, np.float64).reshape(-1, 3)
    if colors is None:
        colors = np.full((len(points), 3), 200, np.uint8)
    colors = np.asarray(colors, np.uint8).reshape(-1, 3)
    kf = (np.asarray(keyframe_positions, np.float64).reshape(-1, 3)
          if keyframe_positions is not None else np.zeros((0, 3)))
    n = len(points) + len(kf)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n"
                f"element vertex {n}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "property uchar red\nproperty uchar green\n"
                "property uchar blue\nend_header\n")
        for p, c in zip(points, colors):
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                    f"{c[0]} {c[1]} {c[2]}\n")
        for p in kf:
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} 255 0 0\n")


def load_kitti_poses(path: str) -> np.ndarray:
    """KITTI poses file: 12 floats per line (3x4 row-major). Returns
    (N, 3) camera positions (the translation column)."""
    rows = np.loadtxt(path).reshape(-1, 3, 4)
    return rows[:, :, 3].astype(np.float32)


def kitti_dataset(root: str, sequence: str = "00", capacity: int = 8):
    """KITTI odometry layout: sequences/SS/image_0/*.png, times.txt,
    optional poses/SS.txt. Returns (paths, times, gt_positions_or_None)."""
    seq_dir = os.path.join(root, "sequences", sequence)
    paths = sorted(glob.glob(os.path.join(seq_dir, "image_0", "*.png")))
    times_file = os.path.join(seq_dir, "times.txt")
    times = (np.loadtxt(times_file)
             if os.path.exists(times_file) else np.arange(len(paths), dtype=float))
    gt = None
    poses_file = os.path.join(root, "poses", f"{sequence}.txt")
    if os.path.exists(poses_file):
        gt = load_kitti_poses(poses_file)
    return paths, times, gt
