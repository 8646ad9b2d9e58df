"""One run of one cell: set-up, the measured window, and what it returns.

Everything that belongs to one deployment, one traffic mix or one per-layer
metric is a file of its own, found by name: ``configs/<config>.json``,
``traffic/<mix>.json`` and ``metrics/<metric>.py``; ``BENCHMARK.json`` names
the cells and their metrics. The system under test is the port,
``pislam_tpu_torch``, driven through the calls that its service's ``step``
makes: ``KeyframeSLAM.process_chunk`` (chunk mixes) and ``process`` (frame
mixes), with the service's long-session housekeeping at the mix's cadence.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import time
from pathlib import Path

import numpy as np
import torch

from portbench.reference import lens
from portbench.scene import render

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent


def load_spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_json(kind: str, name: str) -> dict:
    return json.loads((HERE / kind / f"{name}.json").read_text())


def load_reader(name: str):
    """The module ``metrics/<name>.py``: LAYER, UNIT, BETTER, MOVES, read(ctx)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(spec: dict, workload: str):
    """(end-to-end names, per-layer names) that ``workload`` reports."""
    def applies(m):
        return "workloads" not in m or workload in m["workloads"]

    e2e = [m["name"] for m in spec["end_to_end"] if applies(m)]
    per_layer = [m["name"] for m in spec["per_layer"]
                 if applies(m) and m["moves"] in e2e]
    return e2e, per_layer


# -- frames -----------------------------------------------------------------

class Stream:
    """A lap of frames rendered on the device, replayed lap after lap:
    session frame k is lap frame (offset + k) % n. The scene (its photo
    crops, from the configuration's ``texture_seed``) and the trajectory
    are the cell's own, the same for every seed: the run's seed picks where
    in the lap the session starts (the same frames in another order) and,
    in ``build_slam``, the program's RANSAC seed. A configuration's
    ``lens`` bends each pixel's ray (``render.lens_rays``)."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        lap = mix["lap"]
        self.n = lap["frames"]
        self.offset = int(np.random.default_rng(seed).integers(0, self.n))
        rng = np.random.default_rng(cfg["scene"]["texture_seed"])
        roll, sx, dz = render.loop_trajectory(
            self.n, lap["sx_amp"], lap["sx_cycles"], lap["dz_amp"], lap["dz_cycles"],
            lap["roll_deg"], lap["roll_cycles"])
        self.gt_R, self.gt_t = render.poses(roll, sx, dz)
        sc = cfg["scene"]
        w, h, mx, my = cfg["width"], cfg["height"], sc["margin_x"], sc["margin_y"]
        seqs = sorted((ROOT / "data").glob("eval_seq*.npz"))
        source = seqs[int(rng.integers(0, len(seqs)))]
        with np.load(source) as d:
            photos = d["frames"]
        bg, fg, picks = render.texture_pair(photos, int(rng.integers(0, 2**63)),
                                            (h + 2 * my, w + 2 * mx), device, sc["gain"])
        self.textures = f"{source.name} frames {picks}"
        terms = lens.terms(cfg)
        rays = None if terms is None else render.lens_rays(
            w, h, cfg["fx"], cfg["fy"], cfg["cx"], cfg["cy"], terms, device)
        scene = render.PlaneScene(w, h, cfg["fx"], cfg["fy"], cfg["cx"], cfg["cy"],
                                  sc["z_bg"], sc["z_fg"], mx, my, bg, fg, rays)

        def dev(a):
            return torch.as_tensor(a, dtype=torch.float32, device=device)

        self.frames = scene.render(dev(roll), dev(sx), dev(dz))
        self.device = device

    def lap_index(self, k):
        return (self.offset + np.asarray(k)) % self.n

    def frame(self, k: int):
        return self.frames[int(self.lap_index(k))]

    def chunk(self, k: int, size: int):
        idx = torch.as_tensor(self.lap_index(np.arange(k, k + size)), device=self.device)
        return self.frames.index_select(0, idx)

    def truth(self, ks):
        li = self.lap_index(ks)
        return self.gt_R[li], self.gt_t[li]


# -- the system under test ----------------------------------------------------

def build_slam(cfg: dict, seed: int, device):
    """The service's KeyframeSLAM for a deployment: ``service.build_config``
    with the file's frontend and camera values, and its lens as the port's
    ``dist`` (as the service's ``--k1 --k2 --p1 --p2``)."""
    from pislam_tpu_torch.models.slam import KeyframeSLAM
    from pislam_tpu_torch.service import build_config

    pc = build_config(cfg["width"], cfg["height"], cfg["levels"], cfg["max_keypoints"])
    if abs(1.0 / pc.pyramid.inv_scale - cfg["scale_factor"]) > 1e-9:
        raise ValueError("the port's pyramid scale differs from the configuration's")
    pc = dataclasses.replace(pc, frontend=dataclasses.replace(
        pc.frontend, fast_threshold=cfg["fast_threshold"],
        harris_threshold=cfg["harris_threshold"]))
    return KeyframeSLAM(pc, cfg["fx"], cfg["fy"], cfg["cx"], cfg["cy"],
                        keyframe_min_inliers=cfg["keyframe_min_inliers"],
                        keyframe_max_gap=cfg["keyframe_max_gap"], seed=seed,
                        dist=lens.terms(cfg), device=device)


class Session:
    """A tracking session as the service runs it: chunks or single frames,
    then the housekeeping of ``--cull-every`` at the mix's cadence."""

    def __init__(self, slam, stream: Stream, mix: dict):
        self.slam, self.stream, self.mix = slam, stream, mix
        self.k = 0                  # next session frame
        self.last_cull = 0
        self.poses = {}             # session frame -> (R, t) as returned

    def step(self):
        """Hand in the next chunk (or frame); returns (frames, seconds until
        their poses were on the host)."""
        slam, n = self.slam, self.mix["chunk"]
        t0 = time.perf_counter()
        if self.mix["mode"] == "frame":
            out = slam.process(self.stream.frame(self.k))
            Rs, ts = [out["pose_R"]], [out["pose_t"]]
        else:
            out = slam.process_chunk(self.stream.chunk(self.k, n))
            Rs, ts = out["pose_R"], out["pose_t"]
        dt = time.perf_counter() - t0
        for i, (R, t) in enumerate(zip(Rs, ts)):
            self.poses[self.k + i] = (np.asarray(R), np.asarray(t))
        self.k += len(Rs)
        self.housekeeping()
        return len(Rs), dt

    def housekeeping(self):
        slam, mix = self.slam, self.mix
        if slam.keyframes_inserted - self.last_cull >= mix["housekeeping_every"]:
            self.last_cull = slam.keyframes_inserted
            slam.cull_keyframes(max_cull=mix["max_cull"])
            slam.cull_landmarks()
            slam.evict_stale_landmarks(min_free=mix["min_free_landmarks"])
            slam.compact()

