"""A whole run of each cell's code path on the CPU at a small size (the look
for a card skipped): the result line has its required keys, a sound run
comes out correct, and a run with the timed path broken underneath comes
out not correct, once for each fault the cell can have:

* a step that returns its state unchanged;
* half of the batch left out (chunk cells: each chunk's second half);
* an answer altered where it is produced: a descriptor bit of the
  frontend's output.

The cells run on one card, so there is no exchange between chips to leave
out."""

import math
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import harness, run
from pislam_tpu_torch import frontend
from pislam_tpu_torch.models import slam as slam_mod

SMALL = {"width": 320, "height": 240, "max_keypoints": 400,
         "scene": {"z_bg": 8.0, "z_fg": 4.0, "margin_x": 64, "margin_y": 48, "gain": 3.0, "texture_seed": 11}}
SEED = 2**31 + 4242


def _cell(name, **mix):
    spec = harness.load_spec()
    cell = {w["name"]: w for w in spec["workloads"]}[name]
    cfg = dict(harness.load_json("configs", cell["config"]), **SMALL)
    cfg.update(fx=cfg["fx"] / 2, fy=cfg["fy"] / 2, cx=cfg["cx"] / 2, cy=cfg["cy"] / 2)
    m = dict(harness.load_json("traffic", cell["traffic"]), **mix)
    return cfg, m


def _run(name, seconds=12.0, **mix):
    torch.set_num_threads(4)
    cfg, m = _cell(name, **mix)
    return run.execute(name, SEED, seconds, False, "cpu", cfg=cfg, mix=m)


def _failed(out):
    """The compared numbers that fell outside their limits."""
    return {n: c["value"] for n, c in out["checks"].items()
            if c["value"] is None or not c["limit"][0] <= c["value"] <= c["limit"][1]}


def test_result_line_keys():
    out = _run("tum_fr1_vga.chunk8", warmup_frames=24)
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert list(out)[-1] == "checks"
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(out["metrics"]) == {"setup_s", "frames_per_s", "frame_p95_ms"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and math.isfinite(m["value"])
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    assert out["correct"], out["checks"]
    info = out["info"]
    for key in ("keyframes_inserted", "keyframes_held_at_open", "landmarks_at_open",
                "frames_per_s_by_quarter", "step_ms_median_insert"):
        assert key in info, key
    assert info["keyframes_held_at_open"] >= 1 and info["keyframes_inserted"] >= 1


def _unchanged(method):
    def broken(self, *a, **k):
        before = self.state
        out = method(self, *a, **k)
        self.set_state(before)
        return out
    return broken


def _half_chunk(method):
    def broken(self, frames):
        n = frames.shape[0]
        out = method(self, frames[: n - n // 2])
        return {k: np.concatenate([v] + [v[-1:]] * (n // 2)) for k, v in out.items()}
    return broken


def _altered_extract(fn):
    """One bit of the strongest keypoint's descriptor flipped."""
    def broken(*a, **k):
        f = fn(*a, **k)
        flip = torch.zeros_like(f.descriptors)
        flip[0, 0] = 1
        return f._replace(descriptors=f.descriptors ^ flip)
    return broken


TRACKING_FAULTS = {
    "unchanged": lambda mp, cls: mp.setattr(cls, "process_chunk",
                                            _unchanged(cls.process_chunk)),
    "half_batch": lambda mp, cls: mp.setattr(cls, "process_chunk",
                                             _half_chunk(cls.process_chunk)),
    "altered": lambda mp, cls: mp.setattr(frontend, "_extract_impl",
                                          _altered_extract(frontend._extract_impl)),
}


@pytest.mark.parametrize("fault", TRACKING_FAULTS)
def test_chunk_cell_faults(fault, monkeypatch):
    TRACKING_FAULTS[fault](monkeypatch, slam_mod.KeyframeSLAM)
    out = _run("tum_fr1_vga.chunk8", warmup_frames=24)
    print(f"chunk8 {fault}: fails {_failed(out)}")
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_live_cell_faults(fault, monkeypatch):
    cls = slam_mod.KeyframeSLAM
    if fault == "unchanged":
        monkeypatch.setattr(cls, "process", _unchanged(cls.process))
    else:
        TRACKING_FAULTS[fault](monkeypatch, cls)
    out = _run("tum_fr1_vga.live", warmup_frames=24)
    print(f"live {fault}: fails {_failed(out)}")
    assert not out["correct"], out["checks"]


def test_live_cell_sound():
    out = _run("tum_fr1_vga.live", warmup_frames=24)
    assert out["correct"], out["checks"]


def test_command_without_a_card_prints_no_result():
    """The command exits non-zero and prints no result line where there is
    no card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run the cell")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "tum_fr1_vga.live",
                        "--seed", str(SEED), "--seconds", "1"], cwd=harness.ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == "" and "no CUDA card" in p.stderr
