"""``pislam_tpu_torch.service`` on the CPU over the whole 48-frame eval_seq:
the mirrors of tests/test_service.py's mid-run loop closure (five closures,
most of this file's time) and long-session maintenance, each assertion
kept."""

import dataclasses
import json

import torch

from pislam_tpu_torch import service
from torch_parity import DATA

torch.set_num_threads(1)

SEQ = str(DATA / "eval_seq.npz")


def run(capsys, *args):
    service.main(["--seq", SEQ, *args, "--cpu"])
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_service_midrun_loop_closure(capsys):
    """--loop-every closes the out-and-back loop DURING the run."""
    rep = run(capsys, "--chunk", "8", "--loop-every", "2", "--no-loop-close")
    assert rep["frames"] == 48
    assert rep["loops_closed_midrun"] >= 1
    assert "ate_rmse" in rep and rep["ate_rmse"] < 0.5


def test_service_maintenance_evicts_stale_landmarks(capsys, monkeypatch):
    """With a small landmark table the --cull-every block evicts the
    stalest landmarks to keep --min-free-landmarks slots free, and the run
    stays finite."""
    real = service.build_config

    def small(*a, **kw):
        cfg = real(*a, **kw)
        return dataclasses.replace(cfg, map=dataclasses.replace(
            cfg.map, max_landmarks=768, max_obs=3072))

    monkeypatch.setattr(service, "build_config", small)
    rep = run(capsys, "--cull-every", "2", "--min-free-landmarks", "256", "--no-loop-close")
    assert rep["frames"] == 48
    assert rep["landmarks_evicted"] > 0, rep
    assert rep["landmarks"] <= 768
    assert rep["frames_lost"] == 0
    assert "ate_rmse" in rep and rep["ate_rmse"] is not None
