"""``pislam_tpu_torch.service`` on the CPU: the mirrors of tests/test_service.py
that end in ``close_loop`` (its global BA takes most of their time), each
assertion kept."""

import json

import numpy as np
import torch

from pislam_tpu_torch import service
from pislam_tpu_torch.io import datasets
from torch_parity import DATA

torch.set_num_threads(1)

SEQ = str(DATA / "eval_seq.npz")


def run(capsys, *args):
    service.main(["--seq", SEQ, *args, "--cpu"])
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_service_full_sequence_reports_ate(capsys):
    rep = run(capsys, "--max-frames", "12")
    assert rep["frames"] == 12
    assert rep["loop_closed_to_kf"] >= 0
    assert "ate_rmse" in rep and rep["ate_rmse"] < 0.5


def test_service_chunked_scan_mode(tmp_path, capsys):
    traj = str(tmp_path / "traj.txt")
    rep = run(capsys, "--max-frames", "12", "--chunk", "6", "--traj-out", traj)
    assert rep["frames"] == 12 and rep["resumed_at"] == 0
    assert rep["keyframes"] >= 2
    assert "ate_rmse" in rep and rep["ate_rmse"] < 0.5
    stamps, xyz = datasets.load_tum_trajectory(traj)
    assert stamps.shape == (12,) and np.isfinite(xyz).all()


def test_service_localization_only_with_map_in(tmp_path, capsys):
    """Build a map with a normal run (--checkpoint-dir), then run
    --localization-only --map-in against it: the whole stream is processed
    (no frame-progress resume) and the map stays frozen."""
    ck = str(tmp_path / "ckpt")
    built = run(capsys, "--max-frames", "10", "--checkpoint-dir", ck, "--checkpoint-every", "5")
    assert built["keyframes"] >= 3
    loc = run(capsys, "--max-frames", "10", "--localization-only", "--map-in", ck)
    assert loc["resumed_at"] == 0
    assert loc["keyframes"] == built["keyframes"]
    assert loc["landmarks"] == built["landmarks"]
    assert loc["loop_closed_to_kf"] == -1          # frozen map: no loop closure
    assert "ate_rmse" in loc and loc["ate_rmse"] < 0.5
