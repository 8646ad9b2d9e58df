"""The control, on the card at each cell's own size: the reference frontend
with its pyramid resampled in bfloat16 (the precision below the fixed-point
resampler's), put in the program's place on the cell's frames, must fail the
cell's ``feature_rows_off`` limit on every seed. Run on the card:

    python -m pytest portbench/tests/test_portbench_control.py -m cuda -q -s
"""

import numpy as np
import pytest
import torch

from portbench import check, harness

SPEC = harness.load_spec()
SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_control_fails(card, workload):
    cell = {w["name"]: w for w in SPEC["workloads"]}[workload]
    cfg = harness.load_json("configs", cell["config"])
    mix = harness.load_json("traffic", cell["traffic"])
    limits = {"feature_rows_off": check.load_limits(workload)["feature_rows_off"]}
    readings = []
    for seed in SEEDS:
        stream = harness.Stream(cfg, mix, seed, card)
        frames = np.random.default_rng(seed).choice(stream.n, 16, replace=False)
        readings.append(check.control_rows_off(stream, cfg, frames, card))
    verdicts = [check.judge({"feature_rows_off": r}, limits)[0] for r in readings]
    print(f"control {workload}: feature_rows_off over 16 frames {readings}, limit "
          f"{limits['feature_rows_off']}")
    assert not any(ok for *_, ok in verdicts)
