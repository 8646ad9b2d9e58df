"""Two processes in one gloo group: the port's multi-process surface
(tests/test_multiprocess.py's counterpart).

Two OS processes (tests/torch_dist_worker.py, suite "multihost") join one
group through ``parallel/elastic.initialize_multihost`` and run across the
process boundary: data-parallel extraction (bit-exact against each frame
extracted in one process), the sharded match (against ``matching.match``),
distributed BA (its cost falls), ``CheckpointedRunner.resume`` with
non-shared checkpoint directories (process 0 restores steps_done 7 from
disk, process 1 has nothing, the broadcast lands both at 7, and only
process 0 writes), and the service with ``--model-parallel 2`` on both
ranks, whose TUM rows must be those of ``--model-parallel 1`` on 12
eval_seq frames, written by rank 0 alone.
"""

import json
import os
import subprocess
import sys

import pytest

import torch_dist_worker as W

TIMEOUT = 300            # seconds; the pair takes ~30 s


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """Each rank's TORCH_MULTIHOST_OK report, and the working directory."""
    workdir = tmp_path_factory.mktemp("torch_multihost")
    port = W.free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, W.__file__, "multihost", str(port), str(r), "2",
                               str(workdir)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        pytest.fail("the two-process run timed out\n" + "\n".join(o[-3000:] for o in outs))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
    reports = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
        line = [ln for ln in out.splitlines() if ln.startswith("TORCH_MULTIHOST_OK ")]
        assert line, f"rank {r} output:\n{out[-4000:]}"
        reports.append(json.loads(line[-1].split(" ", 1)[1]))
    return reports, workdir


def test_two_process_multihost(pair):
    reports, workdir = pair
    for r, rep in enumerate(reports):
        assert rep["process"] == r and rep["processes"] == 2
        assert rep["steps_done"] == 7
        c0, c1 = rep["ba_cost"]
        assert c1 < c0
    assert reports[0]["written"] == ["state"]          # rank 0 saved
    assert reports[1]["written"] == []                  # rank 1 wrote nothing
    assert reports[0]["ba_cost"] == reports[1]["ba_cost"]


def test_service_model_parallel(pair):
    """--model-parallel 2 under two ranks: the TUM rows of --model-parallel 1,
    written by rank 0 alone."""
    reports, workdir = pair
    assert [rep["traj_written"] for rep in reports] == [True, False]
    single = (workdir / "single.txt").read_text()
    assert len([ln for ln in single.splitlines() if not ln.startswith("#")]) == 12
    assert (workdir / "sharded_rank0.txt").read_text() == single
