"""Multi-process bootstrap and checkpoint / resume of a long-running SLAM
loop.

The port of ``pislam_tpu/parallel/elastic.py``:

* bootstrap: ``initialize_multihost`` joins this process to a
  ``torch.distributed`` process group (NCCL for a process on the card, gloo
  on the CPU); a peer that fails makes the next collective raise;
* elasticity: the SLAM state is a tuple of tensors and a generator
  (``models/slam.SlamState``), so recovery is checkpoint and restore
  (``utils/checkpoint.py``), and a restart at another world size starts
  from the last checkpoint -- ``CheckpointedRunner`` packages the loop.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Iterable, Optional

import torch
import torch.distributed as tdist

from ..utils import checkpoint as ckpt
from .mesh import comm_device


def initialize_multihost(coordinator: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device="cuda") -> int:
    """Join the process group; returns this process's rank.

    The arguments default from torchrun's environment (WORLD_SIZE, RANK and
    its store at MASTER_ADDR:MASTER_PORT). ``coordinator`` is "host:port"
    where rank 0 serves the group's store. A process
    whose ``device`` is CUDA joins over NCCL on the card of its LOCAL_RANK
    (else its rank modulo the cards), a CPU process over gloo. A single
    process (no world size above 1) joins nothing and returns 0; an
    initialised group is kept and its rank returned."""
    if tdist.is_initialized():
        return tdist.get_rank()
    env = os.environ
    n = num_processes or int(env.get("WORLD_SIZE", "0") or 0)
    if n <= 1:
        return 0
    if coordinator is not None:
        init_method = f"tcp://{coordinator}"
    elif "MASTER_ADDR" in env:
        init_method = "env://"       # torchrun's store
    else:
        raise ValueError(f"{n} processes but no coordinator: pass one or set MASTER_ADDR")
    rank = process_id if process_id is not None else int(env.get("RANK", "0"))
    if torch.device(device).type == "cuda":
        local = int(env.get("LOCAL_RANK", rank % max(torch.cuda.device_count(), 1)))
        torch.cuda.set_device(local)
        backend = "nccl"
    else:
        backend = "gloo"
    tdist.init_process_group(backend, init_method=init_method, world_size=n, rank=rank)
    return rank


def process_index() -> int:
    return tdist.get_rank() if tdist.is_initialized() else 0


def process_count() -> int:
    return tdist.get_world_size() if tdist.is_initialized() else 1


class CheckpointedRunner:
    """Periodic-checkpoint wrapper for a long-running SLAM loop.

    ``step_fn(state, item) -> state`` runs the work; every ``every`` steps,
    and once at the end, the state and the number of steps done are saved
    together to ``<ckpt_dir>/state`` by process 0, so a restarted process
    resumes from the last checkpoint instead of item 0.
    """

    def __init__(self, step_fn: Callable[[Any, Any], Any], ckpt_dir: str, every: int = 50):
        if every < 1:
            raise ValueError(f"every must be at least 1, got {every}")
        self._step = step_fn
        self._dir = ckpt_dir
        self._every = every
        self.steps_done = 0

    @property
    def path(self) -> str:
        return os.path.join(self._dir, "state")

    def resume(self, init_state: Any) -> Any:
        """The state of the latest checkpoint if there is one, else
        ``init_state``.

        The step counter lives inside the checkpoint's payload, so state and
        progress are restored together: a crash can never resume a newer
        state with an older counter, which would apply items again that the
        state already holds. In a process group the counter is broadcast
        from process 0, so every process resumes at the same step even where
        the checkpoint directories are not shared. The generator must come
        back exactly (``utils/checkpoint.py``), so a checkpoint of another
        device type raises.
        """
        state = init_state
        if os.path.exists(self.path):
            payload = ckpt.restore(self.path, like={"state": init_state, "steps_done": 0})
            self.steps_done = payload["steps_done"]
            state = payload["state"]
        if process_count() > 1:
            steps = torch.tensor([self.steps_done], dtype=torch.int64, device=comm_device())
            tdist.broadcast(steps, src=0)
            self.steps_done = int(steps.item())
        return state

    def run(self, state: Any, items: Iterable) -> Any:
        """Step through ``items``, skipping those the checkpoint covers."""
        for i, item in enumerate(items):
            if i < self.steps_done:
                continue  # already covered by the restored checkpoint
            state = self._step(state, item)
            self.steps_done = i + 1
            if self.steps_done % self._every == 0:
                self._save(state)
        self._save(state)
        return state

    def _save(self, state):
        if process_index() != 0:
            return
        os.makedirs(self._dir, exist_ok=True)
        ckpt.save(self.path, {"state": state, "steps_done": self.steps_done})
