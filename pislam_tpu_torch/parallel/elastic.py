"""Checkpoint / resume of a long-running SLAM loop.

The port of ``CheckpointedRunner`` from ``pislam_tpu/parallel/elastic.py``.
This runner is single-process: the JAX package's multi-process parts (the
``jax.distributed`` bootstrap, the step counter broadcast from process 0 on
resume, the primary-only save) belong to the distributed layer, which the
port does not have yet (``torch.distributed``).
"""

from __future__ import annotations

import os
from typing import Any, Callable, Iterable

from ..utils import checkpoint as ckpt


class CheckpointedRunner:
    """Periodic-checkpoint wrapper for a long-running SLAM loop.

    ``step_fn(state, item) -> state`` runs the work; every ``every`` steps,
    and once at the end, the state and the number of steps done are saved
    together to ``<ckpt_dir>/state``, so a restarted process resumes from
    the last checkpoint instead of item 0.
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
        state already holds. The generator must come back exactly
        (``utils/checkpoint.py``), so a checkpoint of another device type
        raises.
        """
        if os.path.exists(self.path):
            payload = ckpt.restore(self.path, like={"state": init_state, "steps_done": 0})
            self.steps_done = payload["steps_done"]
            return payload["state"]
        return init_state

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
        os.makedirs(self._dir, exist_ok=True)
        ckpt.save(self.path, {"state": state, "steps_done": self.steps_done})
