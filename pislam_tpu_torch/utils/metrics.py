"""Structured per-frame metrics for keyframe SLAM.

The port's own copy of ``pislam_tpu/utils/metrics.py`` (pure Python; the
port imports nothing of the JAX package). A dependency-free registry of
counters, gauges and wall-clock stage timers that KeyframeSLAM updates every
frame and flushes as JSON lines.

Host wall-clock timers measure the host loop: Python orchestration,
launches and any host reads. On a CUDA card work is asynchronous, so a
stage's timer holds the launches it made plus whatever host read ends it;
the device's own time per stage comes from CUDA events or the profiler.
"""

from __future__ import annotations

import json
import time
from contextlib import contextmanager
from typing import Callable, Optional


class Metrics:
    """Counters + gauges + stage timers with JSON-line emission.

    Counters accumulate (events since the last emit); gauges hold the latest
    value; timers accumulate per-stage wall seconds and call counts between
    emits. ``emit`` writes one JSON line to the sink and resets counters and
    timers (gauges persist: they describe current state, e.g. map size).
    """

    def __init__(self, sink: Optional[Callable[[str], None]] = None):
        self._sink = sink if sink is not None else _stdout_sink
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        self._timers: dict[str, list] = {}  # name -> [total_s, calls]
        self._t0 = time.perf_counter()

    def count(self, name: str, n: float = 1):
        self._counters[name] = self._counters.get(name, 0) + n

    def gauge(self, name: str, value: float):
        self._gauges[name] = value

    @contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            tot = self._timers.setdefault(name, [0.0, 0])
            tot[0] += dt
            tot[1] += 1

    def snapshot(self) -> dict:
        """Current values as a flat dict (does not reset)."""
        out = {f"count.{k}": v for k, v in self._counters.items()}
        out.update({f"gauge.{k}": v for k, v in self._gauges.items()})
        for k, (tot, n) in self._timers.items():
            out[f"time_ms.{k}"] = round(tot * 1e3, 3)
            out[f"calls.{k}"] = n
        out["uptime_s"] = round(time.perf_counter() - self._t0, 3)
        return out

    def emit(self, **extra):
        """Write one JSON line (snapshot + extra) and reset counters/timers."""
        rec = self.snapshot()
        rec.update(extra)
        self._sink(json.dumps(rec, sort_keys=True))
        self._counters.clear()
        self._timers.clear()
        return rec


def _stdout_sink(line: str):
    print(line, flush=True)


class NullMetrics(Metrics):
    """No-op drop-in: zero overhead when observability is off."""

    def __init__(self):  # noqa: D401 - no sink
        pass

    def count(self, name, n=1):
        pass

    def gauge(self, name, value):
        pass

    @contextmanager
    def timer(self, name):
        yield

    def snapshot(self):
        return {}

    def emit(self, **extra):
        return {}
