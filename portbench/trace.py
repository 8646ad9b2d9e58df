"""The traced window: ``torch.profiler`` over the card and the host, the
synchronizing calls counted by ``torch.cuda.set_sync_debug_mode``, and the
reduction of both to what the per-layer readers read.

The reduction keeps, for the traced window: its wall seconds; every device
operation's name, start and duration; the union of their intervals (busy
seconds); the host's operations, to name what the host was doing in the
longest idle gaps; and the count of synchronizing calls.
"""

from __future__ import annotations

import contextlib
import time
import warnings


class Trace:
    """Context manager over a window: profile, count syncs, then reduce."""

    def __init__(self):
        self.syncs = 0
        self.device_ops = []     # (name, start_us, dur_us)
        self.host_ops = []       # (name, start_us, dur_us)
        self.window_s = 0.0
        self._stack = contextlib.ExitStack()

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._caught = self._stack.enter_context(warnings.catch_warnings(record=True))
        warnings.simplefilter("always")
        self._prof.__enter__()
        torch.cuda.set_sync_debug_mode("warn")
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        torch.cuda.set_sync_debug_mode(0)
        self._prof.__exit__(*exc)
        self.syncs = sum(1 for w in self._caught if "synchroniz" in str(w.message))
        self._stack.close()
        if exc[0] is None:
            self._reduce()
        return False

    def _reduce(self):
        import torch

        dev_type = torch.autograd.DeviceType.CUDA
        for e in self._prof.profiler.kineto_results.events():
            start = e.start_ns() / 1e3
            dur = e.duration_ns() / 1e3
            if e.device_type() == dev_type:
                self.device_ops.append((e.name(), start, dur))
            else:
                self.host_ops.append((e.name(), start, dur))
        self.device_ops.sort(key=lambda o: o[1])

    # -- reductions -----------------------------------------------------------

    def busy_s(self) -> float:
        """Seconds in which at least one device operation ran."""
        busy, end = 0.0, float("-inf")
        for _, s, d in self.device_ops:
            e = s + d
            if e <= end:
                continue
            busy += e - max(s, end)
            end = e
        return busy / 1e6

    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s() / self.window_s)

    def by_name(self, top: int = 10):
        """The device operations that took most time: [name, seconds]."""
        tot = {}
        for name, _, d in self.device_ops:
            tot[name] = tot.get(name, 0.0) + d
        return [[n[:120], t / 1e6] for n, t in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10):
        """The longest stretches with no device operation: [what the host was
        doing at the gap's middle, seconds]. The host operation named is the
        shortest one that covers the middle."""
        gaps, end = [], None
        for _, s, d in self.device_ops:
            if end is not None and s > end:
                gaps.append((s - end, end, s))
            end = s + d if end is None else max(end, s + d)
        gaps.sort(reverse=True)
        host = sorted(self.host_ops, key=lambda o: o[1])
        out = []
        for length, a, b in gaps[:top]:
            mid = (a + b) / 2
            cover = [o for o in host if o[1] <= mid <= o[1] + o[2]]
            name = min(cover, key=lambda o: o[2])[0] if cover else "host (no recorded op)"
            out.append([name[:120], length / 1e6])
        return out

    def kernel_ops(self, fragment: str):
        """Durations (us) of the device operations whose name holds ``fragment``."""
        return [d for n, _, d in self.device_ops if fragment in n]
