"""Profiling & tracing utilities.

Replaces the reference's ``TicToc`` wall timers (``tictoc.h:12-47``) and
adds what a GPU pipeline needs: per-stage timing with device
synchronization (a CUDA launch returns before the device finishes — timing
without ``torch.cuda.synchronize`` measures the enqueue, not the work) and
optional ``torch.profiler`` traces.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


class TicToc:
    """Scoped wall timer, reference semantics (print optional)."""

    def __init__(self, disp: bool = False):
        self.disp = disp
        self.tic()

    def tic(self):
        self._t0 = time.perf_counter()

    def toc(self, about: str = "") -> float:
        dt_ms = (time.perf_counter() - self._t0) * 1000.0
        if self.disp:
            print(f"{about}: {dt_ms:.2f} ms")
        return dt_ms


def _synchronize(sync_on) -> None:
    """Wait for the device work behind ``sync_on`` (a ``torch.device`` or a
    tensor); a CPU device has nothing queued."""
    device = sync_on.device if isinstance(sync_on, torch.Tensor) else torch.device(sync_on)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class StageTimers:
    """Accumulates per-stage wall time; ``sync_on`` (a device or a tensor)
    waits for that device before the stage's clock stops."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, sync_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_on is not None:
                _synchronize(sync_on)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> dict[str, dict]:
        return {
            k: dict(
                total_s=round(self.totals[k], 4),
                count=self.counts[k],
                mean_ms=round(1000 * self.totals[k] / max(self.counts[k], 1), 3),
            )
            for k in sorted(self.totals)
        }


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` trace of the CPU and, where there is one, the GPU,
    written to ``log_dir`` as a Chrome trace (view in Perfetto or
    TensorBoard)."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
