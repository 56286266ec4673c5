"""Tracing and timing hooks (counterpart: ``bpx/utils/profiling.py``).

* :class:`StepTimer` — per-step wall time with p50/p90 percentiles and
  samples/s; on a CUDA device it synchronises before each ``stop``, so a
  step is timed to its end on the device, not to the end of its launches;
* :func:`trace` — context manager around ``torch.profiler`` (a Chrome
  trace per run under ``log_dir``), enabled by ``TrainConfig.profile_dir``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import List, Optional

import torch


class StepTimer:
    def __init__(self, window: int = 200, device=None):
        self.window = window
        self.device = torch.device(device) if device is not None else None
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, n_samples: int = 0) -> float:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        return dt

    def percentile(self, q: float) -> float:
        if not self.times:
            return float("nan")
        s = sorted(self.times)
        idx = min(int(len(s) * q), len(s) - 1)
        return s[idx]

    @property
    def p50(self) -> float:
        return self.percentile(0.5)

    @property
    def p90(self) -> float:
        return self.percentile(0.9)

    def summary(self, batch_size: int) -> str:
        p50 = self.p50
        sps = batch_size / p50 if p50 > 0 else float("nan")
        return (f"p50 {p50 * 1e3:.1f} ms | p90 {self.p90 * 1e3:.1f} ms | "
                f"{sps:.1f} samples/s")


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """``torch.profiler`` trace of the CPU and (when present) CUDA
    activity, written as ``trace.json`` under ``log_dir``; no-op when
    ``log_dir`` is None."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
