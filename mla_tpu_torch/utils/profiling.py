"""Tracing and step timing.

Counterpart of mla_tpu/utils/profiling.py:
  * `trace(logdir)`: a context manager that records host and, with a
    card, device activity through torch.profiler and writes a Chrome trace
    (trace.json, for Perfetto) into logdir;
  * `annotate(name)`: a named span in the trace (record_function);
  * `StepTimer`: a rolling per-step wall clock with p50 / p90 / mean.
"""

from __future__ import annotations

import contextlib
import time
from collections import deque
from pathlib import Path
from typing import Iterator, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    Path(logdir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(Path(logdir) / "trace.json"))


def annotate(name: str):
    return torch.profiler.record_function(name)


class StepTimer:
    def __init__(self, window: int = 100) -> None:
        self.times: deque = deque(maxlen=window)
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        if self._t0 is None:
            raise RuntimeError("StepTimer.stop() before start()")
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        self._t0 = None
        return dt

    def summary(self) -> dict:
        if not self.times:
            return {}
        arr = np.asarray(self.times)
        return {
            "step_time_p50": float(np.percentile(arr, 50)),
            "step_time_p90": float(np.percentile(arr, 90)),
            "step_time_mean": float(arr.mean()),
        }
