"""Tracing and phase timing (counterpart of lvd_tpu/utils/profiling.py).

* ``PhaseTimer`` — host-side wall-clock phase accounting with a summary and
  each phase's last time (the pipeline keeps one and reads its timings from
  it; each phase is printed when ``LVD_TIMINGS=1``).
* ``maybe_trace`` — wraps a block in ``torch.profiler.profile`` when
  ``LVD_PROFILE=<dir>`` is set, and writes a Chrome trace (TensorBoard and
  Perfetto load it) under ``<dir>/<label>/``.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict


class PhaseTimer:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.last: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.last[name] = dt
            self.totals[name] += dt
            self.counts[name] += 1
            if os.environ.get("LVD_TIMINGS") == "1":
                print(f"[lvd_tpu timing] {name}: {dt:.3f}s")

    def summary(self) -> Dict[str, float]:
        return dict(self.totals)


@contextlib.contextmanager
def maybe_trace(label: str = "lvd"):
    trace_dir = os.environ.get("LVD_PROFILE")
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(os.path.join(trace_dir, label))):
        yield
