"""Metrics and logging (the port's copy of
``vae_captioning_tpu/utils/logging.py``; its trace context
:func:`profile_trace` records ``torch.profiler`` where that one records
``jax.profiler``).

The reference's observability is print statements every 500 steps
(``main.py:246-251``).  Here: a structured metric logger (console +
JSONL file, so curves can be plotted or diffed) and a step timer with
examples/sec.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Iterator, Optional


class MetricLogger:
    """Append-only JSONL metric log + console echo."""

    def __init__(self, log_dir: Optional[str] = None, echo: bool = True,
                 run_name: str = "run"):
        self.echo = echo
        self._f = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            path = os.path.join(log_dir, f"{run_name}.metrics.jsonl")
            self._f = open(path, "a")
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict[str, float], **extra) -> None:
        record = {"step": int(step), "time": round(time.time() - self._t0, 3),
                  **{k: float(v) for k, v in metrics.items()}, **extra}
        if self._f:
            self._f.write(json.dumps(record) + "\n")
            self._f.flush()
        if self.echo:
            body = " ".join(f"{k}={v:.4f}" if isinstance(v, float) else
                            f"{k}={v}" for k, v in record.items()
                            if k not in ("time",))
            print(f"[{record['time']:8.1f}s] {body}")

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None


class Throughput:
    """Examples/sec meter with exponential smoothing."""

    def __init__(self, alpha: float = 0.9):
        self._last = None
        self._rate = None
        self._alpha = alpha

    def update(self, n_examples: int) -> Optional[float]:
        now = time.perf_counter()
        if self._last is not None:
            inst = n_examples / max(now - self._last, 1e-9)
            self._rate = (inst if self._rate is None
                          else self._alpha * self._rate
                          + (1 - self._alpha) * inst)
        self._last = now
        return self._rate


def make_profiler(cuda: bool):
    """A ``torch.profiler.profile`` of the CPU activities, and of the CUDA
    ones under ``cuda`` (not started)."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=activities)


@contextlib.contextmanager
def profile_trace(log_dir: str, enabled: bool = True,
                  name: str = "trace.json") -> Iterator[None]:
    """Record the block with :func:`make_profiler` (CUDA activities where a
    card is present) and write its Chrome trace to ``<log_dir>/<name>``
    (read it with ``utils/trace_report.py`` or Perfetto)."""
    if not enabled:
        yield
        return
    import torch

    os.makedirs(log_dir, exist_ok=True)
    with make_profiler(torch.cuda.is_available()) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, name))
