"""What every cell's run shares: the run's settings, the clock and the
benchmark's host spans, the traced window, and the record a run hands
to the per-layer readers."""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from perfbench.devtrace import Trace, from_profiler


@dataclass
class Ctx:
    """One run of one cell."""

    cell: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    started: float                      # perf_counter at process start
    control: Tuple[str, ...] = ()       # the controls to read (calibration)


class Spans:
    """Host time by benchmark span name; under a trace also each span's
    interval on the profiler's clock (``time.time_ns``), which names the
    device's idle gaps.  No profiler range is opened: the traced window
    records CUDA activity only, so the host runs at its untraced pace."""

    def __init__(self, traced: bool):
        self.traced = traced
        self.seconds: Dict[str, float] = {}
        self.intervals: List[Tuple[int, int, str]] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        n0 = time.time_ns() if self.traced else 0
        try:
            yield
        finally:
            self.seconds[name] = (self.seconds.get(name, 0.0)
                                  + time.perf_counter() - t0)
            if self.traced:
                self.intervals.append((n0, time.time_ns(), name))


class Tracer:
    """The profiler over CUDA activity alone (kernels, copies, fills), or
    nothing: recording the host's operators too slowed the window's host
    by about a third and inflated the idle share it measures.  It starts
    before the warm-up, so that its own start-up falls there, and reads
    only the window, from :meth:`open` to :meth:`stop`."""

    def __init__(self, on: bool, outside: str, device: torch.device):
        self.on, self.outside = on, outside
        self.prof = None
        self.t0 = self.t1 = 0
        self.result: Optional[Trace] = None
        if on:
            # a machine without a card (the CPU tests) records the host's
            # operators, which no reader takes for the device's
            act = torch.profiler.ProfilerActivity
            self.prof = torch.profiler.profile(
                activities=[act.CUDA if device.type == "cuda" else act.CPU])
            self.prof.start()

    def open(self) -> None:
        self.t0 = time.time_ns()

    def stop(self, reps: int, spans: "Spans") -> None:
        """Close the window of ``reps`` batches or steps, whose host spans
        ``spans`` name the idle gaps."""
        self.t1 = time.time_ns()
        if self.prof is not None:
            self.prof.stop()
            self.result = from_profiler(self.prof, (self.t0, self.t1),
                                        spans.intervals, self.outside, reps)
            self.prof = None


@dataclass
class Window:
    """What a run measured, for the end-to-end metrics and the readers."""

    cell: str
    setup_s: float                      # process start to window start
    seconds: float                      # the window, host clock
    captions: int                       # captions decoded or trained on
    batches: int
    spans: Dict[str, float]
    bound_s: float                      # roofline bound of the window's work
    flops: float                        # model FLOPs of the window's work
    latencies_s: List[float] = field(default_factory=list)
    peak_bytes: int = 0                 # max_memory_allocated in the window
    trace: Optional[Trace] = None


@dataclass
class Outcome:
    window: Window
    attempted: int
    failed: int
    checks: Dict[str, float]            # the numbers compared
    memory_peak_bytes: int
    notes: Dict[str, object] = field(default_factory=dict)
    control: Dict[str, float] = field(default_factory=dict)


def host_notes(times: List[float], t0: float, seconds: float,
               load0: Tuple[float, ...], chunk: float = 5.0) -> Dict[str, object]:
    """What the host did in the window, for the notes line: the batches or
    steps that ended in each ``chunk`` seconds (a host that slows for a
    while shows as a dip), and the machine's load average at the window's
    start and end (other processes on the host's cores)."""
    import os
    n = max(1, int(-(-seconds // chunk)))
    per = [0] * n
    for t in times:
        per[min(n - 1, max(0, int((t - t0) // chunk)))] += 1
    return {"per_chunk": per, "chunk_s": chunk,
            "loadavg": [load0[0], os.getloadavg()[0]],
            "cpus": len(os.sched_getaffinity(0))}


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device: torch.device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def settle() -> None:
    """End of set-up: collect, then freeze what set-up made (the corpus's
    hundreds of thousands of caption lists) out of the collector's view,
    so that a full collection inside the window does not walk it."""
    import gc
    gc.collect()
    gc.freeze()


def free(device: torch.device) -> None:
    import gc
    gc.unfreeze()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
