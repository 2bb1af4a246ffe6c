"""Reading the traced window: device busy time, idle gaps and the device
operations that took the most time, from ``torch.profiler``'s events.

The profiler records the CUDA activity alone over the window; the
benchmark's own host spans are intervals on ``time.time_ns``, the clock
the profiler's events carry.  :func:`summarize`
reduces the events to a :class:`Trace`: the union of the device
operations' intervals inside the window (busy), the gaps between them
named by the host span open where each starts, and each device
operation's total time.  :func:`partial_trace` is a frozen copy of the
program's whole-trace check (``utils/trace_report.py``), kept so that the
yardstick cannot move with it: every batch or step of a window launches
the same kernels, so a trace that lost events shows it.
"""

from __future__ import annotations

import bisect
import collections
import re
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

TOP = 10
ONCE = "check_copy"     # the host span of the output check's copies

Interval = Tuple[int, int]          # [start_ns, end_ns)


class Trace(NamedTuple):
    window_s: float
    busy_s: float
    device_ops: List[Tuple[str, float]]     # name, seconds (most first)
    idle_gaps: List[Tuple[str, float]]      # host span at the gap, seconds
    kernels: int                            # device operations seen
    partial: Optional[str] = None           # why the trace lost events


def union(intervals: Sequence[Interval]) -> List[Interval]:
    """Sorted, merged intervals."""
    out: List[Interval] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            if end > out[-1][1]:
                out[-1] = (out[-1][0], end)
        else:
            out.append((start, end))
    return out


def span_at(spans: Sequence[Tuple[int, int, str]], t: int,
            outside: str) -> str:
    """The innermost (latest-starting) host span covering time ``t``, or
    ``outside``."""
    best = None
    for start, end, name in spans:
        if start <= t < end and (best is None or start >= best[0]):
            best = (start, name)
    return best[1] if best else outside


def summarize(device: Sequence[Tuple[str, int, int]],
              spans: Sequence[Tuple[int, int, str]],
              window: Interval, outside: str, reps: int = 0) -> Trace:
    """``device``: (name, start_ns, end_ns) of each device operation;
    ``spans``: the benchmark's host spans (start_ns, end_ns, name);
    ``window``: the traced window (start_ns, end_ns); a gap under no span
    is named ``outside``; ``reps``: the batches or steps of the window, each
    of which launches the same device operations (:func:`partial_trace`),
    but for those inside a span named ``ONCE``: the output check's own
    copies, made once in the window."""
    lo, hi = window
    device = [(n, max(s, lo), min(e, hi)) for n, s, e in device
              if e > lo and s < hi]
    once = [(s, e) for s, e, name in spans if name == ONCE]
    repeated = [ev for ev in device
                if not any(s <= ev[1] and ev[2] <= e for s, e in once)]
    busy = union([(s, e) for _, s, e in device])
    per_name: Dict[str, float] = collections.Counter()
    for name, s, e in device:
        per_name[name] += (e - s) / 1e9
    gaps, prev = [], lo
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = e
    if hi > prev:
        gaps.append((prev, hi))
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    starts = sorted(spans)
    named = []
    for g0, g1 in gaps[:TOP]:
        # spans that started by the gap's start, nearest last
        k = bisect.bisect_right(starts, (g0, float("inf"), ""))
        named.append((span_at(starts[max(0, k - 64):k], g0, outside),
                      (g1 - g0) / 1e9))
    return Trace(window_s=(hi - lo) / 1e9,
                 busy_s=sum(e - s for s, e in busy) / 1e9,
                 device_ops=sorted(per_name.items(), key=lambda kv: kv[1],
                                   reverse=True)[:TOP],
                 idle_gaps=named, kernels=len(device),
                 partial=partial_trace(repeated, reps) if reps else None)


RUNTIME = re.compile(r"^cu(da)?[A-Z]")     # cudaLaunchKernel, cuLaunchKernel


def from_profiler(prof, window: Interval, spans: Sequence[Tuple[int, int, str]],
                  outside: str, reps: int) -> Trace:
    """:func:`summarize` over a stopped ``torch.profiler.profile``: the
    events on the device (kernels, copies, fills; not the device's copies
    of host annotations, nor runtime calls), with the benchmark's host
    ``spans``."""
    from torch.autograd import DeviceType
    device = []
    for ev in prof.profiler.kineto_results.events():
        name, start = ev.name(), ev.start_ns()
        annotation = getattr(ev, "is_user_annotation", lambda: False)()
        if (ev.device_type() == DeviceType.CUDA and not annotation
                and not RUNTIME.match(name)):
            device.append((name, start, start + ev.duration_ns()))
    return summarize(device, spans, window, outside, reps)


# ----------------------------------------------------------------------
# frozen copy of the program's whole-trace check
# ----------------------------------------------------------------------

def partial_trace(events, reps: int) -> Optional[str]:
    """Why a trace of ``reps`` calls of one function lost events, or None
    where it is whole: a call launches the same kernels each time, so in
    a whole trace every name occurs a nonzero multiple of ``reps`` times."""
    if not events:
        return "no device event"
    counts = collections.Counter(ev[0] for ev in events)
    odd = sorted((n, c) for n, c in counts.items() if c % reps)
    if odd:
        name, count = odd[0]
        return (f"{len(odd)} of {len(counts)} names occur a count that is not a "
                f"multiple of {reps} calls (as {name[:60]!r}: {count})")
    return None
