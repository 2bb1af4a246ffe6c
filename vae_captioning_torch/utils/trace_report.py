"""Reader for ``torch.profiler`` Chrome traces (counterpart of
``vae_captioning_tpu/utils/xplane.py``).

``Config.profile`` (``Trainer.fit``) and any ``torch.profiler`` run write
a Chrome trace (``export_chrome_trace``): a JSON object whose
``traceEvents`` hold complete events (``"ph": "X"``) with a category
(``cat``), a name and a duration in microseconds.  This module answers
the question xplane answers for the JAX package: which operations took
the device's time.  It groups the events into planes, as an XPlane trace
has them:

* ``device``: the card's events, CUDA kernels (``kernel``), copies
  (``gpu_memcpy``) and fills (``gpu_memset``);
* ``host: <category>``: everything else, by category (``cpu_op``, the
  PyTorch operators; ``cuda_runtime``; ``python_function``; ...).

and aggregates each plane's events by name, most expensive first.  A
trace on the CPU has no device plane; :func:`format_report` then reports
the host planes.  A missing file, a file that is not a trace, or a trace
without a duration event raises: the summary is never "unavailable".

CLI::

    python -m vae_captioning_torch.utils.trace_report <trace.json | dir> \\
        [--top N] [--plane SUBSTR]
"""

from __future__ import annotations

import collections
import glob
import json
import os
from typing import Dict, List, NamedTuple, Optional

DEVICE = "device"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


class OpStats(NamedTuple):
    name: str
    duration_us: float
    count: int

    @property
    def duration_ms(self) -> float:
        return self.duration_us / 1e3


def resolve_trace_path(path: str) -> str:
    """A trace file, or the newest ``*.json`` under a directory."""
    if os.path.isfile(path):
        return path
    hits = sorted(glob.glob(os.path.join(path, "**", "*.json"), recursive=True),
                  key=os.path.getmtime)
    if not hits:
        raise FileNotFoundError(f"no Chrome trace (*.json) under {path}")
    return hits[-1]


def plane_of(category: str) -> str:
    """The plane of an event's category."""
    return DEVICE if category in DEVICE_CATEGORIES else f"host: {category}"


def aggregate(path: str) -> Dict[str, List[OpStats]]:
    """Per plane, the duration events aggregated by name, most expensive
    first (durations summed over occurrences; overlapping events, such as
    kernels launched with programmatic dependent launch, each count their
    whole span)."""
    path = resolve_trace_path(path)
    with open(path) as f:
        try:
            trace = json.load(f)
        except json.JSONDecodeError as e:
            raise ValueError(f"{path}: not a Chrome trace ({e})") from None
    events = trace.get("traceEvents") if isinstance(trace, dict) else trace
    if not isinstance(events, list):
        raise ValueError(f"{path}: no traceEvents list")
    dur: Dict[str, collections.Counter] = collections.defaultdict(
        collections.Counter)
    cnt: Dict[str, collections.Counter] = collections.defaultdict(
        collections.Counter)
    for ev in events:
        if not isinstance(ev, dict) or ev.get("ph") != "X" or "dur" not in ev:
            continue
        plane = plane_of(str(ev.get("cat", "")))
        name = str(ev.get("name", ""))
        dur[plane][name] += float(ev["dur"])
        cnt[plane][name] += 1
    if not dur:
        raise ValueError(f"{path}: the trace holds no duration event")
    return {plane: [OpStats(n, d, cnt[plane][n]) for n, d in c.most_common()]
            for plane, c in sorted(dur.items())}


def partial_trace(events, reps: int) -> Optional[str]:
    """Why a trace of ``reps`` calls of one function lost events, or None
    where it is whole.  ``events`` are the trace's device events as
    (name, ...) tuples; a call launches the same kernels each time, so in
    a whole trace every name occurs a nonzero multiple of ``reps`` times
    (and some name occurs).  A trace that dropped some events would
    otherwise undercount the calls' device time without a word."""
    if not events:
        return "no device event"
    counts = collections.Counter(ev[0] for ev in events)
    odd = sorted((n, c) for n, c in counts.items() if c % reps)
    if odd:
        name, count = odd[0]
        return (f"{len(odd)} of {len(counts)} names occur a count that is not a "
                f"multiple of {reps} calls (as {name[:60]!r}: {count})")
    return None


def format_report(stats: Dict[str, List[OpStats]], top: int = 20,
                  plane_filter: str = "") -> str:
    """The ``top`` names of each plane whose name contains
    ``plane_filter``, by total time; "" when no plane matches."""
    rows = []
    for plane, ops in stats.items():
        if plane_filter and plane_filter not in plane:
            continue
        total = sum(o.duration_us for o in ops)
        rows.append(f"== {plane}: {len(ops)} distinct ops, "
                    f"Σ {total / 1e3:.3f} ms (overlapping spans each count)")
        for o in ops[:top]:
            rows.append(f"  {o.duration_ms:10.3f} ms  x{o.count:<6d} "
                        f"{o.name[:110]}")
    return "\n".join(rows)


def device_report(stats: Dict[str, List[OpStats]], top: int = 10) -> str:
    """The device plane's top ``top``, or, for a trace taken on the CPU
    (no device plane), the host operators' (``cpu_op``), else every
    plane's."""
    return (format_report(stats, top, DEVICE)
            or format_report(stats, top, "host: cpu_op")
            or format_report(stats, top))


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(
        description="Summarize a torch.profiler Chrome trace by op cost")
    p.add_argument("trace", help="a trace .json (export_chrome_trace) or a "
                                 "directory holding one (the newest is read)")
    p.add_argument("--top", type=int, default=20)
    p.add_argument("--plane", default="",
                   help="only planes whose name contains this substring "
                        "(device, host: cpu_op, ...)")
    args = p.parse_args(argv)
    try:
        report = format_report(aggregate(args.trace), args.top, args.plane)
    except (ValueError, FileNotFoundError) as e:
        raise SystemExit(f"trace_report: cannot read {args.trace!r}: {e}")
    if not report:
        raise SystemExit(f"trace_report: no plane matches {args.plane!r}")
    print(report)


if __name__ == "__main__":
    main()
