"""Run one cell of the benchmark once and print its result.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (kernels loaded, and built at a checkout's first run; weights,
inputs, warm-up) is timed from the process's start to the window's;
then the cell's traffic runs for ``--seconds`` in a closed loop; then,
with the program's state freed, its outputs are compared with the plain
reference.  The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), ``device``, with
``--trace 1`` a ``breakdown``, and last ``checks``, each number compared
with its limit; the same numbers end standard error.  A machine without
CUDA, or with fewer cards than the cell asks for, gets no result and a
non-zero exit; so does a run that loaded JAX or the JAX package, and a
traced run whose trace lost events.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "vae_captioning_tpu")


def forbidden_modules(modules=None) -> list:
    """Top-level names of loaded modules that a run may not load, compared
    whole (``vae_captioning_torch`` is not ``vae_captioning_tpu``)."""
    names = sys.modules if modules is None else modules
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device,
             started: float = STARTED, control: tuple = (),
             root: Path = None):
    """One run of ``cell`` on ``device``; returns (its Outcome, the
    result's dict)."""
    import importlib

    from perfbench import check, spec
    from perfbench.harness import Ctx

    root = spec.ROOT if root is None else root
    bench = spec.benchmark(root)
    entry = spec.cell(bench, cell)
    ctx = Ctx(cell=cell, config=spec.config(bench, entry, root),
              traffic=spec.traffic(entry, root), seed=seed, seconds=seconds,
              trace=trace, device=device, started=started, control=control)
    driver = importlib.import_module(f"perfbench.drive_{ctx.traffic['kind']}")
    outcome = driver.run(ctx)
    limits = spec.limits(cell, root)
    correct = check.verdict(outcome.checks, limits)
    w = outcome.window
    metrics = {}
    for m in (spec.per_layer if trace else spec.end_to_end)(bench, cell):
        value = spec.reader(m["name"], root)(w)
        if value is None and not trace and device.type == "cuda":
            raise RuntimeError(f"{cell}: no reading of {m['name']}")
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": _device_name(device), "count": entry["chips"],
                   "memory_peak_bytes": outcome.memory_peak_bytes}
    result = {"correct": correct, "attempted": outcome.attempted,
              "failed": outcome.failed, "metrics": metrics,
              "device": device_info}
    if trace and w.trace is not None:
        device_info["busy_s"] = w.trace.busy_s
        device_info["window_s"] = w.trace.window_s
        result["breakdown"] = {"device_ops": [list(x) for x in w.trace.device_ops],
                               "idle_gaps": [list(x) for x in w.trace.idle_gaps]}
    result["checks"] = {k: {"value": outcome.checks[k], "limit": v}
                        for k, v in limits.items()}
    return outcome, result


def trace_fault(outcome) -> str:
    """Why a traced run's trace cannot be read ('' where it can): a trace
    that lost events would give wrong busy, idle and roofline figures."""
    trace = outcome.window.trace
    return trace.partial or "" if trace is not None else ""


def _device_name(device) -> str:
    import torch
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    import platform
    return platform.processor() or "cpu"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # every cache a run writes stays inside the checkout, at fixed paths
    cache = REPO / ".perfbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [str(REPO)] + [p for p in sys.path if p != here]

    import torch

    from perfbench import spec
    entry = spec.cell(spec.benchmark(), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"run.py: {args.workload} needs {entry['chips']} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    outcome, result = run_cell(args.workload, args.seed, args.seconds,
                               bool(args.trace), torch.device("cuda", 0))
    notes = dict(outcome.notes, window_s=outcome.window.seconds,
                 batches=outcome.window.batches,
                 spans_s=outcome.window.spans)
    print("notes: " + json.dumps(notes, default=str), file=sys.stderr)
    fault = trace_fault(outcome)
    if fault:
        print(f"run.py: the trace lost events ({fault}); no result",
              file=sys.stderr)
        return 4
    found = forbidden_modules()
    if found:
        print(f"run.py: the run loaded {found}, which the benchmark forbids",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
