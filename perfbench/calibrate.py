"""The readings the output check's limits are set from, on the card: for
one cell, the program's numbers over many seeds, the control's (the
reference in float8 in the program's place) on the same inputs, and the
numbers of a planted fault, each run in one process.

    python3 perfbench/calibrate.py --workload <cell> --seeds <n> ... \\
        [--seconds 2] [--fault <name>] [--out <file.jsonl>]

A limit lies above the largest reading of sound runs and below the least
reading of the control (and, for a train cell, of each fault that reads
ten times the sound runs or more); ``PERF.md`` gives the readings and
the limits.  Each line also gives the verdict of the cell's limits on the
program's numbers (``correct``) and on each control's
(``control_correct``), which has to come out false.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--control", nargs="*", default=["fp8"],
                   help="lower precisions read as the control: fp8 (float8 "
                        "e4m3, one scale a tensor), fp8_raw, int8")
    p.add_argument("--fault", default="")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [str(REPO)] + [x for x in sys.path if x != here]

    import torch

    from perfbench import check, faults, run, spec
    from perfbench.harness import free
    if not torch.cuda.is_available():
        print("calibrate.py: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    kind = spec.traffic(spec.cell(spec.benchmark(), args.workload))["kind"]
    plant = faults.FAULTS[kind][args.fault] if args.fault else contextlib.nullcontext
    out = open(args.out, "a") if args.out else None
    limits = spec.limits(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        with plant():
            outcome, result = run.run_cell(args.workload, seed, args.seconds,
                                           False, dev, started=t0,
                                           control=tuple(args.control))
        verdicts = {kind: check.verdict(
            {k: outcome.control[f"{kind}:{k}"] for k in limits}, limits)
            for kind in args.control}
        line = json.dumps({"cell": args.workload, "seed": seed,
                           "fault": args.fault, "correct": result["correct"],
                           "control_correct": verdicts,
                           "program": outcome.checks,
                           "control": outcome.control,
                           "seconds": time.perf_counter() - t0})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        del outcome, result
        free(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
