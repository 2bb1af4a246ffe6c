"""Where the benchmark finds what belongs to a cell, by name.

``BENCHMARK.json`` (at the root of the checkout) names each cell's
configuration and traffic mix and lists the metrics.  Beside this module:

* ``configs/<config>.json``: the configuration's sizes (the ``file`` that
  BENCHMARK.json gives it);
* ``traffic/<traffic>.json``: the traffic mix's parameters, read by the
  generator of its ``kind`` (``drive_<kind>.py``);
* ``limits/<cell>.json``: the limits of the cell's output check;
* ``metrics/<metric>.py``: a per-layer metric's reader, a function
  ``read(window) -> float | None``.

A cell, configuration, traffic mix or per-layer metric is added by files
and entries alone.  Every function takes the benchmark's ``root`` (this
directory by default), so tests can point it at a tree of their own.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parent


class SpecError(ValueError):
    pass


def repo_of(root: Path = ROOT) -> Path:
    return root.parent


def benchmark(root: Path = ROOT) -> dict:
    path = repo_of(root) / "BENCHMARK.json"
    if not path.is_file():
        raise SpecError(f"no {path}")
    return json.loads(path.read_text())


def _named(entries: List[dict], name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise SpecError(f"BENCHMARK.json has no {what} {name!r}")


def cell(bench: dict, name: str) -> dict:
    return _named(bench["workloads"], name, "workload")


def config(bench: dict, cell_entry: dict, root: Path = ROOT) -> dict:
    entry = _named(bench["configs"], cell_entry["config"], "config")
    cfg = json.loads((repo_of(root) / entry["file"]).read_text())
    cfg["name"] = entry["name"]
    return cfg


def traffic(cell_entry: dict, root: Path = ROOT) -> dict:
    path = root / "traffic" / f"{cell_entry['traffic']}.json"
    if not path.is_file():
        raise SpecError(f"no traffic file {path}")
    return json.loads(path.read_text())


def limits(cell_name: str, root: Path = ROOT) -> Dict[str, float]:
    path = root / "limits" / f"{cell_name}.json"
    if not path.is_file():
        raise SpecError(f"no limits file {path}")
    return json.loads(path.read_text())["limits"]


def _applies(metric: dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def end_to_end(bench: dict, cell_name: str) -> List[dict]:
    return [m for m in bench["end_to_end"] if _applies(m, cell_name)]


def per_layer(bench: dict, cell_name: str) -> List[dict]:
    """The per-layer metrics that apply to the cell: those that list it,
    and those without a list whose end-to-end metric the cell reports."""
    reported = {m["name"] for m in end_to_end(bench, cell_name)}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]


def reader(metric_name: str, root: Path = ROOT
           ) -> Callable[[object], Optional[float]]:
    path = root / "metrics" / f"{metric_name}.py"
    if not path.is_file():
        raise SpecError(f"no reader {path}")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{metric_name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
