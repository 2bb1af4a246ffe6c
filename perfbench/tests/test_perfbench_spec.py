"""Discovery by name: cells, configurations, traffic, limits and metric
readers come from BENCHMARK.json and files, and a new cell, configuration
and per-layer metric need new files and entries alone."""

from __future__ import annotations

import json
import re

import pytest

from conftest import REPO, run_tiny
from perfbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_names_and_files():
    bench = spec.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and 1 <= len(c["why"]) <= 200
        assert c["file"].startswith("perfbench/") and (REPO / c["file"]).is_file()
        assert c["reduced"] == []
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1 and len(w["why"]) <= 200
        assert spec.traffic(w)["kind"] in ("decode", "train")
        assert spec.limits(w["name"])
        reported = {m["name"] for m in spec.end_to_end(bench, w["name"])}
        assert "setup_s" in reported and len(reported) >= 2
        assert spec.per_layer(bench, w["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert callable(spec.reader(m["name"]))
    assert all(m["moves"] in {e["name"] for e in bench["end_to_end"]}
               for m in bench["per_layer"])
    assert len(json.dumps(bench)) < 64 * 1024


@pytest.mark.parametrize("kind", ["decode", "train"])
def test_cell_added_from_files_alone(tiny, kind):
    """A new configuration, traffic mix, cell, limits and per-layer metric,
    added as files and entries only, are found and run."""
    bench = json.loads((tiny.parent / "BENCHMARK.json").read_text())
    base = next(w for w in bench["workloads"]
                if spec.traffic(w, tiny)["kind"] == kind)
    cfg = json.loads((tiny.parent / spec._named(
        bench["configs"], base["config"], "config")["file"]).read_text())
    cfg["decoder_hidden"] = 32
    (tiny / "configs" / f"new-{kind}.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": f"new-{kind}", "source": "https://example.org",
                             "file": f"perfbench/configs/new-{kind}.json",
                             "reduced": [], "why": "a configuration added by files alone"})
    tr = spec.traffic(base, tiny)
    tr["batch_images"] = 2
    (tiny / "traffic" / f"new-{kind}.json").write_text(json.dumps(tr))
    cell = f"new-{kind}-cell"
    bench["workloads"].append({"name": cell, "config": f"new-{kind}",
                               "traffic": f"new-{kind}", "chips": 1,
                               "why": "a cell added by files alone"})
    (tiny / "limits" / f"{cell}.json").write_text(
        (tiny / "limits" / f"{base['name']}.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        if base["name"] in m.get("workloads", []):
            m["workloads"].append(cell)
    (tiny / "metrics" / f"new.{kind}_batches.py").write_text(
        "def read(w):\n    return float(w.batches)\n")
    bench["per_layer"].append({"name": f"new.{kind}_batches", "unit": "count",
                               "better": "higher", "source": "host_clock",
                               "layer": "batch loop",
                               "moves": bench["end_to_end"][0]["name"],
                               "workloads": [cell]})
    (tiny.parent / "BENCHMARK.json").write_text(json.dumps(bench))
    try:
        outcome, result = run_tiny(tiny, cell, trace=True)
    finally:
        bench["workloads"].pop()
        bench["per_layer"].pop()
        for m in bench["end_to_end"] + bench["per_layer"]:
            if cell in m.get("workloads", []):
                m["workloads"].remove(cell)
        (tiny.parent / "BENCHMARK.json").write_text(json.dumps(bench))
    assert result["correct"] is True
    assert result["metrics"][f"new.{kind}_batches"]["value"] == outcome.window.batches > 0
    assert set(result["checks"]) == set(spec.limits(base["name"], tiny))


def test_unknown_names_raise(tiny):
    bench = spec.benchmark(tiny)
    with pytest.raises(spec.SpecError):
        spec.cell(bench, "no-such-cell")
    with pytest.raises(spec.SpecError):
        spec.reader("no.such_metric", tiny)
