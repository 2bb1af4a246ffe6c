"""Fixtures of the benchmark's CPU tests: a benchmark tree at a tiny size
(the same files, the configurations' widths and the traffic's sizes cut
down), whose runs take the program's plain CPU path."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY_WIDTHS = dict(vocab_size=64, embed_size=32, encoder_hidden=64,
                   decoder_hidden=64, latent_size=8, gen_z_samples=4,
                   cnn_feature_size=64, gen_max_len=6)
SEED = 2 ** 31 + 12345


def tiny_tree(tmp: Path) -> Path:
    """A copy of the benchmark at tiny sizes under ``tmp``; returns its
    ``perfbench`` directory."""
    from perfbench import spec
    src = spec.ROOT
    root = tmp / "perfbench"
    shutil.copytree(src / "metrics", root / "metrics")
    shutil.copytree(src / "limits", root / "limits")
    for d in ("configs", "traffic"):
        (root / d).mkdir(parents=True)
    bench = json.loads((src.parent / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        cfg = json.loads((src.parent / c["file"]).read_text())
        cfg.update(TINY_WIDTHS)
        (tmp / c["file"]).write_text(json.dumps(cfg))
    for w in bench["workloads"]:
        tr = json.loads((src / "traffic" / f"{w['traffic']}.json").read_text())
        tr["caption_words"] = {"3": 50, "4": 30, "5": 15, "6": 5}
        tr.update(images=20, batch_images=8) if tr["kind"] == "decode" else \
            tr.update(images=24, batch_images=4)
        (root / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(tr))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture(scope="session")
def tiny(tmp_path_factory) -> Path:
    return tiny_tree(tmp_path_factory.mktemp("bench"))


def run_tiny(root: Path, cell: str, trace: bool = False, control: tuple = (),
             seconds: float = 0.3, seed: int = SEED):
    import time

    import torch

    from perfbench import run
    return run.run_cell(cell, seed, seconds, trace, torch.device("cpu"),
                        started=time.perf_counter(), control=control,
                        root=root)
