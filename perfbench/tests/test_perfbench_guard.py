"""What a run may load and where it may run."""

from __future__ import annotations

import subprocess
import sys

import pytest
import torch

from conftest import REPO
from perfbench import run


def test_forbidden_modules_compare_whole_names():
    loaded = {"vae_captioning_torch": 1, "vae_captioning_torch.ops": 1,
              "jaxtyping": 1, "flaxen": 1, "optax_like.x": 1, "torch": 1}
    assert run.forbidden_modules(loaded) == []
    assert run.forbidden_modules(dict(loaded, **{"jax.numpy": 1})) == ["jax"]
    assert run.forbidden_modules({"vae_captioning_tpu.ops.lstm": 1, "flax": 1,
                                  "jaxlib": 1, "optax": 1}) == \
        ["flax", "jaxlib", "optax", "vae_captioning_tpu"]


def test_the_harness_and_reference_load_nothing_forbidden(tiny):
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import perfbench.run as r, perfbench.drive_decode, perfbench.drive_train\n"
            "import perfbench.reference.cvae\n"
            "print(r.forbidden_modules())" % str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=REPO)
    assert out.stdout.strip() == "[]"


def test_reference_imports_nothing_of_the_program():
    for path in (REPO / "perfbench" / "reference").glob("*.py"):
        text = path.read_text()
        for name in ("vae_captioning", "jax", "flax", "perfbench.program"):
            assert f"import {name}" not in text and f"from {name}" not in text


def test_a_machine_without_a_card_gets_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "ag512-decode-beam10-b4096", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=REPO)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


@pytest.mark.cuda
def test_a_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import json
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "ag512-train-b256", "--seed", "2147483659", "--seconds", "2",
         "--trace", "0"], capture_output=True, text=True, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert set(result["metrics"]) == {"train_captions_per_s", "train_peak_mib",
                                      "setup_s"}
    assert list(result)[-1] == "checks"
