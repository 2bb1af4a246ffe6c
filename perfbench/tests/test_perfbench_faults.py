"""The output check catches a broken timed path: a run with a fault
planted under it (``perfbench/faults.py``) comes out not correct, and the
control (the reference in float8 in the program's place) fails a number
that the program passes.  Tiny sizes, the program's CPU path; the cell's
own limits."""

from __future__ import annotations

import pytest

from conftest import run_tiny
from perfbench import faults, spec

CONTROL = "fp8"


def cells(kind):
    return [w["name"] for w in spec.benchmark()["workloads"]
            if spec.traffic(w)["kind"] == kind]


@pytest.mark.parametrize("cell", cells("decode") + cells("train"))
def test_sound_run_is_correct(tiny, cell):
    _, result = run_tiny(tiny, cell)
    assert result["correct"] is True, result["checks"]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS["decode"]))
@pytest.mark.parametrize("cell", cells("decode"))
def test_decode_fault_is_caught(tiny, cell, fault):
    with faults.FAULTS["decode"][fault]():
        _, result = run_tiny(tiny, cell)
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS["train"]))
@pytest.mark.parametrize("cell", cells("train"))
def test_train_fault_is_caught(tiny, cell, fault):
    with faults.FAULTS["train"][fault]():
        _, result = run_tiny(tiny, cell)
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("cell", cells("decode") + cells("train"))
def test_control_fails_a_number(tiny, cell):
    outcome, result = run_tiny(tiny, cell, control=(CONTROL,))
    limits = spec.limits(cell)
    assert result["correct"] is True
    assert any(outcome.control[f"{CONTROL}:{k}"] > limits[k] for k in limits), \
        outcome.control
