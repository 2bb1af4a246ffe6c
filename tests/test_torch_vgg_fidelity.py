"""The port's VGG16 fidelity tool (vae_captioning_torch/models/
vgg_fidelity.py), the counterparts of the JAX tool's tests
(tests/test_models.py: passes on the synthetic Caffe npz, fails on a
swapped layout), on the CPU at 224 on the ``vgg_npz`` fixture, one
image (the CLI two).  Its oracle imports nothing of models/vgg16.py."""

import ast
import json

import numpy as np
import pytest

from vae_captioning_tpu.models import vgg_fidelity as jvf
from vae_captioning_torch.models import vgg_fidelity as vf


def test_tool_passes_on_synthetic_npz(vgg_npz):
    ok, report = vf.compare(vgg_npz, device="cpu", batch=1)
    assert ok, report
    assert report["rel_diff_f32"] < 1e-3, report
    assert report["rel_diff_bf16_path"] < 2e-2, report
    assert report["nonzero_frac"] > 0.0
    assert set(report) == {"fc2_scale", "max_abs_diff_f32", "rel_diff_f32",
                           "rel_diff_bf16_path", "threshold", "nonzero_frac"}


def _swapped(vgg_npz, tmp_path) -> str:
    """The npz with conv5_2 and conv5_3 swapped (shape-compatible, so it
    loads silently)."""
    raw = dict(np.load(vgg_npz))
    raw["conv5_2_W"], raw["conv5_3_W"] = raw["conv5_3_W"], raw["conv5_2_W"]
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, **raw)
    return bad


def test_tool_fails_on_wrong_layout(vgg_npz, tmp_path, monkeypatch):
    """A loader that takes the swapped layout: the tool reports FAIL,
    and the oracle alone sees the swap (rel > 1e-2), as the JAX test
    holds its oracle to."""
    bad = _swapped(vgg_npz, tmp_path)
    images = vf.fixed_image(batch=1)
    ref, wrong = vf.oracle_fc2(vgg_npz, images), vf.oracle_fc2(bad, images)
    rel = float(np.abs(wrong - ref).max()) / (float(np.abs(ref).max()) + 1e-12)
    assert rel > 1e-2, f"layout corruption invisible to the tool: {rel}"
    port = vf.port_fc2
    monkeypatch.setattr(vf, "port_fc2",
                        lambda path, *a, **k: port(bad, *a, **k))
    ok, report = vf.compare(vgg_npz, device="cpu", batch=1)
    assert not ok and report["rel_diff_f32"] > 1e-2, report


def test_oracle_matches_the_jax_oracle(vgg_npz):
    images = vf.fixed_image(batch=1)
    np.testing.assert_array_equal(images, jvf.fixed_image(batch=2)[:1])
    got, want = vf.oracle_fc2(vgg_npz, images), jvf.oracle_fc2(vgg_npz, images)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_oracle_is_independent_of_the_model():
    """No import of models/vgg16.py at module level or in the oracle (the
    path under test imports it inside port_fc2)."""
    with open(vf.__file__) as f:
        tree = ast.parse(f.read())
    oracle = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
                  and n.name == "oracle_fc2")
    assert not [n for n in ast.walk(oracle)
                if isinstance(n, (ast.Import, ast.ImportFrom))]
    top = [a.name for n in tree.body if isinstance(n, ast.Import)
           for a in n.names]
    top += [n.module for n in tree.body if isinstance(n, ast.ImportFrom)]
    assert not any("vgg16" in m or m.startswith("vae_captioning")
                   for m in top), top


def test_cli_reports_pass(vgg_npz, capsys):
    with pytest.raises(SystemExit) as done:
        vf.main(["--weights", vgg_npz, "--device", "cpu"])
    assert done.value.code == 0
    report = json.loads(capsys.readouterr().out)
    assert report["verdict"] == "PASS" and report["rel_diff_f32"] < 1e-3
