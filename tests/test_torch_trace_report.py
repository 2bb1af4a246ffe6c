"""The profiler hook and its trace summary (``Config.profile`` in
``Trainer.fit`` and vae_captioning_torch/utils/trace_report.py, the
counterparts of the JAX package's ``jax.profiler`` window and
utils/xplane.py, whose tests are tests/test_xplane.py).

* ``aggregate`` on a canned Chrome trace written here: device and host
  planes, per-name totals and counts, most expensive first, exactly;
  ``format_report`` / ``device_report``; the CLI; and the errors (no
  file, not a trace, no duration event).
* A real ``torch.profiler`` capture on the CPU (``utils.logging.
  profile_trace``): its operators are aggregated, the matmul among them.
* ``Trainer.fit`` under ``profile=True`` on the CPU for 21 steps writes
  ``trace_steps11-20.json`` into ``log_dir`` after step 20 (the JAX
  package's steps 10-20 window) and prints its top operators; without
  ``profile`` it writes nothing."""

import json
import os

import numpy as np
import pytest
import torch

from vae_captioning_torch import train as ttrain
from vae_captioning_torch.config import Config
from vae_captioning_torch.data.batcher import Batch
from vae_captioning_torch.utils import trace_report
from vae_captioning_torch.utils.logging import profile_trace


def _canned(tmp_path):
    events = [
        {"ph": "X", "cat": "kernel", "name": "lstm_cell_kernel", "dur": 30.0,
         "ts": 0},
        {"ph": "X", "cat": "kernel", "name": "lstm_cell_kernel", "dur": 20.0,
         "ts": 40},
        {"ph": "X", "cat": "kernel", "name": "ce_fwd_kernel", "dur": 45.5,
         "ts": 70},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "dur": 2.0,
         "ts": 90},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 7.0, "ts": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "dur": 9.0, "ts": 9},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "dur": 1.0, "ts": 19},
        {"ph": "i", "cat": "cpu_op", "name": "instant", "ts": 3},     # no span
        {"ph": "M", "name": "process_name", "args": {"name": "x"}},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_aggregate_canned_trace(tmp_path):
    stats = trace_report.aggregate(_canned(tmp_path))
    assert list(stats) == ["device", "host: cpu_op"]
    assert stats["device"] == [
        trace_report.OpStats("lstm_cell_kernel", 50.0, 2),
        trace_report.OpStats("ce_fwd_kernel", 45.5, 1),
        trace_report.OpStats("Memcpy HtoD", 2.0, 1)]
    assert stats["host: cpu_op"] == [trace_report.OpStats("aten::add", 10.0, 2),
                                     trace_report.OpStats("aten::mm", 7.0, 1)]
    assert stats["device"][0].duration_ms == pytest.approx(0.05)
    report = trace_report.device_report(stats, top=2)
    assert report.splitlines()[0].startswith("== device: 3 distinct ops, Σ 0.098 ms")
    assert "lstm_cell_kernel" in report and "Memcpy" not in report
    assert trace_report.format_report(stats, plane_filter="nothing") == ""
    # the newest trace of a directory
    assert trace_report.aggregate(str(tmp_path)) == stats


def test_trace_report_cli(tmp_path, capsys):
    path = _canned(tmp_path)
    trace_report.main([path, "--top", "1", "--plane", "host"])
    out = capsys.readouterr().out
    assert "aten::add" in out and "aten::mm" not in out and "kernel" not in out
    with pytest.raises(SystemExit, match="no plane"):
        trace_report.main([path, "--plane", "TPU"])


def test_missing_or_empty_traces_raise(tmp_path):
    with pytest.raises(FileNotFoundError):
        trace_report.aggregate(str(tmp_path / "none"))
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    with pytest.raises(ValueError, match="not a Chrome trace"):
        trace_report.aggregate(str(bad))
    empty = tmp_path / "empty.json"
    empty.write_text(json.dumps({"traceEvents": [{"ph": "M", "name": "x"}]}))
    with pytest.raises(ValueError, match="no duration event"):
        trace_report.aggregate(str(empty))
    with pytest.raises(SystemExit, match="cannot read"):
        trace_report.main([str(empty)])


def test_aggregates_a_real_cpu_capture(tmp_path):
    a = torch.randn(64, 64)
    with profile_trace(str(tmp_path), name="cpu.json"):
        for _ in range(3):
            a = torch.tanh(a @ a)
    stats = trace_report.aggregate(str(tmp_path / "cpu.json"))
    ops = {o.name: o for o in stats["host: cpu_op"]}
    assert ops["aten::mm"].count == 3 and ops["aten::tanh"].count == 3
    assert "device" not in stats
    assert "aten::mm" in trace_report.device_report(stats)


class _Batches:
    """A train batcher serving one fixed batch of 2 images x 1 caption."""

    def __init__(self, seed=0):
        rng = np.random.default_rng(seed)
        T = 5
        labels = rng.integers(3, 40, size=(2, 1, T)).astype(np.int32)
        labels[1, 0, 3:] = 0
        dec = np.roll(labels, 1, axis=2)
        dec[..., 0] = 1
        self.batch = Batch(features=rng.normal(size=(2, 4096)).astype(np.float32),
                           dec_inputs=dec, labels=labels,
                           lengths=(labels != 0).sum(-1).astype(np.int32),
                           cluster_vectors=np.zeros((2, 90), np.float32),
                           valid=2)

    def train_batches(self, num_captions):
        while True:
            yield self.batch


@pytest.mark.parametrize("profile", [True, False])
def test_fit_profiles_steps_11_to_20(tmp_path, capsys, profile):
    cfg = Config(embed_size=16, encoder_hidden=16, decoder_hidden=16,
                 latent_size=4, gen_z_samples=2, batch_size=2, num_captions=1,
                 num_epochs=1, num_ex_per_epoch=40, prefetch_batches=0,
                 logging=False, profile=profile, log_dir=str(tmp_path / "logs"))
    cfg.vocab_size = 40
    trainer = ttrain.Trainer(cfg, device="cpu")
    trainer.fit(_Batches(), log_every=1000)
    assert trainer.host_step == 21
    out = capsys.readouterr().out
    if not profile:
        assert trainer.trace_path is None
        assert not os.path.exists(cfg.log_dir)
        return
    assert trainer.trace_path == os.path.join(cfg.log_dir, "trace_steps11-20.json")
    assert f"profiler trace written to {trainer.trace_path}" in out
    stats = trace_report.aggregate(trainer.trace_path)
    # ten steps of the CPU path: the LSTM sequence and the z projection
    # ran once a step each, forward and backward
    names = {o.name: o.count for o in stats["host: cpu_op"]}
    assert names["aten::mm"] >= 10
    assert "== host: cpu_op" in out and "aten::" in out
