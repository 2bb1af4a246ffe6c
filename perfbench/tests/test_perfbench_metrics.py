"""The metric arithmetic on canned runs: whole-window rates, the p95 over
every batch, the traced window's busy and idle time, and the roofline and
MFU counts at each cell's shapes against numbers worked by hand."""

from __future__ import annotations

import pytest

from perfbench import counts, devtrace, spec
from perfbench.harness import Window

MS = 1_000_000      # ns


def window(**kw) -> Window:
    base = dict(cell="c", setup_s=12.5, seconds=10.0, captions=204800,
                batches=100, spans={"decode_fn": 6.0, "next_batch": 0.5,
                                    "device_batch": 0.7},
                bound_s=2.0, flops=4.0e15, latencies_s=[0.1] * 100)
    base.update(kw)
    return Window(**base)


def read(name: str, w: Window):
    return spec.reader(name)(w)


def test_rates_are_whole_window():
    w = window()
    assert read("decode_captions_per_s", w) == pytest.approx(20480.0)
    assert read("train_captions_per_s", w) == pytest.approx(20480.0)
    assert read("setup_s", w) == 12.5
    assert read("train_peak_mib", window(peak_bytes=3 * 2 ** 30)) == 3072.0


def test_p95_over_every_batch():
    lat = [i / 1000 for i in range(1, 201)]        # 1 .. 200 ms
    # numpy's linear p95 of 1..200: 1 + 0.95 * 199 = 190.05
    assert read("decode_batch_p95_ms", window(latencies_s=lat)) == pytest.approx(190.05)
    assert read("decode_batch_p95_ms", window(latencies_s=[])) is None


def test_host_span_readers():
    w = window()
    assert read("decode.search_ms", w) == pytest.approx(60.0)
    assert read("decode.loop_self_ms", w) == pytest.approx(40.0)
    assert read("train.batch_wait_ms", w) == pytest.approx(12.0)
    assert read("decode.search_ms", window(spans={})) is None


def test_idle_busy_and_gaps_from_a_canned_trace():
    # window [0, 100) ms; kernels [10, 30), [20, 40) overlapping, [70, 80)
    device = [("k1", 10 * MS, 30 * MS), ("k2", 20 * MS, 40 * MS),
              ("k1", 70 * MS, 80 * MS), ("k3", 120 * MS, 130 * MS)]
    spans = [(0, 50 * MS, "decode_fn"), (60 * MS, 65 * MS, "next_batch")]
    t = devtrace.summarize(device, spans, (0, 100 * MS), "loop")
    assert t.busy_s == pytest.approx(0.040)
    assert t.window_s == pytest.approx(0.100)
    assert [round(s, 6) for _, s in t.idle_gaps] == [0.03, 0.02, 0.01]
    # gaps [40, 70), [80, 100), [0, 10): named by the span open at each start
    assert [n for n, _ in t.idle_gaps] == ["decode_fn", "loop", "decode_fn"]
    assert t.device_ops[0] == ("k1", pytest.approx(0.030))
    w = window(trace=t, seconds=0.1, bound_s=0.01, flops=1e10)
    assert read("idle.decode", w) == pytest.approx(60.0)
    assert read("idle.train", w) == pytest.approx(60.0)
    assert read("decode_roofline", w) == pytest.approx(25.0)
    assert read("mfu.decode", w) == pytest.approx(100 * 1e10 / (0.1 * 989e12))
    assert read("decode_roofline", window()) is None


def test_partial_trace():
    ev = [("a",), ("a",), ("b",), ("b",)]
    assert devtrace.partial_trace(ev, 2) is None
    assert "not a multiple" in devtrace.partial_trace(ev + [("a",)], 2)
    assert devtrace.partial_trace([], 2) == "no device event"


PAPER = dict(vocab_size=11500, embed_size=256, encoder_hidden=512,
             decoder_hidden=512, latent_size=150, gen_z_samples=100,
             num_clusters=90, cnn_feature_size=4096)


def test_decode_counts_by_hand():
    # a batch of 2048 images at beam 10, 30 steps: N = 20,480 rows
    ops = counts.decode_batch(PAPER, 2048, 10, 30)
    flops = {}
    for op in ops:
        flops[op.name] = flops.get(op.name, 0) + op.flops
    assert flops["head + top-k"] == 30 * 2 * 20480 * 512 * 11500     # 7.24e12
    assert flops["lstm step"] == 30 * 2 * 20480 * 768 * 2048          # 1.93e12
    assert flops["init steps"] == 3 * 2 * 2048 * 768 * 2048
    # the head binds by products: 241.2 GFLOP a step at 989 TFLOP/s
    head = counts.decode_step(PAPER, 2048, 10)[1]
    assert head.seconds() == pytest.approx(2 * 20480 * 512 * 11500 / 989e12)
    # the merge is all bytes: 4 N H f32 of carry reordered, k-lists, lse
    merge = counts.decode_step(PAPER, 2048, 10)[2]
    assert merge.bytes == 20480 * 10 * 8 + 20480 * 4 + 4 * 20480 * 512 * 4 + 3 * 20480 * 8
    # beam 3 at 8192 images: N = 24,576
    assert counts.model_flops(counts.decode_step(PAPER, 8192, 3)) == \
        2 * 24576 * 768 * 2048 + 2 * 24576 * 512 * 11500


def test_train_counts_by_hand():
    tokens = 16000              # real tokens of 1280 captions
    params = 30_000_000
    listed = counts.train_step(dict(PAPER, prior="AG"), 256, 5, tokens, params)
    ops = {op.name: op for op in listed}
    assert ops["logits head + CE"].flops == 3 * 2 * tokens * 512 * 11500
    assert ops["decoder lstm sequence"].flops == 3 * 2 * tokens * 768 * 2048
    assert ops["posterior heads"].flops == 3 * 2 * 1280 * 512 * 2 * 90 * 150
    assert ops["z sample + projection"].flops == 3 * 2 * 1280 * 100 * 150 * 256
    assert ops["image embedding"].flops == 2 * 2 * 256 * 4096 * 256
    assert ops["clip + Adam"].bytes == 32 * params
    assert ops["clip + Adam"].seconds() == pytest.approx(32 * params / 3.35e12)
    # three products a forward product (forward, dX, dW), two where the
    # input is data: about 1.03 TFLOP a step
    by_hand = (3 * 2 * (tokens * (2 * 768 * 2048 + 512 * 11500)
                        + 1280 * (512 * 27000 + 15000 * 256 + 5 * 768 * 2048))
               + 2 * 2 * 256 * (4096 + 90) * 256)
    assert counts.model_flops(listed) == by_hand
    assert all(op.bytes > 0 for op in listed)


def test_a_trace_that_lost_events_gives_no_result():
    from types import SimpleNamespace

    from perfbench import run
    whole = devtrace.summarize([("k", 0, MS), ("k", 2 * MS, 3 * MS)], [],
                               (0, 4 * MS), "loop", reps=2)
    lost = devtrace.summarize([("k", 0, MS), ("k", 2 * MS, 3 * MS), ("j", 0, 1)],
                              [], (0, 4 * MS), "loop", reps=2)
    assert run.trace_fault(SimpleNamespace(window=window(trace=whole))) == ""
    assert "not a multiple" in run.trace_fault(SimpleNamespace(window=window(trace=lost)))
    assert run.trace_fault(SimpleNamespace(window=window())) == ""


def test_traced_spans_keep_their_intervals():
    from perfbench.harness import Spans
    spans = Spans(True)
    with spans("next_batch"):
        pass
    with spans("step"):
        pass
    assert [n for _, _, n in spans.intervals] == ["next_batch", "step"]
    assert all(s <= e for s, e, _ in spans.intervals)
    assert set(spans.seconds) == {"next_batch", "step"}
    assert Spans(False).intervals == []


def test_the_checks_own_copies_are_not_a_lost_event():
    # two steps of one kernel, and one copy inside the check's span
    device = [("k", 0, MS), ("k", 2 * MS, 3 * MS), ("copy", 4 * MS, 5 * MS)]
    spans = [(int(3.5 * MS), 6 * MS, devtrace.ONCE)]
    t = devtrace.summarize(device, spans, (0, 8 * MS), "loop", reps=2)
    assert t.partial is None
    assert t.busy_s == pytest.approx(0.003)
    assert devtrace.summarize(device, [], (0, 8 * MS), "loop", reps=2).partial
