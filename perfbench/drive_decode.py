"""Traffic kind ``decode``: batch captioning of a split, batches back to
back in a closed loop (the next batch's turn comes when the loop asks for
it), through the program's own batch loop (``generate_captions``) over its
batcher (``CaptionBatcher.eval_batches``) and feature store, with its
decode fn (``make_decode_fns(...)[method]``).

The split is swept again until the window closes; the z noise of the
window's j-th batch is drawn by the benchmark from the seed and handed in
as ``eps``.  A batch's latency runs from the loop's request for it to its
captions on the host: the loop detokenises batch j while batch j + 1
decodes, so batch j is done when the loop asks for batch j + 2 (or when
the sweep returns).  Three batches, drawn from the seed among those the
window completed, are compared with the reference (``check.py``).
"""

from __future__ import annotations

import os
import time
from typing import List, Optional

import numpy as np
import torch

from perfbench import check, counts, program, traffic, weights
from perfbench.harness import (Ctx, Outcome, Spans, Tracer, Window, free,
                               host_notes, peak_bytes, reset_peak, settle,
                               synchronize)
from perfbench.reference import cvae as ref

KEEP = 3            # batches compared with the reference
OUTSIDE = "loop: copy + detokenize"


class Feed:
    """The batcher as ``generate_captions`` sees it: its batches, the time
    of each request, and an end at the deadline or after ``limit``."""

    def __init__(self, batcher, spans: Spans, deadline: Optional[float] = None,
                 limit: Optional[int] = None):
        self.batcher, self.spans = batcher, spans
        self.deadline, self.limit = deadline, limit
        self.requests: List[float] = []
        self.valid: List[int] = []

    def eval_batches(self, num_captions: int = 1, with_ids: bool = True):
        batches = self.batcher.eval_batches(num_captions, with_ids)
        while True:
            now = time.perf_counter()
            self.requests.append(now)
            if ((self.deadline is not None and now >= self.deadline)
                    or (self.limit is not None and len(self.valid) >= self.limit)):
                return
            with self.spans("next_batch"):
                batch = next(batches, None)
            if batch is None:
                return
            self.valid.append(batch.valid)
            yield batch

    def latencies(self, returned: float) -> List[float]:
        n = len(self.valid)
        ends = self.requests[2:n + 1] + [returned] * (n - len(self.requests[2:n + 1]))
        return [end - start for start, end in zip(self.requests[:n], ends)]


class Tap:
    """The decode fn handed to the loop: the run's eps for each batch, the
    decode's span, its steps, and a seeded sample of its results."""

    def __init__(self, fn, seed: int, width: int, device, spans: Spans,
                 first: int = 0, keep: int = 0):
        self.fn, self.seed, self.width, self.device = fn, seed, width, device
        self.spans, self.calls, self.keep = spans, first, keep
        self.first = first
        self.steps: List[int] = []
        self.kept: List[tuple] = []
        self.rng = np.random.default_rng([seed, 5])

    def __call__(self, features, c_v, generator=None):
        j = self.calls
        self.calls += 1
        eps = traffic.decode_eps(self.seed, j, features.shape[0], self.width,
                                 self.device)
        with self.spans("decode_fn"):
            res = self.fn(features, c_v, eps=eps)
        self.steps.append(res.steps)
        if self.keep:
            item = (j, res.tokens, res.scores)
            seen = j - self.first
            if seen < self.keep:
                self.kept.append(item)
            else:
                slot = int(self.rng.integers(0, seen + 1))
                if slot < self.keep:
                    self.kept[slot] = item
        return res


def run(ctx: Ctx) -> Outcome:
    from vae_captioning_torch.data.batcher import CaptionBatcher
    from vae_captioning_torch.data.features import FeatureStore
    from vae_captioning_torch.inference import (generate_captions,
                                                make_decode_fns)
    from vae_captioning_torch.models.cvae import CVAEModel

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    B, beam = tr["batch_images"], tr["beam_size"]
    pcfg = program.config(cfg, ctx.seed, beam_size=beam, batch_size=B,
                          gen_batch_size=B, sample_gen=tr["method"])
    vocab = program.vocabulary(cfg["vocab_size"])
    shapes = ref.flax_shapes(cfg)
    build_s = program.build() if dev.type == "cuda" else 0.0
    model = CVAEModel.from_config(pcfg).to(dev).eval()
    program.load_weights(model, weights.draw(shapes, ctx.seed, dev), shapes)
    decode = make_decode_fns(model, pcfg, vocab)[tr["method"]]
    data = traffic.corpus(tr, cfg, ctx.seed, dev, "val2014")
    batcher = CaptionBatcher(
        data.names, data.captions, B,
        feature_store=FeatureStore(data.names, data.features),
        cluster_vectors=data.cluster_vectors,
        filename_to_imid=data.image_ids, seed=ctx.seed)
    per_sweep = -(-len(data.names) // B)
    gen = torch.Generator(device=dev).manual_seed(ctx.seed)
    E = cfg["embed_size"]

    tracer = Tracer(ctx.trace, OUTSIDE, dev)
    # warm-up: one batch of the cell's shape through the same loop
    warm_spans = Spans(False)
    generate_captions(Feed(batcher, warm_spans, limit=1),
                      Tap(decode, ctx.seed, E, dev, warm_spans, first=10 ** 9),
                      vocab, gen, dev)
    synchronize(dev)
    settle()
    setup_s = time.perf_counter() - ctx.started

    spans = Spans(ctx.trace)
    tap = Tap(decode, ctx.seed, E, dev, spans, keep=KEEP)
    program.reset_launches()
    setup_peak = peak_bytes(dev)
    reset_peak(dev)
    captions, latencies, valid, requests = 0, [], [], []
    load0 = os.getloadavg()
    tracer.open()
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    while time.perf_counter() < deadline:
        feed = Feed(batcher, spans, deadline=deadline)
        captions += len(generate_captions(feed, tap, vocab, gen, dev))
        latencies += feed.latencies(time.perf_counter())
        valid += feed.valid
        requests += feed.requests[:len(feed.valid)]
    synchronize(dev)
    t1 = time.perf_counter()
    tracer.stop(len(valid), spans)
    launches = program.launches()
    window_peak = peak_bytes(dev)

    work = []
    for rows, steps in zip(valid, tap.steps):
        work += counts.decode_batch(cfg, rows, beam, steps)
    window = Window(cell=ctx.cell, setup_s=setup_s, seconds=t1 - t0,
                    captions=captions, batches=len(valid),
                    spans=dict(spans.seconds),
                    bound_s=counts.bound_seconds(work),
                    flops=counts.model_flops(work), latencies_s=latencies,
                    peak_bytes=window_peak, trace=tracer.result)

    # the check, once the program's state is freed
    kept = [(j, tok.clone(), sc.clone()) for j, tok, sc in tap.kept]
    steps_per_batch = float(np.mean(tap.steps[:len(valid)])) if valid else 0.0
    del decode, model, tap
    free(dev)
    p = weights.draw(shapes, ctx.seed, dev)
    rcfg = dict(cfg, seed=ctx.seed)
    readings, control = [], []
    for j, tokens, scores in kept:
        i = j % per_sweep
        lo, hi = i * B, min((i + 1) * B, len(data.names))
        feats = torch.from_numpy(data.features[lo:hi]).to(dev)
        cv = torch.from_numpy(data.cv_array[lo:hi, 1:]).to(dev)
        eps = traffic.decode_eps(ctx.seed, j, B, E, dev)[:hi - lo]
        with ref.no_tf32():
            carry = ref.decode_init(p, rcfg, feats, cv, eps)
        readings.append(check.decode_numbers(
            p, rcfg, carry, tokens[:hi - lo], scores[:hi - lo], beam,
            vocab.bos_id, vocab.eos_id))
        lows = {}
        for kind in ctx.control:
            mm = ref.quantized(kind)
            with ref.no_tf32():
                qcarry = ref.decode_init(p, rcfg, feats, cv, eps, mm)
                qtok, qscore = ref.beam_search(p, rcfg, qcarry, beam,
                                               vocab.bos_id, vocab.eos_id, mm)
            lows.update({f"{kind}:{k}": v for k, v in check.decode_numbers(
                p, rcfg, carry, qtok, qscore, beam, vocab.bos_id,
                vocab.eos_id).items()})
        if lows:
            control.append(lows)
    return Outcome(window=window, attempted=captions,
                   failed=0, checks=check.merge(readings),
                   memory_peak_bytes=max(setup_peak, window_peak),
                   notes={"build_s": build_s, "launches": launches,
                          "batches_checked": [j for j, _, _ in kept],
                          "per_sweep": per_sweep,
                          "steps_per_batch": steps_per_batch,
                          **host_notes(requests, t0, ctx.seconds, load0)},
                   control=check.merge(control) if control else {})
