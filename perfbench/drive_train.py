"""Traffic kind ``train``: training on fc2 features in a closed loop, the
program's Trainer fed by its batcher (``CaptionBatcher.train_batches``
over an in-memory feature store, inline) through ``Trainer.device_batch``
and ``run_step_arrays``, epoch after epoch until the window closes.

Set-up builds the one Trainer, loads the run's weights into it and runs
its first three steps through the window's own call and feed: they warm
every shape (every batch has the same caption-length bucket) and are the
steps the reference follows (``check.py``); ``WARM_STEPS`` more finish the
warm-up.  The window continues the same Trainer.  One window step, drawn
from the seed among its first ``PROBE_STEPS``, is also followed: the
parameters and the optimizer's first moment are copied to the host before
it and the first moment after it (one pause of about 0.2 s in the window),
and the reference takes that step again from the program's parameters.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from perfbench import check, counts, devtrace, program, traffic, weights
from perfbench.harness import (Ctx, Outcome, Spans, Tracer, Window, free,
                               host_notes, peak_bytes, reset_peak, settle,
                               synchronize)
from perfbench.reference import cvae as ref

CHECK_STEPS = 3
WARM_STEPS = 60     # further warm-up steps, after those the reference follows
PROBE_STEPS = 32    # the window step followed is drawn among the first 32
OUTSIDE = "loop: step enqueue"


class Stream:
    """The Trainer's batches, epoch after epoch, formed inline: the
    Prefetcher's thread contends with the loop for the interpreter lock
    and makes the host's time chaotic (PERF.md)."""

    def __init__(self, batcher, captions: int):
        self.batcher, self.captions = batcher, captions
        self.it = None

    def next(self):
        while True:
            if self.it is None:
                self.it = self.batcher.train_batches(self.captions)
            batch = next(self.it, None)
            if batch is not None:
                return batch
            self.it = None


class Probe(NamedTuple):
    """The window step the reference takes again."""

    step: int                       # the optimizer's step index, 0-based
    batch: object                   # the host batch
    params: List[torch.Tensor]      # before the step, host copies
    grads: List[torch.Tensor]       # its clipped gradient, from the moments


def host_copy(tensors) -> List[torch.Tensor]:
    return [t.detach().to("cpu", copy=True) for t in tensors]


GUARD_S = 0.002


@contextlib.contextmanager
def check_copy(dev, spans: Spans):
    """The span (``devtrace.ONCE``) of the check's copies in the window:
    the device idle before it, and a guard of a few ms inside and outside
    each end, so that the copies alone fall in it on the device's clock
    (a trace placed some copies a little past a span without guards)."""
    synchronize(dev)
    time.sleep(GUARD_S)
    with spans(devtrace.ONCE):
        time.sleep(GUARD_S)
        yield
        time.sleep(GUARD_S)
    time.sleep(GUARD_S)


def step(trainer, stream: Stream, spans: Spans):
    with spans("next_batch"):
        batch = stream.next()
    with spans("device_batch"):
        arrays = trainer.device_batch(batch)
    with spans("step"):
        metrics = trainer.run_step_arrays(arrays)
    return batch, arrays, metrics


def run(ctx: Ctx) -> Outcome:
    from vae_captioning_torch.data.batcher import CaptionBatcher
    from vae_captioning_torch.data.features import FeatureStore
    from vae_captioning_torch.train import Trainer

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    B, K = tr["batch_images"], tr["captions_per_image"]
    pcfg = program.config(cfg, ctx.seed, batch_size=B, num_captions=K)
    shapes = ref.flax_shapes(cfg)
    build_s = program.build() if dev.type == "cuda" else 0.0
    zeros = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
    trainer = Trainer(pcfg, device=dev, params=zeros)
    program.load_weights(trainer.model, weights.draw(shapes, ctx.seed, dev),
                         shapes)
    data = traffic.corpus(tr, cfg, ctx.seed, dev, "train2014")
    batcher = CaptionBatcher(
        data.names, data.captions, B,
        feature_store=FeatureStore(data.names, data.features),
        cluster_vectors=data.cluster_vectors, seed=ctx.seed)
    stream = Stream(batcher, K)

    tracer = Tracer(ctx.trace, OUTSIDE, dev)
    # the first steps: warm-up, and the steps the reference follows
    warm = Spans(False)
    fed, losses = [], []
    for i in range(CHECK_STEPS):
        batch, _, metrics = step(trainer, stream, warm)
        fed.append(batch)
        losses.append(metrics["loss"])
        if i == 0:
            b1 = trainer.optimizer.b1
            first_grads = [m.detach().cpu() / (1.0 - b1)
                           for m in trainer.optimizer.mu]
    synchronize(dev)
    params = [p.detach().to("cpu", copy=True) for p in trainer.model.parameters()]
    losses = [float(x) for x in losses]
    # the first seconds of a window after three steps alone ran 10-20%
    # slower than the rest (PERF.md): more steps of warm-up, same call
    for _ in range(WARM_STEPS):
        step(trainer, stream, warm)
    synchronize(dev)
    setup_peak = peak_bytes(dev)
    settle()
    setup_s = time.perf_counter() - ctx.started

    spans = Spans(ctx.trace)
    probe_at = int(np.random.default_rng([ctx.seed, 7]).integers(PROBE_STEPS))
    probe: Optional[Probe] = None
    program.reset_launches()
    reset_peak(dev)
    steps, tokens, ends = 0, [], []
    load0 = os.getloadavg()
    tracer.open()
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    while time.perf_counter() < deadline or probe is None:
        if steps == probe_at:
            with check_copy(dev, spans):
                before = host_copy(trainer.model.parameters())
                mu = host_copy(trainer.optimizer.mu)
        batch, _, metrics = step(trainer, stream, spans)
        if steps == probe_at:
            with check_copy(dev, spans):
                after = host_copy(trainer.optimizer.mu)
            grads = [(m1 - b1 * m0) / (1.0 - b1) for m0, m1 in zip(mu, after)]
            probe = Probe(step=CHECK_STEPS + WARM_STEPS + steps, batch=batch,
                          params=before, grads=grads)
        tokens.append(int((batch.labels != 0).sum()))
        steps += 1
        ends.append(time.perf_counter())
    synchronize(dev)
    t1 = time.perf_counter()
    tracer.stop(steps, spans)
    launches = program.launches()
    window_peak = peak_bytes(dev)

    n_params = sum(p.numel() for p in params)
    work = []
    for n_tokens in tokens:
        work += counts.train_step(cfg, B, K, n_tokens, n_params)
    window = Window(cell=ctx.cell, setup_s=setup_s, seconds=t1 - t0,
                    captions=steps * B * K, batches=steps,
                    spans=dict(spans.seconds),
                    bound_s=counts.bound_seconds(work),
                    flops=counts.model_flops(work), peak_bytes=window_peak,
                    trace=tracer.result)

    # the check, once the program's state is freed
    model = trainer.model
    prog_grads = program.flax_leaves(model, first_grads)
    prog_params = program.flax_leaves(model, params)
    probe_params = program.flax_leaves(model, probe.params)
    probe_grads = program.flax_leaves(model, probe.grads)
    del trainer, model, stream
    free(dev)
    p0 = weights.draw(shapes, ctx.seed, dev)
    batches = [reference_batch(b, dev) for b in fed]
    probe_batch = reference_batch(probe.batch, dev)
    rcfg = dict(cfg, seed=ctx.seed)
    on_dev = lambda d: {k: v.to(dev) for k, v in d.items()}  # noqa: E731
    probe_params = on_dev(probe_params)

    def follow(mm):
        """The reference's first steps and its window step, under ``mm``."""
        first = reference_steps(p0, rcfg, batches, ctx.seed, dev, mm)
        z_seed, clusters = probe_draws(rcfg, ctx.seed, dev, probe.step,
                                       probe_batch.labels.shape[0])
        at = ref.train_step_at(probe_params, rcfg, probe_batch, z_seed,
                               probe.step, clusters, mm)
        return first, at

    want, want_at = follow(ref.exact)
    checks = check.train_numbers(
        losses, on_dev(prog_grads), on_dev(prog_params), p0, want,
        probe=(on_dev(probe_grads), want_at[1]))
    control: Dict[str, float] = {}
    for kind in ctx.control:
        low, low_at = follow(ref.quantized(kind))
        control.update({f"{kind}:{k}": v for k, v in check.train_numbers(
            low.losses, low.first_grads, low.params, p0, want,
            probe=(low_at[1], want_at[1])).items()})
    return Outcome(window=window, attempted=steps, failed=0,
                   checks=checks,
                   memory_peak_bytes=max(setup_peak, window_peak),
                   notes={"build_s": build_s, "launches": launches,
                          "tokens_per_step": float(np.mean(tokens))
                          if tokens else 0.0,
                          "probe_step": probe.step,
                          **host_notes(ends, t0, ctx.seconds, load0)},
                   control=control)


def reference_batch(batch, dev) -> ref.TrainBatch:
    """A host batch as the reference reads it: [B*K, T] caption rows."""
    B, K, T = batch.labels.shape
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return ref.TrainBatch(features=put(batch.features).float(),
                          labels=put(batch.labels.reshape(B * K, T)).long(),
                          dec_inputs=put(batch.dec_inputs.reshape(B * K, T)).long(),
                          lengths=put(batch.lengths.reshape(B * K)).long(),
                          c_v=put(batch.cluster_vectors).float())


def reference_steps(p0, cfg: dict, batches: List[ref.TrainBatch], seed: int,
                    dev, mm) -> ref.TrainTrace:
    """The reference's first steps: the Trainer's z seeds (a host
    generator at seed + 1) and GMM cluster draws (a generator on the
    device at seed + 3), drawn again by the same rule."""
    seeds = torch.Generator().manual_seed(seed + 1)
    z_seeds = [int(torch.randint(0, 2 ** 32, (), generator=seeds))
               for _ in batches]
    clusters = (torch.Generator(device=dev).manual_seed(seed + 3)
                if cfg["prior"] == "GMM" else None)
    return ref.train_steps(p0, cfg, batches, z_seeds, clusters, mm)


def probe_draws(cfg: dict, seed: int, dev, at: int, rows: int):
    """The z seed and the GMM cluster generator of step ``at``, drawn again
    by the Trainer's rule: the ``at``-th draw of a host generator at seed +
    1, and a generator on the device at seed + 3 past ``at`` draws of
    ``rows`` clusters (their offsets follow the shape alone)."""
    seeds = torch.Generator().manual_seed(seed + 1)
    draws = [int(torch.randint(0, 2 ** 32, (), generator=seeds))
             for _ in range(at + 1)]
    if cfg["prior"] != "GMM":
        return draws[-1], None
    clusters = torch.Generator(device=dev).manual_seed(seed + 3)
    probs = torch.ones((rows, cfg["num_clusters"]), device=dev)
    for _ in range(at):
        torch.multinomial(probs, 1, generator=clusters)
    return draws[-1], clusters
