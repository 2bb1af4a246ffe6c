"""Batch caption generation + COCO-eval JSON export (counterpart of
``vae_captioning_tpu/inference.py``).

Sweeps the val split with beam search (or greedy) and the test split
with greedy decoding, and writes ``val_<gen_name>.json`` /
``test_<gen_name>.json`` as ``[{"image_id": int, "caption": str}]``.

Every decode step runs the fused LSTM step kernel (once per decoder
layer, ``cell_0`` first), then one of:

* the fused logits + top-k (k = beam, or 1 for greedy), the default;
* its int8 variant under ``Config.decode_int8`` (approximate: h and the
  logits head quantised to int8, the head once per build);
* for beams wider than those kernels' lists of 16, either of them with
  its fold replaced by a store of the f32 logits, then the exact top-k +
  logsumexp kernel over them (``ops/fused_logits_topk.py``: ``K_MAX``);
* the fused Gumbel-max sampler for ``sample_gen="sample"``
  (``Config.temperature``), keyed on one 32-bit seed per decode call,
  drawn from the decode's generator, and the step index;
* under ``Config.fused_decode = False``, the JAX package's kill switch,
  the logits head as a plain bf16 product written to memory (the Flax
  Dense's rounding: bf16 logits, bf16 bias), then the beam's exact top-k
  + logsumexp kernel over those logits, ``torch.argmax`` for greedy, or
  ``torch.multinomial`` with the decode's generator for sampling.  On the
  TPU that switch reaches XLA's top-k; here the step_fn form's top-k is
  the ``top_k_logsumexp`` kernel, as the JAX ``top_k_logsumexp`` dispatch
  takes its Pallas kernel on its accelerator.

Under ``compute_dtype="float32"`` the decode takes the JAX package's
route there: its LSTM step kernel is gated on bf16, so every LSTM step is
the plain step in f32 (``ops/f32.py``), with TF32 off; its logits kernels
are not gated, so the logits head runs as above, on the kernels, h and
the head cast to bf16 (or the int8 head under ``decode_int8``), and
``fused_decode = False`` writes f32 logits.

The weights are cast once, when ``make_decode_fns`` builds its closures,
and on a card zero-padded once to the kernels' widths (E and H to
multiples of 32, or of 64 for the int8 head): the carry then lies at the
padded H, whose extra units stay 0, and no step pads.
A ``FineTuneModel`` decodes from raw images: its VGG16 makes the fc2
features in ``decode_init``.  The TPU switches ``fused_lstm_step`` and
``fused_force`` are not read.

Over data-parallel ranks (``Config.multihost``: ``run_inference`` and the
quality hook pass ``DataParallel.current()``) a decode fn takes the
global batch on every rank and runs ``decode_init`` on all of it (the z
draws, and each row's carry, are one process's), searches from its
rank's contiguous share of the carry rows (the batch padded to a
multiple of the ranks, ``kernel_shard.DataParallel.shard_rows``) and
gathers the tokens and scores of every rank (``gather_rows``).  The step
kernels take the launch plans of the batch's real row count
(:func:`plan_rows`), so beam and greedy decode row for row, bit for bit,
as one process does.
The sampler's seed is folded with the rank (``fold_seed``, the JAX
wrapper's formula), so the ranks draw distinct streams: the same law as
one process, not its draws.  Rank 0 alone writes the JSON files and
scores the holdout.

``make_quality_hook`` is ``Trainer.fit``'s per-epoch caption-quality hook
(``Config.eval_metrics``): a greedy decode of the holdout through the
decode kernels, scored by ``eval/``.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from torch import nn

from vae_captioning_torch.config import Config
from vae_captioning_torch.data.vocabulary import Vocabulary
from vae_captioning_torch.eval.meteor import corpus_meteor_es
from vae_captioning_torch.eval.scorers import cider_d, corpus_bleu, rouge_l
from vae_captioning_torch.models.cvae import (CVAEModel, decoder_step_params,
                                              logits_head_params)
from vae_captioning_torch.models.finetune import cvae_of
from vae_captioning_torch.ops.decoding import (beam_search, sample_decode,
                                               tokens_to_text)
from vae_captioning_torch.ops.f32 import (exact_matmuls, logits_f32,
                                          lstm_step_f32, torch_dtype)
from vae_captioning_torch.ops.fused_logits_topk import (
    INT8_WIDTH_STEP, fused_logits_sample, fused_logits_sample_plain,
    fused_logits_top_k, fused_logits_top_k_int8,
    fused_logits_top_k_int8_plain, fused_logits_top_k_plain,
    quantize_logits_weights)
from vae_captioning_torch.ops.fused_lstm_step import (
    WIDTH_STEP as LSTM_WIDTH_STEP, fused_lstm_step, fused_lstm_step_plain)
from vae_captioning_torch.ops.padding import (pad_gates, pad_last,
                                              pad_lstm_kernel, round_up)
from vae_captioning_torch.ops.topk_lse import (top_k_logsumexp,
                                               top_k_logsumexp_plain)
from vae_captioning_torch.parallel import mesh
from vae_captioning_torch.parallel.kernel_shard import SINGLE, DataParallel


def check_supported(cfg: Config) -> None:
    """Raise ValueError for a configuration no decode takes: an unknown
    ``compute_dtype`` or fewer than one decoder layer."""
    torch_dtype(cfg.compute_dtype)
    if cfg.decoder_rnn_layers < 1:
        raise ValueError(f"decoder_rnn_layers={cfg.decoder_rnn_layers}: "
                         "at least one layer")


class DecodeOps(NamedTuple):
    """The per-step operations.  The decode path uses the kernel
    wrappers; comparisons on the card swap in the plain versions.  The
    LSTM step and the top-k functions take ``plan_rows`` (decode over
    ranks: :func:`plan_rows`), which the plain versions ignore.  Under
    f32 the LSTM step is ``lstm_step_f32`` whatever the ops
    (:func:`route`)."""

    lstm_step: Callable = fused_lstm_step
    logits_top_k: Callable = fused_logits_top_k
    logits_top_k_int8: Callable = fused_logits_top_k_int8
    logits_sample: Callable = fused_logits_sample
    top_k_lse: Callable = top_k_logsumexp


KERNEL_OPS = DecodeOps()
PLAIN_OPS = DecodeOps(fused_lstm_step_plain, fused_logits_top_k_plain,
                      fused_logits_top_k_int8_plain, fused_logits_sample_plain,
                      top_k_logsumexp_plain)
# The plain versions with every dot product of the bf16 decode summed in
# reverse order: how far f32 sum order alone moves a bf16 decode, the
# yardstick for the kernels' own sum order.
REORDERED_OPS = PLAIN_OPS._replace(
    lstm_step=functools.partial(fused_lstm_step_plain, reverse_sum=True),
    logits_top_k=functools.partial(fused_logits_top_k_plain, reverse_sum=True))


def route(ops: DecodeOps, dtype: torch.dtype) -> DecodeOps:
    """``ops`` as the decode runs them in ``dtype``: under f32 the LSTM
    step in plain f32, as the JAX package runs its bf16-only step kernel
    nowhere else; the logits functions as given."""
    if dtype == torch.float32:
        return ops._replace(lstm_step=lstm_step_f32)
    return ops


class DecodeWeights(NamedTuple):
    """Decode-step weights, cast once: the embedding and LSTM kernels in
    the compute dtype (bf16, or f32), the head in bf16 for the logits
    kernels (or f32 for the f32 unfused head), f32 biases; E and H
    zero-padded once to the kernels' widths on a card."""

    embed: torch.Tensor     # [V, E]
    lstm_w: Tuple[torch.Tensor, ...]    # per layer [in+H, 4H], cell_0 first
    lstm_b: Tuple[torch.Tensor, ...]    # per layer [4H] f32
    # [H, V], stored column-major: head_w.t() is W^T [V, H] contiguous,
    # the layout the logits kernels read with TMA
    head_w: torch.Tensor
    head_b: torch.Tensor    # [V] f32
    # decode_int8 only: the f32 head quantised per column
    head_wq: Optional[torch.Tensor] = None   # [H, V] int8
    head_ws: Optional[torch.Tensor] = None   # [V] f32

    @classmethod
    def of(cls, model: CVAEModel, int8: bool = False,
           dtype: torch.dtype = torch.bfloat16,
           head_dtype: torch.dtype = torch.bfloat16,
           multiple: int = 1) -> "DecodeWeights":
        """The model's decode weights: the embedding and LSTM kernels in
        ``dtype``, the head in ``head_dtype`` and, under ``int8``, the
        int8 head; E and H zero-padded up to multiples of ``multiple``
        (exact: ``ops/padding.py``), so that the wrappers, which pad only
        what is not aligned, pad nothing on any step."""
        with torch.no_grad():
            emb, kernels, biases = decoder_step_params(model)
            w, b = logits_head_params(model)
            E, H = emb.shape[1], w.shape[0]
            Ep, Hp = round_up(E, multiple), round_up(H, multiple)
            ins = [(E, Ep)] + [(H, Hp)] * (len(kernels) - 1)
            wq, ws = quantize_logits_weights(w) if int8 else (None, None)
            return cls(pad_last(emb, Ep).to(dtype).contiguous(),
                       tuple(pad_lstm_kernel(k, i, H, ip, Hp).to(dtype)
                             .contiguous() for k, (i, ip) in zip(kernels, ins)),
                       tuple(pad_gates(kb.float(), H, Hp).contiguous()
                             for kb in biases),
                       # [Hp, V] column-major, W^T [V, Hp] contiguous
                       pad_last(w.t(), Hp).to(head_dtype).contiguous().t(),
                       b.float().contiguous(),
                       None if wq is None else pad_last(wq.t(), Hp).t(), ws)


# a rank's share of a decode batch: (the share's rows, the batch's rows)
Share = Optional[Tuple[int, int]]


def plan_rows(n: int, share: Share) -> dict:
    """The decode ops' keyword for a call on ``n`` rows of a rank's
    ``share`` of a batch: the row count the same call has in one process
    (n // share rows · batch rows: the batch's real count, or that times
    the beam), whose launch plans the kernels take, so that a row computes
    as one process computes it (the kernels choose their units and vocab
    chunks by the row count); none outside a share."""
    if share is None:
        return {}
    rows, whole = share
    return {"plan_rows": n // rows * whole}


def make_lstm_fn(weights: DecodeWeights, ops: DecodeOps = KERNEL_OPS,
                 share: Share = None) -> Callable:
    """(carry, x [N, E]) → (carry, h' [N, Hp]): one step of every layer of
    the stack on the weights cast once, each layer's h' the next one's x;
    x and a carry narrower than the weights are zero-padded to them (the
    first conditioning step's).  Every LSTM step of a decode goes through
    it: the conditioning steps of ``decode_init`` and each token step.  On
    a rank the N rows are a ``share`` of the batch (:func:`plan_rows`)."""
    dtype = weights.embed.dtype
    Ep, Hp = weights.embed.shape[1], weights.lstm_b[0].shape[0] // 4

    def fn(carry, x):
        new_carry = []
        plan = plan_rows(x.shape[0], share)
        x = pad_last(x.to(dtype), Ep)
        for (c, h), w, b in zip(carry, weights.lstm_w, weights.lstm_b):
            c, h = ops.lstm_step(x, pad_last(c, Hp), pad_last(h, Hp), w, b,
                                 **plan)
            new_carry.append((c, h))
            x = h.to(dtype)
        return tuple(new_carry), h

    return fn


def make_step_topk_fn(weights: DecodeWeights, k: int,
                      ops: DecodeOps = KERNEL_OPS, share: Share = None
                      ) -> Callable:
    """(carry, tokens [N]) → (carry, top-k values, indices, logsumexp):
    one LSTM step, then the logits head folded into top-k, the [N, V]
    logits never stored.  With the quantised head in ``weights``, the
    int8 variant, on the f32 h the LSTM step returns.  On a rank the N
    rows are a ``share`` of the batch (:func:`plan_rows`): each row's
    logsumexp then sums its vocab chunks as one process does."""
    lstm = make_lstm_fn(weights, ops, share)

    def fn(carry, tokens):
        carry, h = lstm(carry, weights.embed[tokens])
        plan = plan_rows(h.shape[0], share)
        if weights.head_wq is not None:
            vals, idx, lse = ops.logits_top_k_int8(
                h, weights.head_wq, weights.head_ws, weights.head_b, k, **plan)
        else:
            vals, idx, lse = ops.logits_top_k(
                h.to(torch.bfloat16), weights.head_w, weights.head_b, k, **plan)
        return carry, vals, idx, lse

    return fn


def make_step_sample_fn(weights: DecodeWeights, seed: int, temperature: float,
                        ops: DecodeOps = KERNEL_OPS, share: Share = None
                        ) -> Callable:
    """(carry, tokens [N], step) → (carry, next [N]): one LSTM step, then
    one Gumbel-max draw per lane from softmax(logits / temperature),
    keyed on (seed, step), the logits never stored."""
    lstm = make_lstm_fn(weights, ops, share)

    def fn(carry, tokens, step):
        carry, h = lstm(carry, weights.embed[tokens])
        return carry, ops.logits_sample(h.to(torch.bfloat16), weights.head_w,
                                        weights.head_b, seed, step,
                                        temperature)

    return fn


def make_step_logits_fn(weights: DecodeWeights,
                        ops: DecodeOps = KERNEL_OPS,
                        share: Share = None) -> Callable:
    """(carry, tokens [N]) → (carry, logits [N, V] f32): one LSTM step,
    then the logits head as a plain product written to memory, rounded
    as the Flax Dense with ``dtype=bfloat16`` rounds it (bf16 logits
    from an f32 sum, plus the bias in bf16): the decode step of the JAX
    package's ``fused_decode=False`` path; on an f32 head the f32 head."""
    lstm = make_lstm_fn(weights, ops, share)
    w = weights.head_w.float()
    if weights.head_w.dtype == torch.float32:
        def fn(carry, tokens):
            carry, h = lstm(carry, weights.embed[tokens])
            return carry, logits_f32(h, w, weights.head_b)

        return fn
    b16 = weights.head_b.to(torch.bfloat16)

    def fn(carry, tokens):
        carry, h = lstm(carry, weights.embed[tokens])
        logits = (h.to(torch.bfloat16).float() @ w).to(torch.bfloat16) + b16
        return carry, logits.float()

    return fn


def draw_seed(generator: Optional[torch.Generator],
              device: torch.device) -> int:
    """One 32-bit seed for a sampled decode, from ``generator`` (or the
    device's default generator): the only host sync the sampler adds."""
    return int(torch.randint(0, 2 ** 32, (1,), generator=generator,
                             device=device, dtype=torch.int64))


def make_step_argmax_fn(weights: DecodeWeights,
                        ops: DecodeOps = KERNEL_OPS,
                        share: Share = None) -> Callable:
    """Greedy step: the argmax is the fused top-1."""
    topk = make_step_topk_fn(weights, 1, ops, share)

    def fn(carry, tokens):
        carry, _, idx, _ = topk(carry, tokens)
        return carry, idx[:, 0]

    return fn


class Decoded(NamedTuple):
    tokens: torch.Tensor             # [B, T] (beam_search_all: [B, beam, T])
    scores: Optional[torch.Tensor]   # [B] / [B, beam]; None for greedy
    steps: int                       # decode steps run


def make_decode_fns(model: nn.Module, cfg: Config, vocab: Vocabulary,
                    ops: DecodeOps = KERNEL_OPS,
                    dp: DataParallel = SINGLE) -> Dict[str, Callable]:
    """Whole-batch decoders ``fn(features [B, F], c_v [B, 90],
    generator=None, eps=None) -> Decoded``, for "beam_search" (best
    beam), "beam_search_all" (all beams, best-first), "greedy" and
    "sample" (temperature sampling); for a ``FineTuneModel`` the first
    argument is images [B, S, S, 3].  Tensors lie on the model's device;
    the z noise comes from ``eps`` [B, E] or is drawn from ``generator``,
    which also keys the sampler.  Under f32 the LSTM steps are the f32
    ones (:func:`route`).  On data-parallel ranks (``dp``) each fn takes
    the global batch, runs ``decode_init`` on all of it (the generator's
    draws, and each row's carry, are then one process's), searches from
    this rank's share of the carry rows and returns every rank's rows."""
    check_supported(cfg)
    dtype = torch_dtype(cfg.compute_dtype)
    f32 = dtype == torch.float32
    ops = route(ops, dtype)
    fused = cfg.fused_decode
    int8 = cfg.decode_int8 and fused
    cvae = cvae_of(model)
    on_card = next(cvae.parameters()).device.type == "cuda"
    weights = DecodeWeights.of(
        cvae, int8, dtype=dtype,
        head_dtype=torch.bfloat16 if fused else dtype,
        multiple=(INT8_WIDTH_STEP if int8 else LSTM_WIDTH_STEP) if on_card else 1)
    bos, eos = vocab.bos_id, vocab.eos_id
    needs_cv = cfg.needs_cluster_vectors
    ranks = dp.world
    dec = dict(bos_id=bos, eos_id=eos, max_len=cfg.gen_max_len)
    # decode_init runs on the whole batch on every rank, as one process
    init_lstm = make_lstm_fn(weights, ops)

    def decode_fn(search: Callable) -> Callable:
        """The decode fn of ``search(carry, rows, generator, share) ->
        Decoded``: ``decode_init`` on the whole batch, then the search, in
        inference mode and, under f32, with TF32 off; on ranks the search
        from this rank's share of the carry rows, gathered."""
        @functools.wraps(search)
        def fn(features, c_v, generator=None, eps=None) -> Decoded:
            with torch.inference_mode(), \
                    (exact_matmuls() if f32 else contextlib.nullcontext()):
                carry = model.decode_init(
                    features, c_v if needs_cv else None, eps=eps,
                    generator=generator, lstm_step=init_lstm)
                B = features.shape[0]
                if ranks == 1:
                    return search(carry, B, generator, None)
                local = tuple((dp.shard_rows(c), dp.shard_rows(h))
                              for c, h in carry)
                rows = local[0][0].shape[0]
                res = search(local, rows, generator, (rows, B))
                return Decoded(
                    dp.gather_rows(res.tokens, B),
                    None if res.scores is None else dp.gather_rows(res.scores, B),
                    max(mesh.gather_objects(res.steps)))
        return fn

    def step_logits(share: Share) -> Optional[Callable]:
        return None if fused else make_step_logits_fn(weights, ops, share)

    @decode_fn
    def beam_all_fn(carry, rows, generator, share) -> Decoded:
        res = beam_search(
            step_logits(share), carry, rows, beam_size=cfg.beam_size,
            len_norm_f=cfg.len_norm_f,
            step_topk_fn=make_step_topk_fn(weights, cfg.beam_size, ops, share)
            if fused else None,
            top_k_fn=ops.top_k_lse, **dec)
        return Decoded(res.tokens, res.scores, res.steps)

    @decode_fn
    def greedy_fn(carry, rows, generator, share) -> Decoded:
        res = sample_decode(
            step_logits(share), carry, rows,
            step_argmax_fn=make_step_argmax_fn(weights, ops, share)
            if fused else None, **dec)
        return Decoded(res.tokens, None, res.steps)

    @decode_fn
    def sample_fn(carry, rows, generator, share) -> Decoded:
        # the sampler's seed, one a call; on ranks folded with the rank,
        # so that the ranks draw distinct streams (the JAX wrapper's fold),
        # which multinomial draws on ranks take from a generator of their
        # own
        step_sample = None
        if fused or ranks > 1:
            seed = dp.seed(draw_seed(generator, carry[0][0].device))
            if fused:
                step_sample = make_step_sample_fn(weights, seed,
                                                  cfg.temperature, ops, share)
            else:
                generator = torch.Generator(
                    device=carry[0][0].device).manual_seed(seed)
        res = sample_decode(
            step_logits(share), carry, rows, mode="sample",
            temperature=cfg.temperature, generator=generator,
            step_sample_fn=step_sample, **dec)
        return Decoded(res.tokens, None, res.steps)

    def beam_fn(features, c_v, generator=None, eps=None) -> Decoded:
        res = beam_all_fn(features, c_v, generator, eps)
        return Decoded(res.tokens[:, 0], res.scores[:, 0], res.steps)

    return {"beam_search": beam_fn, "beam_search_all": beam_all_fn,
            "greedy": greedy_fn, "sample": sample_fn}


def generate_captions(
    batcher,
    decode_fn: Callable,
    vocab: Vocabulary,
    generator: torch.Generator,
    device: torch.device,
    image_batches: bool = False,
    stats: Optional[Dict[str, int]] = None,
) -> List[Dict]:
    """Sweep a batcher, decode every image, return coco-eval dicts.

    Batch t+1 is decoded before batch t's tokens are copied to the host
    and detokenized.  ``stats``, when given, receives the images served
    the zero cluster vector (``cv_fallbacks``), the batches and the
    decode steps run."""
    out: List[Dict] = []
    counts = {"cv_fallbacks": 0, "batches": 0, "decode_steps": 0}
    idx2word, eos, bos = vocab.idx2word, vocab.eos_id, vocab.bos_id
    iterator = (batcher.image_batches() if image_batches
                else batcher.eval_batches(with_ids=True))

    def drain(res: Decoded, batch) -> None:
        tokens = res.tokens.cpu().numpy()
        for row in range(batch.valid):
            out.append({
                "image_id": int(batch.image_ids[row]),
                "caption": tokens_to_text(tokens[row], idx2word, eos, bos),
            })

    pending = None
    for batch in iterator:
        counts["cv_fallbacks"] += getattr(batch, "cv_fallbacks", 0)
        # fc2 features as f32; images as they come (uint8 from the stores)
        features = torch.from_numpy(np.ascontiguousarray(
            batch.features if batch.features.dtype == np.uint8
            else batch.features.astype(np.float32, copy=False)))
        c_v = torch.from_numpy(np.asarray(batch.cluster_vectors, np.float32))
        res = decode_fn(features.to(device), c_v.to(device),
                        generator=generator)
        counts["batches"] += 1
        counts["decode_steps"] += res.steps
        if pending is not None:
            drain(*pending)
        pending = (res, batch)
    if pending is not None:
        drain(*pending)
    if stats is not None:
        stats.update(counts)
    return out


def decode_ranks(cfg: Config) -> DataParallel:
    """The ranks a decode of ``cfg`` spans: this process's group under
    ``cfg.multihost``, else one."""
    return DataParallel.current() if cfg.multihost else SINGLE


def caption_scores(caps: List[Dict], references: Dict[str, List[str]]
                   ) -> Dict[str, float]:
    """{"val_CIDEr-D", "val_BLEU-4", "val_ROUGE-L", "val_METEOR_es"} of
    the captions whose image has references, rounded to 4 places; all
    zeros when none has."""
    hyps = {str(c["image_id"]): c["caption"] for c in caps
            if str(c["image_id"]) in references and c["caption"]}
    if not hyps:
        return {"val_CIDEr-D": 0.0, "val_BLEU-4": 0.0,
                "val_ROUGE-L": 0.0, "val_METEOR_es": 0.0}
    refs = {iid: references[iid] for iid in hyps}
    bleu = corpus_bleu(hyps, refs)
    keys = sorted(hyps)
    meteor = corpus_meteor_es(
        [hyps[k].split() for k in keys],
        [[r.split() for r in refs[k]] for k in keys])
    return {"val_CIDEr-D": round(cider_d(hyps, refs), 4),
            "val_BLEU-4": round(bleu[3], 4),
            "val_ROUGE-L": round(rouge_l(hyps, refs), 4),
            "val_METEOR_es": round(meteor, 4)}


def make_quality_hook(cfg: Config, vocab: Vocabulary,
                      references: Dict[str, List[str]]) -> Callable:
    """Per-epoch caption-quality hook for ``Trainer.fit``
    (``Config.eval_metrics``): ``hook(model, val_batcher, generator) ->
    {"val_CIDEr-D", "val_BLEU-4", "val_ROUGE-L", "val_METEOR_es"}``.  It
    greedy-decodes the holdout through the decode kernels (z drawn from
    ``generator``, which the Trainer seeds per epoch) and scores it
    (:func:`caption_scores`).  Greedy, not beam: a trend signal each
    epoch, as in the reference.  Under ``cfg.multihost`` every rank calls
    it: the ranks decode their shares, rank 0 scores, and every rank
    returns rank 0's numbers."""

    def hook(model: nn.Module, val_batcher, generator: torch.Generator
             ) -> Dict[str, float]:
        dp = decode_ranks(cfg)
        greedy = make_decode_fns(model, cfg, vocab, dp=dp)["greedy"]
        device = next(model.parameters()).device
        caps = generate_captions(val_batcher, greedy, vocab, generator, device)
        scores = caption_scores(caps, references) if dp.rank == 0 else None
        return mesh.broadcast_object(scores)

    return hook


def run_inference(
    cfg: Config,
    model: nn.Module,
    vocab: Vocabulary,
    val_batcher,
    test_batcher=None,
    output_dir: str = ".",
    stats: Optional[Dict[str, Dict[str, int]]] = None,
) -> Dict[str, str]:
    """Full inference pass: val split with ``cfg.sample_gen``, test split
    greedy.  Returns the written paths; ``stats``, when given, receives
    per-split counts (see ``generate_captions``).  Under
    ``cfg.multihost`` every rank calls it and decodes its share of each
    batch; rank 0 alone prints and writes the files."""
    dp = decode_ranks(cfg)
    fns = make_decode_fns(model, cfg, vocab, dp=dp)
    device = next(model.parameters()).device
    say = print if dp.rank == 0 else (lambda *a, **k: None)
    written: Dict[str, str] = {}
    splits = [("val", val_batcher, fns[cfg.sample_gen], False, cfg.seed)]
    if test_batcher is not None:
        splits.append(("test", test_batcher, fns["greedy"], True,
                       cfg.seed + 999))
    for split, batcher, fn, images_only, seed in splits:
        say(f"Generating captions for {split} file")
        generator = torch.Generator(device=device).manual_seed(seed)
        split_stats: Dict[str, int] = {}
        caps = generate_captions(batcher, fn, vocab, generator, device,
                                 image_batches=images_only, stats=split_stats)
        path = os.path.join(output_dir, f"{split}_{cfg.gen_name}.json")
        if dp.rank == 0:
            with open(path, "w") as f:
                json.dump(caps, f)
        say(f"Generated {len(caps)} captions → {path}")
        if cfg.needs_cluster_vectors and split_stats["cv_fallbacks"]:
            # a zero cluster vector silently degrades c_v-conditioned
            # quality: surface the count per split
            say(f"WARNING: {split_stats['cv_fallbacks']}/{len(caps)} "
                  f"{split} images had no cluster vector (served the zero "
                  "fallback); c_v-conditioned caption quality degrades "
                  "for these. See python -m "
                  "vae_captioning_torch.data.cluster_vectors --help to build "
                  "vectors from detector output.")
        written[split] = path
        if stats is not None:
            stats[split] = split_stats
    mesh.barrier()      # the files are written when any rank returns
    return written
