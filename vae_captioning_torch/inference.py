"""Batch caption generation + COCO-eval JSON export (counterpart of
``vae_captioning_tpu/inference.py``).

Sweeps the val split with beam search (or greedy) and the test split
with greedy decoding, and writes ``val_<gen_name>.json`` /
``test_<gen_name>.json`` as ``[{"image_id": int, "caption": str}]``.

Every decode step runs the fused LSTM step kernel, then one of:

* the fused logits + top-k (k = beam, or 1 for greedy), the default;
* its int8 variant under ``Config.decode_int8`` (approximate: h and the
  logits head quantised to int8, the head once per build);
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

The weights are cast once, when ``make_decode_fns`` builds its closures.
A ``FineTuneModel`` decodes from raw images: its VGG16 makes the fc2
features in ``decode_init``.  The TPU switches ``fused_lstm_step`` and
``fused_force`` are not read.  Configurations the decode slice does not
cover raise ``NotImplementedError`` naming their ROADMAP item.

``make_quality_hook`` is ``Trainer.fit``'s per-epoch caption-quality hook
(``Config.eval_metrics``): a greedy decode of the holdout through the
decode kernels, scored by ``eval/``.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Callable, Dict, List, NamedTuple, Optional

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
from vae_captioning_torch.ops.fused_logits_topk import (
    fused_logits_sample, fused_logits_sample_plain, fused_logits_top_k,
    fused_logits_top_k_int8, fused_logits_top_k_int8_plain,
    fused_logits_top_k_plain, quantize_logits_weights)
from vae_captioning_torch.ops.fused_lstm_step import (fused_lstm_step,
                                                      fused_lstm_step_plain)
from vae_captioning_torch.ops.topk_lse import (top_k_logsumexp,
                                               top_k_logsumexp_plain)


def check_supported(cfg: Config) -> None:
    """Raise NotImplementedError for what the decode slice does not
    cover, naming the ROADMAP item that will."""
    gates = [
        (cfg.decoder_rnn_layers != 1,
         f"decoder_rnn_layers={cfg.decoder_rnn_layers}: the decode slice "
         "runs one LSTM layer (ROADMAP A.11)"),
        (str(cfg.compute_dtype) != "bfloat16",
         f"compute_dtype={cfg.compute_dtype!r}: the decode slice runs "
         "bfloat16 (ROADMAP A.11)"),
    ]
    for failed, what in gates:
        if failed:
            raise NotImplementedError(f"not ported yet: {what}")


class DecodeOps(NamedTuple):
    """The per-step operations.  The decode path uses the kernel
    wrappers; comparisons on the card swap in the plain versions."""

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


class DecodeWeights(NamedTuple):
    """Decode-step weights, cast once: bf16 matrices, f32 biases."""

    embed: torch.Tensor     # [V, E] bf16
    lstm_w: torch.Tensor    # [E+H, 4H] bf16
    lstm_b: torch.Tensor    # [4H] f32
    # [H, V] bf16, stored column-major: head_w.t() is W^T [V, H]
    # contiguous, the layout the logits kernels read with TMA
    head_w: torch.Tensor
    head_b: torch.Tensor    # [V] f32
    # decode_int8 only: the f32 head quantised per column
    head_wq: Optional[torch.Tensor] = None   # [H, V] int8
    head_ws: Optional[torch.Tensor] = None   # [V] f32

    @classmethod
    def of(cls, model: CVAEModel, int8: bool = False) -> "DecodeWeights":
        with torch.no_grad():
            emb, kern, kbias = decoder_step_params(model)
            w, b = logits_head_params(model)
            bf16 = torch.bfloat16
            wq, ws = quantize_logits_weights(w) if int8 else (None, None)
            return cls(emb.to(bf16).contiguous(), kern.to(bf16).contiguous(),
                       kbias.float().contiguous(),
                       w.to(bf16).t().contiguous().t(),
                       b.float().contiguous(), wq, ws)


def make_lstm_fn(weights: DecodeWeights,
                 ops: DecodeOps = KERNEL_OPS) -> Callable:
    """(carry, x [N, E]) → (carry, h' [N, H]): one step of the cell on
    the weights cast once.  Every LSTM step of a decode goes through it:
    the three conditioning steps of ``decode_init`` and each token step."""

    def fn(carry, x):
        ((c, h),) = carry
        c, h = ops.lstm_step(x.to(torch.bfloat16), c, h, weights.lstm_w,
                             weights.lstm_b)
        return ((c, h),), h

    return fn


def make_step_topk_fn(weights: DecodeWeights, k: int,
                      ops: DecodeOps = KERNEL_OPS) -> Callable:
    """(carry, tokens [N]) → (carry, top-k values, indices, logsumexp):
    one LSTM step, then the logits head folded into top-k, the [N, V]
    logits never stored.  With the quantised head in ``weights``, the
    int8 variant, on the f32 h the LSTM step returns."""
    lstm = make_lstm_fn(weights, ops)

    def fn(carry, tokens):
        carry, h = lstm(carry, weights.embed[tokens])
        if weights.head_wq is not None:
            vals, idx, lse = ops.logits_top_k_int8(
                h, weights.head_wq, weights.head_ws, weights.head_b, k)
        else:
            vals, idx, lse = ops.logits_top_k(
                h.to(torch.bfloat16), weights.head_w, weights.head_b, k)
        return carry, vals, idx, lse

    return fn


def make_step_sample_fn(weights: DecodeWeights, seed: int, temperature: float,
                        ops: DecodeOps = KERNEL_OPS) -> Callable:
    """(carry, tokens [N], step) → (carry, next [N]): one LSTM step, then
    one Gumbel-max draw per lane from softmax(logits / temperature),
    keyed on (seed, step), the logits never stored."""
    lstm = make_lstm_fn(weights, ops)

    def fn(carry, tokens, step):
        carry, h = lstm(carry, weights.embed[tokens])
        return carry, ops.logits_sample(h.to(torch.bfloat16), weights.head_w,
                                        weights.head_b, seed, step,
                                        temperature)

    return fn


def make_step_logits_fn(weights: DecodeWeights,
                        ops: DecodeOps = KERNEL_OPS) -> Callable:
    """(carry, tokens [N]) → (carry, logits [N, V] f32): one LSTM step,
    then the logits head as a plain product written to memory, rounded
    as the Flax Dense with ``dtype=bfloat16`` rounds it (bf16 logits
    from an f32 sum, plus the bias in bf16): the decode step of the JAX
    package's ``fused_decode=False`` path."""
    lstm = make_lstm_fn(weights, ops)
    w = weights.head_w.float()
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
                        ops: DecodeOps = KERNEL_OPS) -> Callable:
    """Greedy step: the argmax is the fused top-1."""
    topk = make_step_topk_fn(weights, 1, ops)

    def fn(carry, tokens):
        carry, _, idx, _ = topk(carry, tokens)
        return carry, idx[:, 0]

    return fn


class Decoded(NamedTuple):
    tokens: torch.Tensor             # [B, T] (beam_search_all: [B, beam, T])
    scores: Optional[torch.Tensor]   # [B] / [B, beam]; None for greedy
    steps: int                       # decode steps run


def make_decode_fns(model: nn.Module, cfg: Config, vocab: Vocabulary,
                    ops: DecodeOps = KERNEL_OPS) -> Dict[str, Callable]:
    """Whole-batch decoders ``fn(features [B, F], c_v [B, 90],
    generator=None, eps=None) -> Decoded``, for "beam_search" (best
    beam), "beam_search_all" (all beams, best-first), "greedy" and
    "sample" (temperature sampling); for a ``FineTuneModel`` the first
    argument is images [B, S, S, 3].  Tensors lie on the model's device;
    the z noise comes from ``eps`` [B, E] or is drawn from ``generator``,
    which also keys the sampler."""
    check_supported(cfg)
    weights = DecodeWeights.of(cvae_of(model), int8=cfg.decode_int8)
    bos, eos = vocab.bos_id, vocab.eos_id
    needs_cv = cfg.needs_cluster_vectors
    lstm = make_lstm_fn(weights, ops)
    fused = cfg.fused_decode
    step_logits = None if fused else make_step_logits_fn(weights, ops)
    beam_step = (make_step_topk_fn(weights, cfg.beam_size, ops) if fused
                 else None)
    greedy_step = make_step_argmax_fn(weights, ops) if fused else None
    dec = dict(bos_id=bos, eos_id=eos, max_len=cfg.gen_max_len)

    def init(features, c_v, generator, eps):
        return model.decode_init(features, c_v if needs_cv else None,
                                 eps=eps, generator=generator, lstm_step=lstm)

    @torch.inference_mode()
    def beam_all_fn(features, c_v, generator=None, eps=None) -> Decoded:
        res = beam_search(
            step_logits, init(features, c_v, generator, eps),
            features.shape[0], beam_size=cfg.beam_size,
            len_norm_f=cfg.len_norm_f, step_topk_fn=beam_step,
            top_k_fn=ops.top_k_lse, **dec)
        return Decoded(res.tokens, res.scores, res.steps)

    def beam_fn(features, c_v, generator=None, eps=None) -> Decoded:
        res = beam_all_fn(features, c_v, generator, eps)
        return Decoded(res.tokens[:, 0], res.scores[:, 0], res.steps)

    @torch.inference_mode()
    def greedy_fn(features, c_v, generator=None, eps=None) -> Decoded:
        res = sample_decode(
            step_logits, init(features, c_v, generator, eps),
            features.shape[0], step_argmax_fn=greedy_step, **dec)
        return Decoded(res.tokens, None, res.steps)

    @torch.inference_mode()
    def sample_fn(features, c_v, generator=None, eps=None) -> Decoded:
        carry = init(features, c_v, generator, eps)
        step_sample = (make_step_sample_fn(
            weights, draw_seed(generator, features.device), cfg.temperature,
            ops) if fused else None)
        res = sample_decode(
            step_logits, carry, features.shape[0], mode="sample",
            temperature=cfg.temperature, generator=generator,
            step_sample_fn=step_sample, **dec)
        return Decoded(res.tokens, None, res.steps)

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


def make_quality_hook(cfg: Config, vocab: Vocabulary,
                      references: Dict[str, List[str]]) -> Callable:
    """Per-epoch caption-quality hook for ``Trainer.fit``
    (``Config.eval_metrics``): ``hook(model, val_batcher, generator) ->
    {"val_CIDEr-D", "val_BLEU-4", "val_ROUGE-L", "val_METEOR_es"}``.  It
    greedy-decodes the holdout through the decode kernels (z drawn from
    ``generator``, which the Trainer seeds per epoch) and scores the
    captions whose image has references, rounded to 4 places; all zeros
    when none has.  Greedy, not beam: a trend signal each epoch, as in
    the reference."""

    def hook(model: nn.Module, val_batcher, generator: torch.Generator
             ) -> Dict[str, float]:
        greedy = make_decode_fns(model, cfg, vocab)["greedy"]
        device = next(model.parameters()).device
        caps = generate_captions(val_batcher, greedy, vocab, generator, device)
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
    per-split counts (see ``generate_captions``)."""
    fns = make_decode_fns(model, cfg, vocab)
    device = next(model.parameters()).device
    written: Dict[str, str] = {}
    splits = [("val", val_batcher, fns[cfg.sample_gen], False, cfg.seed)]
    if test_batcher is not None:
        splits.append(("test", test_batcher, fns["greedy"], True,
                       cfg.seed + 999))
    for split, batcher, fn, images_only, seed in splits:
        print(f"Generating captions for {split} file")
        generator = torch.Generator(device=device).manual_seed(seed)
        split_stats: Dict[str, int] = {}
        caps = generate_captions(batcher, fn, vocab, generator, device,
                                 image_batches=images_only, stats=split_stats)
        path = os.path.join(output_dir, f"{split}_{cfg.gen_name}.json")
        with open(path, "w") as f:
            json.dump(caps, f)
        print(f"Generated {len(caps)} captions → {path}")
        if cfg.needs_cluster_vectors and split_stats["cv_fallbacks"]:
            # a zero cluster vector silently degrades c_v-conditioned
            # quality: surface the count per split
            print(f"WARNING: {split_stats['cv_fallbacks']}/{len(caps)} "
                  f"{split} images had no cluster vector (served the zero "
                  "fallback); c_v-conditioned caption quality degrades "
                  "for these. See python -m "
                  "vae_captioning_torch.data.cluster_vectors --help to build "
                  "vectors from detector output.")
        written[split] = path
        if stats is not None:
            stats[split] = split_stats
    return written
