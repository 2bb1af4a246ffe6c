"""Batched decoding: greedy, temperature sampling and beam search
(counterpart of ``vae_captioning_tpu/ops/decoding.py``).

The algorithms are the reference's: greedy is argmax until every lane
has emitted EOS; sampling draws from ``softmax(logits / temperature)``
with the same stopping rule (EOS stops a lane, PAD follows, BOS may be
drawn mid-caption and is dropped from the text); beam search expands each
beam by its own top-K tokens, floors log-probs of p < 1e-12, scores
completions with ``len(sentence)**len_norm_f`` normalisation, falls back
to partial captions when nothing completed, and carries backpointers
instead of sequences, rebuilding the sequences once at the end.

Ties go to the lowest index everywhere, as ``jax.lax.top_k`` and the
stable ``jnp.argsort`` give them: an empty finished slot against a
non-viable candidate (both at NEG_INF) is a routine tie, and its order
decides whether a row of ``beam_search_all`` comes out all-PAD.

The early exit is a host check per step (one device sync), where the
reference runs a ``while_loop`` on the device; the output is the same as
running all ``max_len`` steps.

The model enters as in the reference, through ``step_fn(carry,
tokens[N]) -> (carry, logits[N, V])`` or through the fused step forms
that never write the logits: ``step_topk_fn(carry, tokens[N]) -> (carry,
vals[N, k], idx[N, k], lse[N])`` (top-k raw logits with their
logsumexp), ``step_argmax_fn(carry, tokens[N]) -> (carry, next[N])`` and
``step_sample_fn(carry, tokens[N], step) -> (carry, next[N])``.  A fused
form, where given, takes precedence.  The step_fn form's beam search
takes :func:`~vae_captioning_torch.ops.topk_lse.top_k_logsumexp` (the
kernel on CUDA tensors), its sampling ``torch.multinomial`` with the
caller's generator.  carry is a nested tuple of tensors with leading dim
N.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from vae_captioning_torch.ops.fused_logits_topk import stable_top_k
from vae_captioning_torch.ops.topk_lse import top_k_logsumexp

NEG_INF = -1.0e9
# ln(1e-12), the reference's zero-probability skip threshold
_LOG_PROB_FLOOR = -27.631021


def _map(fn: Callable[[torch.Tensor], torch.Tensor], tree: Any) -> Any:
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, t) for t in tree)
    return fn(tree)


def _first_leaf(tree: Any) -> torch.Tensor:
    while isinstance(tree, (tuple, list)):
        tree = tree[0]
    return tree


# ----------------------------------------------------------------------
# greedy / temperature sampling
# ----------------------------------------------------------------------

class GreedyResult(NamedTuple):
    tokens: torch.Tensor   # [B, max_len] int64 (EOS included, then PAD)
    steps: int             # decode steps run before the early exit


def sample_decode(
    step_fn: Optional[Callable],
    init_carry: Any,
    batch_size: int,
    *,
    bos_id: int,
    eos_id: int,
    max_len: int,
    mode: str = "greedy",
    temperature: float = 1.0,
    generator: Optional[torch.Generator] = None,
    step_argmax_fn: Optional[Callable] = None,
    step_sample_fn: Optional[Callable] = None,
    early_exit: bool = True,
) -> GreedyResult:
    """Batched greedy (``mode="greedy"``) or sampled (``mode="sample"``)
    decode → token ids [B, max_len] (EOS included; positions after EOS
    are PAD = 0).  Without a fused form, ``step_fn``'s logits go through
    ``torch.argmax`` or are sampled from ``softmax(logits / temperature)``
    with ``generator``."""
    if mode not in ("greedy", "sample"):
        raise ValueError(f"mode must be 'greedy' or 'sample', got {mode!r}")
    fused = step_argmax_fn if mode == "greedy" else step_sample_fn
    if fused is None and step_fn is None:
        raise ValueError(f"mode={mode!r} needs step_fn or its fused form")
    dev = _first_leaf(init_carry).device
    carry = init_carry
    tokens = torch.full((batch_size,), bos_id, dtype=torch.long, device=dev)
    alive = torch.ones((batch_size,), dtype=torch.bool, device=dev)
    out = torch.zeros((batch_size, max_len), dtype=torch.long, device=dev)
    t = 0
    while t < max_len and (not early_exit or bool(alive.any())):
        if mode == "greedy" and step_argmax_fn is not None:
            carry, nxt = step_argmax_fn(carry, tokens)
        elif mode == "sample" and step_sample_fn is not None:
            carry, nxt = step_sample_fn(carry, tokens, t)
        else:
            carry, logits = step_fn(carry, tokens)
            if mode == "sample":
                probs = torch.softmax(logits.float() / temperature, dim=-1)
                nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
            else:
                nxt = torch.argmax(logits, dim=-1)
        nxt = nxt.long()
        out[:, t] = torch.where(alive, nxt, 0)
        alive = alive & (nxt != eos_id)
        tokens = nxt
        t += 1
    return GreedyResult(out, t)


# ----------------------------------------------------------------------
# beam search
# ----------------------------------------------------------------------

class BeamResult(NamedTuple):
    """All beams, best-first per image."""

    tokens: torch.Tensor   # [B, beam, max_len] (BOS excluded, EOS included)
    scores: torch.Tensor   # [B, beam] (length-normalized; raw logp if partial)
    steps: int             # expansion steps run before the early exit


def _gather_beams(tree: Any, beam_idx: torch.Tensor, B: int, beam: int) -> Any:
    """Reindex leading [B*beam, ...] leaves by per-image beam indices."""
    rows = (torch.arange(B, device=beam_idx.device)[:, None] * beam
            + beam_idx).reshape(-1)
    return _map(lambda leaf: leaf.index_select(0, rows), tree)


def beam_search(
    step_fn: Optional[Callable],
    init_carry: Any,
    batch_size: int,
    *,
    beam_size: int,
    bos_id: int,
    eos_id: int,
    max_len: int,
    len_norm_f: float = 0.7,
    early_exit: bool = True,
    step_topk_fn: Optional[Callable] = None,
    top_k_fn: Callable = top_k_logsumexp,
) -> BeamResult:
    """Batched beam search.  ``init_carry`` has leading dim B and is
    broadcast to B*beam lanes; at most ``max_len`` expansion steps.  Each
    step runs ``step_topk_fn`` where given, else ``step_fn`` and
    ``top_k_fn(logits in f32, beam_size)`` over its logits (the
    ``top_k_logsumexp`` wrapper; the JAX function's ``use_pallas``
    choice)."""
    if step_topk_fn is None:
        if step_fn is None:
            raise ValueError("beam_search needs step_fn or step_topk_fn")

        def step_topk_fn(carry, tokens):
            carry, logits = step_fn(carry, tokens)
            return (carry, *top_k_fn(logits.float().contiguous(), beam_size))
    B, K = batch_size, beam_size
    dev = _first_leaf(init_carry).device
    carry = _map(lambda leaf: leaf.repeat_interleave(K, dim=0), init_carry)
    # the first expansion must come from ONE beam: the others start at -inf
    alive_logp = torch.tensor([0.0] + [NEG_INF] * (K - 1),
                              device=dev).repeat(B, 1)
    fin_scores = torch.full((B, K), NEG_INF, device=dev)
    fin_step = torch.full((B, K), -1, dtype=torch.long, device=dev)  # -1 empty
    fin_parent = torch.zeros((B, K), dtype=torch.long, device=dev)
    tokens = torch.full((B, K), bos_id, dtype=torch.long, device=dev)
    # candidate c in [0, K²) extends alive beam c // K (beam-major layout)
    cand_parent = (torch.arange(K * K, device=dev) // K).expand(B, K * K)
    bp_hist = torch.zeros((max_len, B, K), dtype=torch.long, device=dev)
    tok_hist = torch.zeros((max_len, B, K), dtype=torch.long, device=dev)
    # log-probs only decrease and the most favourable future normaliser is
    # max_len's, so no alive beam can beat max(alive_logp)/final_norm
    final_norm = float(max_len + 1) ** len_norm_f if len_norm_f > 0 else 1.0

    t = 0
    while t < max_len:
        if early_exit:
            best_possible = alive_logp.max(dim=1).values / final_norm
            worst_kept = fin_scores.min(dim=1).values
            if not bool((best_possible > worst_kept).any()):
                break
        # each beam expands only its OWN top-K tokens, then the K² merge
        carry, vals, toks, lse = step_topk_fn(carry, tokens.reshape(B * K))
        logp_top = vals - lse[:, None]                           # [B·K, K]
        logp_top = torch.where(logp_top < _LOG_PROB_FLOOR,
                               torch.full_like(logp_top, NEG_INF), logp_top)
        top_logp = (alive_logp[:, :, None]
                    + logp_top.reshape(B, K, K)).reshape(B, K * K)
        token_idx = toks.reshape(B, K * K).long()
        is_eos = token_idx == eos_id

        # finished pool: normalised score, merged top-K.  Floored
        # candidates must not complete: NEG_INF / norm would lift them
        viable = is_eos & (top_logp > NEG_INF / 2)
        norm = float(t + 2) ** len_norm_f if len_norm_f > 0 else 1.0
        eos_scores = torch.where(viable, top_logp / norm,
                                 torch.full_like(top_logp, NEG_INF))
        fin_scores, keep = stable_top_k(
            torch.cat([fin_scores, eos_scores], dim=1), K)
        fin_step = torch.gather(
            torch.cat([fin_step, torch.full((B, K * K), t, dtype=torch.long,
                                            device=dev)], dim=1), 1, keep)
        fin_parent = torch.gather(torch.cat([fin_parent, cand_parent], dim=1),
                                  1, keep)

        # alive pool: best K non-EOS continuations
        alive_cand = torch.where(is_eos, torch.full_like(top_logp, NEG_INF),
                                 top_logp)
        alive_logp, alive_keep = stable_top_k(alive_cand, K)
        tokens = torch.gather(token_idx, 1, alive_keep)
        parent = alive_keep // K
        carry = _gather_beams(carry, parent, B, K)
        bp_hist[t] = parent
        tok_hist[t] = tokens
        t += 1

    # fall back to partials when nothing completed; they keep raw log-probs
    has_finished = (fin_scores > NEG_INF / 2).any(dim=1, keepdim=True)
    out_scores = torch.where(has_finished, fin_scores, alive_logp)
    # each output row is (step_e, parent_e): a finished entry emits EOS at
    # step_e and backtraces from (step_e - 1, parent_e); a partial is the
    # same with step_e = t and no EOS; an empty slot (step_e = -1) is PAD
    slot = torch.arange(K, device=dev).expand(B, K)
    step_e = torch.where(has_finished, fin_step, torch.full_like(fin_step, t))
    ptr = torch.where(has_finished, fin_parent, slot)
    emit_eos = has_finished.expand(B, K)
    out = torch.zeros((B, K, max_len), dtype=torch.long, device=dev)
    for s in range(max_len - 1, -1, -1):
        active = s < step_e
        tok = torch.gather(tok_hist[s], 1, ptr)
        col = torch.where(active, tok, 0)
        out[:, :, s] = torch.where((step_e == s) & emit_eos, eos_id, col)
        ptr = torch.where(active, torch.gather(bp_hist[s], 1, ptr), ptr)

    # best-first per image (stable: ties keep slot order)
    order = torch.sort(-out_scores, dim=1, stable=True).indices
    out_scores = torch.gather(out_scores, 1, order)
    out = torch.gather(out, 1, order[:, :, None].expand(B, K, max_len))
    return BeamResult(out, out_scores, t)


def tokens_to_text(token_row, idx2word, eos_id: int,
                   bos_id: Optional[int] = None) -> str:
    """One token row → caption string: stops at EOS, drops PAD and (when
    given) BOS; <UNK> is kept, as the reference keeps it."""
    words = []
    for tok in token_row:
        tok = int(tok)
        if tok == eos_id:
            break
        if tok == 0 or (bos_id is not None and tok == bos_id):
            continue
        words.append(idx2word[tok])
    return " ".join(words)
