"""The comparison that decides ``correct``: what the timed path produced,
against the plain reference (``reference/cvae.py``) on the same inputs
and weights, each number against its limit (``limits/<cell>.json``).

Decode (every image of the batches sampled from the window):

* ``token_gap``: the widest gap, per token, between the score the program
  returned for its best caption and the score the reference gives the
  same tokens (teacher-forced from the reference's own decode_init: z from
  the same eps, the conditioning steps, each step's LSTM, head and
  log-softmax, the floor, the length normalisation of a finished caption
  or the raw log-probability of a partial one);
* ``search_gap``: over the images where neither the program's best
  caption nor the reference's own beam search's is finished (a partial
  one keeps its raw log-probability, so the two are comparable), the mean
  amount per token by which the reference's is better (0 where the
  program's is as good), both scored by the reference;
* ``search_share``: the share of those images where that amount exceeds
  ``SEARCH_TOL`` a token, so that worse captions in a few per cent of the
  images (each with its own score, which ``token_gap`` passes) do not
  hide in the mean.  (The worst image's amount does not separate the
  float8 control from the program, whose rounding reorders near-tied
  beams: PERF.md.)

Train (the optimizer's first three steps, which the window continues):

* ``loss_gap``: the widest relative gap of a step's loss;
* ``grad_gap``: step 1's clipped gradient as the optimizer holds it (its
  first moment over 1 - b1), the worst leaf's gap of norms over the
  larger of the leaf's reference norm and the median leaf's;
* ``update_gap``: the same, of each leaf's change over the three steps;
* ``grad_row_gap``: step 1's gradient again, the gap of norms taken row
  by row (a row: one input unit's weights, or one embedding) over the
  rows at or above their leaf's median row.  A leaf's norm sums out the
  unbiased rounding of a lower precision; a row's keeps it, so this is
  the number that a float8 step fails (PERF.md);
* ``window_grad_gap``, ``window_grad_row_gap``: the same of one window
  step, taken again by the reference from the program's parameters
  before it (its clipped gradient from the first moment before and after
  it).  Their readings are wider than step 1's, so they have limits of
  their own.  That step's loss gap has no upper reading (neither the
  control nor a planted fault reads three or ten times the program's) and
  is not compared (PERF.md).

Leaves whose reference gradient is under a thousandth of the median
leaf's move under Adam by round-off alone and are left out of all.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from perfbench.reference import cvae as ref

TINY_LEAF = 1e-3
SEARCH_TOL = 3e-3       # nats a token


def leaf_gaps(prog: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
              keys: List[str]) -> Dict[str, float]:
    """Each leaf's gap of norms over the larger of its reference norm and
    the median leaf's."""
    norms = {k: float(want[k].float().norm()) for k in keys}
    median = float(torch.tensor(list(norms.values())).median())
    return {k: abs(float(prog[k].float().norm()) - norms[k]) / max(norms[k], median)
            for k in keys}


def row_gap(prog: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
            keys: List[str]) -> float:
    """The widest gap of norms over the rows of the 2-D leaves (a row: one
    input unit's weights, or one embedding), over the larger of the row's
    reference norm and the median row's of its leaf; rows under the
    median row's norm are left out, as a leaf under the median leaf's
    would weigh little."""
    worst = 0.0
    for k in keys:
        if want[k].dim() != 2:
            continue
        ref_rows = want[k].float().norm(dim=1)
        median = ref_rows.median()
        live = ref_rows >= median
        gaps = ((prog[k].float().norm(dim=1) - ref_rows).abs()
                / ref_rows.clamp(min=float(median)))[live]
        worst = max(worst, float(gaps.max()))
    return worst


def moving_leaves(grads: Dict[str, torch.Tensor]) -> List[str]:
    norms = {k: float(g.float().norm()) for k, g in grads.items()}
    median = float(torch.tensor(list(norms.values())).median())
    return sorted(k for k, n in norms.items() if n >= TINY_LEAF * median)


def step_numbers(grads, want_grads) -> Dict[str, float]:
    """One step's clipped gradient's gaps, by leaf and by row, over the
    leaves that the reference's gradient moves."""
    keys = moving_leaves(want_grads)
    return {"grad_gap": max(leaf_gaps(grads, want_grads, keys).values()),
            "grad_row_gap": row_gap(grads, want_grads, keys)}


def train_numbers(losses: List[float], first_grads, params, p0,
                  want: ref.TrainTrace, probe: Optional[tuple] = None
                  ) -> Dict[str, float]:
    """The train numbers: the program's losses, step 1's clipped gradients
    and its parameters after the steps (Flax keys, on the reference's
    device), the weights it started from, and the reference's trace of
    the same steps; with ``probe`` = (the program's clipped gradient, the
    reference's) of the window step, its numbers too, named
    ``window_...``."""
    keys = moving_leaves(want.first_grads)
    loss = [abs(a - b) / abs(b) for a, b in zip(losses, want.losses)]
    moved = {k: params[k] - p0[k] for k in keys}
    moved_ref = {k: want.params[k] - p0[k] for k in keys}
    out = {"loss_gap": max(loss),
           "grad_gap": max(leaf_gaps(first_grads, want.first_grads,
                                     keys).values()),
           "update_gap": max(leaf_gaps(moved, moved_ref, keys).values()),
           "grad_row_gap": row_gap(first_grads, want.first_grads, keys)}
    if probe is not None:
        out.update({f"window_{k}": v for k, v in step_numbers(*probe).items()})
    return out


def decode_numbers(p, cfg: dict, carry, tokens: torch.Tensor,
                   scores: torch.Tensor, beam: int, bos: int, eos: int
                   ) -> Dict[str, float]:
    """The two decode numbers of one batch's returned best captions
    ``tokens`` [B, T] and ``scores`` [B], on the reference's carry."""
    with ref.no_tf32():
        want, n = ref.rescore(p, cfg, carry, tokens, bos, eos)
        finished = (tokens == eos).any(dim=1)
        norm = torch.where(finished, (n.float() + 1.0) ** cfg["len_norm_f"],
                           torch.ones_like(want))
        per_token = (scores.float() - want).abs() * norm / n.float()
        best_tokens, best = ref.beam_search(p, cfg, carry, beam, bos, eos)
    partial = ~finished & ~(best_tokens == eos).any(dim=1)
    better = (best - want)[partial].clamp(min=0) / cfg["gen_max_len"]
    return {"token_gap": float(per_token.max()),
            "search_gap": float(better.mean()) if partial.any() else 0.0,
            "search_share": (float((better > SEARCH_TOL).float().mean())
                             if partial.any() else 0.0)}


def merge(readings: List[Dict[str, float]]) -> Dict[str, float]:
    """The widest of each number over the batches compared."""
    return {k: max(r[k] for r in readings) for k in readings[0]}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Whether every number that has a limit is within it."""
    missing = sorted(set(limits) - set(numbers))
    if missing:
        raise ValueError(f"no reading of {missing}")
    return all(numbers[k] == numbers[k] and numbers[k] <= limits[k]
               for k in limits)
