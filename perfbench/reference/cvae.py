"""Plain PyTorch reference of the AG- and GMM-CVAE captioners of Wang &
Schwing (NeurIPS 2017), as the reference implementation (yiyang92/
vae_captioning) defines them: the train step (forward, loss, gradients,
global-norm clip, Adam) and the decode (z from the prior, beam search with
length normalisation).

It imports nothing of the program.  Parameters are a dict of Flax-layout
leaves (``"decoder/lstm/cell_0/kernel"`` [E+H, 4H], Dense kernels [in,
out]), the checkpoint format both packages read.  Every product goes
through ``mm``: :func:`exact` (float32 with TF32 off) for the reference,
or :func:`quantized` for the control, which rounds each operand to a lower
precision first.

Architecture (one LSTM layer each side, the paper's settings):

* image embedding ``imf_emb`` (4096 -> E), cluster-vector embedding
  ``cv_emb`` (90 -> E);
* LSTM cell ``gates = [x, h] @ W + b``, gate order (i, f, g, o), forget
  bias 1.0; a masked sequence copies the carry past a row's length and
  emits zeros there;
* encoder: steps on the image, then the cluster vector, then the caption
  (the labels, w1 .. <EOS>); the first layer's final h feeds ``q_heads``
  (mu || log sigma of 90 clusters).  AG: the c_v-weighted sums of the
  clusters' mu and sigma.  GMM: one cluster a row, drawn from c_v
  normalised (+1e-9) by ``torch.multinomial`` on the given generator;
* z: K_z reparameterised samples mu + sigma * eps (eps of :mod:`philox`,
  keyed on the step's seed and index), projected by ``z_rnn`` on their
  concatenation;
* decoder: steps on the image, the cluster vector and z, then teacher
  forcing; the logits head ``rnn_logits``; the CE's mean over non-PAD
  labels; KL: AG against the c_v-weighted cluster means (sigma_c 0.1),
  GMM the paper code's standard-normal placeholder; loss = CE + KL / 10;
* decode: z ~ N(mu_AG, 0.1^2) projected, drawn in the projected space
  from eps [B, E] by a Cholesky factor of z_rnn's W^T W (+1e-6 max(diag));
  mu_AG the mean of the image's active cluster means (all used classes
  for an image with none); beam search over log-softmax with the
  ln(1e-12) floor, finished captions scored logp / (n + 1)^0.7, partial
  ones by raw logp when none finished.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import philox

Params = Dict[str, torch.Tensor]
Mm = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

NEG_INF = -1.0e9
LOG_PROB_FLOOR = -27.631021          # ln(1e-12)
CLUSTER_SIGMA = 0.1
AG_UNUSED_CLASSES = (0, 12, 26, 29, 30, 45, 66, 68, 69, 71, 83)


# ----------------------------------------------------------------------
# precision
# ----------------------------------------------------------------------

def exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a.float() @ b.float()


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded through ``dtype`` with one scale a tensor (its largest
    magnitude onto the type's largest), the gradient passed straight."""
    x = x.float()
    with torch.no_grad():
        top = float(torch.finfo(dtype).max)
        scale = x.detach().abs().amax().clamp(min=1e-30) / top
        q = (x.detach() / scale).to(dtype).float() * scale
    return x + (q - x).detach()


def _int8(x: torch.Tensor) -> torch.Tensor:
    """x on a symmetric int8 grid with one scale a tensor, the gradient
    passed straight."""
    x = x.float()
    with torch.no_grad():
        scale = x.detach().abs().amax().clamp(min=1e-30) / 127.0
        q = (x.detach() / scale).round().clamp(-127, 127) * scale
    return x + (q - x).detach()


def _raw(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x cast through ``dtype`` as it is (no scale), clamped to its range."""
    x = x.float()
    with torch.no_grad():
        top = float(torch.finfo(dtype).max)
        q = x.detach().clamp(-top, top).to(dtype).float()
    return x + (q - x).detach()


LOWER = {"fp8": lambda x: _round(x, torch.float8_e4m3fn),
         "fp8_raw": lambda x: _raw(x, torch.float8_e4m3fn),
         "int8": _int8}


def quantized(kind: str) -> Mm:
    """A product whose operands are rounded to a lower precision first,
    accumulated in f32; ``kind`` one of :data:`LOWER` (``fp8``: float8
    e4m3 with one scale a tensor, the control; ``fp8_raw``: cast as is;
    ``int8``: a symmetric grid)."""
    q = LOWER[kind]

    def mm(a, b):
        return q(a) @ q(b)
    return mm


@contextlib.contextmanager
def no_tf32():
    cuda, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                   torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = cuda
        torch.backends.cudnn.allow_tf32 = cudnn


# ----------------------------------------------------------------------
# parameters
# ----------------------------------------------------------------------

def flax_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """Every parameter of the configuration's model, Flax layout."""
    V, E = cfg["vocab_size"], cfg["embed_size"]
    He, Hd = cfg["encoder_hidden"], cfg["decoder_hidden"]
    L, C, F = cfg["latent_size"], cfg["num_clusters"], cfg["cnn_feature_size"]
    Kz = cfg["gen_z_samples"]
    return {
        "imf_emb/kernel": (F, E), "imf_emb/bias": (E,),
        "cv_emb/kernel": (C, E), "cv_emb/bias": (E,),
        "encoder/enc_embeddings/embedding": (V, E),
        "encoder/lstm/cell_0/kernel": (E + He, 4 * He),
        "encoder/lstm/cell_0/bias": (4 * He,),
        "encoder/q_heads/kernel": (He, 2 * C * L),
        "encoder/q_heads/bias": (2 * C * L,),
        "decoder/dec_embeddings/embedding": (V, E),
        "decoder/lstm/cell_0/kernel": (E + Hd, 4 * Hd),
        "decoder/lstm/cell_0/bias": (4 * Hd,),
        "decoder/z_rnn/kernel": (Kz * L, E), "decoder/z_rnn/bias": (E,),
        "decoder/rnn_logits/kernel": (Hd, V), "decoder/rnn_logits/bias": (V,),
    }


def cluster_means(seed: int, clusters: int, latent: int) -> np.ndarray:
    """Unit-norm cluster means fixed by the model's seed (the reference's
    numpy draw)."""
    rng = np.random.default_rng(seed)
    m = 2.0 * rng.random((clusters, latent)) - 1.0
    m /= np.sqrt((m ** 2).sum(axis=1, keepdims=True))
    return m.astype(np.float32)


def dense(p: Params, name: str, x: torch.Tensor, mm: Mm) -> torch.Tensor:
    return mm(x, p[f"{name}/kernel"]) + p[f"{name}/bias"]


def lstm_cell(p: Params, name: str, x, c, h, mm: Mm):
    H = c.shape[1]
    gates = (mm(torch.cat([x.float(), h], dim=1), p[f"{name}/kernel"])
             + p[f"{name}/bias"])
    i, f, g, o = gates.split(H, dim=1)
    c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    return c, torch.sigmoid(o) * torch.tanh(c)


def lstm_sequence(p: Params, name: str, xs, lengths, c, h, mm: Mm):
    """xs [N, T, E], lengths [N] -> (c, h at each row's length, hs [N, T,
    H] zeros past the length)."""
    out = []
    for t in range(xs.shape[1]):
        nc, nh = lstm_cell(p, name, xs[:, t], c, h, mm)
        live = (t < lengths)[:, None]
        c, h = torch.where(live, nc, c), torch.where(live, nh, h)
        out.append(torch.where(live, nh, torch.zeros_like(nh)))
    return c, h, torch.stack(out, dim=1)


# ----------------------------------------------------------------------
# training
# ----------------------------------------------------------------------

class TrainBatch(NamedTuple):
    features: torch.Tensor   # [B, F] f32
    labels: torch.Tensor     # [B*K, T] int64 (w1 .. <EOS>, PAD 0)
    dec_inputs: torch.Tensor  # [B*K, T] int64 (<BOS> w1 ..)
    lengths: torch.Tensor    # [B*K]
    c_v: torch.Tensor        # [B, C] f32


def train_loss(p: Params, cfg: dict, batch: TrainBatch, means: torch.Tensor,
               z_seed: int, step: int, clusters: Optional[torch.Generator],
               mm: Mm) -> torch.Tensor:
    B = batch.features.shape[0]
    M = batch.labels.shape[0]
    K = M // B
    L, C = cfg["latent_size"], cfg["num_clusters"]
    fv = dense(p, "imf_emb", batch.features, mm).repeat_interleave(K, 0)
    cv = batch.c_v.float().repeat_interleave(K, 0)
    cemb = dense(p, "cv_emb", batch.c_v.float(), mm).repeat_interleave(K, 0)
    lengths = batch.lengths.long()

    # encoder
    zeros = torch.zeros((M, cfg["encoder_hidden"]), device=fv.device)
    c, h = lstm_cell(p, "encoder/lstm/cell_0", fv, zeros, zeros, mm)
    c, h = lstm_cell(p, "encoder/lstm/cell_0", cemb, c, h, mm)
    emb = p["encoder/enc_embeddings/embedding"][batch.labels]
    _, h, _ = lstm_sequence(p, "encoder/lstm/cell_0", emb, lengths, c, h, mm)
    q = dense(p, "encoder/q_heads", h, mm)
    mu_k = q[:, :C * L].reshape(M, C, L)
    sigma_k = torch.exp(q[:, C * L:]).reshape(M, C, L)
    if cfg["prior"] == "AG":
        q_mean = torch.einsum("nk,nkl->nl", cv, mu_k)
        q_std = torch.einsum("nk,nkl->nl", cv, sigma_k)
    else:
        total = cv.sum(dim=1, keepdim=True)
        probs = torch.where(total > 0, cv / total.clamp(min=1e-9),
                            torch.full_like(cv, 1.0 / C)) + 1e-9
        idx = torch.multinomial(probs, 1, generator=clusters)[:, 0]
        rows = torch.arange(M, device=q.device)
        q_mean, q_std = mu_k[rows, idx], sigma_k[rows, idx]

    # z: K_z samples, projected
    Kz = cfg["gen_z_samples"]
    eps = philox.normals(z_seed, step, M, Kz, L, q.device)
    z = (q_mean[:, None, :] + q_std[:, None, :] * eps).reshape(M, Kz * L)
    z_dec = dense(p, "decoder/z_rnn", z, mm)

    # decoder
    zeros = torch.zeros((M, cfg["decoder_hidden"]), device=fv.device)
    c, h = lstm_cell(p, "decoder/lstm/cell_0", fv, zeros, zeros, mm)
    c, h = lstm_cell(p, "decoder/lstm/cell_0", cemb, c, h, mm)
    c, h = lstm_cell(p, "decoder/lstm/cell_0", z_dec, c, h, mm)
    emb = p["decoder/dec_embeddings/embedding"][batch.dec_inputs]
    _, _, hs = lstm_sequence(p, "decoder/lstm/cell_0", emb, lengths, c, h, mm)

    mask = batch.labels != 0
    hsel = hs[mask]                               # real tokens only
    logits = dense(p, "decoder/rnn_logits", hsel, mm)
    ce = torch.logsumexp(logits, dim=1) - logits.gather(
        1, batch.labels[mask][:, None])[:, 0]
    rec = ce.sum() / mask.sum().clamp(min=1)

    row_mask = mask.any(dim=1).float()
    rows = row_mask.sum().clamp(min=1.0)
    if cfg["prior"] == "AG":
        prior_mean = cv @ means
        sig_c = torch.tensor(CLUSTER_SIGMA, device=q.device)
        inner = (0.5 + torch.log(q_std + 1e-5) - torch.log(sig_c + 1e-5)
                 - ((q_mean - prior_mean).square() + q_std.square())
                 / (2.0 * sig_c.square() + 1e-7))
    else:
        inner = (1.0 + torch.log(q_std.square() + 1e-5)
                 - q_mean.square() - q_std.square())
    kld = (-0.5 * inner.sum(dim=1) * row_mask).sum() / rows
    return rec + kld / 10.0


class Adam:
    """clip_by_global_norm(clip), then Adam (b1 0.8, b2 0.999, eps 1e-8
    outside the root, bias-corrected, constant lr): the paper code's
    optimizer chain."""

    def __init__(self, params: Params, lr: float, clip: float,
                 b1: float = 0.8, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.clip, self.b1, self.b2, self.eps = lr, clip, b1, b2, eps
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, params: Params, grads: Params) -> Params:
        """Updates ``params`` in place; returns the clipped gradients."""
        clipped = clip_by_global_norm(grads, self.clip)
        self.count += 1
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        for k, g in clipped.items():
            self.mu[k].mul_(self.b1).add_((1.0 - self.b1) * g)
            self.nu[k].mul_(self.b2).add_((1.0 - self.b2) * g.square())
            params[k].add_(-self.lr * (self.mu[k] / c1)
                           / (torch.sqrt(self.nu[k] / c2) + self.eps))
        return clipped


@torch.no_grad()
def clip_by_global_norm(grads: Params, clip: float) -> Params:
    norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
    scale = 1.0 if float(norm) < clip else clip / float(norm)
    return {k: g * scale for k, g in grads.items()}


def loss_and_grads(p: Params, cfg: dict, batch: TrainBatch,
                   means: torch.Tensor, z_seed: int, step: int,
                   clusters: Optional[torch.Generator], mm: Mm
                   ) -> Tuple[float, Params]:
    """One step's loss and (unclipped) gradients at ``p``."""
    leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
    loss = train_loss(leaves, cfg, batch, means, z_seed, step, clusters, mm)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    grads = {k: torch.zeros_like(v) if g is None else g
             for (k, v), g in zip(leaves.items(), grads)}
    return float(loss.detach()), grads


def _means(cfg: dict, device) -> torch.Tensor:
    return torch.from_numpy(cluster_means(
        cfg["seed"], cfg["num_clusters"], cfg["latent_size"])).to(device)


class TrainTrace(NamedTuple):
    losses: List[float]          # each step's loss
    first_grads: Params          # step 1's clipped gradients
    params: Params               # the parameters after the last step


def train_steps(params: Params, cfg: dict, batches: List[TrainBatch],
                z_seeds: List[int], clusters: Optional[torch.Generator],
                mm: Mm = exact, first_step: int = 0) -> TrainTrace:
    """The optimizer's first len(batches) steps from ``params`` (copied)."""
    p = {k: v.detach().clone().float() for k, v in params.items()}
    means = _means(cfg, next(iter(p.values())).device)
    opt = Adam(p, cfg["learning_rate"], cfg["lstm_clip_by_norm"])
    losses, first = [], None
    with no_tf32():
        for i, (batch, seed) in enumerate(zip(batches, z_seeds)):
            loss, grads = loss_and_grads(p, cfg, batch, means, seed,
                                         first_step + i, clusters, mm)
            clipped = opt.step(p, grads)
            if first is None:
                first = clipped
            losses.append(loss)
    return TrainTrace(losses, first, p)


def train_step_at(params: Params, cfg: dict, batch: TrainBatch, z_seed: int,
                  step: int, clusters: Optional[torch.Generator],
                  mm: Mm = exact) -> Tuple[float, Params]:
    """The loss and the clipped gradient of step ``step`` (0-based) taken
    from ``params``: a window step, from the program's parameters before
    it."""
    p = {k: v.detach().float() for k, v in params.items()}
    with no_tf32():
        loss, grads = loss_and_grads(p, cfg, batch,
                                     _means(cfg, next(iter(p.values())).device),
                                     z_seed, step, clusters, mm)
    return loss, clip_by_global_norm(grads, cfg["lstm_clip_by_norm"])


# ----------------------------------------------------------------------
# decode
# ----------------------------------------------------------------------

def ag_prior_mean(c_v: torch.Tensor, means: torch.Tensor) -> torch.Tensor:
    active = (c_v > 0).float()
    used = torch.ones(means.shape[0], device=means.device)
    for cls in AG_UNUSED_CLASSES:
        if 0 <= cls - 1 < used.shape[0]:
            used[cls - 1] = 0.0
    w = torch.where(active.sum(dim=1, keepdim=True) > 0, active, used[None])
    return (w / w.sum(dim=1, keepdim=True)) @ means


def decode_init(p: Params, cfg: dict, features, c_v, eps, mm: Mm = exact):
    """The carry (c, h) [B, H] after the conditioning steps on the image,
    the cluster vector and z ~ N(mu, std^2) projected; eps [B, E]."""
    means = torch.from_numpy(cluster_means(
        cfg["seed"], cfg["num_clusters"], cfg["latent_size"])).to(features.device)
    fv = dense(p, "imf_emb", features.float(), mm)
    cemb = dense(p, "cv_emb", c_v.float(), mm)
    L, Kz = cfg["latent_size"], cfg["gen_z_samples"]
    kernel = p["decoder/z_rnn/kernel"].float()
    E = kernel.shape[1]
    if cfg["prior"] == "AG":
        z_mean = ag_prior_mean(c_v.float(), means)
    else:
        z_mean = torch.zeros((features.shape[0], L), device=features.device)
    mean = z_mean @ kernel.reshape(Kz, L, E).sum(0) + p["decoder/z_rnn/bias"]
    cov = kernel.t() @ kernel
    chol = torch.linalg.cholesky(
        cov + 1e-6 * torch.diagonal(cov).max() * torch.eye(E, device=cov.device))
    z_dec = mean + cfg["std"] * (eps.float() @ chol.t())
    zeros = torch.zeros((features.shape[0], cfg["decoder_hidden"]),
                        device=features.device)
    name = "decoder/lstm/cell_0"
    c, h = lstm_cell(p, name, fv, zeros, zeros, mm)
    c, h = lstm_cell(p, name, cemb, c, h, mm)
    return lstm_cell(p, name, z_dec, c, h, mm)


def step_logp(p: Params, tokens, c, h, mm: Mm):
    """One decode step: (c, h, log-softmax [N, V])."""
    x = p["decoder/dec_embeddings/embedding"][tokens]
    c, h = lstm_cell(p, "decoder/lstm/cell_0", x, c, h, mm)
    logits = dense(p, "decoder/rnn_logits", h, mm)
    return c, h, torch.log_softmax(logits, dim=1)


def beam_search(p: Params, cfg: dict, carry, beam: int, bos: int, eos: int,
                mm: Mm = exact):
    """Best beam of each image: (tokens [B, T], scores [B])."""
    c, h = carry
    B, K, T = c.shape[0], beam, cfg["gen_max_len"]
    dev = c.device
    c, h = c.repeat_interleave(K, 0), h.repeat_interleave(K, 0)
    alive = torch.full((B, K), NEG_INF, device=dev)
    alive[:, 0] = 0.0
    fin = torch.full((B, K), NEG_INF, device=dev)
    fin_step = torch.full((B, K), -1, dtype=torch.long, device=dev)
    fin_parent = torch.zeros((B, K), dtype=torch.long, device=dev)
    tokens = torch.full((B * K,), bos, dtype=torch.long, device=dev)
    parent_of = (torch.arange(K * K, device=dev) // K).expand(B, K * K)
    bps, toks = [], []
    with no_tf32():
        for t in range(T):
            c, h, logp = step_logp(p, tokens, c, h, mm)
            top, idx = torch.topk(logp, K, dim=1)
            top = torch.where(top < LOG_PROB_FLOOR, NEG_INF, top)
            cand = (alive[:, :, None] + top.reshape(B, K, K)).reshape(B, K * K)
            idx = idx.reshape(B, K * K)
            is_eos = idx == eos
            norm = float(t + 2) ** cfg["len_norm_f"]
            eos_score = torch.where(is_eos & (cand > NEG_INF / 2), cand / norm,
                                    torch.full_like(cand, NEG_INF))
            pool = torch.cat([fin, eos_score], dim=1)
            order = torch.sort(-pool, dim=1, stable=True).indices[:, :K]
            fin = pool.gather(1, order)
            fin_step = torch.cat([fin_step, torch.full_like(idx, t)], 1).gather(1, order)
            fin_parent = torch.cat([fin_parent, parent_of], 1).gather(1, order)
            cont = torch.where(is_eos, torch.full_like(cand, NEG_INF), cand)
            keep = torch.sort(-cont, dim=1, stable=True).indices[:, :K]
            alive = cont.gather(1, keep)
            nxt = idx.gather(1, keep)
            parent = keep // K
            rows = (torch.arange(B, device=dev)[:, None] * K + parent).reshape(-1)
            c, h = c[rows], h[rows]
            tokens = nxt.reshape(-1)
            bps.append(parent)
            toks.append(nxt)
    done = (fin > NEG_INF / 2).any(dim=1)
    best_fin = fin.argmax(dim=1)        # slots are sorted: argmax is slot 0
    best_alive = alive.argmax(dim=1)
    ar = torch.arange(B, device=dev)
    score = torch.where(done, fin[ar, best_fin], alive[ar, best_alive])
    end = torch.where(done, fin_step[ar, best_fin], torch.full_like(best_fin, T))
    ptr = torch.where(done, fin_parent[ar, best_fin], best_alive)
    out = torch.zeros((B, T), dtype=torch.long, device=dev)
    out[ar[done], end[done]] = eos
    for s in range(T - 1, -1, -1):
        live = s < end
        out[:, s] = torch.where(live, toks[s][ar, ptr], out[:, s])
        ptr = torch.where(live, bps[s][ar, ptr], ptr)
    return out, score


def rescore(p: Params, cfg: dict, carry, tokens: torch.Tensor, bos: int,
            eos: int, mm: Mm = exact):
    """The score the beam search gives ``tokens`` [B, T] (a finished
    caption, ending at <EOS>, by logp / (n + 1)^len_norm_f; a partial one
    by its raw logp), and each caption's token count n."""
    c, h = carry
    B, T = tokens.shape
    is_eos = tokens == eos
    finished = is_eos.any(dim=1)
    n = torch.where(finished, is_eos.float().argmax(dim=1) + 1,
                    torch.full((B,), T, device=tokens.device))
    prev = torch.full((B,), 0, dtype=torch.long, device=tokens.device)
    total = torch.zeros(B, device=tokens.device)
    with no_tf32():
        for t in range(T):
            inp = prev if t else torch.full_like(prev, bos)
            c, h, logp = step_logp(p, inp, c, h, mm)
            lp = logp.gather(1, tokens[:, t:t + 1])[:, 0]
            lp = torch.where(lp < LOG_PROB_FLOOR, NEG_INF, lp)
            total = total + torch.where(t < n, lp, torch.zeros_like(lp))
            prev = tokens[:, t]
    norm = torch.where(finished, (n.float() + 1.0) ** cfg["len_norm_f"],
                       torch.ones_like(total))
    return total / norm, n
