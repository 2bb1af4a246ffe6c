"""Training on fc2 features: optimizer, train and eval steps, epoch loop
(counterpart of ``vae_captioning_tpu/train.py``).

Semantics kept from the reference:

* the optimizer chain: a global-norm clip at ``lstm_clip_by_norm`` (5.0),
  then Adam with β1 = 0.8 at a constant learning rate, or SGD / Momentum
  (0.9) halved on a staircase every ``num_epochs_per_decay`` epochs.
  Both are written out to optax's formulas (:class:`Optimizer`);
* tanh KL annealing driven by the step, forced to 1 on fine-tune or
  restore;
* the epoch structure: ``num_ex_per_epoch`` examples per epoch, the loss
  printed every ``log_every`` steps, a validation rec-loss and a
  checkpoint (``params.npz``, through the bridge) after each epoch.

The step runs the kernels of the train path (``fused_lstm_seq`` for the
encoder and decoder LSTMs, ``fused_z`` for the z sampling + projection,
``fused_ag_heads`` for the AG posterior heads and, with a CE schedule
flag, the fused logits head and CE: ``fused_linear_ce`` under
``Config.fused_ce``, ``fused_linear_ce_hybrid`` under ``ce_hybrid``,
``fused_linear_ce_xla_bwd`` under ``ce_xla_bwd``) on one card.  Without
a flag the logits head and CE are plain PyTorch, as the JAX package's
default step leaves them to XLA; the optimizer always is.  A flag always
means its CE function here, its plain twin on the CPU (the JAX package
ignores the flags off its kernel path).  Each step's z noise is keyed on
a seed drawn from a host ``torch.Generator`` that the Trainer owns
(seeded from ``cfg.seed``) and on the step number; the GMM head's
cluster draws come from a device generator it owns too: no global RNG
state is read.  The step counter lives on the host and metrics stay on
the device until a log step reads them.

Configurations this port does not train raise NotImplementedError in
:func:`check_supported_training`, naming their ROADMAP item; more than
one CE schedule flag raises ValueError.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np
import torch

from vae_captioning_torch.bridge import (export_flax_params, flax_shapes,
                                         load_flax_params)
from vae_captioning_torch.checkpoint import save_params
from vae_captioning_torch.config import Config
from vae_captioning_torch.data.batcher import Batch
from vae_captioning_torch.models.cvae import (KERNEL_TRAIN_OPS, CVAEModel,
                                              TrainOps, compute_loss)
from vae_captioning_torch.models.encoder import Clusters
from vae_captioning_torch.ops import distributions as dist
from vae_captioning_torch.utils.logging import MetricLogger
from vae_captioning_torch.utils.prefetch import Prefetcher

Arrays = Tuple[torch.Tensor, ...]   # features, enc, dec, lengths, c_v


CE_FLAGS = ("fused_ce", "ce_hybrid", "ce_xla_bwd")


def check_supported_training(cfg: Config) -> None:
    """Raise ValueError when more than one CE schedule flag is set (the
    JAX package picks one of them silently), and NotImplementedError for
    what the port does not train yet (each would need a kernel or a path
    not ported yet), naming the ROADMAP item that will."""
    ce_flags = [name for name in CE_FLAGS if getattr(cfg, name)]
    if len(ce_flags) > 1:
        raise ValueError(f"set at most one CE schedule of {CE_FLAGS}, got "
                         f"{ce_flags}")
    gates = [
        (cfg.restore, "restore (resume a run from a checkpoint): ROADMAP A.6.3"),
        (cfg.dec_lstm_drop < 1.0,
         f"dec_lstm_drop={cfg.dec_lstm_drop} (LSTM output dropout, the JAX "
         "package's nn.scan path, not the sequence kernel): ROADMAP D.6"),
        (cfg.encoder_rnn_layers != 1 or cfg.decoder_rnn_layers != 1,
         f"encoder_rnn_layers={cfg.encoder_rnn_layers}, decoder_rnn_layers="
         f"{cfg.decoder_rnn_layers}: the train slice runs one LSTM layer "
         "(ROADMAP D.1)"),
        (str(cfg.compute_dtype) != "bfloat16",
         f"compute_dtype={cfg.compute_dtype!r}: the train slice runs "
         "bfloat16 (ROADMAP D.2)"),
        (cfg.fine_tune, "fine_tune (VGG16 in the model): ROADMAP A.8"),
        (cfg.eval_metrics,
         "eval_metrics (the per-epoch BLEU/CIDEr hook): ROADMAP A.6.4"),
        (cfg.profile, "profile (a profiler trace of steps 10-20): ROADMAP A.10"),
        (cfg.multihost, "multihost (data parallelism): ROADMAP A.9"),
    ]
    for failed, what in gates:
        if failed:
            raise NotImplementedError(f"not ported yet: {what}")
    if cfg.optimizer not in ("Adam", "SGD", "Momentum"):
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")


def init_flax_params(model: CVAEModel, seed: int) -> Dict[str, np.ndarray]:
    """Random weights for ``model`` in the Flax layout, drawn by numpy
    from ``seed`` with Flax's default scales: LSTM kernels xavier-uniform,
    Dense kernels lecun-normal (std 1/√fan_in), embeddings normal (std
    1/√V), biases zero."""
    rng = np.random.default_rng(seed)
    params = {}
    for key, shape in sorted(flax_shapes(model).items()):
        if key.endswith("/bias"):
            params[key] = np.zeros(shape, np.float32)
        elif key.endswith("/embedding"):
            params[key] = (rng.standard_normal(shape, dtype=np.float32)
                           / np.float32(np.sqrt(shape[0])))
        elif "/lstm/" in key:
            lim = np.float32((6.0 / (shape[0] + shape[1])) ** 0.5)
            params[key] = (2 * rng.random(shape, dtype=np.float32) - 1) * lim
        else:
            params[key] = (rng.standard_normal(shape, dtype=np.float32)
                           / np.float32(np.sqrt(shape[0])))
    return params


# ----------------------------------------------------------------------
# optimizer
# ----------------------------------------------------------------------

def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt(Σ x²) over every element of every tensor (optax.global_norm)."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


class Optimizer:
    """The reference's non-CNN optimizer chain, in optax's formulas:
    clip_by_global_norm(max_norm) — the gradients are kept when their
    global norm is below max_norm, else scaled by max_norm / norm — then
    Adam (β1 = 0.8, β2 = 0.999, eps 1e-8 outside the square root, bias
    corrected; constant lr), SGD, or Momentum (trace 0.9); the SGD and
    Momentum lr halves every ``decay_steps`` updates.  Updates the
    parameters in place."""

    def __init__(self, params: Iterable[torch.nn.Parameter], kind: str,
                 lr: float, max_norm: float, decay_steps: int = 1,
                 b1: float = 0.8, b2: float = 0.999, eps: float = 1e-8,
                 momentum: float = 0.9):
        if kind not in ("Adam", "SGD", "Momentum"):
            raise ValueError(f"unknown optimizer {kind!r}")
        self.params: List[torch.nn.Parameter] = list(params)
        self.kind, self.base_lr, self.max_norm = kind, lr, max_norm
        self.decay_steps = max(int(decay_steps), 1)
        self.b1, self.b2, self.eps, self.momentum = b1, b2, eps, momentum
        self.count = 0      # updates done
        zeros = lambda: [torch.zeros_like(p) for p in self.params]  # noqa: E731
        self.mu = zeros() if kind in ("Adam", "Momentum") else None
        self.nu = zeros() if kind == "Adam" else None

    def lr(self) -> float:
        """The learning rate of the next update."""
        if self.kind == "Adam":
            return self.base_lr
        return self.base_lr * 0.5 ** (self.count // self.decay_steps)

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """One update from ``grads`` (one per parameter); returns the
        global norm before clipping, on the device."""
        g_norm = global_norm(grads)
        keep = g_norm < self.max_norm
        grads = [torch.where(keep, g, g / g_norm * self.max_norm)
                 for g in grads]
        lr = self.lr()
        self.count += 1
        if self.kind == "Adam":
            # bias corrections in f32, as optax computes them; host
            # scalars, so no copy to the device
            one = np.float32(1.0)
            c1 = float(one - np.float32(self.b1) ** self.count)
            c2 = float(one - np.float32(self.b2) ** self.count)
            for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
                mu.copy_((1.0 - self.b1) * g + self.b1 * mu)
                nu.copy_((1.0 - self.b2) * g.square() + self.b2 * nu)
                p.add_(-lr * ((mu / c1) / (torch.sqrt(nu / c2) + self.eps)))
        elif self.kind == "Momentum":
            for p, g, tr in zip(self.params, grads, self.mu):
                tr.copy_(g + self.momentum * tr)
                p.add_(-lr * tr)
        else:
            for p, g in zip(self.params, grads):
                p.add_(-lr * g)
        return g_norm


def make_optimizer(cfg: Config, params: Iterable[torch.nn.Parameter]
                   ) -> Optimizer:
    """The reference's ``make_optimizer`` on the port's parameters."""
    batches_per_epoch = cfg.num_ex_per_epoch / (cfg.batch_size + 0.001)
    return Optimizer(params, cfg.optimizer, cfg.learning_rate,
                     cfg.lstm_clip_by_norm,
                     decay_steps=int(batches_per_epoch * cfg.num_epochs_per_decay))


# ----------------------------------------------------------------------
# steps
# ----------------------------------------------------------------------

def make_train_step(model: CVAEModel, optimizer: Optimizer, cfg: Config,
                    ops: TrainOps = KERNEL_TRAIN_OPS) -> Callable:
    """``step_fn(step, features, enc, dec, lengths, c_v, z_seed,
    dropout=None, clusters=None) -> metrics``: forward, loss, backward
    and one optimizer update in place.  ``enc`` [B·K, T] holds the labels
    (the encoder's input), ``dec`` the decoder inputs, ``clusters`` the
    GMM head's draw.  The metrics (loss, rec_loss, kld, annealing,
    grad_norm before clipping) stay on the device."""
    force_one = cfg.fine_tune or cfg.restore
    params = optimizer.params
    loss_args = _loss_args(model, cfg, ops)
    hidden = loss_args["logits_params"] is not None

    def step_fn(step: int, features, enc, dec, lengths, c_v, z_seed: int,
                dropout: Optional[torch.Generator] = None,
                clusters: Clusters = None) -> Dict[str, torch.Tensor]:
        annealing = dist.kl_annealing(step, cfg.ann_param, force_one)
        for p in params:
            p.grad = None
        out = model(features, enc, dec, lengths,
                    c_v if cfg.needs_cluster_vectors else None,
                    z_seed=z_seed, z_step=step, ops=ops, time_major=True,
                    dropout=dropout, return_hidden=hidden,
                    clusters=clusters)
        losses = compute_loss(out, enc.t(), annealing=annealing, **loss_args)
        losses["loss"].backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["grad_norm"] = optimizer.step(grads)
        return metrics

    return step_fn


def make_eval_step(model: CVAEModel, cfg: Config,
                   ops: TrainOps = KERNEL_TRAIN_OPS) -> Callable:
    """``eval_fn(features, enc, dec, lengths, c_v, z_seed, clusters=None)
    -> rec_loss`` (the reference validates the rec-loss only), without
    gradients: under a CE schedule flag it runs that CE's forward only
    (the hybrid's written logits are freed on return)."""
    loss_args = _loss_args(model, cfg, ops)
    hidden = loss_args["logits_params"] is not None

    @torch.no_grad()
    def eval_fn(features, enc, dec, lengths, c_v, z_seed: int,
                clusters: Clusters = None) -> torch.Tensor:
        out = model(features, enc, dec, lengths,
                    c_v if cfg.needs_cluster_vectors else None,
                    z_seed=z_seed, z_step=0, ops=ops, time_major=True,
                    return_hidden=hidden, clusters=clusters)
        return compute_loss(out, enc.t(), **loss_args)["rec_loss"]

    return eval_fn


def _loss_args(model: CVAEModel, cfg: Config, ops: TrainOps) -> dict:
    """The train and eval steps' arguments of ``compute_loss``.  Under a
    CE schedule flag: its CE function of ``ops``, and the ``rnn_logits``
    weight [V, H] and bias, read in place (the forward then returns the
    decoder's hidden rows in place of the logits)."""
    head = model.decoder.rnn_logits
    ce_fn = {"fused_ce": ops.linear_ce, "ce_hybrid": ops.linear_ce_hybrid,
             "ce_xla_bwd": ops.linear_ce_xla_bwd}
    flags = [name for name in CE_FLAGS if getattr(cfg, name)]
    return dict(no_encoder=cfg.no_encoder, prior=cfg.prior,
                cluster_means=model.cluster_means, ag_kl_sum=cfg.ag_kl_sum,
                gmm_true_kl=cfg.gmm_true_kl, time_major=True,
                logits_params=(head.weight, head.bias) if flags else None,
                ce_fn=ce_fn[flags[0]] if flags else None)


# ----------------------------------------------------------------------
# epoch loop
# ----------------------------------------------------------------------

class Trainer:
    """Single-card training.  The model starts from ``params`` (a Flax
    tree, nested or flat) or from :func:`init_flax_params` at
    ``cfg.seed``; ``ops`` picks the kernels or the plain versions."""

    def __init__(self, cfg: Config, vocab_size: Optional[int] = None,
                 device: torch.device | str = "cuda",
                 params: Optional[Mapping] = None,
                 ops: TrainOps = KERNEL_TRAIN_OPS):
        if vocab_size is not None:
            cfg.vocab_size = vocab_size
        check_supported_training(cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = CVAEModel.from_config(cfg)
        load_flax_params(self.model, init_flax_params(self.model, cfg.seed)
                         if params is None else params)
        self.model.to(self.device).train()
        self.optimizer = make_optimizer(cfg, self.model.parameters())
        self.train_step = make_train_step(self.model, self.optimizer, cfg, ops)
        self.eval_step = make_eval_step(self.model, cfg, ops)
        # host generator of the per-step z seeds; the eval seed is fixed
        self.seeds = torch.Generator().manual_seed(cfg.seed + 1)
        self.eval_seed = (cfg.seed + 1) & 0xFFFFFFFF
        self.dropout = None
        if cfg.dec_keep_rate < 1.0:
            self.dropout = torch.Generator(device=self.device).manual_seed(
                cfg.seed + 2)
        # the GMM head's cluster draws: a device generator (tests may set
        # fixed indices [B·K] instead)
        self.clusters: Clusters = None
        if cfg.prior == "GMM" and not cfg.no_encoder:
            self.clusters = torch.Generator(device=self.device).manual_seed(
                cfg.seed + 3)
        self.host_step = 0

    def next_seed(self) -> int:
        return int(torch.randint(0, 2 ** 32, (), generator=self.seeds))

    def device_batch(self, batch: Batch) -> Arrays:
        """[B, K, T] host batch → flat tensors on the device."""
        B, K, T = batch.dec_inputs.shape
        dev = self.device

        def put(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

        return (put(batch.features, torch.float32),
                put(batch.labels.reshape(B * K, T), torch.int64),
                put(batch.dec_inputs.reshape(B * K, T), torch.int64),
                put(batch.lengths.reshape(B * K), torch.int32),
                put(batch.cluster_vectors, torch.float32))

    def run_step(self, batch: Batch) -> Dict[str, torch.Tensor]:
        return self.run_step_arrays(self.device_batch(batch))

    def run_step_arrays(self, arrays: Arrays) -> Dict[str, torch.Tensor]:
        metrics = self.train_step(self.host_step, *arrays,
                                  z_seed=self.next_seed(), dropout=self.dropout,
                                  clusters=self.clusters)
        self.host_step += 1
        return metrics

    def validate(self, batcher) -> float:
        # every validation draws the same clusters, as it uses one z seed
        clusters = self.clusters
        if isinstance(clusters, torch.Generator):
            clusters = torch.Generator(device=self.device).manual_seed(
                self.eval_seed)
        vals = [self.eval_step(*self.device_batch(b), z_seed=self.eval_seed,
                               clusters=clusters)
                for b in batcher.eval_batches(num_captions=self.cfg.num_captions,
                                              with_ids=False)]
        return float(torch.stack(vals).mean()) if vals else float("nan")

    def save(self, directory: str, name: str) -> str:
        return save_params(export_flax_params(self.model), directory, name)

    def fit(self, train_batcher, val_batcher=None,
            checkpoint_dir: Optional[str] = None,
            checkpoint_name: str = "last_run",
            log_every: int = 500) -> Dict[str, float]:
        """The epoch loop; after each epoch the validation rec-loss and,
        with ``checkpoint_dir``, ``params.npz`` in
        ``<checkpoint_dir>/<checkpoint_name>/``."""
        cfg = self.cfg
        metrics: Dict[str, float] = {}
        m: Dict[str, torch.Tensor] = {}
        logger = None
        if cfg.logging:
            logger = MetricLogger(cfg.log_dir, echo=False,
                                  run_name=cfg.checkpoint)
        for epoch in range(cfg.num_epochs):
            seen = 0
            t0 = time.time()
            while seen <= cfg.num_ex_per_epoch:
                epoch_batches = 0
                stream = train_batcher.train_batches(cfg.num_captions)
                if cfg.prefetch_batches > 0:
                    stream = Prefetcher(stream, cfg.prefetch_batches)
                try:
                    for batch in stream:
                        epoch_batches += 1
                        m = self.run_step(batch)
                        seen += batch.batch_size
                        step = self.host_step
                        if step % log_every == 0:
                            metrics = {k: float(v) for k, v in m.items()}
                            rate = seen / max(time.time() - t0, 1e-9)
                            print(f"Epoch: {epoch} Iteration: {step} "
                                  f"VLB: {metrics['loss']:.4f} "
                                  f"Rec Loss: {metrics['rec_loss']:.4f} "
                                  f"KLD: {metrics['kld']:.4f} "
                                  f"Annealing: {metrics['annealing']:.3f} "
                                  f"({rate:.1f} ex/s)")
                            if logger is not None:
                                logger.log(step, metrics, epoch=epoch,
                                           examples_per_sec=round(rate, 1))
                        if (checkpoint_dir is not None
                                and cfg.ckpt_every_steps > 0
                                and step % cfg.ckpt_every_steps == 0):
                            self.save(checkpoint_dir, checkpoint_name)
                        if seen > cfg.num_ex_per_epoch:
                            break
                finally:
                    if hasattr(stream, "close"):
                        stream.close()
                if epoch_batches == 0:
                    raise ValueError(
                        "train_batches yielded nothing: dataset smaller "
                        f"than batch_size ({cfg.batch_size})? Lower --bs.")
            epoch_extra: Dict[str, float] = {}
            if val_batcher is not None:
                val_rec = self.validate(val_batcher)
                print(f"Validation reconstruction loss: {val_rec}")
                metrics["val_rec_loss"] = val_rec
                epoch_extra["val_rec_loss"] = val_rec
            if logger is not None:
                logger.log(self.host_step, {k: float(v) for k, v in m.items()},
                           epoch=epoch, **epoch_extra)
            if checkpoint_dir is not None:
                self.save(checkpoint_dir, checkpoint_name)
        if logger is not None:
            logger.close()
        return dict(metrics) if metrics else {"loss": float("nan")}
