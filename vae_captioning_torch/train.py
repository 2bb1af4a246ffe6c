"""Training on fc2 features or end to end through VGG16: optimizers,
train and eval steps, train state, epoch loop (counterpart of
``vae_captioning_tpu/train.py``).

Semantics kept from the reference:

* the optimizer chain: a global-norm clip at ``lstm_clip_by_norm`` (5.0),
  then Adam with β1 = 0.8 at a constant learning rate, or SGD / Momentum
  (0.9) halved on a staircase every ``num_epochs_per_decay`` epochs.
  Both are written out to optax's formulas (:class:`Optimizer`).  Under
  ``fine_tune`` the VGG16 convs and fc layers each get the CNN chain
  (weight decay, then ``cnn_optimizer`` at ``cnn_lr``) or are frozen, as
  optax's ``multi_transform`` routes them (:class:`GroupOptimizer`);
* tanh KL annealing driven by the step, forced to 1 on fine-tune or
  restore;
* the epoch structure: ``num_ex_per_epoch`` examples per epoch, the loss
  printed every ``log_every`` steps, a validation rec-loss, the optional
  caption-quality hook (``inference.make_quality_hook``) and a checkpoint
  after each epoch (and every ``ckpt_every_steps``): ``params.npz``
  through the bridge and the train state (``checkpoint.Checkpointer``),
  from which ``Trainer.restore_from`` resumes a run exactly: the
  generators' states are saved with the weights and the optimizer.

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
the device until a log step reads them; under ``Config.debug_nans`` each
step reads them once and raises ``FloatingPointError`` at the first
non-finite loss, metric or gradient norm (:func:`check_finite`).

The step computes in ``Config.compute_dtype``: bf16 through the kernels,
or f32 with TF32 off (``models/cvae.py``: ``train_ops``), its LSTMs, z
and AG heads in plain f32 PyTorch, as the JAX package gates those
kernels on bf16, and a CE schedule flag's CE on its kernels, as the JAX
package runs its CE kernels under f32 too.
Encoder and decoder stacks of any depth run the sequence kernel layer by
layer; ``dec_lstm_drop`` < 1 drops the decoder's LSTM outputs with masks
drawn from the Trainer's device generator (the one of the caption-input
dropout).  ``Config.profile`` traces host steps 11-20 with
``torch.profiler`` (CPU and CUDA activities), writes the Chrome trace into
``cfg.log_dir`` and prints its top device operations
(``utils/trace_report.py``), as the JAX package traces steps 10-20 with
``jax.profiler`` and summarises them with ``utils/xplane.py``.

Under ``Config.multihost`` the Trainer is one rank of a data-parallel
group (``parallel/``, the counterpart of the JAX ``dp`` mesh): every
rank builds the same global batch and takes its contiguous rows
(``mesh.prepare_process_batch``), the parameters are broadcast from rank
0 at start and after a restore, each rank's loss is its share of the
global loss (its means divided by the global batch's counts,
``kernel_shard.DataParallel.counts``) and the gradients are summed over
the ranks before the clip, so a step over ranks is the step over the
global batch.  The ranks' noise differs: the z seeds and the device
generators are folded with the rank.  Every rank runs the quality hook
(the decode split over the ranks, the scores broadcast from rank 0); rank
0 alone prints, logs, profiles and writes ``params.npz`` and the train
states, which hold every rank's generator states.

More than one CE schedule flag, an unknown compute dtype or optimizer
raises ValueError (:func:`check_supported_training`).
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from vae_captioning_torch.bridge import (export_flax_params, flax_layout,
                                         flax_shapes, from_flax_array,
                                         load_flax_params, to_flax_array)
from vae_captioning_torch.checkpoint import (Checkpointer, TrainState,
                                             check_arrays, save_params)
from vae_captioning_torch.config import Config
from vae_captioning_torch.data.batcher import Batch
from vae_captioning_torch.models.cvae import (CVAEModel, TrainOps,
                                              compute_loss, train_ops)
from vae_captioning_torch.models.finetune import (FineTuneModel, cvae_of,
                                                  load_vgg_into_params)
from vae_captioning_torch.models.encoder import Clusters
from vae_captioning_torch.ops import distributions as dist
from vae_captioning_torch.ops.f32 import exact_matmuls, torch_dtype
from vae_captioning_torch.parallel import mesh
from vae_captioning_torch.parallel.kernel_shard import SINGLE, DataParallel
from vae_captioning_torch.utils import trace_report
from vae_captioning_torch.utils.logging import MetricLogger, make_profiler
from vae_captioning_torch.utils.prefetch import Prefetcher

Arrays = Tuple[torch.Tensor, ...]   # features, enc, dec, lengths, c_v
# the global batch's (tokens, rows) on data-parallel ranks, else None
Counts = Optional[Tuple[float, float]]


CE_FLAGS = ("fused_ce", "ce_hybrid", "ce_xla_bwd")
# Config.profile: the host steps after which the trace starts and stops
PROFILE_START, PROFILE_STOP = 10, 20


def check_supported_training(cfg: Config) -> None:
    """Raise ValueError when more than one CE schedule flag is set (the
    JAX package picks one of them silently), for an unknown compute dtype
    or optimizer, or for a stack of fewer than one layer."""
    ce_flags = [name for name in CE_FLAGS if getattr(cfg, name)]
    if len(ce_flags) > 1:
        raise ValueError(f"set at most one CE schedule of {CE_FLAGS}, got "
                         f"{ce_flags}")
    torch_dtype(cfg.compute_dtype)
    if min(cfg.encoder_rnn_layers, cfg.decoder_rnn_layers) < 1:
        raise ValueError(f"encoder_rnn_layers={cfg.encoder_rnn_layers}, "
                         f"decoder_rnn_layers={cfg.decoder_rnn_layers}: at "
                         "least one layer each")
    for kind in (cfg.optimizer, cfg.cnn_optimizer):
        if kind not in ("Adam", "SGD", "Momentum"):
            raise ValueError(f"unknown optimizer {kind!r}")


def init_flax_params(model: nn.Module, seed: int, skip: str = ""
                     ) -> Dict[str, np.ndarray]:
    """Random weights for ``model`` in the Flax layout, drawn by numpy
    from ``seed`` with Flax's default scales: LSTM kernels xavier-uniform,
    Dense and Conv kernels lecun-normal (std 1/√fan_in), embeddings
    normal (std 1/√V), biases zero.  Keys starting with ``skip`` (when
    given) are left out; the keys are drawn in sorted order, so a
    fine-tune model's ``cvae/*`` draws equal the feature model's."""
    rng = np.random.default_rng(seed)
    params = {}
    for key, shape in sorted(flax_shapes(model).items()):
        if skip and key.startswith(skip):
            continue
        if key.endswith("/bias"):
            params[key] = np.zeros(shape, np.float32)
        elif key.endswith("/embedding"):
            params[key] = (rng.standard_normal(shape, dtype=np.float32)
                           / np.float32(np.sqrt(shape[0])))
        elif "/lstm/" in key:
            lim = np.float32((6.0 / (shape[0] + shape[1])) ** 0.5)
            params[key] = (2 * rng.random(shape, dtype=np.float32) - 1) * lim
        else:
            fan_in = int(np.prod(shape[:-1]))
            params[key] = (rng.standard_normal(shape, dtype=np.float32)
                           / np.float32(np.sqrt(fan_in)))
    return params


# ----------------------------------------------------------------------
# optimizer
# ----------------------------------------------------------------------

def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt(Σ x²) over every element of every tensor (optax.global_norm)."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


class Optimizer:
    """One of the reference's optimizer chains, in optax's formulas:
    clip_by_global_norm(max_norm) — the gradients are kept when their
    global norm is below max_norm, else scaled by max_norm / norm — or
    add_decayed_weights(weight_decay) (g + wd·p), each when given, then
    Adam (β1 = 0.8, β2 = 0.999, eps 1e-8 outside the square root, bias
    corrected; constant lr), SGD, or Momentum (trace 0.9); the SGD and
    Momentum lr halves every ``decay_steps`` updates.  Updates the
    parameters in place."""

    def __init__(self, params: Iterable[torch.nn.Parameter], kind: str,
                 lr: float, max_norm: Optional[float], decay_steps: int = 1,
                 b1: float = 0.8, b2: float = 0.999, eps: float = 1e-8,
                 momentum: float = 0.9, weight_decay: float = 0.0):
        if kind not in ("Adam", "SGD", "Momentum"):
            raise ValueError(f"unknown optimizer {kind!r}")
        self.params: List[torch.nn.Parameter] = list(params)
        self.kind, self.base_lr, self.max_norm = kind, lr, max_norm
        self.weight_decay = weight_decay
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
        """One update from ``grads`` (one per parameter); returns their
        global norm (before clipping), on the device."""
        g_norm = global_norm(grads)
        if self.max_norm is not None:
            keep = g_norm < self.max_norm
            grads = [torch.where(keep, g, g / g_norm * self.max_norm)
                     for g in grads]
        if self.weight_decay:
            grads = [g + self.weight_decay * p
                     for g, p in zip(grads, self.params)]
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


class GroupOptimizer:
    """optax's ``multi_transform``: the parameters carry labels, and each
    label's gradients go to that label's :class:`Optimizer`, or nowhere
    for a frozen label (``set_to_zero``): each chain, the main chain's
    clip included, sees only its own gradients.  ``step`` returns the
    global norm over every gradient (the logged ``grad_norm``)."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 labels: Iterable[str],
                 chains: Mapping[str, Optional[Callable[[List], Optimizer]]]):
        self.params: List[torch.nn.Parameter] = list(params)
        labels = list(labels)
        # label -> (indices into params, its Optimizer or None if frozen)
        self.groups: Dict[str, Tuple[List[int], Optional[Optimizer]]] = {}
        for label, make in chains.items():
            idx = [i for i, lab in enumerate(labels) if lab == label]
            self.groups[label] = (idx, None if make is None or not idx
                                  else make([self.params[i] for i in idx]))

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> torch.Tensor:
        squares = []
        for idx, opt in self.groups.values():
            if idx:
                sub = [grads[i] for i in idx]
                norm = global_norm(sub) if opt is None else opt.step(sub)
                squares.append(norm.square())
        return torch.sqrt(sum(squares))


def groups_of(optimizer) -> Dict[str, Tuple[List[int], Optional[Optimizer]]]:
    """``{label: (parameter indices, Optimizer or None)}``; a plain
    :class:`Optimizer` is the one group "main"."""
    if isinstance(optimizer, GroupOptimizer):
        return optimizer.groups
    return {"main": (list(range(len(optimizer.params))), optimizer)}


def _decay_steps(cfg: Config) -> int:
    batches_per_epoch = cfg.num_ex_per_epoch / (cfg.batch_size + 0.001)
    return int(batches_per_epoch * cfg.num_epochs_per_decay)


def make_optimizer(cfg: Config, params: Iterable[torch.nn.Parameter]
                   ) -> Optimizer:
    """The reference's ``make_optimizer`` on the port's parameters."""
    return Optimizer(params, cfg.optimizer, cfg.learning_rate,
                     cfg.lstm_clip_by_norm, decay_steps=_decay_steps(cfg))


def finetune_label(flax_key: str) -> str:
    """``vgg16/fc*`` → "cnn_top", other ``vgg16/*`` → "cnn_fe", the rest
    "main" (the reference's routing by parameter path)."""
    parts = flax_key.split("/")
    if parts[0] != "vgg16":
        return "main"
    return "cnn_top" if parts[1].startswith("fc") else "cnn_fe"


def make_finetune_optimizer(cfg: Config, model: FineTuneModel
                            ) -> GroupOptimizer:
    """The reference's ``make_finetune_optimizer``: the main chain for the
    CVAE; for the VGG16 convs (``fine_tune_fe``) and fc layers
    (``fine_tune_top``) the CNN chain, weight decay then ``cnn_optimizer``
    at ``cnn_lr`` on its own schedule, or frozen."""
    names = {name: key for key, (name, _) in flax_layout(model).items()}
    params = list(model.named_parameters())
    cnn = lambda ps: Optimizer(  # noqa: E731
        ps, cfg.cnn_optimizer, cfg.cnn_lr, None, decay_steps=_decay_steps(cfg),
        weight_decay=cfg.weight_decay)
    return GroupOptimizer(
        [p for _, p in params], [finetune_label(names[n]) for n, _ in params],
        {"main": lambda ps: make_optimizer(cfg, ps),
         "cnn_fe": cnn if cfg.fine_tune_fe else None,
         "cnn_top": cnn if cfg.fine_tune_top else None})


# ----------------------------------------------------------------------
# steps
# ----------------------------------------------------------------------

def make_train_step(model: nn.Module, optimizer, cfg: Config,
                    ops: Optional[TrainOps] = None,
                    dp: DataParallel = SINGLE) -> Callable:
    """``step_fn(step, features, enc, dec, lengths, c_v, z_seed,
    dropout=None, clusters=None, cnn_dropout=None, counts=None) ->
    metrics``: forward,
    loss, backward and one optimizer update in place.  ``features`` are
    fc2 features, or images for a :class:`FineTuneModel` (whose VGG16
    dropout ``cnn_dropout`` drives); ``enc`` [B·K, T] holds the labels
    (the encoder's input), ``dec`` the decoder inputs, ``clusters`` the
    GMM head's draw.  The metrics (loss, rec_loss, kld, annealing,
    grad_norm over every gradient before clipping) stay on the device.
    On data-parallel ranks (``dp``) ``counts`` must hold the global
    batch's (tokens, rows): the loss is this rank's share of the global
    loss, and the gradients and the loss's terms are summed over the ranks
    before the update.  ``ops`` defaults to :func:`train_ops`'s for
    ``cfg``; ``dropout`` (a generator, or a callable giving the masks)
    drives the caption-input and LSTM output dropout."""
    force_one = cfg.fine_tune or cfg.restore
    params = optimizer.params
    ops = train_ops(cfg, ops)
    loss_args = _loss_args(cvae_of(model), cfg, ops)
    hidden = loss_args["logits_params"] is not None
    fine_tune = isinstance(model, FineTuneModel)

    @_in_compute_dtype(cfg)
    def step_fn(step: int, features, enc, dec, lengths, c_v, z_seed: int,
                dropout: Optional[torch.Generator] = None,
                clusters: Clusters = None,
                cnn_dropout: Optional[torch.Generator] = None,
                counts: Counts = None) -> Dict[str, torch.Tensor]:
        annealing = dist.kl_annealing(step, cfg.ann_param, force_one)
        for p in params:
            p.grad = None
        _need_counts(dp, counts)
        out = model(features, enc, dec, lengths,
                    c_v if cfg.needs_cluster_vectors else None,
                    z_seed=z_seed, z_step=step, ops=ops, time_major=True,
                    dropout=dropout, return_hidden=hidden,
                    clusters=clusters,
                    **({"cnn_dropout": cnn_dropout} if fine_tune else {}))
        losses = compute_loss(out, enc.t(), annealing=annealing,
                              counts=counts, **loss_args)
        losses["loss"].backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        mesh.all_reduce_sum_(grads)
        metrics = {k: v.detach() for k, v in losses.items()}
        mesh.all_reduce_sum_([metrics[k] for k in ("loss", "rec_loss", "kld")])
        metrics["grad_norm"] = optimizer.step(grads)
        return metrics

    return step_fn


def _in_compute_dtype(cfg: Config) -> Callable:
    """A decorator: under f32, the step runs with TF32 off."""
    f32 = torch_dtype(cfg.compute_dtype) == torch.float32

    def wrap(fn: Callable) -> Callable:
        if not f32:
            return fn

        def wrapped(*args, **kwargs):
            with exact_matmuls():
                return fn(*args, **kwargs)
        return wrapped

    return wrap


def make_eval_step(model: nn.Module, cfg: Config,
                   ops: Optional[TrainOps] = None,
                   dp: DataParallel = SINGLE) -> Callable:
    """``eval_fn(features, enc, dec, lengths, c_v, z_seed, clusters=None)
    -> rec_loss`` (the reference validates the rec-loss only), without
    gradients: under a CE schedule flag it runs that CE's forward only
    (the hybrid's written logits are freed on return).  On
    data-parallel ranks, this rank's share of the global rec-loss."""
    ops = train_ops(cfg, ops)
    loss_args = _loss_args(cvae_of(model), cfg, ops)
    hidden = loss_args["logits_params"] is not None

    @_in_compute_dtype(cfg)
    @torch.no_grad()
    def eval_fn(features, enc, dec, lengths, c_v, z_seed: int,
                clusters: Clusters = None, counts: Counts = None
                ) -> torch.Tensor:
        _need_counts(dp, counts)
        out = model(features, enc, dec, lengths,
                    c_v if cfg.needs_cluster_vectors else None,
                    z_seed=z_seed, z_step=0, ops=ops, time_major=True,
                    return_hidden=hidden, clusters=clusters)
        return compute_loss(out, enc.t(), counts=counts, **loss_args)["rec_loss"]

    return eval_fn


def _need_counts(dp: DataParallel, counts: Counts) -> None:
    if dp.world > 1 and counts is None:
        raise ValueError("a step over data-parallel ranks needs the global "
                         "batch's counts (DataParallel.counts)")


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


def check_finite(metrics: Mapping[str, torch.Tensor], step: int) -> None:
    """``Config.debug_nans``: FloatingPointError naming the first
    non-finite value of ``metrics`` (the loss, its terms, the annealing,
    the gradient norm, in that order) and the step; one host sync."""
    names = list(metrics)
    finite = torch.isfinite(torch.stack(
        [metrics[k].detach().float().reshape(()) for k in names])).tolist()
    for name, ok in zip(names, finite):
        if not ok:
            raise FloatingPointError(
                f"debug_nans: {name} is {float(metrics[name])} at step {step}")


# ----------------------------------------------------------------------
# epoch loop
# ----------------------------------------------------------------------

class Trainer:
    """Training on one card, or as one rank of a data-parallel group
    under ``cfg.multihost`` (the process group joined first:
    ``parallel.mesh.initialize_multihost``).  The model (a
    :class:`CVAEModel`, or under ``cfg.fine_tune`` a
    :class:`FineTuneModel` fed images) starts from ``params`` (a Flax
    tree, nested or flat) or from :func:`init_flax_params` at
    ``cfg.seed``, with, for a fine-tune model, VGG16's weights read from
    ``cfg.image_net_weights_path`` when that file exists; ``ops`` picks
    the kernels or the plain versions (by default :func:`train_ops`'s:
    the kernels under bf16, the f32 operations under f32)."""

    def __init__(self, cfg: Config, vocab_size: Optional[int] = None,
                 device: torch.device | str = "cuda",
                 params: Optional[Mapping] = None,
                 ops: Optional[TrainOps] = None):
        if vocab_size is not None:
            cfg.vocab_size = vocab_size
        check_supported_training(cfg)
        if cfg.multihost and not torch.distributed.is_initialized():
            raise RuntimeError(
                "multihost: join the process group first "
                "(parallel.mesh.initialize_multihost, under torchrun)")
        self.cfg = cfg
        self.device = torch.device(device)
        self.dp = DataParallel.current() if cfg.multihost else SINGLE
        if cfg.fine_tune:
            self.model = FineTuneModel.from_config(cfg)
        else:
            self.model = CVAEModel.from_config(cfg)
        if params is None:
            weights = cfg.image_net_weights_path
            npz = cfg.fine_tune and os.path.exists(weights)
            params = init_flax_params(self.model, cfg.seed,
                                      skip="vgg16/" if npz else "")
            if npz:
                params = load_vgg_into_params(params, weights)
        load_flax_params(self.model, params)
        self.model.to(self.device).train()
        mesh.broadcast_(list(self.model.parameters()))
        if cfg.fine_tune:
            self.optimizer = make_finetune_optimizer(cfg, self.model)
        else:
            self.optimizer = make_optimizer(cfg, self.model.parameters())
        self.train_step = make_train_step(self.model, self.optimizer, cfg, ops,
                                          self.dp)
        self.eval_step = make_eval_step(self.model, cfg, ops, self.dp)
        # host generator of the per-step z seeds (the same on every rank,
        # each folding the rank in); the eval seed is fixed
        self.seeds = torch.Generator().manual_seed(cfg.seed + 1)
        self.eval_seed = self.dp.seed((cfg.seed + 1) & 0xFFFFFFFF)
        # the caption-input and the LSTM output dropout's masks
        self.dropout = None
        if cfg.dec_keep_rate < 1.0 or cfg.dec_lstm_drop < 1.0:
            self.dropout = self._device_generator(cfg.seed + 2)
        # the GMM head's cluster draws: a device generator (tests may set
        # fixed indices [B·K] instead)
        self.clusters: Clusters = None
        if cfg.prior == "GMM" and not cfg.no_encoder:
            self.clusters = self._device_generator(cfg.seed + 3)
        # VGG16's dropout on fc1 / fc2 while fine-tuning
        self.cnn_dropout = None
        if cfg.fine_tune and self.model.vgg16.dropout_keep < 1.0:
            self.cnn_dropout = self._device_generator(cfg.seed + 4)
        self.host_step = 0
        # Config.profile: the running profiler, and the trace it wrote
        self._profiler: Optional[torch.profiler.profile] = None
        self._profile_first = 0
        self.trace_path: Optional[str] = None

    def _device_generator(self, seed: int) -> torch.Generator:
        """A generator on the device, seeded per rank."""
        return torch.Generator(device=self.device).manual_seed(
            self.dp.seed(seed))

    @property
    def is_main(self) -> bool:
        """Whether this process prints, logs and writes (rank 0)."""
        return self.dp.rank == 0

    def next_seed(self) -> int:
        return int(torch.randint(0, 2 ** 32, (), generator=self.seeds))

    def device_batch(self, batch: Batch) -> Arrays:
        """[B, K, T] host batch → flat tensors on the device (uint8 images
        stay uint8 through the copy); on data-parallel ranks, this rank's
        rows of the batch padded to a multiple of the ranks."""
        B, K, T = batch.dec_inputs.shape
        dev = self.device
        arrays = (batch.features, batch.labels.reshape(B * K, T),
                  batch.dec_inputs.reshape(B * K, T),
                  batch.lengths.reshape(B * K), batch.cluster_vectors)
        if self.dp.world > 1:
            arrays = mesh.prepare_process_batch(arrays, K, self.dp.world,
                                                self.dp.world, self.dp.rank)

        def put(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

        images = batch.features.dtype == np.uint8
        return (put(arrays[0], None if images else torch.float32),
                put(arrays[1], torch.int64), put(arrays[2], torch.int64),
                put(arrays[3], torch.int32), put(arrays[4], torch.float32))

    def run_step(self, batch: Batch) -> Dict[str, torch.Tensor]:
        return self.run_step_arrays(self.device_batch(batch),
                                    self.dp.counts(batch.labels))

    def run_step_arrays(self, arrays: Arrays, counts: Counts = None
                        ) -> Dict[str, torch.Tensor]:
        """One step on ``arrays`` (:meth:`device_batch`'s); on
        data-parallel ranks ``counts`` are the global batch's
        (``DataParallel.counts``)."""
        metrics = self.train_step(self.host_step, *arrays,
                                  z_seed=self.dp.seed(self.next_seed()),
                                  dropout=self.dropout,
                                  clusters=self.clusters,
                                  cnn_dropout=self.cnn_dropout,
                                  counts=counts)
        if self.cfg.debug_nans:
            check_finite(metrics, self.host_step)
        self.host_step += 1
        return metrics

    def validate(self, batcher) -> float:
        # every validation draws the same clusters, as it uses one z seed
        clusters = self.clusters
        if isinstance(clusters, torch.Generator):
            clusters = torch.Generator(device=self.device).manual_seed(
                self.eval_seed)
        vals = [self.eval_step(*self.device_batch(b), z_seed=self.eval_seed,
                               clusters=clusters,
                               counts=self.dp.counts(b.labels))
                for b in batcher.eval_batches(num_captions=self.cfg.num_captions,
                                              with_ids=False)]
        if not vals:
            return float("nan")
        vals = torch.stack(vals)
        mesh.all_reduce_sum_([vals])     # the ranks' shares of each batch's loss
        return float(vals.mean())

    # ------------------------------------------------------------------
    # train state
    # ------------------------------------------------------------------

    def generators(self) -> Dict[str, torch.Generator]:
        """The generators whose states a resume must restore, by name."""
        gens = {"seeds": self.seeds, "dropout": self.dropout,
                "clusters": self.clusters, "cnn_dropout": self.cnn_dropout}
        return {k: g for k, g in gens.items()
                if isinstance(g, torch.Generator)}

    def _keys(self) -> List[Tuple[str, tuple]]:
        """(Flax key, permutation) of each parameter, in parameter order."""
        by_name = {name: (key, perm) for key, (name, perm) in
                   flax_layout(self.model).items()}
        return [by_name[n] for n, _ in self.model.named_parameters()]

    def _moments(self):
        """(array key, tensor, permutation) of every moment the optimizer
        holds: ``opt/<group>/<mu|nu>/<flax key>``."""
        keys = self._keys()
        for label, (idx, opt) in groups_of(self.optimizer).items():
            for moment in ("mu", "nu"):
                tensors = None if opt is None else getattr(opt, moment)
                for i, t in zip(idx, tensors or ()):
                    key, perm = keys[i]
                    yield f"opt/{label}/{moment}/{key}", t, perm

    def train_state(self) -> TrainState:
        """Everything a resume needs, as numpy: the parameters
        (``params/<flax key>``), each optimizer group's Adam / momentum
        moments (``opt/<group>/{mu,nu}/<flax key>``, Flax layout) and
        kind and update count, the step, and the generators' states
        (``rng/<name>``, read from the card for the device generators; on
        data-parallel ranks every rank's, [ranks, state], gathered: every
        rank calls this, rank 0 writes it)."""
        arrays = {f"params/{k}": v
                  for k, v in export_flax_params(self.model).items()}
        arrays.update({k: to_flax_array(t, perm)
                       for k, t, perm in self._moments()})
        rngs = {f"rng/{k}": g.get_state().numpy()
                for k, g in self.generators().items()}
        if self.dp.world > 1:
            ranks = mesh.gather_objects(rngs)
            rngs = {k: np.stack([r[k] for r in ranks]) for k in rngs}
        arrays.update(rngs)
        groups = {label: {"kind": opt.kind, "count": opt.count}
                  for label, (_, opt) in groups_of(self.optimizer).items()
                  if opt is not None}
        return TrainState(self.host_step, arrays,
                          {"step": self.host_step, "optimizer": groups})

    def load_train_state(self, state: TrainState) -> None:
        """Restore :meth:`train_state`'s output into this Trainer: the
        parameters, moments, counts and step, and the generators' states
        (onto the card for the device generators; on data-parallel ranks
        this rank's, and the parameters then broadcast from rank 0).  Any
        key, shape, optimizer group or kind that does not match this
        Trainer raises ValueError naming it, before anything is changed."""
        arrays = state.arrays
        gens = self.generators()
        moments = list(self._moments())
        shapes = flax_shapes(self.model)
        ranks = (self.dp.world,) if self.dp.world > 1 else ()
        check_arrays(arrays, {
            **{f"params/{k}": v for k, v in shapes.items()},
            **{k: shapes[k.split("/", 3)[3]] for k, _, _ in moments},
            **{f"rng/{k}": ranks + tuple(g.get_state().shape)
               for k, g in gens.items()}}, "train state")
        groups = {label: opt for label, (_, opt) in
                  groups_of(self.optimizer).items() if opt is not None}
        saved = state.meta.get("optimizer", {})
        kinds = {label: opt.kind for label, opt in groups.items()}
        if {k: v.get("kind") for k, v in saved.items()} != kinds:
            raise ValueError(f"train state: optimizer groups {saved} do not "
                             f"match this run's {kinds}")
        with torch.no_grad():
            for p, (key, perm) in zip(self.model.parameters(), self._keys()):
                p.copy_(from_flax_array(arrays[f"params/{key}"], perm))
            for key, t, perm in moments:
                t.copy_(from_flax_array(arrays[key], perm))
        for label, opt in groups.items():
            opt.count = int(saved[label]["count"])
        for name, gen in gens.items():
            rng = arrays[f"rng/{name}"]
            gen.set_state(torch.from_numpy(np.ascontiguousarray(
                rng[self.dp.rank] if ranks else rng)))
        mesh.broadcast_(list(self.model.parameters()))
        self.host_step = int(state.step)

    def restore_from(self, checkpointer: Checkpointer,
                     step: Optional[int] = None) -> None:
        """Resume from the checkpointer's newest train state (or ``step``)."""
        self.load_train_state(checkpointer.restore(step))

    def save(self, directory: str, name: str) -> str:
        """``params.npz`` in ``<directory>/<name>/`` (what inference
        reads), written by rank 0."""
        path = os.path.join(directory, name, "params.npz")
        if self.is_main:
            path = save_params(export_flax_params(self.model), directory, name)
        return path

    def save_checkpoint(self, checkpointer: Checkpointer) -> None:
        """``params.npz`` and the train state of this step (every rank
        calls it; rank 0 writes, and the ranks go on together)."""
        base, name = os.path.split(checkpointer.directory)
        self.save(base, name)
        state = self.train_state()
        if self.is_main:
            checkpointer.save(state)
        mesh.barrier()

    def fit(self, train_batcher, val_batcher=None,
            checkpoint_dir: Optional[str] = None,
            checkpoint_name: str = "last_run",
            log_every: int = 500,
            quality_hook: Optional[Callable] = None) -> Dict[str, float]:
        """The epoch loop; after each epoch the validation rec-loss, the
        ``quality_hook(model, val_batcher, generator) -> {metric: float}``
        (``inference.make_quality_hook``; the generator is seeded per
        epoch) merged into the printed line, the metric log and the
        result, and, with ``checkpoint_dir``, a checkpoint in
        ``<checkpoint_dir>/<checkpoint_name>/`` (``save_checkpoint``;
        every ``cfg.ckpt_every_steps`` steps as well).  Under
        ``cfg.profile`` rank 0 traces host steps 11-20 (:meth:`_profile`)."""
        cfg = self.cfg
        ckpt = None
        if checkpoint_dir is not None:
            ckpt = Checkpointer(checkpoint_dir, checkpoint_name,
                                cfg.max_checkpoints_to_keep)
        metrics: Dict[str, float] = {}
        m: Dict[str, torch.Tensor] = {}
        logger = None
        if cfg.logging and self.is_main:
            logger = MetricLogger(cfg.log_dir, echo=False,
                                  run_name=cfg.checkpoint)
        profiling = cfg.profile and self.is_main
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
                        if profiling:
                            self._profile(step)
                        if step % log_every == 0:
                            metrics = {k: float(v) for k, v in m.items()}
                            rate = seen / max(time.time() - t0, 1e-9)
                            if self.is_main:
                                print(f"Epoch: {epoch} Iteration: {step} "
                                      f"VLB: {metrics['loss']:.4f} "
                                      f"Rec Loss: {metrics['rec_loss']:.4f} "
                                      f"KLD: {metrics['kld']:.4f} "
                                      f"Annealing: "
                                      f"{metrics['annealing']:.3f} "
                                      f"({rate:.1f} ex/s)")
                            if logger is not None:
                                logger.log(step, metrics, epoch=epoch,
                                           examples_per_sec=round(rate, 1))
                        if (ckpt is not None and cfg.ckpt_every_steps > 0
                                and step % cfg.ckpt_every_steps == 0):
                            self.save_checkpoint(ckpt)
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
                if self.is_main:
                    print(f"Validation reconstruction loss: {val_rec}")
                metrics["val_rec_loss"] = val_rec
                epoch_extra["val_rec_loss"] = val_rec
                if quality_hook is not None:
                    # every rank decodes its share of each batch from one
                    # generator state (the seed unfolded), and the numbers
                    # are rank 0's
                    qm = quality_hook(self.model, val_batcher,
                                      torch.Generator(device=self.device)
                                      .manual_seed(cfg.seed + 1 + epoch))
                    if self.is_main:
                        print("Validation metrics: " + " ".join(
                            f"{k}: {v}" for k, v in qm.items()))
                    metrics.update(qm)
                    epoch_extra.update(qm)
            if logger is not None:
                logger.log(self.host_step, {k: float(v) for k, v in m.items()},
                           epoch=epoch, **epoch_extra)
            if ckpt is not None:
                self.save_checkpoint(ckpt)
        if logger is not None:
            logger.close()
        if self._profiler is not None:      # the run ended inside the window
            self._profile(PROFILE_STOP)
        return dict(metrics) if metrics else {"loss": float("nan")}

    def _profile(self, step: int) -> None:
        """``Config.profile``, after host step ``step``: start
        ``torch.profiler`` (CPU activities, and CUDA on a card) at
        PROFILE_START; at PROFILE_STOP stop it, write the Chrome trace to
        ``<log_dir>/trace_steps<first>-<last>.json`` (``trace_path``) and
        print its top-10 device operations (``utils/trace_report.py``,
        which raises on a missing or empty trace)."""
        if step == PROFILE_START and self._profiler is None:
            self._profiler = make_profiler(self.device.type == "cuda")
            self._profiler.start()
            self._profile_first = step + 1
        elif step == PROFILE_STOP and self._profiler is not None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._profiler.stop()
            os.makedirs(self.cfg.log_dir, exist_ok=True)
            path = os.path.join(self.cfg.log_dir, f"trace_steps"
                                f"{self._profile_first}-{self.host_step}.json")
            self._profiler.export_chrome_trace(path)
            self._profiler = None
            self.trace_path = path
            print(f"profiler trace written to {path}")
            print(trace_report.device_report(trace_report.aggregate(path), 10))
