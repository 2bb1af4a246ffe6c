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
the device until a log step reads them.

Configurations this port does not train raise NotImplementedError in
:func:`check_supported_training`, naming their ROADMAP item; more than
one CE schedule flag raises ValueError.
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
from vae_captioning_torch.models.cvae import (KERNEL_TRAIN_OPS, CVAEModel,
                                              TrainOps, compute_loss)
from vae_captioning_torch.models.finetune import (FineTuneModel, cvae_of,
                                                  load_vgg_into_params)
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
        (cfg.dec_lstm_drop < 1.0,
         f"dec_lstm_drop={cfg.dec_lstm_drop} (LSTM output dropout, the JAX "
         "package's nn.scan path, not the sequence kernel): ROADMAP A.11"),
        (cfg.encoder_rnn_layers != 1 or cfg.decoder_rnn_layers != 1,
         f"encoder_rnn_layers={cfg.encoder_rnn_layers}, decoder_rnn_layers="
         f"{cfg.decoder_rnn_layers}: the train slice runs one LSTM layer "
         "(ROADMAP A.11)"),
        (str(cfg.compute_dtype) != "bfloat16",
         f"compute_dtype={cfg.compute_dtype!r}: the train slice runs "
         "bfloat16 (ROADMAP A.11)"),
        (cfg.profile, "profile (a profiler trace of steps 10-20): ROADMAP A.10"),
        (cfg.multihost, "multihost (data parallelism): ROADMAP A.9"),
    ]
    for failed, what in gates:
        if failed:
            raise NotImplementedError(f"not ported yet: {what}")
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
                    ops: TrainOps = KERNEL_TRAIN_OPS) -> Callable:
    """``step_fn(step, features, enc, dec, lengths, c_v, z_seed,
    dropout=None, clusters=None, cnn_dropout=None) -> metrics``: forward,
    loss, backward and one optimizer update in place.  ``features`` are
    fc2 features, or images for a :class:`FineTuneModel` (whose VGG16
    dropout ``cnn_dropout`` drives); ``enc`` [B·K, T] holds the labels
    (the encoder's input), ``dec`` the decoder inputs, ``clusters`` the
    GMM head's draw.  The metrics (loss, rec_loss, kld, annealing,
    grad_norm over every gradient before clipping) stay on the device."""
    force_one = cfg.fine_tune or cfg.restore
    params = optimizer.params
    loss_args = _loss_args(cvae_of(model), cfg, ops)
    hidden = loss_args["logits_params"] is not None
    fine_tune = isinstance(model, FineTuneModel)

    def step_fn(step: int, features, enc, dec, lengths, c_v, z_seed: int,
                dropout: Optional[torch.Generator] = None,
                clusters: Clusters = None,
                cnn_dropout: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        annealing = dist.kl_annealing(step, cfg.ann_param, force_one)
        for p in params:
            p.grad = None
        out = model(features, enc, dec, lengths,
                    c_v if cfg.needs_cluster_vectors else None,
                    z_seed=z_seed, z_step=step, ops=ops, time_major=True,
                    dropout=dropout, return_hidden=hidden,
                    clusters=clusters,
                    **({"cnn_dropout": cnn_dropout} if fine_tune else {}))
        losses = compute_loss(out, enc.t(), annealing=annealing, **loss_args)
        losses["loss"].backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["grad_norm"] = optimizer.step(grads)
        return metrics

    return step_fn


def make_eval_step(model: nn.Module, cfg: Config,
                   ops: TrainOps = KERNEL_TRAIN_OPS) -> Callable:
    """``eval_fn(features, enc, dec, lengths, c_v, z_seed, clusters=None)
    -> rec_loss`` (the reference validates the rec-loss only), without
    gradients: under a CE schedule flag it runs that CE's forward only
    (the hybrid's written logits are freed on return)."""
    loss_args = _loss_args(cvae_of(model), cfg, ops)
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
    """Single-card training.  The model (a :class:`CVAEModel`, or under
    ``cfg.fine_tune`` a :class:`FineTuneModel` fed images) starts from
    ``params`` (a Flax tree, nested or flat) or from
    :func:`init_flax_params` at ``cfg.seed``, with, for a fine-tune model,
    VGG16's weights read from ``cfg.image_net_weights_path`` when that
    file exists; ``ops`` picks the kernels or the plain versions."""

    def __init__(self, cfg: Config, vocab_size: Optional[int] = None,
                 device: torch.device | str = "cuda",
                 params: Optional[Mapping] = None,
                 ops: TrainOps = KERNEL_TRAIN_OPS):
        if vocab_size is not None:
            cfg.vocab_size = vocab_size
        check_supported_training(cfg)
        self.cfg = cfg
        self.device = torch.device(device)
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
        if cfg.fine_tune:
            self.optimizer = make_finetune_optimizer(cfg, self.model)
        else:
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
        # VGG16's dropout on fc1 / fc2 while fine-tuning
        self.cnn_dropout = None
        if cfg.fine_tune and self.model.vgg16.dropout_keep < 1.0:
            self.cnn_dropout = torch.Generator(device=self.device).manual_seed(
                cfg.seed + 4)
        self.host_step = 0

    def next_seed(self) -> int:
        return int(torch.randint(0, 2 ** 32, (), generator=self.seeds))

    def device_batch(self, batch: Batch) -> Arrays:
        """[B, K, T] host batch → flat tensors on the device (uint8 images
        stay uint8 through the copy)."""
        B, K, T = batch.dec_inputs.shape
        dev = self.device

        def put(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

        images = batch.features.dtype == np.uint8
        return (put(batch.features, None if images else torch.float32),
                put(batch.labels.reshape(B * K, T), torch.int64),
                put(batch.dec_inputs.reshape(B * K, T), torch.int64),
                put(batch.lengths.reshape(B * K), torch.int32),
                put(batch.cluster_vectors, torch.float32))

    def run_step(self, batch: Batch) -> Dict[str, torch.Tensor]:
        return self.run_step_arrays(self.device_batch(batch))

    def run_step_arrays(self, arrays: Arrays) -> Dict[str, torch.Tensor]:
        metrics = self.train_step(self.host_step, *arrays,
                                  z_seed=self.next_seed(), dropout=self.dropout,
                                  clusters=self.clusters,
                                  cnn_dropout=self.cnn_dropout)
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
        (``rng/<name>``, read from the card for the device generators)."""
        arrays = {f"params/{k}": v
                  for k, v in export_flax_params(self.model).items()}
        arrays.update({k: to_flax_array(t, perm)
                       for k, t, perm in self._moments()})
        arrays.update({f"rng/{k}": g.get_state().numpy()
                       for k, g in self.generators().items()})
        groups = {label: {"kind": opt.kind, "count": opt.count}
                  for label, (_, opt) in groups_of(self.optimizer).items()
                  if opt is not None}
        return TrainState(self.host_step, arrays,
                          {"step": self.host_step, "optimizer": groups})

    def load_train_state(self, state: TrainState) -> None:
        """Restore :meth:`train_state`'s output into this Trainer: the
        parameters, moments, counts and step, and the generators' states
        (onto the card for the device generators).  Any key, shape,
        optimizer group or kind that does not match this Trainer raises
        ValueError naming it, before anything is changed."""
        arrays = state.arrays
        gens = self.generators()
        moments = list(self._moments())
        shapes = flax_shapes(self.model)
        check_arrays(arrays, {
            **{f"params/{k}": v for k, v in shapes.items()},
            **{k: shapes[k.split("/", 3)[3]] for k, _, _ in moments},
            **{f"rng/{k}": tuple(g.get_state().shape)
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
            gen.set_state(torch.from_numpy(np.ascontiguousarray(
                arrays[f"rng/{name}"])))
        self.host_step = int(state.step)

    def restore_from(self, checkpointer: Checkpointer,
                     step: Optional[int] = None) -> None:
        """Resume from the checkpointer's newest train state (or ``step``)."""
        self.load_train_state(checkpointer.restore(step))

    def save(self, directory: str, name: str) -> str:
        """``params.npz`` in ``<directory>/<name>/`` (what inference reads)."""
        return save_params(export_flax_params(self.model), directory, name)

    def save_checkpoint(self, checkpointer: Checkpointer) -> None:
        """``params.npz`` and the train state of this step."""
        base, name = os.path.split(checkpointer.directory)
        self.save(base, name)
        checkpointer.save(self.train_state())

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
        every ``cfg.ckpt_every_steps`` steps as well)."""
        cfg = self.cfg
        ckpt = None
        if checkpoint_dir is not None:
            ckpt = Checkpointer(checkpoint_dir, checkpoint_name,
                                cfg.max_checkpoints_to_keep)
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
                print(f"Validation reconstruction loss: {val_rec}")
                metrics["val_rec_loss"] = val_rec
                epoch_extra["val_rec_loss"] = val_rec
                if quality_hook is not None:
                    qm = quality_hook(self.model, val_batcher,
                                      torch.Generator(device=self.device)
                                      .manual_seed(self.eval_seed + epoch))
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
        return dict(metrics) if metrics else {"loss": float("nan")}
