"""Configuration of the port (its copy of ``vae_captioning_tpu/config.py``).

The same dataclass, field for field and default for default, with the
same JSON round trip and the same reference-compatible command line, so
a ``config.json`` written by either package loads in the other.  The
JAX package's TPU switches (``fused_*``, the CE schedules, ``mesh_axis``,
``optax_flatten``, ...) are kept as fields so that such files load; the
port does not read them: its bf16 train and decode paths always run
their CUDA kernels, at any width (padded up to the kernels' widths),
and its f32 paths those the JAX package runs under f32 (the CE under a
CE flag, the decode's logits kernels; ``ops/f32.py``).  What no path
takes raises ValueError
(``train.check_supported_training``, ``inference.check_supported``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Optional

PRIORS = ("Normal", "GMM", "AG")
SAMPLE_GENS = ("greedy", "sample", "beam_search")
OPTIMIZERS = ("SGD", "Adam", "Momentum")
MODES = ("training", "inference")


@dataclass
class Config:
    # --- model / latent space (ref utils/parameters.py:3-9) ---
    latent_size: int = 150
    num_clusters: int = 90      # 80 COCO classes + unused ids in 0..90
    cnn_feature_size: int = 4096  # VGG16 fc2 output width

    # --- training schedule (ref utils/parameters.py:5-8,29-32,55,64) ---
    num_epochs: int = 20
    learning_rate: float = 0.0005
    num_captions: int = 5       # captions used per image per step (1-5)
    batch_size: int = 32
    optimizer: str = "Adam"     # SGD | Adam | Momentum
    lstm_clip_by_norm: float = 5.0
    num_epochs_per_decay: int = 5
    num_ex_per_epoch: int = 150000
    ann_param: float = 0.0      # KL annealing ramp speed; <=1 disables

    # --- decoding (ref utils/parameters.py:11-18,28-29) ---
    temperature: float = 1.0
    sample_gen: str = "beam_search"  # greedy | sample | beam_search
    beam_size: int = 10
    gen_max_len: int = 30
    len_norm_f: float = 0.7     # beam length-normalization exponent
    # Batch-inference decode batch (TPU-native addition, no reference
    # equivalent — the ref decodes at batch_size).  None keeps the
    # reference behavior; decode throughput scales with batch to a knee
    # (beam-3: 32768, greedy: 65536 rows — PERF.md round-5 ladders), so
    # production batch inference should set e.g. 4096-32768.  Ceiling:
    # beam_size × gen_batch_size rows must fit the fused top-K kernel's
    # 32 MiB running scratch (≈8·Mp·k bytes → ~100k rows at beam 10;
    # beam 3's knee sits safely under it).
    gen_batch_size: Optional[int] = None

    # --- encoder (ref utils/parameters.py:20-21) ---
    encoder_rnn_layers: int = 1
    encoder_hidden: int = 512

    # --- decoder (ref utils/parameters.py:23-31) ---
    std: float = 0.1            # decode-time prior std, z ~ N(mean, std)
    decoder_hidden: int = 512
    decoder_rnn_layers: int = 1
    dec_keep_rate: float = 1.0  # caption-input dropout keep rate
    dec_lstm_drop: float = 1.0  # LSTM output dropout keep rate
    embed_size: int = 256
    gen_z_samples: int = 100    # z samples per example (paper: 100)

    # --- run control (ref utils/parameters.py:34-40,53-54,62-63) ---
    restore: bool = False
    no_encoder: bool = False
    vocab_size: Optional[int] = None   # set during data load
    gen_name: str = "00"
    checkpoint: str = "last_run"
    max_checkpoints_to_keep: int = 5
    mode: str = "training"
    prior: str = "Normal"       # Normal | GMM | AG
    use_c_v: bool = False
    logging: bool = False
    log_dir: str = "./model_logs/"
    save_params: bool = False

    # --- fine-tuning the CNN (ref utils/parameters.py:42-51) ---
    fine_tune: bool = False
    fine_tune_top: bool = True
    fine_tune_fe: bool = True
    cnn_lr: float = 0.00001
    cnn_optimizer: str = "Adam"
    cnn_dropout: float = 0.5    # keep rate
    weight_decay: float = 0.00004

    # --- data / paths (ref utils/parameters.py:41-44,57-60,65) ---
    coco_dir: str = "./mscoco/"
    hdf5_file: str = ""         # derived: <coco_dir>/train_val.hdf5
    use_hdf5: bool = False
    raw_images_file: str = ""   # derived: <coco_dir>/train_val.bin (native
                                # mmap loader; preferred over HDF5 if present)
    gen_val_captions: int = 4000  # -1: no repartition
    keep_words: int = 3         # vocab min-count
    cap_max_length: int = 100
    image_net_weights_path: str = "./vgg16_weights.npz"
    checkpoint_dir: str = "./checkpoints"
    cache_dir: str = "./cache"  # feature / vocab / cluster-mean caches
    obj_vectors_dir: str = "./obj_vectors"

    # --- knobs of the JAX package (no reference equivalent) ---
    seed: int = 42
    compute_dtype: str = "bfloat16"  # or "float32" (ops/f32.py)
    bucket_multiple: int = 8    # pad caption length to a multiple of this
    extract_batch_size: int = 64  # VGG16 feature-extraction batch
    mesh_axis: str = "dp"       # JAX: data-parallel mesh axis name
    profile: bool = False       # trace steps 11-20 into log_dir (torch.profiler)
    debug_nans: bool = False    # raise at the first non-finite loss,
                                # metric or grad norm (Trainer); the CLI
                                # also turns on autograd anomaly detection
    # the fused CE schedules, at most one set (ops/fused_ce.py): fused_ce
    # is the flash CE (the [M, V] logits never reach memory); ce_hybrid
    # writes the bf16 logits once and folds the reductions into the
    # passes over them; ce_xla_bwd is a plain forward with the hybrid's
    # backward kernels; ce_bias_fold is a JAX schedule of the plain
    # logits head, which the port does not read
    fused_ce: bool = False
    ce_hybrid: bool = False
    ce_xla_bwd: bool = False
    ce_bias_fold: bool = False
    # the decode's kill switch: False writes the logits and takes the
    # exact top-k + logsumexp kernel over them (JAX: XLA's top-k)
    fused_decode: bool = True
    # JAX: switches of its TPU kernels; the port always runs its kernels
    # on the card and its plain versions on the CPU, and reads none
    fused_lstm_step: bool = True
    fused_heads: bool = True
    fused_z: bool = True
    fused_lstm_seq: bool = True
    fused_force: bool = False
    decode_int8: bool = False   # APPROXIMATE int8 logits (inference.py)
    ag_kl_sum: bool = False     # AG prior only: the reference leaves its
                                # AG KL per-example and tf.gradients
                                # implicitly SUMS it into the loss
                                # (batch-size-dependent KL weight, ref
                                # main.py:136-145/172-177); we mean it by
                                # default.  True = the reference's
                                # effective weighting (masked row sum)
    gmm_true_kl: bool = False   # GMM prior only: the true mixture KL in
                                # place of the reference's placeholder
                                # standard-normal KL
    multihost: bool = False     # data-parallel training over the ranks
                                # torchrun starts (parallel/)
    image_size: int = 224       # fine-tune input resolution
    ckpt_every_steps: int = 0   # >0: a checkpoint every N steps as well
    eval_metrics: bool = False  # per-epoch BLEU/CIDEr-D/ROUGE-L/METEOR
    optax_flatten: bool = False  # JAX: one flat optimizer vector
    prefetch_batches: int = 2   # host-side batch-assembly lookahead on a
                                # background thread (0 = inline)

    def __post_init__(self):
        if not self.hdf5_file:
            self.hdf5_file = os.path.join(self.coco_dir, "train_val.hdf5")
        if not self.raw_images_file:
            self.raw_images_file = os.path.join(self.coco_dir, "train_val.bin")
        self.validate()

    # ------------------------------------------------------------------
    def validate(self) -> None:
        if self.prior not in PRIORS:
            raise ValueError(f"prior must be one of {PRIORS}, got {self.prior!r}")
        if self.sample_gen not in SAMPLE_GENS:
            raise ValueError(
                f"sample_gen must be one of {SAMPLE_GENS}, got {self.sample_gen!r}")
        if self.optimizer not in OPTIMIZERS or self.cnn_optimizer not in OPTIMIZERS:
            raise ValueError(f"optimizer must be one of {OPTIMIZERS}")
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {self.mode!r}")
        if not 1 <= self.num_captions <= 5:
            raise ValueError("num_captions must be in [1, 5]")

    # ------------------------------------------------------------------
    @property
    def needs_cluster_vectors(self) -> bool:
        """Cluster vectors are consumed when requested or required by the
        prior (ref main.py:52-56)."""
        return self.use_c_v or self.prior in ("GMM", "AG")

    # ------------------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def from_json(cls, text: str) -> "Config":
        raw = json.loads(text)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in known})

    @classmethod
    def load(cls, path: str) -> "Config":
        with open(path) as f:
            return cls.from_json(f.read())

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)


# ----------------------------------------------------------------------
# CLI overlay with the reference's flag names (ref utils/parameters.py:68-159)
# ----------------------------------------------------------------------

# CLI flag → Config field for the reference-compatible names
_FLAG_TO_FIELD = {
    "lr": "learning_rate", "embed": "embed_size",
    "enc_hid": "encoder_hidden", "dec_hid": "decoder_hidden",
    "latent": "latent_size", "restore": "restore", "coco_dir": "coco_dir",
    "epochs": "num_epochs", "bs": "batch_size", "no_encoder": "no_encoder",
    "temperature": "temperature", "gen_name": "gen_name",
    "dec_drop": "dec_keep_rate", "gen_z_samples": "gen_z_samples",
    "ann_param": "ann_param", "dec_lstm_drop": "dec_lstm_drop",
    "sample_gen": "sample_gen", "checkpoint": "checkpoint",
    "optimizer": "optimizer", "c_v": "use_c_v", "std": "std",
    "save_params": "save_params", "prior": "prior", "fine_tune": "fine_tune",
    "mode": "mode", "beam_size": "beam_size",
}


def build_arg_parser() -> argparse.ArgumentParser:
    # every option defaults to SUPPRESS: only flags the user actually
    # typed appear in the namespace, so ``--config`` payloads are never
    # clobbered by argparse defaults
    S = argparse.SUPPRESS
    p = argparse.ArgumentParser(
        description="Train / run the VAE captioning models on the GPU. "
        "Flags mirror the reference CLI; every Config field can also be "
        "set via --set key=value.")
    p.add_argument("--lr", type=float, default=S, dest="lr")
    p.add_argument("--embed_dim", type=int, default=S, dest="embed")
    p.add_argument("--enc_hid", type=int, default=S)
    p.add_argument("--dec_hid", type=int, default=S)
    p.add_argument("--latent", type=int, default=S)
    p.add_argument("--restore", action="store_true", default=S)
    p.add_argument("--coco_dir", default=S)
    p.add_argument("--epochs", type=int, default=S)
    p.add_argument("--bs", type=int, default=S)
    p.add_argument("--no_encoder", action="store_true", default=S)
    p.add_argument("--temperature", type=float, default=S)
    p.add_argument("--gen_name", default=S)
    p.add_argument("--dec_drop", type=float, default=S)
    p.add_argument("--gen_z_samples", type=int, default=S)
    p.add_argument("--ann_param", type=float, default=S)
    p.add_argument("--dec_lstm_drop", type=float, default=S)
    p.add_argument("--sample_gen", default=S, choices=SAMPLE_GENS)
    p.add_argument("--checkpoint", default=S)
    p.add_argument("--optimizer", default=S, choices=OPTIMIZERS)
    p.add_argument("--c_v", action="store_true", default=S,
                   help="use detected-object cluster vectors")
    p.add_argument("--std", type=float, default=S)
    p.add_argument("--save_params", action="store_true", default=S,
                   help="save resolved config JSON next to checkpoints")
    p.add_argument("--prior", default=S, choices=PRIORS)
    p.add_argument("--fine_tune", action="store_true", default=S)
    p.add_argument("--mode", default=S, choices=MODES)
    p.add_argument("--beam_size", type=int, default=S)
    p.add_argument("--gpu", default=None, metavar="ID",
                   help="accepted for reference-CLI compatibility "
                        "(ref main.py --gpu) and IGNORED: the port's "
                        "command line takes --device")
    p.add_argument("--config", default=None,
                   help="load a saved config JSON before applying flags")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="override any Config field, e.g. --set seed=7")
    return p


def _coerce(value: str, target: Any, declared: Any = None) -> Any:
    if isinstance(target, bool):
        return value.lower() in ("1", "true", "yes", "on")
    if isinstance(target, int):
        return int(value)
    if isinstance(target, float):
        return float(value)
    if target is None and declared is not None:
        # Optional[T] fields default to None, so the runtime value can't
        # drive the dispatch — use the declared annotation's inner type
        # (e.g. --set gen_batch_size=4096 must become an int, not "4096")
        import typing
        inner = [t for t in typing.get_args(declared) if t is not type(None)]
        if inner and inner[0] in (int, float):
            return inner[0](value)
    return value


def parse_args(argv: Optional[list] = None) -> Config:
    """Build a Config from CLI flags (reference-compatible names).

    Precedence: Config defaults < --config JSON < explicit flags < --set.
    Only flags the user actually typed override the loaded config."""
    args = build_arg_parser().parse_args(argv)
    if args.gpu is not None:
        import warnings
        warnings.warn("--gpu is ignored: pass --device to the port's "
                      "command line")
    cfg = Config.load(args.config) if args.config else Config()

    present = vars(args)
    overrides = {
        _FLAG_TO_FIELD[flag]: value
        for flag, value in present.items()
        if flag in _FLAG_TO_FIELD
    }
    if "coco_dir" in overrides:
        # re-derive the coco_dir-relative paths (ref parameters.py:161)
        overrides.setdefault("hdf5_file", "")
        overrides.setdefault("raw_images_file", "")

    defaults = Config()
    import typing
    hints = typing.get_type_hints(Config)
    for item in args.set:
        if "=" not in item:
            raise ValueError(f"--set expects KEY=VALUE, got {item!r}")
        key, value = item.split("=", 1)
        if not hasattr(defaults, key):
            raise ValueError(f"unknown Config field {key!r}")
        overrides[key] = _coerce(value, getattr(defaults, key),
                                 hints.get(key))
    if overrides:
        cfg = cfg.replace(**overrides)
    cfg.validate()
    return cfg
