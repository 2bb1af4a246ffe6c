"""Smoke test of the PyTorch port on one NVIDIA GPU (``python3 chip_smoke.py``).

Phases, in order; any failure raises and the script exits nonzero:

1. device: require CUDA, print the card's name and power limit;
2. build: compile the CUDA kernels from ``vae_captioning_torch/csrc``
   (one nvcc per source, all started together) and print the wgmma +
   TMA templates' registers, spills and shared memory per instance (the
   CE forward of both schedules, the flash CE's and the written logits'
   backward, the AG-heads forward and backward, the LSTM cell of the
   decode step and of the sequence forward, the sequence backward's
   steps, dx and dW, the fused z forward, dmu/dsigma and dW, the decode's
   logits top-k, int8 top-k and sampler at every block shape and list
   length), and any ptxas warning that one serialises its wgmmas;
3. kernels: each kernel against its plain PyTorch version on the card,
   at the main paths' shapes and ragged ones: the decode kernels (plus a
   deliberate tie; the LSTM step also at one row, one row past a tile,
   narrow widths and a width whose A is taken in chunks; the logits top-k
   also at one row, one row past a tile, lists of 16, H = 96, 1024 (64-row
   blocks) and 2048 (h streamed)), the int8 top-k (also at one row, one
   row past a tile, lists of 16, H = 1024 and 2624) and the top-k + lse over written
   logits (values and indices bit for bit), the sampler (token for token
   outside near-ties, also at one row and H = 96, 1024, and its law over
   200,000 draws), the train path's ``fused_lstm_seq`` (also at one
   row, one row past a tile, one step and the narrowest and a wider
   width; forward and backward twice, bit for bit) and ``fused_z``
   forward and backward (also at one row, one row past a tile, one
   sample, latent widths 37 and 256 and every column width; each twice,
   bit for bit), the fused z generator's bits, normals and
   moments against the plain generator, and the AG train path's
   ``fused_ag_heads`` forward and backward with COCO-like cluster vectors
   (also at one row, one row past a tile and every width; forward and
   backward twice, bit for bit), the flash CE's three kernels (``fused_linear_ce``:
   forward, dh, dW/db) and the written-logits CE's three
   (``fused_linear_ce_hybrid``: the forward that writes the bf16 logits,
   dh and dW/db over them) at the train shapes, with the train batch's
   PAD rows, and ragged ones (both also at one row, one row past a tile,
   every width and a vocabulary smaller than a tile; the flash forward
   twice, bit for bit; the written-logits kernels with labels past V on
   rows of weight 0, each twice, bit for bit);
4. decode path: the full-width AG-CVAE (random weights from a seed, in
   the Flax layout, through the bridge) decodes synthetic features
   through ``run_inference`` at beam 3, beam 10 and greedy, writing the
   val/test JSON files; the kernels' launch counts must match the steps
   taken; then batches are decoded at beam 3, beam 10 and greedy through
   the kernels, the plain versions and the plain versions summed in
   reverse order, and compared step by step and caption by caption (see
   phase_decode_compare); then the other decode modes, each its own path
   through ``run_inference`` with exact launch counts
   (phase_mode_paths): ``decode-sample`` (temperature sampling through
   ``fused_logits_sample``), ``decode-int8`` (beam 3 and greedy through
   ``fused_logits_top_k_int8``) and ``decode-unfused`` (the logits
   written, beam 3 through ``top_k_logsumexp``), and each compared step
   by step with its plain versions (phase_mode_compare);
5. train path: the full-width Normal-prior CVAE (``config.py``
   defaults, random weights from a seed through the bridge) takes 20
   ``Trainer`` steps on one synthetic batch of 256 images x 5 captions x
   24 tokens; the loss must be finite and fall and the train kernels'
   launch counts must match the steps; then 5 steps through the kernels
   and 5 through the plain versions from the same weights and seeds are
   compared (phase_train_compare); the trained weights go through
   ``export_flax_params`` / ``save_params`` / ``load_model`` and decode a
   greedy batch of 512 images through the decode kernels;
6. AG train path: the same for the full-width AG-CVAE with cluster
   vectors (``Config(prior="AG", use_c_v=True)``, COCO-like c_v), whose
   encoder runs ``fused_ag_heads``; its checkpoint decodes a beam-3 batch
   of 512 images with their cluster vectors: the served model, trained by
   the port;
7. GMM train path: the same for the full-width GMM-CVAE with cluster
   vectors and the flash CE (``Config(prior="GMM", use_c_v=True,
   fused_ce=True)``): the encoder draws one cluster per row from a
   generator the Trainer owns, and the logits head and CE run through the
   three CE kernels, so the [M, V] logits never reach memory; the
   comparison with the plain versions draws the same clusters; the
   checkpoint decodes a beam-3 batch with z centred at 0;
8. GMM train paths under the other CE schedules: ``train-gmm-hybrid``
   (``ce_hybrid=True``: the three written-logits kernels) and
   ``train-gmm-xla-bwd`` (``ce_xla_bwd=True``: a plain forward writes the
   logits, the hybrid's dh and dW/db kernels read them), each with its
   exact launch counts (no flash CE kernel) and compared with the plain
   versions as in 5;
9. the training life cycle at full width: ``resume`` (the AG-CVAE, and
   the GMM-CVAE under the flash CE: 3 steps, the train state saved
   through ``Checkpointer``, a fresh Trainer restored from it, 3 more
   steps, bit for bit against 6 uninterrupted steps, with the annealing
   1.0 after the restore and retention at ``max_checkpoints_to_keep``);
   ``quality`` (the AG-CVAE trained by ``Trainer.fit`` with the per-epoch
   caption-quality hook on a synthetic corpus whose captions follow from
   each image's cluster vector and features, val CIDEr-D required to rise
   above the untrained model's; then the int8 decode's BLEU-4 / CIDEr-D
   against bf16 at beam 3 and 10, and the whole-caption agreement of the
   kernel decode with the plain decode on the trained weights, written
   to ``quality.json``); ``finetune`` (the AG-CVAE as a FineTuneModel,
   VGG16 from a Caffe-layout npz drawn by numpy, 32 images x 5 captions
   served by ``RawImageStore``'s native loader: 5 steps with exact launch
   counts, the VGG16 weights moving or frozen as configured, 3 steps
   against the plain versions, a checkpoint round trip and a beam-3
   decode from images, the step's time and peak memory, and fc2
   extraction at 64 images a batch);
10. this slice's paths: ``wide-beam`` (beams 20 and 40, and int8 at
   beam 20, on 512 images: past the fused kernels' lists of 16 the decode
   writes its logits and takes the top-k + logsumexp kernel, with exact
   launch counts; compared with the plain decodes as in 4, and timed);
   ``generate`` (the single-image API, ``Generator.caption_pixels``, on
   the AG-CVAE the train-ag path trained, VGG16 from a Caffe-layout npz
   drawn by numpy, at greedy, beam 3 with every beam and sampling, with a
   detections JSON's and an explicit cluster vector, per step against the
   plain versions, whole captions against a plain-ops Generator, and one
   caption a mode timed, VGG16 included; also on the fine-tune
   checkpoint, raw pixels into its VGG16); ``fidelity`` (the VGG16
   fidelity tool passes on that npz and fails on a swapped layout); and
   ``dp`` (two ranks spawned on the card over gloo: 3 SGD steps of the
   AG-CVAE and of the GMM-CVAE under the flash CE at B = 256 x 5 x 24
   against one process on the global batch, every parameter to rtol
   1e-3; then each rank's launches and step time with its own noise);
11. times: each kernel against its plain version and, where one PyTorch
   call or a short chain of them computes the same function, that call;
   decode batches (every mode) and train steps (Normal, AG and GMM),
   kernel path against plain path, in turns; the GMM step and the Normal
   step under the four CE schedules (plain CE over bf16 logits, flash,
   hybrid, XLA forward), in turns, and the peak device memory of one step
   of each.

``python3 chip_smoke.py --profile`` instead builds the kernels and
profiles the full-width train step, Normal, AG, then GMM with the flash
CE and with the hybrid CE (phase_train_profile): device time by kernel,
and the device's idle share.

Before its last lines it checks that no JAX module, and no module of the
JAX package, was loaded.  The line before the last is the kernels' JSON
record (each with its launches on its path, its time, its plain
version's, its bound and the library call's, and its launches on
each path that ran it, this slice's included); the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import functools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

if not torch.cuda.is_available():
    sys.exit("chip_smoke: CUDA is not available; this script needs one GPU")

from vae_captioning_torch.config import Config  # noqa: E402
from vae_captioning_torch.data.batcher import Batch, CaptionBatcher  # noqa: E402
from vae_captioning_torch.data.features import FeatureStore  # noqa: E402
from vae_captioning_torch.data.vocabulary import Vocabulary  # noqa: E402
from vae_captioning_torch import _ext  # noqa: E402
from vae_captioning_torch.bridge import (export_flax_params,  # noqa: E402
                                         flax_shapes, load_flax_params)
from vae_captioning_torch.checkpoint import (  # noqa: E402
    Checkpointer, load_model, save_params, save_sidecars)
from vae_captioning_torch.data import native_loader  # noqa: E402
from vae_captioning_torch.data.features import FeatureExtractor  # noqa: E402
from vae_captioning_torch.data.native_loader import (  # noqa: E402
    RawImageStore, write_raw)
from vae_captioning_torch.eval.scorers import cider_d, corpus_bleu  # noqa: E402
from vae_captioning_torch.generate import (  # noqa: E402
    Generator, feature_extractor)
from vae_captioning_torch.inference import (  # noqa: E402
    PLAIN_OPS, REORDERED_OPS, DecodeOps, generate_captions, make_decode_fns,
    make_quality_hook, run_inference)
from vae_captioning_torch.models import vgg_fidelity  # noqa: E402
from vae_captioning_torch.models.cvae import (  # noqa: E402
    PLAIN_TRAIN_OPS, CVAEModel, TrainOps)
from vae_captioning_torch.models.vgg16 import CONV_BLOCKS  # noqa: E402
from vae_captioning_torch.ops.distributions import (  # noqa: E402
    AG_UNUSED_CLASSES)
from vae_captioning_torch.ops import fused_ce  # noqa: E402
from vae_captioning_torch.ops.fused_ag_heads import (  # noqa: E402
    ag_heads_bwd_kernel, ag_heads_bwd_plain, ag_heads_fwd_kernel,
    ag_heads_plain, prepare)
from vae_captioning_torch.ops.fused_logits_topk import (  # noqa: E402
    K_MAX, bf16_logits, fused_logits_sample, fused_logits_sample_plain,
    fused_logits_top_k, fused_logits_top_k_int8, fused_logits_top_k_int8_plain,
    fused_logits_top_k_plain, int8_logits, int8_logits_kernel,
    int8_top_k_kernel, int8_top_k_plain, logits_kernel, logits_plan,
    logits_top_k_kernel, quantize_logits_weights, quantize_rows, sample_scores)
from vae_captioning_torch.ops.fused_lstm_seq import (  # noqa: E402
    lstm_seq_bwd_kernel, lstm_seq_bwd_plain, lstm_seq_fwd_kernel,
    lstm_seq_fwd_plain)
from vae_captioning_torch.ops.fused_lstm_step import (  # noqa: E402
    fused_lstm_step, fused_lstm_step_plain, lstm_step_geometry,
    lstm_step_kernel, lstm_step_layout, lstm_step_plan)
from vae_captioning_torch.ops.fused_z import (  # noqa: E402
    fused_z_eps, fused_z_plain, philox_bits, philox_normals, transform_mismatches,
    z_bwd_kernel, z_bwd_plain, z_fwd_kernel, z_fwd_plain)
from vae_captioning_torch.ops.topk_lse import (  # noqa: E402
    top_k_logsumexp, top_k_logsumexp_plain)
from vae_captioning_torch.parallel import mesh as dp_mesh  # noqa: E402
from vae_captioning_torch.parallel.kernel_shard import DataParallel  # noqa: E402
from vae_captioning_torch.train import Trainer  # noqa: E402

DEV = torch.device("cuda", 0)
# tolerances of the kernel-vs-plain comparisons (f32 sums in another order)
LSTM_ATOL = 1e-5        # c', h'
TOPK_RTOL = 1e-5        # top-k values
LSE_RTOL = 1e-5         # logsumexp
TIE_GAP = 1e-4          # rows whose plain top-(k+1) values lie this close
                        # may order their indices differently
KERNELS = {
    "fused_lstm_step": {
        "route": "cuda", "source": "vae_captioning_torch/csrc/fused_lstm_step.cu",
        "replaces": "vae_captioning_tpu/ops/fused_lstm_step.py:47"},
    "fused_logits_top_k": {
        "route": "cuda", "source": "vae_captioning_torch/csrc/fused_logits_topk.cu",
        "replaces": "vae_captioning_tpu/ops/fused_logits_topk.py:194"},
    "fused_lstm_seq_fwd": {
        "route": "cuda", "source": "vae_captioning_torch/csrc/fused_lstm_seq.cu",
        "replaces": "vae_captioning_tpu/ops/fused_lstm_seq.py:86"},
    "fused_lstm_seq_bwd": {
        "route": "cuda", "source": "vae_captioning_torch/csrc/fused_lstm_seq.cu",
        "replaces": "vae_captioning_tpu/ops/fused_lstm_seq.py:195"},
    "fused_z_fwd": {
        "route": "cuda", "source": "vae_captioning_torch/csrc/fused_z.cu",
        "replaces": "vae_captioning_tpu/ops/fused_z.py:71"},
    "fused_z_bwd": {
        "route": "cuda", "source": "vae_captioning_torch/csrc/fused_z.cu",
        "replaces": "vae_captioning_tpu/ops/fused_z.py:91"},
    # check only: the eps stream materialised, on no main path (its
    # launches stay 0), held bit for bit against the plain generator
    "fused_z_eps": {
        "route": "cuda", "source": "vae_captioning_torch/csrc/fused_z.cu",
        "replaces": "vae_captioning_tpu/ops/fused_z.py:234"},
    "fused_ag_heads_fwd": {
        "route": "cuda", "source": "vae_captioning_torch/csrc/fused_ag_heads.cu",
        "replaces": "vae_captioning_tpu/ops/fused_ag_heads.py:80"},
    "fused_ag_heads_bwd": {
        "route": "cuda", "source": "vae_captioning_torch/csrc/fused_ag_heads.cu",
        "replaces": "vae_captioning_tpu/ops/fused_ag_heads.py:116"},
    "fused_linear_ce_fwd": {
        "route": "cuda", "source": "vae_captioning_torch/csrc/fused_ce.cuh",
        "replaces": "vae_captioning_tpu/ops/fused_ce.py:59"},
    "fused_linear_ce_dh": {
        "route": "cuda", "source": "vae_captioning_torch/csrc/fused_ce.cu",
        "replaces": "vae_captioning_tpu/ops/fused_ce.py:134"},
    "fused_linear_ce_dwdb": {
        "route": "cuda", "source": "vae_captioning_torch/csrc/fused_ce.cu",
        "replaces": "vae_captioning_tpu/ops/fused_ce.py:159"},
    "fused_logits_top_k_int8": {
        "route": "cuda", "source": "vae_captioning_torch/csrc/fused_logits_topk.cu",
        "replaces": "vae_captioning_tpu/ops/fused_logits_topk.py:211"},
    "fused_logits_sample": {
        "route": "cuda", "source": "vae_captioning_torch/csrc/fused_logits_topk.cu",
        "replaces": "vae_captioning_tpu/ops/fused_logits_topk.py:398"},
    "top_k_logsumexp": {
        "route": "cuda", "source": "vae_captioning_torch/csrc/topk_lse.cu",
        "replaces": "vae_captioning_tpu/ops/topk_pallas.py:36",
        # warp lists of up to 64 (ops/topk_lse.py: K_LIST); past them a
        # dispatch on k takes the same file's block-a-row bitonic sort; the
        # fused top-k past 16 write their logits and route here
        "k": "1-64: warp lists; k > 64: the bitonic-sort kernel (dispatch on k); "
             "the fused bf16 / int8 top-k past k = 16 write their logits with "
             "their own kernel's writer instance and call this"},
    "fused_linear_ce_mat_fwd": {
        "route": "cuda", "source": "vae_captioning_torch/csrc/fused_ce.cuh",
        "replaces": "vae_captioning_tpu/ops/fused_ce.py:304"},
    "fused_linear_ce_mat_dh": {
        "route": "cuda", "source": "vae_captioning_torch/csrc/fused_ce_mat.cu",
        "replaces": "vae_captioning_tpu/ops/fused_ce.py:377"},
    "fused_linear_ce_mat_dwdb": {
        "route": "cuda", "source": "vae_captioning_torch/csrc/fused_ce_mat.cu",
        "replaces": "vae_captioning_tpu/ops/fused_ce.py:346"},
}
DECODE_KERNELS = ("fused_lstm_step", "fused_logits_top_k")
# the decode modes' paths: each runs the LSTM step and one logits kernel
# (the sample path's greedy test split runs the bf16 top-k)
MODE_PATHS = {"decode-sample": "fused_logits_sample",
              "decode-int8": "fused_logits_top_k_int8",
              "decode-unfused": "top_k_logsumexp"}
MODE_KERNELS = tuple(MODE_PATHS.values())
TRAIN_KERNELS = ("fused_lstm_seq_fwd", "fused_lstm_seq_bwd", "fused_z_fwd",
                 "fused_z_bwd")
AG_KERNELS = ("fused_ag_heads_fwd", "fused_ag_heads_bwd")
CE_KERNELS = ("fused_linear_ce_fwd", "fused_linear_ce_dh", "fused_linear_ce_dwdb")
MAT_KERNELS = ("fused_linear_ce_mat_fwd", "fused_linear_ce_mat_dh",
               "fused_linear_ce_mat_dwdb")
# the CE kernels a train step launches under each CE schedule flag
CE_STEP_LAUNCHES = {
    "fused_ce": dict.fromkeys(CE_KERNELS, 1),
    "ce_hybrid": dict.fromkeys(MAT_KERNELS, 1),
    "ce_xla_bwd": dict.fromkeys(MAT_KERNELS[1:], 1),
}
CE_SCHEDULES = ("", "fused_ce", "ce_hybrid", "ce_xla_bwd")   # "": the plain CE
# the card's published peaks (NVIDIA H100 SXM data sheet, at 700 W): dense
# bf16 and int8 tensor-core operations and HBM3 bytes per second
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
PEAK_BYTES = 3.35e12


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms, by CUDA events around ``iters``
    calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, reps: int = 10) -> dict:
    """Device time per call of each kernel that fn() launches, by name
    (from a torch.profiler trace of ``reps`` calls after one warm-up
    call): what the card spent, without the host's gaps between calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):      # the profiler now and then hands back no event
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        times = {}
        for e in prof.events():
            if e.device_type.name == "CUDA":
                times[e.name] = times.get(e.name, 0.0) + e.device_time_total / reps / 1e3
        if sum(times.values()) > 0:
            return times
    raise AssertionError("device_ms: the profiler recorded no kernel in three tries")


def union_ms(spans) -> float:
    """The time (ms) that a set of (start, end) intervals in microseconds
    covers."""
    busy, end = 0.0, float("-inf")
    for start, stop in sorted(spans):
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    return busy / 1e3


def device_spans(fn, group, reps: int = 5) -> dict:
    """Device time per call of fn(), from a torch.profiler trace of
    ``reps`` calls after one warm-up call, as the union of the kernels'
    intervals (kernels launched with programmatic dependent launch
    overlap, so their durations do not add up): {"total": the calls'
    union, part: the union of the intervals of the kernels that
    ``group(name)`` puts in that part}."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
    spans = {"total": []}
    for e in events:
        span = (e["ts"], e["ts"] + e["dur"])
        spans["total"].append(span)
        spans.setdefault(group(kernel_name(e["name"])), []).append(span)
    return {k: union_ms(v) / reps for k, v in spans.items()}


def kernel_name(name: str) -> str:
    """A profiler kernel name without its return type, namespace and
    parameters."""
    return name.replace("void ", "").replace("(anonymous namespace)::", "").split("(")[0]


def host_us(fn, reps: int = 100) -> float:
    """Host time per call of fn() in microseconds, the calls enqueued back
    to back (the device finishes after)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(flops: float, moved: int, peak: float = PEAK_BF16) -> tuple:
    """(the least ms the card could take, what binds it): the larger of
    the tensor-core operations over their type's peak (bf16 unless
    ``peak`` says otherwise) and the bytes (each input read once, each
    output written once) over the memory rate."""
    t_ops, t_bytes = flops / peak * 1e3, moved / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ----------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ----------------------------------------------------------------------

def lstm_inputs(N: int, E: int = 256, H: int = 512, seed: int = 0):
    g = torch.Generator(device=DEV).manual_seed(seed)
    lim = (6.0 / (E + H + 4 * H)) ** 0.5      # the Flax xavier_uniform bound
    x = torch.randn((N, E), generator=g, device=DEV).to(torch.bfloat16)
    c = torch.randn((N, H), generator=g, device=DEV)
    h = torch.tanh(torch.randn((N, H), generator=g, device=DEV))
    w = ((torch.rand((E + H, 4 * H), generator=g, device=DEV) * 2 - 1) * lim
         ).to(torch.bfloat16)
    b = 0.1 * torch.randn((4 * H,), generator=g, device=DEV)
    return x, c, h, w, b


def lstm_f64(x, c, h, w, b, forget_bias: float = 1.0) -> tuple:
    """The step in f64 on the same bf16-rounded operands: the yardstick
    that shows how far the kernel's and the plain version's f32 sums each
    stray."""
    zh = torch.cat([x.to(torch.bfloat16), h.to(torch.bfloat16)], dim=-1).double()
    gates = zh @ w.to(torch.bfloat16).double() + b.double()
    i, f, g, o = gates.chunk(4, dim=-1)
    new_c = (torch.sigmoid(f + forget_bias) * c.double()
             + torch.sigmoid(i) * torch.tanh(g))
    return new_c, torch.sigmoid(o) * torch.tanh(new_c)


def check_lstm(N: int, E: int = 256, H: int = 512) -> float:
    args = lstm_inputs(N, E, H, seed=N)
    got = fused_lstm_step(*args)
    want = fused_lstm_step_plain(*args)
    exact = lstm_f64(*args)
    torch.cuda.synchronize()
    err = 0.0
    for name, a, r in zip(("c", "h"), got, want):
        diff = (a - r).abs()
        bad = diff > LSTM_ATOL
        if bool(bad.any()) or not bool(torch.isfinite(a).all()):
            raise AssertionError(
                f"fused_lstm_step N={N} E={E} H={H}: {name}' differs from the plain "
                f"version at {int(bad.sum())} places, max |diff| "
                f"{float(diff.max()):.3e}")
        err = max(err, float(diff.max()))
    stray = [max(float((a.double() - e).abs().max()) for a, e in zip(out, exact))
             for out in (got, want)]
    plan = lstm_step_plan(N, E, H)
    boxes = -(-E // 64) + -(-H // 64)
    chunk, stages, _ = lstm_step_layout(E, H, plan.units)
    print(f"fused_lstm_step N={N} E={E} H={H}: max |kernel - plain| {err:.3e}, "
          f"from f64: kernel {stray[0]:.3e}, plain {stray[1]:.3e} (U = "
          f"{plan.units}, {plan.grid[0] * plan.grid[1]} blocks, A in "
          f"{-(-boxes // chunk)} chunk(s), {stages} ring stages)")
    return err


def logits_inputs(M: int, V: int, H: int = 512, seed: int = 0):
    """h [M, H] bf16, the head w [H, V] bf16 in the layout the decode
    stores it (``w.t()`` contiguous, as ``DecodeWeights.of`` casts it),
    b [V] f32."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    h = torch.tanh(torch.randn((M, H), generator=g, device=DEV)).to(torch.bfloat16)
    w = (0.05 * torch.randn((H, V), generator=g, device=DEV)).to(torch.bfloat16)
    b = 0.1 * torch.randn((V,), generator=g, device=DEV)
    return h, w.t().contiguous().t(), b


def compare_topk(tag: str, got, want) -> float:
    vals, idx, lse = got
    p_vals, p_idx, p_lse = want
    if vals.shape != p_vals.shape or idx.shape != p_idx.shape:
        raise AssertionError(f"{tag}: shapes {tuple(vals.shape)} vs "
                             f"{tuple(p_vals.shape)}")
    v_err = (vals - p_vals).abs()
    if bool((v_err > TOPK_RTOL * p_vals.abs()).any()):
        raise AssertionError(f"{tag}: top-k values differ, max |diff| "
                             f"{float(v_err.max()):.3e}")
    l_err = (lse - p_lse).abs()
    if bool((l_err > LSE_RTOL * p_lse.abs()).any()):
        raise AssertionError(f"{tag}: logsumexp differs, max |diff| "
                             f"{float(l_err.max()):.3e}")
    return max(float(v_err.max()), float(l_err.max()))


def check_topk(M: int, V: int, k: int, H: int = 512) -> float:
    h, w, b = logits_inputs(M, V, H, seed=M + V + k)
    got = fused_logits_top_k(h, w, b, k)
    p_vals, p_idx, p_lse = fused_logits_top_k_plain(h, w, b, k + 1)
    torch.cuda.synchronize()
    plan = logits_plan(M, H, V, k if k <= K_MAX else 1, 2, _ext.sm_count(0))
    tag = (f"fused_logits_top_k M={M} H={H} V={V} k={k} ({plan.rows}-row blocks, h "
           f"{'resident' if plan.resident else 'streamed'}, {plan.chunks} chunks"
           f"{'; the logits written, then top_k_logsumexp' if k > K_MAX else ''})")
    err = compare_topk(tag, got, (p_vals[:, :k], p_idx[:, :k], p_lse))
    # rows whose plain top-(k+1) values hold a near-tie may order or
    # choose their indices differently; every other row must agree exactly
    near = ((p_vals[:, :k] - p_vals[:, 1:]) <= TIE_GAP).any(dim=1)
    mismatch = (got[1] != p_idx[:, :k]).any(dim=1)
    bad = mismatch & ~near
    if bool(bad.any()):
        raise AssertionError(f"{tag}: indices differ in {int(bad.sum())} rows "
                             "without a near-tie")
    print(f"{tag}: max |kernel - plain| {err:.3e}; near-tie rows "
          f"{int(near.sum())}, of which indices differ in "
          f"{int((mismatch & near).sum())}")
    return err


def check_topk_ties(k: int) -> None:
    """W = 0, so the logits are the bias exactly; duplicated bias entries
    tie, and the lowest index must win."""
    M, H, V = 200, 512, 11519
    h = torch.ones((M, H), device=DEV, dtype=torch.bfloat16)
    w = torch.zeros((H, V), device=DEV, dtype=torch.bfloat16)
    b = torch.zeros((V,), device=DEV)
    top = [9000, 100, 5000, 11518, 7, 3, 2048, 129, 128, 6000]
    for col in top[:3]:
        b[col] = 10.0
    for col in top[3:]:
        b[col] = 9.0
    want_idx = sorted(top[:3]) + sorted(top[3:])
    want_idx += [i for i in range(V) if i not in top][:max(0, k - len(top))]
    vals, idx, lse = fused_logits_top_k(h, w, b, k)
    p_vals, p_idx, p_lse = fused_logits_top_k_plain(h, w, b, k)
    torch.cuda.synchronize()
    expect = torch.tensor(want_idx[:k], dtype=torch.int32, device=DEV)
    if not (bool((idx == expect).all()) and bool((p_idx == expect).all())):
        raise AssertionError(f"tie case k={k}: kernel {idx[0].tolist()}, "
                             f"plain {p_idx[0].tolist()}, want "
                             f"{expect.tolist()}")
    compare_topk(f"tie case k={k}", (vals, idx, lse), (p_vals, p_idx, p_lse))
    print(f"fused_logits_top_k tie case k={k}: lowest index wins "
          f"{idx[0].tolist()}")


# rows the main path gives the kernels: 512 images x (greedy, beam 3,
# beam 10), and a ragged count
ROWS = (512, 1536, 5120, 1000)
# the logits top-k also at one row, one row past a block, lists of 16
# (64-row blocks), H = 96, H = 1024 (64-row blocks) and H = 2048 (h
# streamed): (M, V, k, H)
TOPK_SHAPES = ((1, 11519, 3, 512), (65, 11500, 10, 512), (65, 11519, 16, 512),
               (1000, 11500, 3, 96), (1000, 11519, 10, 1024),
               (65, 11519, 16, 1024), (65, 11519, 3, 2048))
# the LSTM step also at one row, one row past a tile, narrow widths (E %
# 64 != 0, H % 128 != 0: pad units) and a width whose A is taken in chunks
LSTM_SHAPES = ((1, 256, 512), (65, 256, 512), (300, 32, 96), (70, 256, 1536))


def phase_kernels() -> dict:
    """Returns each kernel's largest |kernel - plain| over its checks."""
    lstm = max([check_lstm(N) for N in ROWS]
               + [check_lstm(*shape) for shape in LSTM_SHAPES])
    topk = max([check_topk(M, V, k) for M in ROWS
                for V in (11500, 11519) for k in (1, 3, 10)]
               + [check_topk(*shape) for shape in TOPK_SHAPES])
    for k in (1, 3, 10, 16):
        check_topk_ties(k)
    return {"fused_lstm_step": lstm, "fused_logits_top_k": topk}


# ----------------------------------------------------------------------
# phase 3, the other decode modes: int8 logits, top-k + lse over written
# logits, Gumbel-max sampling
# ----------------------------------------------------------------------

SAMPLE_TV = 0.02        # the sampler's law: total variation to softmax(x / T)
LAW_V, LAW_DRAWS = 100, 200_000


def int8_inputs(M: int, V: int, seed: int, H: int = 512):
    """h as the LSTM step returns it (f32), the head quantised per column
    from f32 weights (stored column-major), the bias."""
    h, w, b = logits_inputs(M, V, H, seed=seed)
    g = torch.Generator(device=DEV).manual_seed(seed + 1)
    wf = w.float() + 0.001 * torch.randn(w.shape, generator=g, device=DEV)
    return (h.float(), *quantize_logits_weights(wf), b)


def check_int8(M: int, V: int, k: int, H: int = 512) -> float:
    """The int32 product is exact and each dequantisation step rounds on
    its own on both sides: values and indices bit for bit, lse to its
    rtol."""
    args = int8_inputs(M, V, M + V + k, H)
    vals, idx, lse = fused_logits_top_k_int8(*args, k)
    p_vals, p_idx, p_lse = fused_logits_top_k_int8_plain(*args, k)
    torch.cuda.synchronize()
    plan = logits_plan(M, H, V, k if k <= K_MAX else 1, 1, _ext.sm_count(0))
    tag = (f"fused_logits_top_k_int8 M={M} H={H} V={V} k={k} ({plan.rows}-row blocks, h "
           f"{'resident' if plan.resident else 'streamed'}"
           f"{'; the logits written, then top_k_logsumexp' if k > K_MAX else ''})")
    err = compare_topk(tag, (vals, idx, lse), (p_vals, p_idx, p_lse))
    if not (torch.equal(vals, p_vals) and torch.equal(idx, p_idx)):
        raise AssertionError(f"{tag}: values or indices not bit-identical "
                             "to the plain version")
    print(f"{tag}: values and indices bit-identical to the plain version; "
          f"max |kernel - plain| {err:.3e} (lse)")
    return err


def unfused_logits(M: int, V: int, seed: int) -> torch.Tensor:
    """[M, V] f32 logits as the unfused decode step writes them: a bf16
    product plus the bf16 bias, rounded to bf16 (so exact ties abound)."""
    h, w, b = logits_inputs(M, V, seed=seed)
    return ((h.float() @ w.float()).to(torch.bfloat16)
            + b.to(torch.bfloat16)).float()


def planted(x: torch.Tensor) -> torch.Tensor:
    """x with ties planted where the top-k + lse kernel's parts meet: the
    row maximum at columns 0 and 3-4 (a row's 16-byte head; a lane's
    float4), 1023-1024 (a chunk of 256 float4) and V - 1 (the tail), a
    runner-up at 5, 1025 and 2047; in rows past 2200 columns, -inf over
    columns 1-1100 of every third row and at every seventh column of the
    rows after them (every row keeps at least 16 finite values)."""
    x = x.clone()
    V = x.shape[1]
    top = x.amax(dim=1) + 1.0
    for c in (0, 3, 4, 1023, 1024, V - 1):
        if c < V:
            x[:, c] = top
    for c in (5, 1025, 2047):
        if c < V:
            x[:, c] = top - 0.5
    if V > 2200:
        x[::3, 1:1101] = float("-inf")
        x[1::3, ::7] = float("-inf")
    return x


def check_topk_lse(N: int, V: int, k: int, plant: bool = False) -> float:
    """Values are copied: values and indices bit for bit, lse to its rtol."""
    x = unfused_logits(N, V, seed=N + V + k)
    if plant:
        x = planted(x)
    vals, idx, lse = top_k_logsumexp(x, k)
    p_vals, p_idx, p_lse = top_k_logsumexp_plain(x, k)
    torch.cuda.synchronize()
    tag = f"top_k_logsumexp N={N} V={V} k={k}{' (planted ties, -inf)' if plant else ''}"
    err = compare_topk(tag, (vals, idx, lse), (p_vals, p_idx, p_lse))
    if not (torch.equal(vals, p_vals) and torch.equal(idx, p_idx)):
        raise AssertionError(f"{tag}: values or indices not bit-identical "
                             "to the plain version")
    ties = int((p_vals[:, :-1] == p_vals[:, 1:]).any(dim=1).sum()) if k > 1 else 0
    print(f"{tag}: values and indices bit-identical to the plain version "
          f"({ties} rows hold an exact tie in their top {k}); max |kernel - "
          f"plain| {err:.3e} (lse)")
    return err


def sample_compare(tag: str, tokens, scores) -> tuple:
    """(rows, near-tie rows, rows that differ) of a draw against the plain
    scored values; a row may differ only where its top two scored values
    lie within TIE_GAP (logf on the card and torch.log may differ by an
    ulp, the logits by sum order)."""
    top2 = scores.topk(2, dim=1).values
    near = (top2[:, 0] - top2[:, 1]) <= TIE_GAP
    differ = tokens.long() != scores.argmax(dim=1)
    bad = differ & ~near
    if bool(bad.any()):
        raise AssertionError(f"{tag}: tokens differ from the plain sampler in "
                             f"{int(bad.sum())} rows without a near-tie")
    return int(tokens.numel()), int(near.sum()), int(differ.sum())


def check_sample(M: int, V: int, H: int = 512, temperature: float = 0.8) -> float:
    h, w, b = logits_inputs(M, V, H, seed=M + V)
    tokens = fused_logits_sample(h, w, b, 4321, 6, temperature)
    scores = sample_scores(h, w, b, 4321, 6, temperature)
    torch.cuda.synchronize()
    tag = f"fused_logits_sample M={M} H={H} V={V} T={temperature}"
    rows, near, differ = sample_compare(tag, tokens, scores)
    picked = scores.gather(1, tokens.long()[:, None])[:, 0]
    err = float((picked - scores.max(dim=1).values).abs().max())
    print(f"{tag}: tokens equal to the plain sampler's in {rows - differ} of "
          f"{rows} rows, near-tie rows {near}; max |scored value of the "
          f"kernel's token - plain max| {err:.3e}")
    return err


def check_sample_law() -> None:
    """LAW_DRAWS draws of one row at V = LAW_V: total variation to
    softmax(logits / T) below SAMPLE_TV at three temperatures."""
    h, w, b = logits_inputs(1, LAW_V, seed=77)
    w = (w.float() * 8).to(torch.bfloat16)      # a law with some spread
    vals, idx, _ = fused_logits_top_k_plain(h, w, b, LAW_V)
    logits = torch.empty(LAW_V, device=DEV).scatter_(0, idx[0].long(), vals[0])
    hs = h.expand(LAW_DRAWS, h.shape[1]).contiguous()
    for step, t in enumerate((0.7, 1.0, 1.5)):
        tokens = fused_logits_sample(hs, w, b, 2024, step, t)
        freq = torch.bincount(tokens.long(), minlength=LAW_V).double() / LAW_DRAWS
        p = torch.softmax(logits.double() / t, dim=0)
        tv = float(0.5 * (freq - p).abs().sum())
        print(f"fused_logits_sample law V={LAW_V} T={t}: {LAW_DRAWS} draws, TV "
              f"to softmax(logits / T) {tv:.5f} (tolerance {SAMPLE_TV}); "
              f"largest p {float(p.max()):.4f}")
        if tv >= SAMPLE_TV:
            raise AssertionError(f"fused_logits_sample law T={t}: TV {tv:.4f}")


# the int8 top-k also at one row and one row past a block with lists of
# 16 (64-row blocks), at H = 1024 and at H = 2624 (h streamed): (M, V, k,
# H); the sampler also at one row, H = 96 and H = 1024: (M, V, H)
INT8_SHAPES = ((1, 11519, 16, 512), (65, 11500, 16, 512), (1000, 11500, 3, 1024),
               (65, 11519, 10, 2624))
SAMPLE_SHAPES = ((512, 11500, 512), (1000, 11519, 512), (1, 11519, 512),
                 (65, 11500, 96), (65, 11519, 1024))


# the top-k + lse kernel's further shapes (N, V, k), with planted ties and
# -inf: one row, rows past a persistent grid's warps, misaligned rows
# (V = 11519), lists of 16 and of 1, and rows shorter than a float4
LSE_SHAPES = ((1536, 11519, 10), (5120, 11500, 3), (1, 11519, 16), (2113, 11519, 1),
              (13, 1000, 16), (13, 3, 3))


def phase_mode_kernels() -> dict:
    """The int8 kernel at every (rows, vocab, k) the main paths give the
    top-k kernel and INT8_SHAPES, the top-k + lse kernel at beam 3 and
    beam 10 (N = 1536, 5120), the ragged N = 1000, V = 11519, LSE_SHAPES
    and the lists past 16 of WIDE_LSE_SHAPES, the sampler at
    SAMPLE_SHAPES, and the sampler's law."""
    int8 = max([check_int8(M, V, k) for M in ROWS for V in (11500, 11519)
                for k in (1, 3, 10)] + [check_int8(*shape) for shape in INT8_SHAPES])
    lse = max([check_topk_lse(N, V, k) for N, V in ((1536, 11500), (5120, 11500),
                                                    (1000, 11519))
               for k in (3, 10)]
              + [check_topk_lse(N, V, k, plant=True)
                 for N, V, k in LSE_SHAPES + WIDE_LSE_SHAPES])
    sample = max(check_sample(*shape) for shape in SAMPLE_SHAPES)
    check_sample_law()
    return {"fused_logits_top_k_int8": int8, "top_k_logsumexp": lse,
            "fused_logits_sample": sample}


def turns(fn_kernel, fn_plain, timer) -> tuple:
    """(kernel, plain) times, measured in turns kernel, plain, plain,
    kernel and averaged, so drift in clocks hits both alike."""
    k1, p1, p2, k2 = timer(fn_kernel), timer(fn_plain), timer(fn_plain), timer(fn_kernel)
    return (k1 + k2) / 2, (p1 + p2) / 2


def timing(t: tuple, b: tuple, library_ms=None) -> dict:
    """A kernel's record: (kernel, plain) ms, (bound ms, what binds it)
    and the library call's ms (None where no one PyTorch call computes
    the same function)."""
    return {"ms": t[0], "plain_ms": t[1], "bound_ms": b[0], "bound_by": b[1],
            "library_ms": library_ms}


def lstm_cell_call(x, c, h, w, b):
    """torch.lstm_cell on the same inputs in bf16 (gate order i, f, g, o
    as the kernel's), the forget bias of 1 folded into its input bias."""
    E, H = x.shape[1], c.shape[1]
    bias = b.clone()
    bias[H:2 * H] += 1.0
    bias = bias.to(torch.bfloat16)
    args = (x, (h.to(torch.bfloat16), c.to(torch.bfloat16)),
            w[:E].t().contiguous(), w[E:].t().contiguous(), bias,
            torch.zeros_like(bias))
    return lambda: torch.lstm_cell(*args)


def logits_yardstick(kernel, plain, library) -> tuple:
    """(kernel, plain, library) ms by CUDA events in turns (kernel, plain,
    library, library, plain, kernel), then the card's own time (device_ms)
    of the kernel and the library in turns, and the host's time per call
    of the kernel's wrapper: ((kernel, plain), library, (device kernel,
    device library), host us)."""
    k1, p1, l1 = cuda_ms(kernel), cuda_ms(plain), cuda_ms(library)
    l2, p2, k2 = cuda_ms(library), cuda_ms(plain), cuda_ms(kernel)
    d = [sum(device_ms(fn).values()) for fn in (kernel, library, library, kernel)]
    return (((k1 + k2) / 2, (p1 + p2) / 2), (l1 + l2) / 2,
            ((d[0] + d[3]) / 2, (d[1] + d[2]) / 2), host_us(kernel))


def topk_library_call(h, w, b, k):
    """The library chain of the fused logits + top-k on the same inputs:
    ``F.linear`` in bf16 (the logits written), then ``torch.topk`` and
    ``torch.logsumexp``."""
    wt, b16 = w.t().contiguous(), b.to(torch.bfloat16)

    def call():
        logits = F.linear(h, wt, b16)
        return torch.topk(logits, k, dim=-1), torch.logsumexp(logits, dim=-1)

    return call


def phase_kernel_times(label: str) -> dict:
    """Each kernel against its plain version at the main path's shapes:
    beam 3 (N = M = 1536, k = 3), beam 10 (5120, k = 10) and greedy (512,
    k = 1).  The record keeps the beam-3 shapes, with the bound and the
    library: for the LSTM step ``torch.lstm_cell`` (in bf16) on the same
    inputs, for the fused logits + top-k the chain ``F.linear`` bf16 +
    ``torch.topk`` + ``torch.logsumexp``."""
    times = {}
    for N in (1536, 5120, 512):
        args = lstm_inputs(N)
        t = turns(lambda: fused_lstm_step(*args),
                  lambda: fused_lstm_step_plain(*args), cuda_ms)
        lib = cuda_ms(lstm_cell_call(*args))
        x, c, h, w, b = args
        E, H = x.shape[1], c.shape[1]
        plan = lstm_step_plan(N, E, H)
        other = lstm_step_geometry(N, E, H, 96 - plan.units)
        t_other = cuda_ms(lambda: lstm_step_kernel(*args, 1.0, other))
        bnd = bound(2.0 * N * (E + H) * 4 * H, nbytes(*args, c, h))
        times.setdefault("fused_lstm_step", timing(t, bnd, lib))
        print(f"time fused_lstm_step N={N} E=256 H=512: kernel {t[0]:.4f} "
              f"ms (U = {plan.units}; U = {other.units}: {t_other:.4f} ms), "
              f"plain {t[1]:.4f} ms, torch.lstm_cell (bf16) {lib:.4f} ms, "
              f"bound {bnd[0]:.4f} ms ({bnd[1]}) [{label}]")
        # back to back, both calls can be bound by the host: the card's
        # own time and the host's per call beside them
        step, cell = lambda: fused_lstm_step(*args), lstm_cell_call(*args)
        dev, dev_lib = device_ms(step), device_ms(cell)
        print(f"time fused_lstm_step N={N}: device {sum(dev.values()):.4f} ms, "
              f"torch.lstm_cell device {sum(dev_lib.values()):.4f} ms ("
              + ", ".join(f"{kernel_name(k)[:40]} {v:.4f}" for k, v in dev_lib.items())
              + f"); host per call {host_us(step):.1f} / {host_us(cell):.1f} us "
              f"[{label}]")
    for M, k in ((1536, 3), (5120, 10), (512, 1)):
        # the head in the layout the decode stores it: no per-call transpose
        h, w, b = logits_inputs(M, 11500)
        t, lib, dev, host = logits_yardstick(
            lambda: fused_logits_top_k(h, w, b, k),
            lambda: fused_logits_top_k_plain(h, w, b, k), topk_library_call(h, w, b, k))
        outs = fused_logits_top_k(h, w, b, k)
        bnd = bound(2.0 * M * h.shape[1] * w.shape[1], nbytes(h, w, b, *outs))
        times.setdefault("fused_logits_top_k", timing(t, bnd, lib))
        plan = logits_plan(M, h.shape[1], w.shape[1], k, 2, _ext.sm_count(0))
        print(f"time fused_logits_top_k M={M} H=512 V=11500 k={k}: kernel "
              f"{t[0]:.4f} ms, plain {t[1]:.4f} ms, F.linear bf16 + torch.topk "
              f"+ torch.logsumexp {lib:.4f} ms, bound {bnd[0]:.4f} ms "
              f"({bnd[1]}); device: kernel {dev[0]:.4f} ms, library {dev[1]:.4f} "
              f"ms; host per call {host:.1f} us ({plan.rows}-row blocks, "
              f"{plan.chunks} chunks of {plan.chunk_tiles} tiles) [{label}]")
    return times


def int8_library_call(hq, hs, wq, ws, b, k):
    """The int8 yardstick on the same quantised rows: ``torch._int_mm``
    (cuBLAS int8; its output width padded to a multiple of 8, as it
    requires), the same dequantisation, ``torch.topk`` and
    ``torch.logsumexp``."""
    V = wq.shape[1]
    wq_pad = torch.nn.functional.pad(wq, (0, (-V) % 8)).contiguous()

    def call():
        logits = torch._int_mm(hq, wq_pad)[:, :V].float() * hs * ws + b
        return torch.topk(logits, k, dim=1), torch.logsumexp(logits, dim=1)

    return call


def phase_mode_kernel_times(label: str) -> dict:
    """The three mode kernels against their plain versions and a library
    yardstick, at the main paths' shapes; the record keeps the first
    shape of each.  int8 at beam 3 (M = 1536, k = 3), beam 10 and greedy,
    all three on the same quantised rows (the wrapper's per-row
    quantisation of h, plain PyTorch ops, is timed beside them); the
    sampler at the greedy
    batch (M = 512); top-k + lse at beam 3 and beam 10 (N = 1536, 5120)
    and past lists of 16, beam 20 and 32 of 512 images (N = 10240, 16384).
    Bounds: int8 operations over the int8 peak, bf16 ones over the bf16
    peak, the logits' bytes over the memory rate."""
    times = {}
    H = 512
    for M, k in ((1536, 3), (5120, 10), (512, 1)):
        h, wq, ws, b = int8_inputs(M, 11500, seed=M)
        hq, hs = quantize_rows(h)
        t, lib, dev, host = logits_yardstick(
            lambda: int8_top_k_kernel(hq, hs, wq, ws, b, k),
            lambda: int8_top_k_plain(hq, hs, wq, ws, b, k),
            int8_library_call(hq, hs, wq, ws, b, k))
        quant = cuda_ms(lambda: quantize_rows(h))
        outs = int8_top_k_kernel(hq, hs, wq, ws, b, k)
        bnd = bound(2.0 * M * H * wq.shape[1], nbytes(hq, hs, wq, ws, b, *outs),
                    PEAK_INT8)
        times.setdefault("fused_logits_top_k_int8", timing(t, bnd, lib))
        print(f"time fused_logits_top_k_int8 M={M} H={H} V=11500 k={k}: kernel "
              f"{t[0]:.4f} ms, plain {t[1]:.4f} ms, library (torch._int_mm + "
              f"dequantise + torch.topk + torch.logsumexp) {lib:.4f} ms, bound "
              f"{bnd[0]:.4f} ms ({bnd[1]}); device: kernel {dev[0]:.4f} ms, "
              f"library {dev[1]:.4f} ms; host per call {host:.1f} us; the "
              f"wrapper's quantisation of h {quant:.4f} ms [{label}]")
    M, T = 512, 0.8
    h, w, b = logits_inputs(M, 11500)
    w_lin = w.t()                               # nn.Linear's [V, H], contiguous

    def multinomial():
        return torch.multinomial(torch.softmax(
            (torch.nn.functional.linear(h, w_lin).float() + b) / T, dim=1), 1)

    t, lib, dev, host = logits_yardstick(
        lambda: fused_logits_sample(h, w, b, 5, 1, T),
        lambda: fused_logits_sample_plain(h, w, b, 5, 1, T), multinomial)
    bnd = bound(2.0 * M * H * w.shape[1],
                nbytes(h, w, b, fused_logits_sample(h, w, b, 5, 1, T)))
    times["fused_logits_sample"] = timing(t, bnd, lib)
    print(f"time fused_logits_sample M={M} H={H} V=11500 T={T}: kernel "
          f"{t[0]:.4f} ms, plain {t[1]:.4f} ms, library (F.linear bf16 + "
          f"torch.multinomial(softmax(logits / T))) {lib:.4f} ms, bound "
          f"{bnd[0]:.4f} ms ({bnd[1]}); device: kernel {dev[0]:.4f} ms, "
          f"library {dev[1]:.4f} ms; host per call {host:.1f} us [{label}]")
    for N, k in ((1536, 3), (5120, 10), (10240, 20), (16384, 32)):
        x = unfused_logits(N, 11500, seed=N)
        t, lib, dev, host = logits_yardstick(
            lambda: top_k_logsumexp(x, k), lambda: top_k_logsumexp_plain(x, k),
            lambda: (torch.topk(x, k, dim=1), torch.logsumexp(x, dim=1)))
        bnd = bound(0.0, nbytes(x, *top_k_logsumexp(x, k)))
        times.setdefault("top_k_logsumexp", timing(t, bnd, lib))
        print(f"time top_k_logsumexp N={N} V=11500 k={k}: kernel {t[0]:.4f} "
              f"ms, plain {t[1]:.4f} ms, library (torch.topk + "
              f"torch.logsumexp, in turns) {lib:.4f} ms, bound {bnd[0]:.4f} ms "
              f"({bnd[1]}); device: kernel {dev[0]:.4f} ms (share "
              f"{bnd[0] / dev[0]:.3f}), library {dev[1]:.4f} ms; host per call "
              f"{host:.1f} us [{label}]")
    return times


# ----------------------------------------------------------------------
# phase 4: the main path at full width
# ----------------------------------------------------------------------

BATCH = 512


def full_width_model():
    """The AG-CVAE with cluster vectors at the reference's widths, with
    random weights drawn by numpy from a seed in the Flax layout and
    loaded through the bridge."""
    cfg = Config(prior="AG", use_c_v=True, embed_size=256, decoder_hidden=512,
                 latent_size=150, gen_z_samples=100, cnn_feature_size=4096,
                 num_clusters=90, gen_max_len=30, compute_dtype="bfloat16",
                 beam_size=3, gen_batch_size=BATCH, gen_name="beam3")
    words = [f"w{i}" for i in range(11500 - 4)]
    vocab = Vocabulary(["<BOS>", "<EOS>", "<UNK>"] + words)
    cfg.vocab_size = vocab.vocab_size
    model = CVAEModel.from_config(cfg)
    # the encoder (unused in decoding) draws from a stream of its own, so
    # every decode weight is the same draw whatever the encoder holds
    rng = np.random.default_rng(cfg.seed)
    enc_rng = np.random.default_rng(cfg.seed + 1)
    params = {}
    for key, shape in flax_shapes(model).items():
        if key.startswith("encoder/"):
            params[key] = 0.01 * enc_rng.standard_normal(shape, dtype=np.float32)
            continue
        if key.endswith("/embedding"):
            params[key] = rng.standard_normal(shape, dtype=np.float32)
        elif key.endswith("/bias"):
            params[key] = 0.01 * rng.standard_normal(shape, dtype=np.float32)
        else:  # Flax kernels: xavier-uniform bound over [in, out]
            lim = np.float32((6.0 / (shape[0] + shape[1])) ** 0.5)
            params[key] = (2 * rng.random(shape, dtype=np.float32) - 1) * lim
    load_flax_params(model, params)   # raises on a key left over or missing
    return cfg, vocab, model.to(DEV).eval()


def batchers(n_images: int, split: str, vocab, seed: int):
    """A CaptionBatcher over an in-memory FeatureStore: synthetic names,
    features and cluster vectors (a few detections per image; every
    tenth image has none and takes the AG fallback)."""
    rng = np.random.default_rng(seed)
    names = [f"COCO_{split}_{i:012d}.jpg" for i in range(n_images)]
    feats = np.maximum(rng.standard_normal((n_images, 4096), dtype=np.float32), 0)
    store = FeatureStore(names, feats)
    c_v = {}
    for i, name in enumerate(names):
        vec = np.zeros(91, np.float32)
        if i % 10:
            vec[rng.integers(1, 91, size=rng.integers(1, 4))] = 1.0
        c_v[name] = vec
    caps = {n: [[vocab.bos_id, 4, 5, vocab.eos_id]] for n in names}
    return CaptionBatcher(names, caps if split == "val" else {}, BATCH,
                          feature_store=store, cluster_vectors=c_v,
                          filename_to_imid={n: i for i, n in enumerate(names)})


def read_captions(path: str, n: int) -> list:
    with open(path) as f:
        caps = json.load(f)
    if len(caps) != n or sorted(c["image_id"] for c in caps) != list(range(n)):
        raise AssertionError(f"{path}: {len(caps)} captions, want {n}")
    if not all(isinstance(c["caption"], str) for c in caps):
        raise AssertionError(f"{path}: a caption is not a string")
    return caps


def phase_main_path(out_dir: str):
    cfg, vocab, model = full_width_model()
    n_init = 3  # LSTM steps of decode_init: image, c_v, z
    _ext.reset_launches()   # the main path's run starts here
    stats3, stats10 = {}, {}
    t0 = time.perf_counter()
    paths = run_inference(cfg, model, vocab, batchers(2 * BATCH, "val", vocab, 1),
                          batchers(BATCH, "test", vocab, 2), out_dir, stats3)
    cfg10 = cfg.replace(beam_size=10, gen_name="beam10")
    paths10 = run_inference(cfg10, model, vocab,
                            batchers(BATCH, "val", vocab, 3), None, out_dir,
                            stats10)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: _ext.LAUNCHES[k] for k in DECODE_KERNELS}  # right after
    runs = [stats3["val"], stats3["test"], stats10["val"]]
    steps = sum(r["decode_steps"] for r in runs)
    batches = sum(r["batches"] for r in runs)
    want = {"fused_lstm_step": n_init * batches + steps,
            "fused_logits_top_k": steps}
    print(f"main path: {batches} batches, {steps} decode steps in "
          f"{seconds:.2f} s; launches {launches}, expected {want}")
    if launches != want:
        raise AssertionError(f"launch counts {launches} != expected {want}")
    read_captions(paths["val"], 2 * BATCH)
    read_captions(paths["test"], BATCH)
    read_captions(paths10["val"], BATCH)
    return cfg, vocab, model, launches


STEP_SHARE = 0.99      # per-step top-k agreement from the same carry
CAPTION_MARGIN = 0.03  # see phase_decode_compare
DECODE_SEEDS = (4, 8, 12)


class CheckedOps:
    """The kernels, each checked against its plain version on the same
    inputs at every call: c', h' to LSTM_ATOL; top-k values and lse to
    their rtol (bf16, int8 and over written logits); indices equal in
    every row whose plain top-(k+1) values hold no near-tie (TIE_GAP);
    sampled tokens equal in every row whose top two scored values hold no
    near-tie."""

    def __init__(self):
        self.rows = self.same = self.near = self.bad = 0
        self.state_err = 0.0

    def lstm_step(self, x, c, h, w, b):
        got = fused_lstm_step(x, c, h, w, b)
        want = fused_lstm_step_plain(x, c, h, w, b)
        err = max(float((a - r).abs().max()) for a, r in zip(got, want))
        if err > LSTM_ATOL:
            raise AssertionError(f"decode: LSTM state differs by {err:.3e}")
        self.state_err = max(self.state_err, err)
        return got

    def _tally(self, tag: str, got, plain, k: int):
        """``plain``: the plain version's top-(k+1) and lse."""
        p_vals, p_idx, p_lse = plain
        compare_topk(tag, got, (p_vals[:, :k], p_idx[:, :k], p_lse))
        same = (got[1] == p_idx[:, :k]).all(dim=1)
        near = ((p_vals[:, :k] - p_vals[:, 1:]) <= TIE_GAP).any(dim=1)
        self.rows += int(same.numel())
        self.same += int(same.sum())
        self.near += int(near.sum())
        self.bad += int((~same & ~near).sum())
        return got

    def logits_top_k(self, h, w, b, k):
        return self._tally(f"decode top-{k}", fused_logits_top_k(h, w, b, k),
                           fused_logits_top_k_plain(h, w, b, k + 1), k)

    def logits_top_k_int8(self, h, wq, ws, b, k):
        return self._tally(f"decode int8 top-{k}",
                           fused_logits_top_k_int8(h, wq, ws, b, k),
                           fused_logits_top_k_int8_plain(h, wq, ws, b, k + 1), k)

    def top_k_lse(self, x, k):
        return self._tally(f"decode top-{k} over logits", top_k_logsumexp(x, k),
                           top_k_logsumexp_plain(x, k + 1), k)

    def logits_sample(self, h, w, b, seed, step, temperature):
        got = fused_logits_sample(h, w, b, seed, step, temperature)
        rows, near, differ = sample_compare(
            f"decode sample step {step}", got,
            sample_scores(h, w, b, seed, step, temperature))
        self.rows += rows
        self.same += rows - differ
        self.near += near
        return got

    def ops(self) -> DecodeOps:
        return DecodeOps(self.lstm_step, self.logits_top_k,
                         self.logits_top_k_int8, self.logits_sample,
                         self.top_k_lse)


def phase_decode_compare(cfg, vocab, model,
                         modes=(("beam 3", 3), ("beam 10", 10), ("greedy", 1)),
                         seeds=DECODE_SEEDS) -> dict:
    """Batches of 512 images decoded at beam 3, beam 10 and greedy, with
    the same z noise, three ways: through the kernels, each call checked
    against its plain version (CheckedOps); through the plain versions;
    and through the plain versions with every dot product summed in
    reverse order (REORDERED_OPS).

    Per step the kernels must agree with the plain versions as CheckedOps
    says, and the top-k indices in at least STEP_SHARE of rows.

    Whole captions: two bf16 decodes whose f32 sums run in another order
    drift apart.  c', h' differ by about 1e-6; now and then that flips an
    element of bf16(h), which moves the logits by a bf16 step of h times
    W, and over 30 steps some near-even choices go the other way.  The
    reversed-sum plain decode measures how far that alone goes, so the
    share of best-beam captions identical to the plain decode's must be,
    for the kernels, at least the reversed-sum decode's share less
    CAPTION_MARGIN (at shares near 0.98, about six standard deviations of
    the difference of two shares over 1,536 rows).  Matched rows' scores agree to rtol 1e-4.
    ``modes`` (name, beam; 1 is greedy) and ``seeds`` (a batch each) pick
    the decodes.  Returns {mode: (kernel share, reversed-sum share)}."""
    shares = {}
    for mode, beam in modes:
        c = cfg if beam == 1 else cfg.replace(beam_size=beam)
        fn_name = "greedy" if beam == 1 else "beam_search"
        checked = CheckedOps()
        fns = {name: make_decode_fns(model, c, vocab, ops=ops)[fn_name]
               for name, ops in (("kernel", checked.ops()),
                                 ("plain", PLAIN_OPS),
                                 ("reordered", REORDERED_OPS))}
        same = {"kernel": [], "reordered": []}
        score_err = 0.0
        for seed in seeds:
            batch = next(batchers(BATCH, "val", vocab, seed).eval_batches())
            feats = torch.from_numpy(batch.features).to(DEV)
            c_v = torch.from_numpy(batch.cluster_vectors).to(DEV)
            g = torch.Generator(device=DEV).manual_seed(seed + 1)
            eps = torch.randn((BATCH, cfg.embed_size), generator=g, device=DEV)
            res = {name: fn(feats, c_v, eps=eps) for name, fn in fns.items()}
            want = res["plain"]
            for name in same:
                got = res[name]
                if not bool(((got.tokens >= 0)
                             & (got.tokens < vocab.vocab_size)).all()):
                    raise AssertionError(f"{mode} {name}: a token out of range")
                rows = (got.tokens == want.tokens).all(dim=1)
                same[name].append(float(rows.float().mean()))
                if (name == "kernel" and got.scores is not None
                        and bool(rows.any())):
                    if not bool(torch.isfinite(got.scores).all()):
                        raise AssertionError(f"{mode}: non-finite beam scores")
                    rel = ((got.scores - want.scores).abs()
                           / want.scores.abs())[rows]
                    score_err = max(score_err, float(rel.max()))
        step_share = checked.same / checked.rows
        k_share = sum(same["kernel"]) / len(seeds)
        r_share = sum(same["reordered"]) / len(seeds)
        per = lambda xs: ", ".join(f"{x:.4f}" for x in xs)  # noqa: E731
        print(f"decode compare {mode} ({len(seeds)} batches of {BATCH} "
              f"images, seeds {seeds}): per step, top-{beam} indices "
              f"identical in {step_share:.5f} of {checked.rows} rows, near-tie "
              f"rows {checked.near}, max |c', h' kernel - plain| "
              f"{checked.state_err:.3e}")
        print(f"decode compare {mode}: best-beam captions identical to the "
              f"plain decode's: kernels {k_share:.4f} ({per(same['kernel'])}), "
              f"plain summed in reverse {r_share:.4f} "
              f"({per(same['reordered'])}); max score rel diff "
              f"{score_err:.3e} over the kernels' identical rows")
        if checked.bad or step_share < STEP_SHARE:
            raise AssertionError(f"{mode}: decode steps disagree in "
                                 f"{checked.bad} rows without a near-tie")
        if k_share < r_share - CAPTION_MARGIN or score_err > 1e-4:
            raise AssertionError(f"{mode}: the kernel decode drifts from the "
                                 "plain decode further than the reversed-sum "
                                 "plain decode does")
        shares[mode] = (k_share, r_share)
    return shares


# the decode modes beside the bf16 fused decode, each a Config override
MODES = {
    "decode-sample": dict(sample_gen="sample", gen_name="sample"),
    "decode-int8": dict(decode_int8=True, gen_name="beam3_int8"),
    "decode-unfused": dict(fused_decode=False, gen_name="beam3_unfused"),
}


def phase_mode_paths(cfg, vocab, model, out_dir: str) -> dict:
    """Each decode mode's path on the full-width AG-CVAE through
    ``run_inference``: val split of 512 images (sampled at T =
    cfg.temperature, or beam 3), test split of 512 images greedy.  The
    launch counts are set to 0 just before each path and read just after:
    its logits kernel once per step (the sample path's greedy test split
    takes the bf16 top-k), the LSTM step 3 times per batch plus once per
    step, every other decode kernel 0.  Returns each mode kernel's
    launches on its path."""
    launches = {}
    for path, kernel in MODE_PATHS.items():
        c = cfg.replace(**MODES[path])
        stats = {}
        torch.cuda.synchronize()
        _ext.reset_launches()   # this path's run starts here
        t0 = time.perf_counter()
        written = run_inference(c, model, vocab, batchers(BATCH, "val", vocab, 21),
                                batchers(BATCH, "test", vocab, 22), out_dir, stats)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {k: _ext.LAUNCHES[k] for k in DECODE_KERNELS + MODE_KERNELS}
        val, test = stats["val"]["decode_steps"], stats["test"]["decode_steps"]
        batches = stats["val"]["batches"] + stats["test"]["batches"]
        want = {k: 0 for k in counts}
        want["fused_lstm_step"] = 3 * batches + val + test
        if path == "decode-sample":
            want.update(fused_logits_sample=val, fused_logits_top_k=test)
        elif path == "decode-int8":
            want["fused_logits_top_k_int8"] = val + test
        else:                           # greedy takes torch.argmax
            want["top_k_logsumexp"] = val
        print(f"{path} path: {batches} batches ({val} val steps, {test} test "
              f"steps) in {seconds:.2f} s; launches {counts}, expected {want}")
        if counts != want:
            raise AssertionError(f"{path} launch counts {counts} != {want}")
        read_captions(written["val"], BATCH)
        read_captions(written["test"], BATCH)
        launches[kernel] = counts[kernel]
    return launches


MODE_CASES = (("int8 beam 3", "decode-int8", "beam_search"),
              ("int8 greedy", "decode-int8", "greedy"),
              ("unfused beam 3", "decode-unfused", "beam_search"),
              ("unfused greedy", "decode-unfused", "greedy"),
              ("sample", "decode-sample", "sample"))


def phase_mode_compare(cfg, vocab, model, cases=MODE_CASES,
                       seeds=DECODE_SEEDS) -> None:
    """Batches of 512 images, with the same z noise (and, sampling, the
    same generator seed), through the kernels, each call checked against
    its plain version (CheckedOps), and through the plain versions: beam 3
    and greedy with int8 logits and unfused, and sampling.  Per step the
    kernels must agree as CheckedOps says, in at least STEP_SHARE of rows.
    Printed, not held: the share of whole captions identical to the plain
    decode's, and for int8 the share of best-beam captions identical to
    the bf16 fused decode's (the quality gate waits for a trained
    checkpoint).  ``cases`` (name, MODES path, decode fn) and ``seeds`` (a
    batch each) pick the decodes."""
    for mode, path, fn_name in cases:
        c = cfg.replace(**MODES[path])
        checked = CheckedOps()
        fns = {name: make_decode_fns(model, cc, vocab, ops=ops)[fn_name]
               for name, cc, ops in (("kernel", c, checked.ops()),
                                     ("plain", c, PLAIN_OPS),
                                     ("bf16", cfg, DecodeOps()))
               if name != "bf16" or path == "decode-int8"}
        same = {"plain": [], "bf16": []}
        for seed in seeds:
            batch = next(batchers(BATCH, "val", vocab, seed).eval_batches())
            feats = torch.from_numpy(batch.features).to(DEV)
            c_v = torch.from_numpy(batch.cluster_vectors).to(DEV)
            g = torch.Generator(device=DEV).manual_seed(seed + 1)
            eps = torch.randn((BATCH, cfg.embed_size), generator=g, device=DEV)
            res = {name: fn(feats, c_v, eps=eps,
                            generator=torch.Generator(device=DEV).manual_seed(seed))
                   for name, fn in fns.items()}
            got = res["kernel"]
            if not bool(((got.tokens >= 0) & (got.tokens < vocab.vocab_size)).all()):
                raise AssertionError(f"{mode}: a token out of range")
            if got.scores is not None and not bool(torch.isfinite(got.scores).all()):
                raise AssertionError(f"{mode}: non-finite beam scores")
            for name in same:
                if name in res:
                    rows = (got.tokens == res[name].tokens).all(dim=1)
                    same[name].append(float(rows.float().mean()))
        # unfused greedy takes torch.argmax: only its LSTM steps are checked
        step_share = checked.same / checked.rows if checked.rows else 1.0
        per = lambda xs: ", ".join(f"{x:.4f}" for x in xs)  # noqa: E731
        logits = (f"logits-kernel choices identical to the plain version's in "
                  f"{step_share:.5f} of {checked.rows} rows, near-tie rows "
                  f"{checked.near}" if checked.rows else "no logits kernel")
        print(f"decode compare {mode} ({len(seeds)} batches of {BATCH} "
              f"images): per step, max |c', h' kernel - plain| "
              f"{checked.state_err:.3e}, {logits}; whole captions identical to the plain "
              f"decode's {sum(same['plain']) / len(seeds):.4f} "
              f"({per(same['plain'])})"
              + (f"; best-beam captions identical to the bf16 fused decode's "
                 f"{sum(same['bf16']) / len(seeds):.4f} ({per(same['bf16'])})"
                 if same["bf16"] else ""))
        if checked.bad or step_share < STEP_SHARE:
            raise AssertionError(f"{mode}: decode steps disagree in "
                                 f"{checked.bad} rows without a near-tie")


def phase_decode_times(cfg, vocab, model, label: str, cases=None) -> None:
    """ms per decode batch of 512 images and captions/s, kernel path vs
    plain path, by the host clock around work that ends in a copy of the
    tokens to the host: the bf16 fused decode at beam 3, beam 10 and
    greedy, and the sample, int8 and unfused modes, or ``cases`` (name,
    config, decode fn)."""
    batch = next(batchers(BATCH, "val", vocab, 6).eval_batches())
    feats = torch.from_numpy(batch.features).to(DEV)
    c_v = torch.from_numpy(batch.cluster_vectors).to(DEV)

    def host_ms(fn):
        fn()                                   # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            fn().tokens.cpu()
        return (time.perf_counter() - t0) / 3 * 1e3

    for name, c, fn_name in cases or (
            ("beam 3", cfg, "beam_search"),
            ("beam 10", cfg.replace(beam_size=10), "beam_search"),
            ("greedy", cfg, "greedy"),
            ("sample", cfg.replace(**MODES["decode-sample"]), "sample"),
            ("beam 3 int8", cfg.replace(**MODES["decode-int8"]), "beam_search"),
            ("greedy int8", cfg.replace(**MODES["decode-int8"]), "greedy"),
            ("beam 3 unfused", cfg.replace(**MODES["decode-unfused"]), "beam_search"),
            ("greedy unfused", cfg.replace(**MODES["decode-unfused"]), "greedy")):
        kern = make_decode_fns(model, c, vocab)[fn_name]
        plain = make_decode_fns(model, c, vocab, ops=PLAIN_OPS)[fn_name]
        g = torch.Generator(device=DEV).manual_seed(7)
        tk, tp = turns(lambda: kern(feats, c_v, generator=g),
                       lambda: plain(feats, c_v, generator=g), host_ms)
        steps = kern(feats, c_v, generator=g).steps
        print(f"time decode {name}, {BATCH} images, {steps} steps: kernel "
              f"{tk:.2f} ms/batch ({BATCH / tk * 1e3:.0f} captions/s), plain "
              f"{tp:.2f} ms/batch ({BATCH / tp * 1e3:.0f} captions/s) [{label}]")


# ----------------------------------------------------------------------
# phase 3, train path: fused_lstm_seq and fused_z against their plain
# versions
# ----------------------------------------------------------------------

# fused_lstm_seq: f32 sums in another order can flip an element of
# bf16(h), which moves the later steps by ~1e-3, and the flips compound
# over T; so c_T, h_T and hs to SEQ_RTOL of their largest element and
# SEQ_SHARE of their elements to SEQ_ATOL; every gradient (and the
# activated gates, bf16) to SEQ_RTOL of its largest element.
SEQ_RTOL = 1e-2
SEQ_ATOL = 1e-4
SEQ_SHARE = 0.99
# fused_z: the bf16 output to one bf16 step (Z_OUT_RTOL of its largest
# element); the f32 gradients to Z_GRAD_RTOL of theirs; the eps stream's
# words and normals bit for bit; the moments over one step's draws.
Z_OUT_RTOL = 1e-2
Z_GRAD_RTOL = 1e-3
MEAN_TOL = 1e-3
VAR_TOL = 2e-3
# the train path's shapes: B = 256 images x K = 5 captions, T = 24
TRAIN_IMAGES, TRAIN_CAPTIONS, TRAIN_T = 256, 5, 24
TRAIN_ROWS = TRAIN_IMAGES * TRAIN_CAPTIONS
RAGGED_ROWS = 1000
LATENT, KZ, EMBED, HIDDEN, VOCAB = 150, 100, 256, 512, 11500


def rel_err(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """(max |a - b|, that over max |b|), in f32."""
    a, b = a.detach().float(), b.detach().float()
    err = float((a - b).abs().max())
    return err, err / max(float(b.abs().max()), 1e-30)


def seq_inputs(T: int, N: int, seed: int, E: int = EMBED, H: int = HIDDEN):
    """x, wx, wh (bf16), b, c0, h0 and lengths in 1..T with one row of
    length 1 and one of length T."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    lim = (6.0 / (E + H + 4 * H)) ** 0.5      # the Flax xavier_uniform bound
    w = ((torch.rand((E + H, 4 * H), generator=g, device=DEV) * 2 - 1) * lim
         ).to(torch.bfloat16)
    lengths = torch.randint(1, T + 1, (N,), generator=g, device=DEV,
                            dtype=torch.int32)
    lengths[0], lengths[-1] = 1, T
    return (torch.randn((T, N, E), generator=g, device=DEV).to(torch.bfloat16),
            w[:E].contiguous(), w[E:].contiguous(),
            0.1 * torch.randn((4 * H,), generator=g, device=DEV),
            torch.randn((N, H), generator=g, device=DEV),
            torch.tanh(torch.randn((N, H), generator=g, device=DEV)), lengths)


def check_lstm_seq(T: int, N: int, E: int = EMBED, H: int = HIDDEN) -> tuple:
    """Returns (forward, backward) max |kernel - plain|; each runs twice
    and must repeat bit for bit."""
    args = seq_inputs(T, N, seed=T + N + H, E=E, H=H)
    tag = f"fused_lstm_seq T={T} N={N} E={E} H={H}"
    got = lstm_seq_fwd_kernel(*args)
    for name, a, r in zip(("hs", "cs", "gates", "h_T"), got,
                          lstm_seq_fwd_kernel(*args)):
        if not torch.equal(a, r):
            raise AssertionError(f"{tag} forward: two calls gave another {name}")
    want = lstm_seq_fwd_plain(*args)
    lengths = args[6]
    if not bool((got[0][:, lengths == 1][1:].float() == 0).all()):
        raise AssertionError(f"{tag}: a masked step emitted a nonzero h")
    fwd = 0.0
    for name, a, b in zip(("hs", "cs", "gates", "h_T"), got, want):
        err, rel = rel_err(a, b)
        share = float(((a.float() - b.float()).abs() <= SEQ_ATOL).float().mean())
        if rel > SEQ_RTOL or (name != "gates" and share < SEQ_SHARE):
            raise AssertionError(f"{tag} forward: {name} differs, max |diff| "
                                 f"{err:.3e} ({rel:.2e} of max), {share:.4f} of "
                                 f"elements within {SEQ_ATOL}")
        fwd = max(fwd, err)
        print(f"{tag} forward {name}: max |kernel - plain| {err:.3e} "
              f"({rel:.2e} of max, tolerance {SEQ_RTOL}); {share:.5f} of "
              f"elements within {SEQ_ATOL} (tolerance {SEQ_SHARE}); bit for "
              "bit across two calls")
    g = torch.Generator(device=DEV).manual_seed(1)
    dhs = torch.randn((T, N, H), generator=g, device=DEV).to(torch.bfloat16)
    dct = torch.randn((N, H), generator=g, device=DEV)
    dht = torch.randn((N, H), generator=g, device=DEV)
    saved = (*args, *want[:3])          # both backwards from one forward
    got = lstm_seq_bwd_kernel(saved, dhs, dct, dht)
    for name, a, r in zip(("dx", "dWx", "dWh", "db", "dc0", "dh0"), got,
                          lstm_seq_bwd_kernel(saved, dhs, dct, dht)):
        if not torch.equal(a, r):
            raise AssertionError(f"{tag} backward: two calls gave another {name}")
    want = lstm_seq_bwd_plain(saved, dhs, dct, dht)
    bwd = 0.0
    for name, a, b in zip(("dx", "dWx", "dWh", "db", "dc0", "dh0"), got, want):
        err, rel = rel_err(a, b)
        if rel > SEQ_RTOL or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{tag} backward: {name} differs, max |diff| "
                                 f"{err:.3e} ({rel:.2e} of max)")
        bwd = max(bwd, err)
        print(f"{tag} backward {name}: max |kernel - plain| {err:.3e} "
              f"({rel:.2e} of max, tolerance {SEQ_RTOL}); bit for bit across "
              "two calls")
    return fwd, bwd


def z_inputs(N: int, seed: int, K: int = KZ, L: int = LATENT, E: int = EMBED):
    g = torch.Generator(device=DEV).manual_seed(seed)
    mean = torch.randn((N, L), generator=g, device=DEV)
    std = torch.exp(0.3 * torch.randn((N, L), generator=g, device=DEV))
    lim = (6.0 / (K * L + E)) ** 0.5
    w = ((torch.rand((E, K * L), generator=g, device=DEV) * 2 - 1)
         * lim).to(torch.bfloat16)
    b = 0.1 * torch.randn((E,), generator=g, device=DEV)
    dz = torch.randn((N, E), generator=g, device=DEV).to(torch.bfloat16)
    return mean, std, w, b, dz


def check_fused_z(N: int, K: int = KZ, L: int = LATENT, E: int = EMBED,
                  seed: int = 5, step: int = 17) -> tuple:
    """Returns (forward, backward) max |kernel - plain|; the plain
    versions draw eps from the plain generator on the same key.  Each
    kernel runs twice and must repeat bit for bit."""
    mean, std, w, b, dz = z_inputs(N, seed=N + K + L + E, K=K, L=L, E=E)
    tag = f"fused_z N={N} K_z={K} L={L} E={E}"
    eps = philox_normals(seed, step, N, K, L, device=DEV)
    got = z_fwd_kernel(mean, std, w, b, K, seed, step)
    if not torch.equal(got, z_fwd_kernel(mean, std, w, b, K, seed, step)):
        raise AssertionError(f"{tag} forward: two calls differ")
    err, rel = rel_err(got, z_fwd_plain(mean, std, w, b, K, eps))
    if rel > Z_OUT_RTOL or not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"{tag} forward differs: {err:.3e} ({rel:.2e})")
    print(f"{tag} forward: max |kernel - plain| {err:.3e} ({rel:.2e} of max, "
          f"tolerance {Z_OUT_RTOL}); bit for bit across two calls")
    fwd, bwd = err, 0.0
    got = z_bwd_kernel(mean, std, w, K, seed, step, dz)
    again = z_bwd_kernel(mean, std, w, K, seed, step, dz)
    want = z_bwd_plain(mean, std, w, K, eps, dz)
    for name, a, r, c in zip(("dmean", "dstd", "dW"), got, again, want):
        if not torch.equal(a, r):
            raise AssertionError(f"{tag} backward: two calls gave another {name}")
        err, rel = rel_err(a, c)
        if rel > Z_GRAD_RTOL or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{tag} backward: {name} differs, {err:.3e} "
                                 f"({rel:.2e} of max)")
        bwd = max(bwd, err)
        print(f"{tag} backward {name}: max |kernel - plain| {err:.3e} "
              f"({rel:.2e} of max, tolerance {Z_GRAD_RTOL}); bit for bit "
              "across two calls")
    return fwd, bwd


# the eps stream's further shapes (N, K_z, L): rows of 3, 5 and 8 floats
# and ragged ones, N K_z not a multiple of 4 rows or of a block's span (the
# kernel stages 32 rows of 150 floats, 1600 of 3, 960 of 5, 600 of 8),
# and enough rows that a block stages more than one span
EPS_SHAPES = ((1281, 7, LATENT), (21001, 101, 3), (4001, 333, 5), (3001, 441, 8), (7, 3, 5))


def check_eps() -> float:
    """The eps kernel's bits against the plain generator's (on the card
    and on the CPU), its normals against the plain normals, its moments
    over one train step's 19.2 M draws, distinct streams, and the fused
    kernels' transform against erfinvf on every input."""
    seed, step = 1234, 7
    shape = (TRAIN_ROWS, KZ, LATENT)
    bits = fused_z_eps(seed, step, *shape, device=DEV, bits=True)
    if not torch.equal(bits, philox_bits(seed, step, *shape, device=DEV)):
        raise AssertionError("fused_z_eps: bits differ from the plain generator")
    if not torch.equal(bits[:64].cpu(), philox_bits(seed, step, 64, KZ, LATENT)):
        raise AssertionError("fused_z_eps: bits differ from the CPU generator")
    eps = fused_z_eps(seed, step, *shape, device=DEV)
    plain = philox_normals(seed, step, *shape, device=DEV)
    err = float((eps - plain).abs().max())
    if not torch.equal(eps, plain):
        raise AssertionError(f"fused_z_eps: normals differ from the plain "
                             f"generator's by up to {err:.3e}")
    for n, k, L in EPS_SHAPES:
        for bits_of in (True, False):
            got = fused_z_eps(seed, step, n, k, L, device=DEV, bits=bits_of)
            want = (philox_bits if bits_of else philox_normals)(seed, step, n, k, L, device=DEV)
            if not torch.equal(got, want):
                raise AssertionError(f"fused_z_eps [{n}, {k}, {L}] "
                                     f"{'bits' if bits_of else 'normals'} differ from "
                                     "the plain generator's")
    e64 = eps.double()
    mean, var = float(e64.mean()), float(e64.var())
    if abs(mean) >= MEAN_TOL or abs(var - 1.0) >= VAR_TOL:
        raise AssertionError(f"fused_z_eps moments: mean {mean:.3e}, var {var:.6f}")
    bad = transform_mismatches(DEV)
    if bad:
        raise AssertionError(f"fused_z: the fused kernels' normals differ from "
                             f"erfinvf's on {bad} of 2^23 uniforms")
    other = fused_z_eps(seed + 1, step, 64, KZ, LATENT, device=DEV)
    later = fused_z_eps(seed, step + 1, 64, KZ, LATENT, device=DEV)
    if (torch.equal(other, eps[:64]) or torch.equal(later, eps[:64])
            or torch.equal(eps[:, 0], eps[:, 1])):
        raise AssertionError("fused_z_eps: two streams are equal")
    print(f"fused_z_eps {TRAIN_ROWS}x{KZ}x{LATENT} = {eps.numel()} draws: bits "
          f"equal to the plain generator's (card and CPU), normals too (also at "
          f"{', '.join('x'.join(map(str, e)) for e in EPS_SHAPES)}, bits and "
          f"normals); mean {mean:.3e} (|.| < {MEAN_TOL}), "
          f"var {var:.6f} (|var - 1| < {VAR_TOL}); other seeds, steps and "
          "samples give other streams; the fused kernels' transform is erfinvf's "
          "bit for bit on all 2^23 uniforms")
    return err


# fused_lstm_seq's checked shapes (T, N, E, H): the train shapes, ragged
# rows, one row, one row past a 64-row tile, one step, a width past a
# resident A (E + H = 1280, where the decode step's layout takes A in
# chunks; the sequence streams it) and the narrowest widths (dx at one
# warpgroup a block, the dW products' 256-column tile)
SEQ_SHAPES = ((TRAIN_T, TRAIN_ROWS, EMBED, HIDDEN), (7, RAGGED_ROWS, EMBED, HIDDEN),
              (TRAIN_T, 1, EMBED, HIDDEN), (TRAIN_T, 65, EMBED, HIDDEN),
              (1, TRAIN_ROWS, EMBED, HIDDEN), (5, 600, 256, 1024),
              (3, 70, 64, 64))


# fused_z's checked shapes (N, K_z, L, E): the train shapes, ragged rows,
# one row, one row past a tile, one sample, a latent width of whole boxes
# (256) and of one partial box (37), every column width the kernels are
# built for (64, 128, 192, 256) and a width in two chunks (512); K_z L =
# 111 and 450 are not multiples of 8 (W padded for TMA).  Every shape's
# last sample reads W's box past its end.
Z_SHAPES = ((TRAIN_ROWS, KZ, LATENT, EMBED), (RAGGED_ROWS, KZ, LATENT, EMBED),
            (1, KZ, LATENT, EMBED), (65, 3, 37, 128), (RAGGED_ROWS, 1, 256, 64),
            (TRAIN_ROWS, 3, LATENT, 512), (65, 3, 256, 192))


def phase_train_kernels() -> dict:
    errors = {k: 0.0 for k in TRAIN_KERNELS}
    for T, N, E, H in SEQ_SHAPES:
        fwd, bwd = check_lstm_seq(T, N, E, H)
        errors["fused_lstm_seq_fwd"] = max(errors["fused_lstm_seq_fwd"], fwd)
        errors["fused_lstm_seq_bwd"] = max(errors["fused_lstm_seq_bwd"], bwd)
    for shape in Z_SHAPES:
        fwd, bwd = check_fused_z(*shape)
        errors["fused_z_fwd"] = max(errors["fused_z_fwd"], fwd)
        errors["fused_z_bwd"] = max(errors["fused_z_bwd"], bwd)
    errors["fused_z_eps"] = check_eps()
    return errors


def cudnn_lstm_calls(args):
    """cuDNN's LSTM through ``torch.nn.LSTM`` in bf16 on the same inputs
    as a packed sequence (rows stop at their lengths, where the kernel
    masks them: the same h_T and outputs, zeros past the length), the
    forget bias of 1 folded into its input bias: (forward, backward), the
    backward one ``torch.autograd.grad`` over a retained graph."""
    from torch.nn.utils.rnn import PackedSequence, pack_padded_sequence
    x, wx, wh, b, c0, h0, lengths = args
    E, H = wx.shape[0], wh.shape[0]
    lstm = torch.nn.LSTM(E, H).to(DEV, torch.bfloat16)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(wx.t())
        lstm.weight_hh_l0.copy_(wh.t())
        bias = b.clone()
        bias[H:2 * H] += 1.0
        lstm.bias_ih_l0.copy_(bias)
        lstm.bias_hh_l0.zero_()
    packed = pack_padded_sequence(x, lengths.cpu().long(), enforce_sorted=False)
    data = packed.data.detach().requires_grad_()
    packed = PackedSequence(data, packed.batch_sizes, packed.sorted_indices,
                            packed.unsorted_indices)
    state = tuple(s.to(torch.bfloat16)[None].requires_grad_() for s in (h0, c0))
    y, (hn, cn) = lstm(packed, state)
    outs = [y.data, hn, cn]
    cots = [torch.randn_like(t) for t in outs]
    leaves = [data, *state, *lstm.parameters()]
    return (lambda: lstm(packed, state),
            lambda: torch.autograd.grad(outs, leaves, cots, retain_graph=True))


def z_library_calls(mean, std, w, b, dz):
    """The library chain of the fused z sampling + projection on the same
    operands, with ``torch.randn``'s draws in place of the kernels' Philox
    stream: eps, ``mean + std·eps`` rounded to bf16, ``F.linear`` in bf16
    (forward), and its ``torch.autograd.grad`` for mean, std and W over a
    retained graph (backward)."""
    N, L = mean.shape
    leaves = [mean.detach().clone().requires_grad_(),
              std.detach().clone().requires_grad_(),
              w.detach().clone().requires_grad_()]
    b16 = b.to(torch.bfloat16)

    def forward():
        m, sd, w16 = leaves
        eps = torch.randn((N, KZ, L), device=DEV)
        z = (m[:, None] + sd[:, None] * eps).to(torch.bfloat16).reshape(N, KZ * L)
        return F.linear(z, w16, b16)

    out = forward()
    cot = dz.to(torch.bfloat16)
    return forward, lambda: torch.autograd.grad(out, leaves, cot, retain_graph=True)


# the sequence kernels' parts, by kernel name (seq_bwd_kernel<WG, MODE>)
SEQ_PARTS = {"lstm_cell_kernel": "forward steps", "seq_bwd_kernel<1, 0>": "gates of step T-1",
             "seq_bwd_kernel<1, 1>": "per-step dh (+ gates)",
             "seq_bwd_kernel<1, 2>": "step 0 dh0", "seq_bwd_kernel<1, 3>": "dx",
             "seq_bwd_kernel<2, 3>": "dx", "seq_dw_kernel": "dW", "sum_parts_kernel": "sums"}


def draw_instructions() -> int:
    """The SASS instructions that one more Philox-4x32-10 block and its
    four normals issue (draw4's central path and the block's store): those
    of ``vct_z_draw_probe_2`` less those of ``vct_z_draw_probe_1`` in the
    fused z library, read with ``cuobjdump -sass`` (NOPs not counted)."""
    lib = next(_ext.library_path(src) for src in _ext._sources() if src.stem == "fused_z")
    cuobjdump = os.path.join(os.path.dirname(_ext._nvcc()), "cuobjdump")

    def count(fn: str) -> int:
        sass = subprocess.run([cuobjdump, "-sass", "-fun", fn, str(lib)],
                              capture_output=True, text=True, check=True).stdout
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)", sass)
        if not ops:
            raise AssertionError(f"cuobjdump printed no SASS for {fn}")
        return sum(op != "NOP" for op in ops)

    return count("vct_z_draw_probe_2") - count("vct_z_draw_probe_1")


def max_sm_clock_hz() -> float:
    return 1e6 * float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])


def eps_bound(draws: int) -> tuple:
    """The eps stream's (bound ms, what binds it): the larger of its bytes
    (4 a draw, written once) over the memory rate and its instructions
    over the card's issue rate, :func:`draw_instructions` a Philox block
    of four draws, a warp instruction for 32 threads, four issue slots an
    SM a clock at the card's top SM clock."""
    per_block, clock = draw_instructions(), max_sm_clock_hz()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    t_issue = draws / 4 * per_block / 32 / (sms * 4 * clock) * 1e3
    t_bytes = draws * 4 / PEAK_BYTES * 1e3
    print(f"bound fused_z_eps: {draws} draws; {per_block} SASS instructions a "
          f"Philox block of four (cuobjdump), {sms} SMs x 4 issue slots at "
          f"{clock / 1e6:.0f} MHz: {t_issue:.4f} ms; {draws * 4} bytes at "
          f"{PEAK_BYTES / 1e12} TB/s: {t_bytes:.4f} ms")
    return (t_issue, "operations") if t_issue >= t_bytes else (t_bytes, "bytes")


def seq_part(name: str) -> str:
    """The part of the sequence kernels that a kernel belongs to
    (``SEQ_PARTS``; anything else, such as bf16(h0)'s copy, is "other")."""
    return next((v for k, v in SEQ_PARTS.items() if name.startswith(k)), "other")


def phase_train_kernel_times(label: str) -> dict:
    """Each train kernel against its plain version at the train path's
    shapes (T = 24, N = 1280; N = 1280, K_z = 100, L = 150), with its
    bound and its library call: for the LSTM sequence cuDNN's LSTM on the
    same inputs, for the fused z the chain of :func:`z_library_calls`
    (another generator's draws; no one PyTorch call gives the kernels'
    Philox stream, so the eps kernel has none).  The sequence kernels also
    by part (device time, ``torch.profiler``)."""
    args = seq_inputs(TRAIN_T, TRAIN_ROWS, seed=3)
    fwd_out = lstm_seq_fwd_plain(*args)
    saved = (*args, *fwd_out[:3])
    # the backward's h_prev stack, as the autograd path passes it
    h_prev = torch.cat([args[5].to(torch.bfloat16)[None], fwd_out[0][:-1]])
    g = torch.Generator(device=DEV).manual_seed(2)
    dhs = torch.randn((TRAIN_T, TRAIN_ROWS, HIDDEN), generator=g,
                      device=DEV).to(torch.bfloat16)
    dc = torch.randn((TRAIN_ROWS, HIDDEN), generator=g, device=DEV)
    mean, std, w, b, dz = z_inputs(TRAIN_ROWS, seed=4)
    eps = lambda: philox_normals(5, 6, TRAIN_ROWS, KZ, LATENT, device=DEV)  # noqa: E731
    seq_bwd = lambda: lstm_seq_bwd_kernel(saved, dhs, dc, dc, h_prev=h_prev)  # noqa: E731
    pairs = {
        "fused_lstm_seq_fwd": (lambda: lstm_seq_fwd_kernel(*args),
                               lambda: lstm_seq_fwd_plain(*args)),
        "fused_lstm_seq_bwd": (seq_bwd,
                               lambda: lstm_seq_bwd_plain(saved, dhs, dc, dc)),
        "fused_z_fwd": (lambda: z_fwd_kernel(mean, std, w, b, KZ, 5, 6),
                        lambda: z_fwd_plain(mean, std, w, b, KZ, eps())),
        "fused_z_bwd": (lambda: z_bwd_kernel(mean, std, w, KZ, 5, 6, dz),
                        lambda: z_bwd_plain(mean, std, w, KZ, eps(), dz)),
        "fused_z_eps": (lambda: fused_z_eps(5, 6, TRAIN_ROWS, KZ, LATENT, device=DEV),
                        eps),
    }
    seq_flops = 2.0 * TRAIN_T * TRAIN_ROWS * (EMBED + HIDDEN) * 4 * HIDDEN
    z_flops = 2.0 * TRAIN_ROWS * KZ * LATENT * EMBED
    bounds = {
        "fused_lstm_seq_fwd": bound(seq_flops, nbytes(*args, *fwd_out)),
        "fused_lstm_seq_bwd": bound(2 * seq_flops, nbytes(
            *saved, dhs, dc, dc, *lstm_seq_bwd_plain(saved, dhs, dc, dc))),
        "fused_z_fwd": bound(z_flops, nbytes(
            mean, std, w, b, z_fwd_kernel(mean, std, w, b, KZ, 5, 6))),
        "fused_z_bwd": bound(2 * z_flops, nbytes(
            mean, std, w, dz, *z_bwd_kernel(mean, std, w, KZ, 5, 6, dz))),
        # Philox and erfinv run outside the tensor cores: the stream's
        # bytes and its instructions' issue slots
        "fused_z_eps": eps_bound(TRAIN_ROWS * KZ * LATENT),
    }
    timer = lambda fn: cuda_ms(fn, iters=5, warmup=1)  # noqa: E731
    # the library calls in turns with the kernels (kernel, library,
    # library, kernel): cuDNN's times move by up to 2x between calls
    lib_fns = dict(zip(("fused_lstm_seq_fwd", "fused_lstm_seq_bwd"), cudnn_lstm_calls(args)))
    lib_fns.update(zip(("fused_z_fwd", "fused_z_bwd"),
                       z_library_calls(mean, std, w, b, dz)))
    library = {name: turns(pairs[name][0], fn, timer) for name, fn in lib_fns.items()}
    names = {"fused_lstm_seq_fwd": "cuDNN LSTM (bf16, packed)",
             "fused_lstm_seq_bwd": "cuDNN LSTM backward (bf16, packed)",
             "fused_z_fwd": "torch.randn + mean + std·eps + F.linear (bf16)",
             "fused_z_bwd": "that chain's autograd.grad"}
    times = {}
    for name, (fk, fp) in pairs.items():
        t = turns(fk, fp, timer)
        lib = library[name][1] if name in library else None
        times[name] = timing(t, bounds[name], lib)
        print(f"time {name} (train shapes): kernel {t[0]:.4f} ms, plain "
              f"{t[1]:.4f} ms, bound {bounds[name][0]:.4f} ms "
              f"({bounds[name][1]})"
              + (f", {names[name]} {lib:.4f} ms (in turns with the kernel at "
                 f"{library[name][0]:.4f} ms)" if lib else "")
              + f" [{label}]")
    eps = pairs["fused_z_eps"][0]
    dev = (sum(device_ms(eps).values()) + sum(device_ms(eps).values())) / 2
    print(f"time fused_z_eps device {dev:.4f} ms (share "
          f"{bounds['fused_z_eps'][0] / dev:.3f} of {bounds['fused_z_eps'][1]}) [{label}]")
    # the sequence kernels' device time by part and cuDNN's (unions of the
    # kernels' intervals: a step's kernel, launched with programmatic
    # dependent launch, starts while the one before finishes, so parts may
    # overlap and sum past the total)
    cudnn_fwd, cudnn_bwd = cudnn_lstm_calls(args)
    for tag, fn, lib in (("fused_lstm_seq_fwd", pairs["fused_lstm_seq_fwd"][0], cudnn_fwd),
                         ("fused_lstm_seq_bwd", seq_bwd, cudnn_bwd)):
        dev, dev_lib = device_spans(fn, seq_part), device_spans(lib, lambda n: n[:40])
        total = dev.pop("total")
        top = sorted(((v, k) for k, v in dev_lib.items() if k != "total"), reverse=True)[:4]
        print(f"time {tag} device {total:.4f} ms by part: "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in dev.items())
              + f"; cuDNN device {dev_lib['total']:.4f} ms (largest: "
              + ", ".join(f"{k} {v:.4f}" for v, k in top) + f") [{label}]")
    # the fused z kernels' device time and their library chain's, in turns
    # (kernel, chain, chain, kernel), each the union of its kernels'
    # intervals; the kernels' also by kernel
    by_kernel = lambda n: n.split("<")[0]  # noqa: E731
    for tag, fn, lib in zip(("fused_z_fwd", "fused_z_bwd"),
                            (pairs["fused_z_fwd"][0], pairs["fused_z_bwd"][0]),
                            z_library_calls(mean, std, w, b, dz)):
        k1, c1, c2, k2 = (device_spans(f, by_kernel) for f in (fn, lib, lib, fn))
        kernel, chain = (k1["total"] + k2["total"]) / 2, (c1["total"] + c2["total"]) / 2
        parts = {k: (v + k2.get(k, 0.0)) / 2 for k, v in k1.items() if k != "total"}
        print(f"time {tag} device {kernel:.4f} ms ("
              + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
              + f"), its chain's device {chain:.4f} ms, in turns: share "
              f"{kernel / chain:.3f} [{label}]")
    return times


# ----------------------------------------------------------------------
# phase 3, AG train path: fused_ag_heads against its plain version
# ----------------------------------------------------------------------

# the forward and db to AG_FWD_RTOL of their largest element (f32 sums in
# another order); dh, dW and dc_v to AG_GRAD_RTOL, two bf16 steps (2 x
# 2^-8): the kernels round dq to bf16 for the tensor cores, the plain
# version rounds the gradients themselves to bf16, as the reference's
# casts do
AG_FWD_RTOL = 1e-4
AG_GRAD_RTOL = 8e-3
CLUSTERS = 90
# the 80 COCO category ids in use (ids 1..90 less the unused ones)
USED_IDS = [i for i in range(1, CLUSTERS + 1) if i not in AG_UNUSED_CLASSES]


def coco_cv(rows: int, K: int = CLUSTERS, seed: int = 0,
            zero_every: int = 10) -> torch.Tensor:
    """[rows, K] cluster vectors as the COCO instances give them: 1-6 of
    the used category ids per image, normalised to sum to 1, index 0
    dropped (column j is id j + 1); every ``zero_every``-th image has no
    detection and an all-zero vector."""
    rng = np.random.default_rng(seed)
    ids = [i for i in USED_IDS if i <= K]
    cv = np.zeros((rows, K + 1), np.float32)
    for r in range(rows):
        if r % zero_every:
            pick = rng.choice(ids, size=rng.integers(1, min(6, len(ids)) + 1),
                              replace=False)
            cv[r, pick] = 1.0 / len(pick)
    return torch.from_numpy(cv[:, 1:]).to(DEV)


def ag_inputs(N: int, K: int, L: int, seed: int, H: int = HIDDEN):
    """h (an LSTM state), the q_heads weight [2KL, H] (lecun-normal, as
    initialised), bias, COCO-like c_v and the output cotangents."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    h = torch.tanh(torch.randn((N, H), generator=g, device=DEV))
    w = torch.randn((2 * K * L, H), generator=g, device=DEV) / H ** 0.5
    b = 0.1 * torch.randn((2 * K * L,), generator=g, device=DEV)
    gm = torch.randn((N, L), generator=g, device=DEV)
    gs = torch.randn((N, L), generator=g, device=DEV)
    return h, w, b, coco_cv(N, K, seed), gm, gs


def check_ag_heads(N: int, K: int, L: int, H: int = HIDDEN) -> tuple:
    """Returns (forward, backward) max |kernel - plain|; each runs twice
    and must repeat bit for bit."""
    h, w, b, cv, gm, gs = ag_inputs(N, K, L, seed=N + K + L, H=H)
    ops = prepare(h, w, b, cv)
    tag = f"fused_ag_heads N={N} H={H} K={K} L={L}"
    fwd = bwd = 0.0
    got = ag_heads_fwd_kernel(*ops)
    for name, a, r in zip(("q_mean", "q_std"), got, ag_heads_fwd_kernel(*ops)):
        if not torch.equal(a, r):
            raise AssertionError(f"{tag} forward: two calls gave another {name}")
    want = ag_heads_plain(h, w, b, cv)
    empty = cv.sum(dim=1) == 0
    for name, a, r in zip(("q_mean", "q_std"), got, want):
        err, rel = rel_err(a, r)
        if (rel > AG_FWD_RTOL or not bool(torch.isfinite(a).all())
                or bool(a[empty].any())):
            raise AssertionError(f"{tag} forward: {name} differs, max |diff| "
                                 f"{err:.3e} ({rel:.2e} of max)")
        fwd = max(fwd, err)
        print(f"{tag} forward {name}: max |kernel - plain| {err:.3e} ({rel:.2e} "
              f"of max, tolerance {AG_FWD_RTOL}); rows without a detection 0; "
              "bit for bit across two calls")
    got = ag_heads_bwd_kernel(*ops, gm, gs)
    for name, a, r in zip(("dh", "dW", "db", "dc_v"), got,
                          ag_heads_bwd_kernel(*ops, gm, gs)):
        if not torch.equal(a, r):
            raise AssertionError(f"{tag} backward: two calls gave another {name}")
    want = ag_heads_bwd_plain(h, w, b, cv, gm, gs)
    for name, a, r, tol in zip(("dh", "dW", "db", "dc_v"), got, want,
                               (AG_GRAD_RTOL, AG_GRAD_RTOL, AG_FWD_RTOL,
                                AG_GRAD_RTOL)):
        err, rel = rel_err(a, r)
        if rel > tol or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{tag} backward: {name} differs, max |diff| "
                                 f"{err:.3e} ({rel:.2e} of max)")
        bwd = max(bwd, err)
        print(f"{tag} backward {name}: max |kernel - plain| {err:.3e} "
              f"({rel:.2e} of max, tolerance {tol}); bit for bit across two calls")
    return fwd, bwd


def phase_ag_kernels() -> dict:
    """The train shapes (N = 1280, K = 90, L = 150) and ragged ones: N =
    1000 with K = 12 and with K = 7, L = 37; one row and one row past a
    64-row tile at the train K and L; the widths H = 64, 128 and 256 at N
    = 1000, K = 12; and the widths past the forward's resident h: H = 768
    at 80 latent columns and H = 1024 at 40 (h streamed), H = 768 at 40 (h
    resident, three stages)."""
    errors = {k: 0.0 for k in AG_KERNELS}
    for N, K, L, H in ((TRAIN_ROWS, CLUSTERS, LATENT, HIDDEN),
                       (RAGGED_ROWS, 12, LATENT, HIDDEN), (RAGGED_ROWS, 7, 37, HIDDEN),
                       (1, CLUSTERS, LATENT, HIDDEN), (65, CLUSTERS, LATENT, HIDDEN),
                       (RAGGED_ROWS, 12, LATENT, 64), (RAGGED_ROWS, 12, LATENT, 128),
                       (RAGGED_ROWS, 12, LATENT, 256), (RAGGED_ROWS, 12, LATENT, 768),
                       (300, 7, 37, 1024), (300, 7, 37, 768)):
        fwd, bwd = check_ag_heads(N, K, L, H)
        errors["fused_ag_heads_fwd"] = max(errors["fused_ag_heads_fwd"], fwd)
        errors["fused_ag_heads_bwd"] = max(errors["fused_ag_heads_bwd"], bwd)
    return errors


def ag_library_calls(h, w, b, cv, gm, gs):
    """The library chain of the AG heads on the same inputs, in bf16:
    ``F.linear``, a reshape to [N, K, L], ``exp`` of the std half and two
    ``einsum`` folds with c_v: (forward, backward), the backward one
    ``torch.autograd.grad`` for h, W, b and c_v over a retained graph."""
    N, K = cv.shape
    KL = w.shape[0] // 2
    leaves = [t.to(torch.bfloat16).detach().requires_grad_() for t in (h, w, b, cv)]

    def forward():
        h16, w16, b16, cv16 = leaves
        q = F.linear(h16, w16, b16)
        means = q[:, :KL].reshape(N, K, KL // K)
        stds = torch.exp(q[:, KL:]).reshape(N, K, KL // K)
        return (torch.einsum("nk,nkl->nl", cv16, means),
                torch.einsum("nk,nkl->nl", cv16, stds))

    outs = forward()
    cots = (gm.to(torch.bfloat16), gs.to(torch.bfloat16))
    return forward, lambda: torch.autograd.grad(outs, leaves, cots, retain_graph=True)


def phase_ag_kernel_times(label: str) -> dict:
    """fused_ag_heads forward and backward against their plain versions
    at the train shapes (the plain backward recomputes the forward, as the
    kernels recompute q), and against the library chain of
    :func:`ag_library_calls`."""
    h, w, b, cv, gm, gs = ag_inputs(TRAIN_ROWS, CLUSTERS, LATENT, seed=8)
    ops = prepare(h, w, b, cv)
    library = dict(zip(AG_KERNELS, (cuda_ms(fn, iters=10, warmup=2) for fn in
                                    ag_library_calls(h, w, b, cv, gm, gs))))
    flops = 2.0 * TRAIN_ROWS * HIDDEN * 2 * CLUSTERS * LATENT
    outs = ag_heads_fwd_kernel(*ops)
    grads = ag_heads_bwd_kernel(*ops, gm, gs)
    pairs = {
        "fused_ag_heads_fwd": (lambda: ag_heads_fwd_kernel(*ops),
                               lambda: ag_heads_plain(h, w, b, cv),
                               bound(flops, nbytes(*ops, *outs))),
        "fused_ag_heads_bwd": (lambda: ag_heads_bwd_kernel(*ops, gm, gs),
                               lambda: ag_heads_bwd_plain(h, w, b, cv, gm, gs),
                               bound(3 * flops, nbytes(*ops, gm, gs, *grads))),
    }
    times = {}
    parts = device_ms(lambda: ag_heads_bwd_kernel(*ops, gm, gs), reps=5)
    print(f"time fused_ag_heads_bwd by kernel (device, {sum(parts.values()):.4f} "
          "ms): " + ", ".join(f"{kernel_name(k)} {v:.4f} ms"
                            for k, v in sorted(parts.items(), key=lambda kv: -kv[1]))
          + f" [{label}]")
    for name, (fk, fp, bnd) in pairs.items():
        t = turns(fk, fp, lambda fn: cuda_ms(fn, iters=10, warmup=2))
        times[name] = timing(t, bnd, library[name])
        print(f"time {name} (N={TRAIN_ROWS} H={HIDDEN} K={CLUSTERS} "
              f"L={LATENT}): kernel {t[0]:.4f} ms, plain {t[1]:.4f} ms, library "
              f"(F.linear bf16 + exp + einsum with c_v"
              f"{'' if name.endswith('fwd') else ', one autograd.grad'}) "
              f"{library[name]:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}) [{label}]")
    return times


# ----------------------------------------------------------------------
# phase 3, GMM train path: the flash CE kernels against their plain version
# ----------------------------------------------------------------------

# lse and ll to CE_FWD_RTOL of their largest element (f32 sums in another
# order); db likewise to CE_DB_RTOL (from the f32 dl on both sides); dh and
# dW to CE_GRAD_RTOL of theirs: both round dl to bf16 before the products,
# and an element whose two f32 values straddle a bf16 rounding boundary
# moves its product by one bf16 step of dl
CE_FWD_RTOL = 1e-5
CE_DB_RTOL = 1e-4
CE_GRAD_RTOL = 1e-3


def ce_inputs(M: int, V: int, seed: int, labels=None, H: int = HIDDEN):
    """h (LSTM outputs, bf16), the rnn_logits weight [V, H] and bias, and
    labels with PAD rows (weight 0, label 0): the train batch's time-major
    labels when given, else about 40% PAD rows and row 0 live (so that Σ
    mask > 0 at M = 1); and the row weights mask / Σ mask, which are also
    the backward kernels' gw for a cotangent of 1."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    h = torch.tanh(torch.randn((M, H), generator=g, device=DEV)).to(torch.bfloat16)
    w = torch.randn((V, H), generator=g, device=DEV) / H ** 0.5
    b = 0.1 * torch.randn((V,), generator=g, device=DEV)
    if labels is None:
        labels = torch.randint(1, V, (M,), generator=g, device=DEV)
        labels[torch.rand((M,), generator=g, device=DEV) < 0.4] = 0
        labels[0] = 1
    mask = (labels != 0).float()
    weights = mask / mask.sum()
    return h, w, b, labels, weights


def check_fused_ce(M: int, V: int, labels=None, H: int = HIDDEN) -> dict:
    """The three kernels against the plain version on the same inputs (the
    backward ones from the plain lse, so both see the same operands), the
    forward twice, bit for bit; returns each kernel's max |kernel -
    plain|."""
    h, w, b, labels, weights = ce_inputs(M, V, seed=M + V, labels=labels, H=H)
    ops = fused_ce.prepare(h, w, b, labels)
    tag = f"fused_linear_ce M={M} H={H} V={V}"
    pad = float((weights == 0).float().mean())
    got = fused_ce.fused_ce_fwd_kernel(*ops)
    for name, a, r in zip(("lse", "ll"), got, fused_ce.fused_ce_fwd_kernel(*ops)):
        if not torch.equal(a, r):
            raise AssertionError(f"{tag} forward: two calls gave another {name}")
    lse, ll = fused_ce.ce_fwd_plain(h, w, b, labels)
    errs = {}
    for name, a, r in zip(("lse", "ll"), got, (lse, ll)):
        err, rel = rel_err(a, r)
        if rel > CE_FWD_RTOL or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{tag} forward: {name} differs, {err:.3e} "
                                 f"({rel:.2e} of max)")
        errs["fused_linear_ce_fwd"] = max(errs.get("fused_linear_ce_fwd", 0.0), err)
        print(f"{tag} forward {name}: max |kernel - plain| {err:.3e} ({rel:.2e} "
              f"of max, tolerance {CE_FWD_RTOL}); bit for bit across two calls")
    gw = weights
    dh = fused_ce.fused_ce_dh_kernel(*ops, lse, gw)
    dw, db = fused_ce.fused_ce_dwdb_kernel(*ops, lse, gw)
    want = (fused_ce.ce_dh_plain(h, w, b, labels, lse, gw),
            *fused_ce.ce_dwdb_plain(h, w, b, labels, lse, gw))
    if bool(dh[weights == 0].any()):
        raise AssertionError(f"{tag}: a row of weight 0 got a nonzero dh")
    for name, a, r, tol, kern in zip(
            ("dh", "dW", "db"), (dh, dw, db), want,
            (CE_GRAD_RTOL, CE_GRAD_RTOL, CE_DB_RTOL),
            ("fused_linear_ce_dh", "fused_linear_ce_dwdb", "fused_linear_ce_dwdb")):
        err, rel = rel_err(a, r)
        if rel > tol or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{tag} backward: {name} differs, {err:.3e} "
                                 f"({rel:.2e} of max)")
        errs[kern] = max(errs.get(kern, 0.0), err)
        print(f"{tag} backward {name}: max |kernel - plain| {err:.3e} ({rel:.2e} "
              f"of max, tolerance {tol})")
    print(f"{tag}: {pad:.3f} of the rows PAD (weight 0), their dh exactly 0")
    return errs


def train_ce_labels() -> torch.Tensor:
    """The train batch's labels, time-major and flattened: the rows the
    GMM path gives the CE kernels (M = 24 x 1280)."""
    return train_arrays()[1].t().reshape(-1)


def phase_ce_kernels() -> dict:
    """The train shapes (M = 30720 with the train batch's PAD rows, V =
    11500) and ragged ones: M = 1000 with V = 11519, M = 300 with V =
    2000; one row and one row past a 64-row tile at the train vocabulary;
    the other widths at ragged M and V; a vocabulary smaller than a tile;
    V = 1921 and 130, whose last 128-column tile holds 1 and 2 columns
    below V and is a vocab chunk alone."""
    errors = {k: 0.0 for k in CE_KERNELS}
    for M, V, labels, H in ((TRAIN_T * TRAIN_ROWS, VOCAB, train_ce_labels(), HIDDEN),
                            (RAGGED_ROWS, 11519, None, HIDDEN),
                            (300, 2000, None, HIDDEN), (1, VOCAB, None, HIDDEN),
                            (65, VOCAB, None, HIDDEN), (RAGGED_ROWS, 11519, None, 256),
                            (77, 301, None, 128), (300, 2000, None, 64),
                            (100, 37, None, 64), (300, 1921, None, HIDDEN),
                            (300, 1921, None, 64), (77, 130, None, 128)):
        for k, err in check_fused_ce(M, V, labels, H).items():
            errors[k] = max(errors[k], err)
    return errors


def ce_library_calls(h, w, b, labels, weights):
    """The library path on the same inputs: ``F.linear`` in bf16, then
    ``F.cross_entropy(reduction="none")``, weighted and summed: (forward,
    backward), the backward one ``torch.autograd.grad`` for h, W and b
    over a retained graph."""
    leaves = [t.to(torch.bfloat16).detach().requires_grad_() for t in (h, w, b)]
    lab = labels.long()

    def forward():
        ce = F.cross_entropy(F.linear(*leaves), lab, reduction="none")
        return (ce.float() * weights).sum()

    loss = forward()
    return forward, lambda: torch.autograd.grad(loss, leaves, retain_graph=True)


def phase_ce_kernel_times(label: str) -> dict:
    """The three CE kernels against their plain versions at the train
    shapes (M = 30720 with the batch's PAD rows, H = 512, V = 11500).
    Bound: operations, 2·M·H·V for the forward and 4·M·H·V for dh and for
    dW/db, which recompute the logits.  Library: the forward's time, and
    for dh and dW/db the time of its one backward, which gives all three
    gradients."""
    M = TRAIN_T * TRAIN_ROWS
    h, w, b, labels, weights = ce_inputs(M, VOCAB, seed=13, labels=train_ce_labels())
    ops = fused_ce.prepare(h, w, b, labels)
    lse, ll = fused_ce.fused_ce_fwd_kernel(*ops)
    dh = fused_ce.fused_ce_dh_kernel(*ops, lse, weights)
    dw, db = fused_ce.fused_ce_dwdb_kernel(*ops, lse, weights)
    flops = 2.0 * M * HIDDEN * VOCAB
    timer = lambda fn: cuda_ms(fn, iters=5, warmup=1)  # noqa: E731
    lib_fwd, lib_bwd = (timer(fn) for fn in ce_library_calls(h, w, b, labels, weights))
    pairs = {
        "fused_linear_ce_fwd": (
            lambda: fused_ce.fused_ce_fwd_kernel(*ops),
            lambda: fused_ce.ce_fwd_plain(h, w, b, labels),
            bound(flops, nbytes(*ops, lse, ll)), lib_fwd),
        "fused_linear_ce_dh": (
            lambda: fused_ce.fused_ce_dh_kernel(*ops, lse, weights),
            lambda: fused_ce.ce_dh_plain(h, w, b, labels, lse, weights),
            bound(2 * flops, nbytes(*ops, lse, weights, dh)), lib_bwd),
        "fused_linear_ce_dwdb": (
            lambda: fused_ce.fused_ce_dwdb_kernel(*ops, lse, weights),
            lambda: fused_ce.ce_dwdb_plain(h, w, b, labels, lse, weights),
            bound(2 * flops, nbytes(*ops, lse, weights, dw, db)), lib_bwd),
    }
    times = {}
    for name, (fk, fp, bnd, lib) in pairs.items():
        t = turns(fk, fp, timer)
        times[name] = timing(t, bnd, lib)
        print(f"time {name} (M={M} H={HIDDEN} V={VOCAB}): kernel {t[0]:.4f} ms, "
              f"plain {t[1]:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}), library "
              f"(F.linear bf16 + F.cross_entropy, "
              f"{'forward' if name.endswith('fwd') else 'backward: dh, dW, db'}) "
              f"{lib:.4f} ms [{label}]")
    return times


# ----------------------------------------------------------------------
# phase 3, the written-logits CE kernels (ce_hybrid, ce_xla_bwd)
# ----------------------------------------------------------------------

# the written logits: the kernel's bf16 value is the rounding of an f32
# value within LG_ATOL of the plain f32 S (f32 sums of H = 512 products in
# another order), so it equals bf16(S) except where S lies that close to a
# bf16 rounding boundary; those elements are counted.  db: both sides sum
# the same f32 dl, in another order, to CE_MAT_DB_RTOL of its largest
# element; lse, ll, dh and dW as the flash kernels'
LG_ATOL = 1e-5
CE_MAT_DB_RTOL = 1e-5


def check_written_logits(tag: str, lg, p_lg, S) -> int:
    """lg (kernel) against p_lg = bf16(S) (plain): pad columns equal, and
    every element that differs is the rounding of a value within LG_ATOL
    of S.  Returns how many elements differ."""
    V = S.shape[1]
    if lg.shape != p_lg.shape or lg.dtype != torch.bfloat16:
        raise AssertionError(f"{tag}: lg {tuple(lg.shape)} {lg.dtype} against "
                             f"{tuple(p_lg.shape)}")
    if not torch.equal(lg[:, V:], p_lg[:, V:]):
        raise AssertionError(f"{tag}: the pad columns of lg are not -1e30")
    diff = lg[:, :V] != p_lg[:, :V]
    got, s = lg[:, :V].float()[diff], S[diff]
    # half a bf16 step of got: 2^(e - 9) for |got| in [2^(e-1), 2^e)
    half_step = torch.ldexp(torch.ones_like(got), torch.frexp(got).exponent - 9)
    if bool(((got - s).abs() > half_step + LG_ATOL).any()):
        raise AssertionError(f"{tag}: lg is no rounding of the f32 logits")
    return int(diff.sum())


def check_ce_mat(M: int, V: int, labels=None, H: int = HIDDEN) -> dict:
    """The three written-logits kernels against their plain versions on
    the same inputs (the backward ones from the kernel's lg and the plain
    lse, so both see the same operands), every other row of weight 0
    labelled V + 7 (a column of lg's pad when V + 7 < Vp); each kernel
    twice, bit for bit.  Returns each kernel's max |kernel -
    plain| (lg: the largest |f32(lg) - bf16(S)|)."""
    h, w, b, labels, weights = ce_inputs(M, V, seed=M + V + 1, labels=labels, H=H)
    labels = labels.clone()
    labels[torch.nonzero(weights == 0)[1::2, 0]] = V + 7
    ops = fused_ce.prepare(h, w, b, labels)
    tag = f"fused_linear_ce_hybrid M={M} H={H} V={V}"
    lg, *got = fused_ce.ce_mat_fwd_kernel(*ops)
    for name, a, r in zip(("lg", "lse", "ll"), (lg, *got),
                          fused_ce.ce_mat_fwd_kernel(*ops)):
        if not torch.equal(a, r):
            raise AssertionError(f"{tag} forward: two calls gave another {name}")
    p_lg, lse, ll = fused_ce.ce_mat_fwd_plain(h, w, b, labels)
    S = fused_ce._logits(h, w, b)
    flips = check_written_logits(tag, lg, p_lg, S)
    lg_err = float((lg.float() - p_lg.float()).abs().max())
    del S, p_lg
    errs = {"fused_linear_ce_mat_fwd": lg_err}
    for name, a, r in zip(("lse", "ll"), got, (lse, ll)):
        err, rel = rel_err(a, r)
        if rel > CE_FWD_RTOL or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{tag} forward: {name} differs, {err:.3e} "
                                 f"({rel:.2e} of max)")
        errs["fused_linear_ce_mat_fwd"] = max(errs["fused_linear_ce_mat_fwd"], err)
        print(f"{tag} forward {name}: max |kernel - plain| {err:.3e} ({rel:.2e} "
              f"of max, tolerance {CE_FWD_RTOL})")
    print(f"{tag} forward lg [{M}, {lg.shape[1]}] bf16: bit-identical to "
          f"bf16(f32 S) but {flips} of {M * V} elements ({flips / (M * V):.2e}) "
          f"whose f32 S lies within {LG_ATOL} of a rounding boundary; pad "
          f"columns -1e30; max |kernel - plain| {lg_err:.3e}; lg, lse and ll "
          "bit for bit across two calls")
    gw = weights
    runs = [(fused_ce.ce_mat_dh_kernel(lg, ops[1], ops[3], lse, gw),
             *fused_ce.ce_mat_dwdb_kernel(ops[0], lg, ops[3], lse, gw, V))
            for _ in range(2)]
    dh, dw, db = runs[0]
    for name, a, r in zip(("dh", "dW", "db"), *runs):
        if not torch.equal(a, r):
            raise AssertionError(f"{tag}: two calls gave another {name}")
    want = (fused_ce.ce_mat_dh_plain(lg, w, labels, lse, gw),
            *fused_ce.ce_mat_dwdb_plain(h, lg, labels, lse, gw, V))
    if bool(dh[weights == 0].any()):
        raise AssertionError(f"{tag}: a row of weight 0 got a nonzero dh")
    for name, a, r, tol, kern in zip(
            ("dh", "dW", "db"), (dh, dw, db), want,
            (CE_GRAD_RTOL, CE_GRAD_RTOL, CE_MAT_DB_RTOL),
            ("fused_linear_ce_mat_dh", "fused_linear_ce_mat_dwdb",
             "fused_linear_ce_mat_dwdb")):
        err, rel = rel_err(a, r)
        if rel > tol or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{tag} backward: {name} differs, {err:.3e} "
                                 f"({rel:.2e} of max)")
        errs[kern] = max(errs.get(kern, 0.0), err)
        print(f"{tag} backward {name}: max |kernel - plain| {err:.3e} ({rel:.2e} "
              f"of max, tolerance {tol})")
    pad = float((weights == 0).float().mean())
    print(f"{tag}: {pad:.3f} of the rows PAD (weight 0, every other one "
          f"labelled {V + 7}), their dh exactly 0; dh, dW and db bit for bit "
          "across two calls")
    return errs


def phase_ce_mat_kernels() -> dict:
    """The train shapes (M = 30720 with the train batch's PAD rows, V =
    11500, lg [30720, 11520]) and ragged ones: M = 1000 with V = 11519, M
    = 300 with V = 2000 (not a multiple of 64); one row and one row past
    a 64-row tile at the train vocabulary; the other widths at ragged M
    and V; a vocabulary smaller than a tile; V = 1921 and 130, whose last
    128-column tile holds 1 and 2 columns below V and is a vocab chunk
    alone."""
    errors = dict.fromkeys(MAT_KERNELS, 0.0)
    for M, V, labels, H in ((TRAIN_T * TRAIN_ROWS, VOCAB, train_ce_labels(), HIDDEN),
                            (RAGGED_ROWS, 11519, None, HIDDEN),
                            (300, 2000, None, HIDDEN), (1, VOCAB, None, HIDDEN),
                            (65, VOCAB, None, HIDDEN), (RAGGED_ROWS, 11519, None, 256),
                            (77, 301, None, 128), (300, 2000, None, 64),
                            (100, 37, None, 64), (300, 1921, None, HIDDEN),
                            (300, 1921, None, 64), (77, 130, None, 128)):
        for k, err in check_ce_mat(M, V, labels, H).items():
            errors[k] = max(errors[k], err)
    return errors


def mat_fwd_library_call(h, w, b, labels):
    """The library chain of the written-logits forward on the same inputs:
    ``F.linear`` in bf16 (the logits written), then ``torch.logsumexp``
    and a gather of the label logits."""
    h16, w16, b16 = (t.to(torch.bfloat16) for t in (h, w, b))
    lab = labels.long()[:, None]

    def call():
        lg = F.linear(h16, w16, b16)
        return lg, torch.logsumexp(lg, dim=1), lg.gather(1, lab)

    return call


def phase_ce_mat_kernel_times(label: str) -> dict:
    """The three written-logits kernels against their plain versions at the
    train shapes (M = 30720 with the batch's PAD rows, H = 512, V =
    11500).  Bound: operations, 2·M·H·V each (nothing recomputes the
    product).  Library: for the forward the chain ``F.linear`` bf16 +
    ``torch.logsumexp`` + gather, for dh and dW/db the flash rows' library
    backward (one ``autograd.grad`` for h, W and b)."""
    M = TRAIN_T * TRAIN_ROWS
    h, w, b, labels, weights = ce_inputs(M, VOCAB, seed=13, labels=train_ce_labels())
    h16, w16, bf, lab = fused_ce.prepare(h, w, b, labels)
    lg, lse, ll = fused_ce.ce_mat_fwd_kernel(h16, w16, bf, lab)
    dh = fused_ce.ce_mat_dh_kernel(lg, w16, lab, lse, weights)
    dw, db = fused_ce.ce_mat_dwdb_kernel(h16, lg, lab, lse, weights, VOCAB)
    flops = 2.0 * M * HIDDEN * VOCAB
    timer = lambda fn: cuda_ms(fn, iters=5, warmup=1)  # noqa: E731
    lib_fwd = timer(mat_fwd_library_call(h, w, b, labels))
    lib_bwd = timer(ce_library_calls(h, w, b, labels, weights)[1])
    pairs = {
        "fused_linear_ce_mat_fwd": (
            lambda: fused_ce.ce_mat_fwd_kernel(h16, w16, bf, lab),
            lambda: fused_ce.ce_mat_fwd_plain(h, w, b, labels),
            bound(flops, nbytes(h16, w16, bf, lab, lg, lse, ll)), lib_fwd,
            "F.linear bf16 + torch.logsumexp + gather"),
        "fused_linear_ce_mat_dh": (
            lambda: fused_ce.ce_mat_dh_kernel(lg, w16, lab, lse, weights),
            lambda: fused_ce.ce_mat_dh_plain(lg, w, labels, lse, weights),
            bound(flops, nbytes(lg, w16, lab, lse, weights, dh)), lib_bwd,
            "F.linear bf16 + F.cross_entropy, backward: dh, dW, db"),
        "fused_linear_ce_mat_dwdb": (
            lambda: fused_ce.ce_mat_dwdb_kernel(h16, lg, lab, lse, weights, VOCAB),
            lambda: fused_ce.ce_mat_dwdb_plain(h, lg, labels, lse, weights, VOCAB),
            bound(flops, nbytes(h16, lg, lab, lse, weights, dw, db)), lib_bwd,
            "F.linear bf16 + F.cross_entropy, backward: dh, dW, db"),
    }
    times = {}
    for name, (fk, fp, bnd, lib, what) in pairs.items():
        t = turns(fk, fp, timer)
        times[name] = timing(t, bnd, lib)
        print(f"time {name} (M={M} H={HIDDEN} V={VOCAB}): kernel {t[0]:.4f} ms, "
              f"plain {t[1]:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}), library "
              f"({what}) {lib:.4f} ms [{label}]")
    return times


# ----------------------------------------------------------------------
# phase 5: the train path at full width
# ----------------------------------------------------------------------

TRAIN_STEPS = 20
COMPARE_STEPS = 5
# kernel path against plain path, same weights and seeds: the metrics of
# step 1 to METRIC_RTOL_1 and of steps 2-5 to METRIC_RTOL (f32 sums in
# another order, bf16 roundings that differ now and then, compounded by
# Adam); step 1's gradients leaf by leaf to GRAD_SHARE of each leaf's
# largest element
METRIC_RTOL_1 = 1e-3
METRIC_RTOL = 1e-2
GRAD_SHARE = 2e-2


def train_config(prior: str = "Normal", ce=None) -> Config:
    """The Normal-prior CVAE, the AG-CVAE with cluster vectors, or the
    GMM-CVAE with cluster vectors, with the config.py defaults (embed 256,
    hidden 512, latent 150, K_z 100, 90 clusters, 4096-d features, bf16,
    Adam 5e-4, clip 5.0) and vocab 11,500.  ``ce`` names the CE schedule
    flag to set, one of CE_SCHEDULES ("" for the plain CE); by default the
    GMM path takes the flash CE and the others the plain CE."""
    if ce is None:
        ce = "fused_ce" if prior == "GMM" else ""
    cfg = Config(prior=prior, use_c_v=prior != "Normal",
                 batch_size=TRAIN_IMAGES, num_captions=TRAIN_CAPTIONS,
                 **({ce: True} if ce else {}))
    cfg.vocab_size = VOCAB
    return cfg


def ce_flag(cfg: Config) -> str:
    """The CE schedule flag ``cfg`` sets, or "" (the plain CE)."""
    return next((f for f in CE_STEP_LAUNCHES if getattr(cfg, f)), "")


def train_arrays(seed: int = 9) -> tuple:
    """One synthetic batch on the card: features, labels (the encoder's
    input), decoder inputs, lengths in 6..24 (one row of 24) and COCO-like
    cluster vectors."""
    rng = np.random.default_rng(seed)
    B, K, T, R = TRAIN_IMAGES, TRAIN_CAPTIONS, TRAIN_T, TRAIN_ROWS
    lengths = rng.integers(min(6, T), T + 1, size=R).astype(np.int32)
    lengths[0] = T
    labels = rng.integers(3, VOCAB, size=(R, T))
    dec = np.roll(labels, 1, axis=1)
    dec[:, 0] = 1
    pad = np.arange(T)[None, :] >= lengths[:, None]
    labels[pad] = 0
    dec[pad] = 0
    feats = np.maximum(rng.standard_normal((B, 4096), dtype=np.float32), 0)
    return (torch.from_numpy(feats).to(DEV), torch.from_numpy(labels).to(DEV),
            torch.from_numpy(dec).to(DEV), torch.from_numpy(lengths).to(DEV),
            coco_cv(B, seed=seed))


def train_launches(steps: int, ag: bool, ce: str) -> dict:
    """The kernels a run of ``steps`` train steps must launch: the LSTM
    sequence for the encoder and the decoder, the fused z, the AG heads
    under the AG prior, the CE kernels of the CE schedule flag ``ce`` (none
    of the six for the plain CE), and never the eps kernel (check only:
    the train step never materialises eps)."""
    per_step = CE_STEP_LAUNCHES.get(ce, {})
    return {"fused_lstm_seq_fwd": 2 * steps, "fused_lstm_seq_bwd": 2 * steps,
            "fused_z_fwd": steps, "fused_z_bwd": steps, "fused_z_eps": 0,
            "fused_ag_heads_fwd": steps if ag else 0,
            "fused_ag_heads_bwd": steps if ag else 0,
            **{k: steps * per_step.get(k, 0) for k in CE_KERNELS + MAT_KERNELS}}


def phase_train_path(cfg, arrays, tag: str):
    """TRAIN_STEPS Trainer steps at full width on one repeated batch."""
    trainer = Trainer(cfg, device=DEV)
    torch.cuda.synchronize()
    _ext.reset_launches()   # this path's run starts here
    t0 = time.perf_counter()
    metrics = [trainer.run_step_arrays(arrays) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    want = train_launches(TRAIN_STEPS, cfg.prior == "AG", ce_flag(cfg))
    launches = {k: _ext.LAUNCHES[k] for k in want}               # right after
    losses = [float(m["loss"]) for m in metrics]
    print(f"{tag} path: {TRAIN_STEPS} steps of {TRAIN_IMAGES} images x "
          f"{TRAIN_CAPTIONS} captions x {TRAIN_T} tokens in {seconds:.2f} s; "
          f"launches {launches}, expected {want}")
    print(f"{tag} path loss by step: " + ", ".join(f"{x:.4f}" for x in losses))
    print(f"{tag} path step 1 / step {TRAIN_STEPS}: " + "; ".join(
        f"{k} {float(metrics[0][k]):.5f} / {float(metrics[-1][k]):.5f}"
        for k in ("rec_loss", "kld", "grad_norm")))
    if launches != want:
        raise AssertionError(f"{tag} launch counts {launches} != expected {want}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"the {tag} loss did not fall: {losses}")
    return trainer, launches


def phase_train_compare(cfg, arrays, tag: str,
                        n_steps: int = COMPARE_STEPS) -> dict:
    """``n_steps`` steps through the kernels and through the plain
    versions, from the same weights, z seeds and (GMM) cluster draws (and
    VGG16 dropout masks): both Trainers seed their generators from the
    same ``cfg.seed``."""
    runs, grads = [], []
    for ops in (None, PLAIN_TRAIN_OPS):
        trainer = Trainer(cfg.replace(), device=DEV,
                          **({} if ops is None else {"ops": ops}))
        steps = []
        for i in range(n_steps):
            steps.append({k: float(v) for k, v in
                          trainer.run_step_arrays(arrays).items()})
            if i == 0:
                grads.append({n: p.grad.detach().clone() for n, p in
                              trainer.model.named_parameters()})
        runs.append(steps)
        del trainer
    worst = {}
    for i, (k, p) in enumerate(zip(*runs)):
        tol = METRIC_RTOL_1 if i == 0 else METRIC_RTOL
        for key in ("loss", "rec_loss", "kld", "grad_norm"):
            rel = abs(k[key] - p[key]) / abs(p[key])
            worst[key] = max(worst.get(key, 0.0), rel)
            if rel > tol:
                raise AssertionError(f"{tag} compare step {i + 1}: {key} kernel "
                                     f"{k[key]:.6f} plain {p[key]:.6f} ({rel:.2e})")
        print(f"{tag} compare step {i + 1}: " + "; ".join(
            f"{key} {k[key]:.6f} / {p[key]:.6f}" for key in
            ("loss", "rec_loss", "kld", "grad_norm")) + " (kernels / plain)")
    shares = {}
    for name in grads[0]:
        _, rel = rel_err(grads[0][name], grads[1][name])
        shares[name] = rel
        if rel > GRAD_SHARE:
            raise AssertionError(f"{tag} compare: step-1 gradient of {name} "
                                 f"differs by {rel:.2e} of its max")
    print(f"{tag} compare: metrics max rel diff {worst} (tolerance "
          f"{METRIC_RTOL_1} at step 1, {METRIC_RTOL} after); step-1 gradients, "
          f"max |kernel - plain| over max |plain| per leaf: " + ", ".join(
              f"{n} {r:.2e}" for n, r in sorted(shares.items()))
          + f" (tolerance {GRAD_SHARE})")
    return worst


def phase_round_trip(cfg, trainer, out_dir: str, tag: str) -> None:
    """The trained weights through export_flax_params / save_params /
    load_model, then one batch of 512 images through the decode kernels:
    greedy for the Normal model, beam 3 with the images' cluster vectors
    for the AG- and GMM-CVAEs (z centred on the active cluster means
    under AG, at 0 under GMM)."""
    vocab = Vocabulary(["<BOS>", "<EOS>", "<UNK>"]
                       + [f"w{i}" for i in range(VOCAB - 4)])
    # the checkpoint (120 MB at full width, 175 MB for the AG- and
    # GMM-CVAEs) is removed after the reload
    ckpt_dir = os.path.join(out_dir, "checkpoints")
    name = f"{tag}_round_trip"
    try:
        save_sidecars(cfg, vocab, ckpt_dir, name)
        save_params(export_flax_params(trainer.model), ckpt_dir, name)
        model, _, report = load_model(ckpt_dir, name, device=DEV)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    for (pname, a), (_, b) in zip(trainer.model.named_parameters(),
                                  model.named_parameters()):
        if not torch.equal(a.detach(), b.detach()):
            raise AssertionError(f"{tag} round trip changed {pname}")
    with_cv = cfg.needs_cluster_vectors      # AG or GMM: beam 3 with c_v
    dcfg = cfg.replace(mode="inference", gen_max_len=30, beam_size=3)
    fn = make_decode_fns(model, dcfg, vocab)["beam_search" if with_cv else "greedy"]
    rng = np.random.default_rng(11)
    feats = torch.from_numpy(np.maximum(
        rng.standard_normal((BATCH, 4096), dtype=np.float32), 0)).to(DEV)
    c_v = coco_cv(BATCH, seed=11)
    _ext.reset_launches()
    res = fn(feats, c_v, generator=torch.Generator(device=DEV).manual_seed(3))
    torch.cuda.synchronize()
    tokens = res.tokens
    if tokens.shape[0] != BATCH or not bool(((tokens >= 0)
                                             & (tokens < VOCAB)).all()):
        raise AssertionError(f"{tag} round trip: decoded tokens out of range")
    if with_cv and not bool(torch.isfinite(res.scores).all()):
        raise AssertionError(f"{tag} round trip: non-finite beam scores")
    if _ext.LAUNCHES["fused_logits_top_k"] != res.steps:
        raise AssertionError(f"{tag} round trip: the decode did not run the kernels")
    print(f"{tag} round trip: {len(report.loaded)} Flax leaves exported, saved, "
          f"reloaded bit for bit; {'beam-3' if with_cv else 'greedy'} decode of "
          f"{BATCH} images{' with their cluster vectors' if with_cv else ''}, "
          f"{res.steps} steps through the decode kernels")


def phase_train_times(cfg, arrays, label: str, tag: str) -> None:
    """ms per full-width train step, kernel path against plain path, in
    turns, by CUDA events over 5 steps after 1 warm-up step."""
    kern = Trainer(cfg.replace(), device=DEV)
    plain = Trainer(cfg.replace(), device=DEV, ops=PLAIN_TRAIN_OPS)
    tk, tp = turns(lambda: kern.run_step_arrays(arrays),
                   lambda: plain.run_step_arrays(arrays),
                   lambda fn: cuda_ms(fn, iters=5, warmup=1))
    print(f"time {tag} step, {TRAIN_IMAGES} images x {TRAIN_CAPTIONS} "
          f"captions x {TRAIN_T} tokens: kernel {tk:.2f} ms "
          f"({TRAIN_IMAGES / tk * 1e3:.0f} images/s), plain {tp:.2f} ms "
          f"({TRAIN_IMAGES / tp * 1e3:.0f} images/s) [{label}]")


CE_NAMES = {"": "plain CE", "fused_ce": "flash CE", "ce_hybrid": "hybrid CE",
            "ce_xla_bwd": "XLA-forward CE"}


def phase_ce_step_times(prior: str, arrays, label: str) -> None:
    """The ``prior`` model's full-width step under the four CE schedules
    (plain CE over bf16 logits, flash, hybrid, XLA forward), all through
    the kernels otherwise, in turns by CUDA events over 5 steps after 1
    warm-up (the schedules in order, then in reverse, averaged); then the
    peak device memory of one step of each, alone on the card (the other
    Trainers freed): max_memory_allocated after reset_peak_memory_stats,
    and its rise over what was allocated before the step."""
    tag = {"GMM": "train-gmm", "Normal": "train"}[prior]
    trainers = [Trainer(train_config(prior, ce), device=DEV)
                for ce in CE_SCHEDULES]
    timer = lambda fn: cuda_ms(fn, iters=5, warmup=1)  # noqa: E731
    fns = [lambda tr=tr: tr.run_step_arrays(arrays) for tr in trainers]
    first = [timer(fn) for fn in fns]
    second = [timer(fn) for fn in reversed(fns)][::-1]
    for ce, t1, t2 in zip(CE_SCHEDULES, first, second):
        ms = (t1 + t2) / 2
        print(f"time {tag} step, {CE_NAMES[ce]}, {TRAIN_IMAGES} images x "
              f"{TRAIN_CAPTIONS} captions x {TRAIN_T} tokens: {ms:.2f} ms "
              f"({TRAIN_IMAGES / ms * 1e3:.0f} images/s; turns {t1:.2f}, "
              f"{t2:.2f}) [{label}]")
    del trainers, fns
    torch.cuda.empty_cache()
    for ce in CE_SCHEDULES:
        trainer = Trainer(train_config(prior, ce), device=DEV)
        trainer.run_step_arrays(arrays)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(DEV)
        torch.cuda.reset_peak_memory_stats(DEV)
        trainer.run_step_arrays(arrays)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(DEV)
        print(f"memory {tag} step, {CE_NAMES[ce]}: peak {peak / 2**20:.1f} MiB "
              f"allocated, {(peak - base) / 2**20:.1f} MiB above the "
              f"{base / 2**20:.1f} MiB held before the step [{label}]")
        del trainer
        torch.cuda.empty_cache()


# ----------------------------------------------------------------------
# the training life cycle: resume, per-epoch caption scores, fine-tuning
# ----------------------------------------------------------------------

RESUME_STEPS = 3
RESUME_KEEP = 2        # max_checkpoints_to_keep of the resume phase
METRIC_KEYS = ("loss", "rec_loss", "kld", "annealing", "grad_norm")


def moments(trainer) -> list:
    return [t for _, t, _ in trainer._moments()]


def phase_resume(prior: str, ce: str, out_dir: str, tag: str) -> dict:
    """RESUME_STEPS steps, the train state saved, a fresh Trainer (under
    ``restore``) restored from it and RESUME_STEPS more steps, against
    2·RESUME_STEPS uninterrupted steps at full width: metrics, parameters
    and Adam moments bit for bit, the annealing 1.0 after the restore,
    and the checkpointer keeping RESUME_KEEP states.  The launch counts
    are those of the interrupted run (reset before its first step, read
    after its last)."""
    cfg, arrays = train_config(prior, ce), train_arrays(seed=13)
    whole = Trainer(cfg.replace(), device=DEV)
    want = [whole.run_step_arrays(arrays) for _ in range(2 * RESUME_STEPS)]
    ckpt_dir = os.path.join(out_dir, "resume")
    try:
        torch.cuda.synchronize()
        _ext.reset_launches()   # this path's run starts here
        t0 = time.perf_counter()
        first = Trainer(cfg.replace(), device=DEV)
        for _ in range(RESUME_STEPS):
            first.run_step_arrays(arrays)
        states = Checkpointer(ckpt_dir, tag, max_to_keep=RESUME_KEEP)
        state = first.train_state()
        for key in range(RESUME_KEEP + 1):      # retention: the newest kept
            states.save(state, step=key * RESUME_STEPS)
        t_save = time.perf_counter()
        del first, state
        resumed = Trainer(cfg.replace(restore=True), device=DEV)
        resumed.restore_from(states)
        t_restore = time.perf_counter()
        got = [resumed.run_step_arrays(arrays) for _ in range(RESUME_STEPS)]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        kept = states.all_steps()
        size = sum(os.path.getsize(os.path.join(states.directory, str(k), f))
                   for k in kept for f in os.listdir(
                       os.path.join(states.directory, str(k)))) / len(kept)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    want_launches = train_launches(2 * RESUME_STEPS, prior == "AG", ce)
    launches = {k: _ext.LAUNCHES[k] for k in want_launches}
    diffs = {k: max(float((g[k] - w[k]).abs()) for g, w in
                    zip(got, want[RESUME_STEPS:])) for k in METRIC_KEYS}
    p_diff = max(float((a - b).detach().abs().max()) for a, b in
                 zip(resumed.model.parameters(), whole.model.parameters()))
    m_diff = max(float((a - b).abs().max()) for a, b in
                 zip(moments(resumed), moments(whole)))
    print(f"{tag} resume: {RESUME_STEPS} steps, train state saved "
          f"({size / 2**20:.1f} MiB a step; {RESUME_KEEP + 1} saves, kept "
          f"{kept}), restored into a fresh Trainer "
          f"({t_restore - t_save:.2f} s), {RESUME_STEPS} more steps: "
          f"{seconds:.2f} s in all; launches {launches}, expected "
          f"{want_launches}")
    print(f"{tag} resume against {2 * RESUME_STEPS} uninterrupted steps: max "
          f"|diff| metrics {diffs}, parameters {p_diff:.3e}, Adam moments "
          f"{m_diff:.3e}; annealing after the restore "
          f"{[float(m['annealing']) for m in got]}")
    if launches != want_launches:
        raise AssertionError(f"{tag} resume launch counts {launches} != "
                             f"expected {want_launches}")
    if kept != [k * RESUME_STEPS for k in range(1, RESUME_KEEP + 1)]:
        raise AssertionError(f"{tag} resume: the checkpointer kept {kept}")
    if any(diffs.values()) or p_diff or m_diff:
        raise AssertionError(f"{tag} resume is not bit for bit the "
                             "uninterrupted run")
    if any(float(m["annealing"]) != 1.0 for m in got):
        raise AssertionError(f"{tag} resume: annealing is not 1 after a restore")
    return launches


# the quality phase's synthetic corpus: every caption is a function of
# its image's detections (cluster vectors) and scene (in its features)
QUALITY_TRAIN, QUALITY_VAL, QUALITY_EPOCHS = 2560, 512, 40
QUALITY_OBJECTS = USED_IDS[::4]     # 20 categories
QUALITY_SCENES = 6
# Adam's lr on the synthetic corpus: the reference's 5e-4 leaves a small
# model's greedy captions generic for hundreds of steps (a CPU rehearsal
# at embed 32 / hidden 64: CIDEr-D 0 after 240 steps at 5e-4, the
# captions' objects right at 3e-3)
QUALITY_LR = 2e-3
QUALITY_BAR = 0.99     # the whole-caption agreement first planned
TEMPLATES = ("a {o1} with a {o2} in the {s}", "the {o1} near the {o2} in {s}",
             "two {o1} and a {o2}", "a {o1} on the {s}",
             "the {s} with a {o1} and {o2}")


def quality_vocab() -> Vocabulary:
    """The corpus's words, padded to the reference's 11,500 ids."""
    words = ["a", "the", "with", "in", "near", "two", "and", "on"]
    words += [f"obj{i}" for i in QUALITY_OBJECTS] + [
        f"scene{j}" for j in range(QUALITY_SCENES)]
    words += [f"w{i}" for i in range(VOCAB - 4 - len(words))]
    vocab = Vocabulary(["<BOS>", "<EOS>", "<UNK>"] + words)
    assert vocab.vocab_size == VOCAB
    return vocab


def quality_corpus(n: int, split: str, seed: int, vocab: Vocabulary,
                   batch_size: int):
    """(CaptionBatcher, references {image id: captions}) over ``n``
    synthetic images: 1-3 of QUALITY_OBJECTS and one of QUALITY_SCENES
    scenes each; features relu(Σ A[category] + B[scene] + noise) with A,
    B fixed across splits; five captions from TEMPLATES."""
    table = np.random.default_rng(1234)
    A = table.standard_normal((CLUSTERS + 1, 4096), dtype=np.float32)
    S = table.standard_normal((QUALITY_SCENES, 4096), dtype=np.float32)
    rng = np.random.default_rng(seed)
    names = [f"{split}_{i:06d}.jpg" for i in range(n)]
    feats = np.empty((n, 4096), np.float32)
    c_v, caps, refs = {}, {}, {}
    w2i = vocab.word2idx
    for i, name in enumerate(names):
        objs = list(rng.choice(QUALITY_OBJECTS, size=rng.integers(1, 4),
                               replace=False))
        scene = int(rng.integers(QUALITY_SCENES))
        noise = 0.3 * rng.standard_normal(4096, dtype=np.float32)
        feats[i] = np.maximum(A[objs].sum(0) + S[scene] + noise, 0)
        vec = np.zeros(CLUSTERS + 1, np.float32)
        vec[objs] = 1.0 / len(objs)
        c_v[name] = vec
        texts = [t.format(o1=f"obj{objs[0]}", o2=f"obj{objs[-1]}",
                          s=f"scene{scene}") for t in TEMPLATES]
        caps[name] = [[vocab.bos_id] + [w2i[w] for w in t.split()]
                      + [vocab.eos_id] for t in texts]
        refs[str(i)] = texts
    batcher = CaptionBatcher(names, caps, batch_size,
                             feature_store=FeatureStore(names, feats),
                             cluster_vectors=c_v,
                             filename_to_imid={n: i for i, n in enumerate(names)})
    return batcher, refs


def caption_scores(caps: list, refs: dict) -> dict:
    hyps = {str(c["image_id"]): c["caption"] for c in caps}
    refs = {k: refs[k] for k in hyps}
    return {"BLEU-4": corpus_bleu(hyps, refs)[3], "CIDEr-D": cider_d(hyps, refs)}


def phase_quality(label: str) -> dict:
    """The full-width AG-CVAE trained by ``Trainer.fit`` with the quality
    hook for QUALITY_EPOCHS epochs on the synthetic corpus: val CIDEr-D
    must end above the untrained model's.  Then, on the trained weights:
    (a) the int8 decode against bf16, BLEU-4 and CIDEr-D at beam 3 and
    beam 10; (b) whole-caption agreement of the kernel decode with the
    plain decode (and the plain decode summed in reverse) at beam 3,
    beam 10 and greedy, beside QUALITY_BAR (a record: phase_decode_compare
    holds the gate)."""
    vocab = quality_vocab()
    cfg = train_config("AG").replace(
        num_epochs=QUALITY_EPOCHS, num_ex_per_epoch=QUALITY_TRAIN - 1,
        learning_rate=QUALITY_LR, gen_max_len=16, prefetch_batches=0)
    train, _ = quality_corpus(QUALITY_TRAIN, "train", 21, vocab, TRAIN_IMAGES)
    val, refs = quality_corpus(QUALITY_VAL, "val", 22, vocab, BATCH)
    trainer = Trainer(cfg, device=DEV)
    hook = make_quality_hook(cfg, vocab, refs)
    untrained = hook(trainer.model, val,
                     torch.Generator(device=DEV).manual_seed(trainer.eval_seed))
    print(f"quality, untrained: {untrained}")
    t0 = time.perf_counter()
    metrics = trainer.fit(train, val, log_every=10 ** 9, quality_hook=hook)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    print(f"quality: {QUALITY_EPOCHS} epochs of {QUALITY_TRAIN} images "
          f"({trainer.host_step} steps of {TRAIN_IMAGES} images x "
          f"{TRAIN_CAPTIONS} captions), validation and the hook on "
          f"{QUALITY_VAL} images each epoch, in {seconds:.2f} s; final "
          f"{ {k: v for k, v in metrics.items() if k.startswith('val_')} }")
    if not metrics["val_CIDEr-D"] > untrained["val_CIDEr-D"]:
        raise AssertionError("quality: val CIDEr-D did not rise with training "
                             f"({untrained['val_CIDEr-D']} -> "
                             f"{metrics['val_CIDEr-D']})")
    model = trainer.model.eval()
    record = {}
    for beam in (3, 10):
        scores = {}
        for int8 in (False, True):
            c = cfg.replace(mode="inference", beam_size=beam, decode_int8=int8)
            fn = make_decode_fns(model, c, vocab)["beam_search"]
            caps = generate_captions(val, fn, vocab, torch.Generator(
                device=DEV).manual_seed(5), DEV)
            scores["int8" if int8 else "bf16"] = (caption_scores(caps, refs),
                                                 {c["image_id"]: c["caption"]
                                                  for c in caps})
        (s16, c16), (s8, c8) = scores["bf16"], scores["int8"]
        same = sum(c16[k] == c8[k] for k in c16) / len(c16)
        record[f"int8 beam {beam}"] = {"bf16": s16, "int8": s8}
        print(f"quality (a) beam {beam}, {QUALITY_VAL} val images: bf16 BLEU-4 "
              f"{s16['BLEU-4']:.4f} CIDEr-D {s16['CIDEr-D']:.4f}; int8 BLEU-4 "
              f"{s8['BLEU-4']:.4f} CIDEr-D {s8['CIDEr-D']:.4f}; delta "
              f"{s8['BLEU-4'] - s16['BLEU-4']:+.4f} / "
              f"{s8['CIDEr-D'] - s16['CIDEr-D']:+.4f}; identical captions "
              f"{same:.4f} [{label}]")
    batch = next(val.eval_batches())
    feats = torch.from_numpy(batch.features).to(DEV)
    c_v = torch.from_numpy(batch.cluster_vectors).to(DEV)
    eps = torch.randn((BATCH, cfg.embed_size), device=DEV,
                      generator=torch.Generator(device=DEV).manual_seed(6))
    for mode, beam in (("beam 3", 3), ("beam 10", 10), ("greedy", 1)):
        c = cfg.replace(mode="inference", beam_size=max(beam, 1))
        name = "greedy" if beam == 1 else "beam_search"
        res = {ops_name: make_decode_fns(model, c, vocab, ops=ops)[name](
                   feats, c_v, eps=eps).tokens
               for ops_name, ops in (("kernel", DecodeOps()),
                                     ("plain", PLAIN_OPS),
                                     ("reordered", REORDERED_OPS))}
        share = {k: float((res[k] == res["plain"]).all(dim=1).float().mean())
                 for k in ("kernel", "reordered")}
        record[f"agreement {mode}"] = share
        print(f"quality (b) {mode}: best-beam captions identical to the plain "
              f"decode's on the trained weights, {BATCH} images: kernels "
              f"{share['kernel']:.4f}, plain summed in reverse "
              f"{share['reordered']:.4f} (bar {QUALITY_BAR})")
    del trainer, model
    return record


FT_IMAGES, FT_STEPS, FT_COMPARE_STEPS = 32, 5, 3
EXTRACT_IMAGES, EXTRACT_BATCH = 256, 64


def vgg_npz(path: str, seed: int = 0) -> None:
    """VGG16 weights drawn by numpy in the Caffe npz key layout
    (conv1_1_W .. fc8_b), He-normal, conv1_1 scaled to the pixels' range."""
    rng = np.random.default_rng(seed)
    arrays, width = {}, 3
    for name, out in (n for block in CONV_BLOCKS for n in block):
        std = np.float32((2.0 / (9 * width)) ** 0.5 / (128.0 if width == 3 else 1.0))
        arrays[f"{name}_W"] = std * rng.standard_normal((3, 3, width, out),
                                                        dtype=np.float32)
        arrays[f"{name}_b"] = np.zeros(out, np.float32)
        width = out
    for fc, shape in (("fc6", (25088, 4096)), ("fc7", (4096, 4096)),
                      ("fc8", (4096, 1000))):
        std = np.float32((2.0 / shape[0]) ** 0.5)
        arrays[f"{fc}_W"] = std * rng.standard_normal(shape, dtype=np.float32)
        arrays[f"{fc}_b"] = np.zeros(shape[1], np.float32)
    np.savez(path, **arrays)


def ft_corpus(raw_path: str, n: int, seed: int):
    """A CaptionBatcher of ``n`` random uint8 224x224 images served by a
    RawImageStore over a raw file written from numpy (the format
    ``pack_images_to_raw`` writes), 5 captions each, COCO-like c_v."""
    rng = np.random.default_rng(seed)
    names = [f"ft_{i:06d}.jpg" for i in range(n)]
    write_raw(rng.integers(0, 256, (n, 224, 224, 3), dtype=np.uint8), names,
              raw_path)
    store = RawImageStore(raw_path)
    cv = coco_cv(n, seed=seed).cpu().numpy()
    c_v = {nm: np.concatenate([[0.0], cv[i]]) for i, nm in enumerate(names)}
    caps = {nm: [[1] + list(rng.integers(3, VOCAB, size=rng.integers(6, 20)))
                 + [2] for _ in range(TRAIN_CAPTIONS)] for nm in names}
    return CaptionBatcher(names, caps, FT_IMAGES, image_store=store,
                          cluster_vectors=c_v), store


def ft_config(npz: str, **kw) -> Config:
    return train_config("AG").replace(
        fine_tune=True, image_net_weights_path=npz, batch_size=FT_IMAGES,
        mode="training", **kw)


def phase_finetune(out_dir: str, npz: str, label: str) -> dict:
    """The full-width AG-CVAE as a FineTuneModel (VGG16 from a Caffe-layout
    npz drawn by numpy) on B = FT_IMAGES images x 5 captions served by
    RawImageStore (the native loader): FT_STEPS steps through the kernels
    with exact launch counts; the VGG16 convs and fc layers move under the
    defaults and stay put when frozen; FT_COMPARE_STEPS steps against the
    plain versions (phase_train_compare); the weights through save_params
    / load_model and a beam-3 decode from images through the decode
    kernels.  Times: the step (CUDA events), its peak memory, and fc2
    extraction at EXTRACT_BATCH a batch; the single-image API on the
    checkpoint (phase_generate: raw pixels into its VGG16).  ``npz``: the
    Caffe-layout weights (vgg_npz)."""
    work = os.path.join(out_dir, "finetune")
    os.makedirs(work, exist_ok=True)
    try:
        t0 = time.perf_counter()
        batcher, store = ft_corpus(os.path.join(work, "images.bin"),
                                   EXTRACT_IMAGES, 31)
        print(f"finetune: {EXTRACT_IMAGES} packed images written "
              f"in {time.perf_counter() - t0:.2f} s; batches served by the "
              f"{store.loader} loader")
        if store.loader != "native":
            raise AssertionError(f"finetune: the native loader did not build: "
                                 f"{native_loader.build_error}")
        cfg = ft_config(npz)
        trainer = Trainer(cfg.replace(), device=DEV)
        batches = batcher.train_batches(TRAIN_CAPTIONS)
        arrays = [trainer.device_batch(next(batches)) for _ in range(2)]
        torch.cuda.synchronize()
        before = {n: p.detach().clone() for n, p in
                  trainer.model.vgg16.named_parameters()}
        _ext.reset_launches()   # this path's run starts here
        metrics = [trainer.run_step_arrays(arrays[i % 2])
                   for i in range(FT_STEPS)]
        torch.cuda.synchronize()
        want = train_launches(FT_STEPS, True, "")
        launches = {k: _ext.LAUNCHES[k] for k in want}
        losses = [float(m["loss"]) for m in metrics]
        print(f"finetune path: {FT_STEPS} steps of {FT_IMAGES} images x "
              f"{TRAIN_CAPTIONS} captions x {arrays[0][1].shape[1]} tokens; "
              f"launches {launches}, expected {want}; loss by step "
              + ", ".join(f"{x:.4f}" for x in losses))
        if launches != want:
            raise AssertionError(f"finetune launch counts {launches} != {want}")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"finetune: non-finite loss {losses}")
        moved = {n: bool((p.detach() != before[n]).any()) for n, p in
                 trainer.model.vgg16.named_parameters()}
        if not all(moved.values()):
            raise AssertionError("finetune: VGG16 weights did not move: "
                                 f"{[n for n, m in moved.items() if not m]}")
        for frozen in ("fine_tune_fe", "fine_tune_top"):
            t = Trainer(ft_config(npz, **{frozen: False}), device=DEV)
            vgg = dict(t.model.vgg16.named_parameters())
            was = {n: p.detach().clone() for n, p in vgg.items()}
            t.run_step_arrays(arrays[0])
            for n, p in vgg.items():
                still = bool((p.detach() == was[n]).all())
                if still != n.startswith("conv" if frozen == "fine_tune_fe"
                                         else "fc"):
                    raise AssertionError(f"finetune {frozen}=False: {n} "
                                         f"{'stayed' if still else 'moved'}")
            del t, vgg, was
        print("finetune: every VGG16 weight moved under the defaults; the "
              "convs stayed put under fine_tune_fe=False and fc1/fc2 under "
              "fine_tune_top=False, the others moved")
        step_ms = cuda_ms(lambda: trainer.run_step_arrays(arrays[0]),
                          iters=5, warmup=1)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(DEV)
        torch.cuda.reset_peak_memory_stats(DEV)
        trainer.run_step_arrays(arrays[0])
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(DEV)
        print(f"time finetune step, {FT_IMAGES} images x {TRAIN_CAPTIONS} "
              f"captions: {step_ms:.2f} ms ({FT_IMAGES / step_ms * 1e3:.1f} "
              f"images/s); peak {peak / 2**20:.1f} MiB allocated, "
              f"{(peak - base) / 2**20:.1f} MiB above the {base / 2**20:.1f} "
              f"MiB held before the step [{label}]")
        name = "finetune_round_trip"
        vocab = Vocabulary(["<BOS>", "<EOS>", "<UNK>"]
                           + [f"w{i}" for i in range(VOCAB - 4)])
        save_sidecars(cfg, vocab, work, name)
        save_params(export_flax_params(trainer.model), work, name)
        model, _, report = load_model(work, name, device=DEV)
        for (pname, a), (_, b) in zip(trainer.model.named_parameters(),
                                      model.named_parameters()):
            if not torch.equal(a.detach(), b.detach()):
                raise AssertionError(f"finetune round trip changed {pname}")
        del trainer
        images, c_v = arrays[0][0], arrays[0][4]
        fn = make_decode_fns(model, cfg.replace(mode="inference", beam_size=3,
                                                gen_max_len=30),
                             vocab)["beam_search"]
        _ext.reset_launches()
        res = fn(images, c_v, generator=torch.Generator(device=DEV).manual_seed(3))
        torch.cuda.synchronize()
        if (_ext.LAUNCHES["fused_logits_top_k"] != res.steps
                or not bool(torch.isfinite(res.scores).all())):
            raise AssertionError("finetune round trip: the image decode did "
                                 "not run the decode kernels")
        print(f"finetune round trip: {len(report.loaded)} Flax leaves "
              f"(vgg16/* and cvae/*) saved and reloaded bit for bit; beam-3 "
              f"decode of {FT_IMAGES} images, {res.steps} steps through the "
              f"decode kernels")
        del model
        phase_generate(work, name, work, label, modes=GEN_MODES[:2])
        phase_train_compare(cfg, arrays[0], "finetune", FT_COMPARE_STEPS)
        extract = FeatureExtractor(npz, batch_size=EXTRACT_BATCH, device=DEV)
        images = store.get_batch(batcher.filenames)
        ms = cuda_ms(lambda: extract(images), iters=3, warmup=1)
        print(f"time fc2 extraction, {EXTRACT_IMAGES} uint8 images from the "
              f"host in batches of {EXTRACT_BATCH}: {ms:.2f} ms "
              f"({EXTRACT_IMAGES / ms * 1e3:.1f} images/s) [{label}]")
        store.close()
        return launches
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ----------------------------------------------------------------------
# this slice's paths: beams past 16, the single-image API, the VGG16
# fidelity tool and data-parallel training
# ----------------------------------------------------------------------

# beams past the fused kernels' lists of 16: the fused decodes write their
# logits with their kernel's writer instance and take the top-k +
# logsumexp kernel over them (ops/fused_logits_topk.py)
WIDE_BEAMS = (20, 40)
WIDE_SEEDS = (4,)
# row 5 alone past lists of 16 (N, V, k): beam 20 and beam 32 of 512
# images, lists of 17, 40 (two entries a lane), 64, and past 64 the sort
# kernel (keys in shared memory; at V = 20000 in its global workspace),
# planted ties
WIDE_LSE_SHAPES = ((10240, 11500, 20), (16384, 11519, 32), (1536, 11500, 17),
                   (65, 11519, 40), (13, 1000, 64), (300, 11519, 65),
                   (300, 11519, 256), (7, 20000, 300))
# the logits writers at the wide beams' rows (512 images x 20 and x 40) and
# at their other block shapes: 64 rows resident (H = 1024), streamed (bf16
# H = 2048, int8 2624), H = 96, a vocabulary of two tiles: (M, V, H, int8)
WRITE_SHAPES = ((10240, 11500, 512, False), (20480, 11500, 512, False),
                (10240, 11500, 512, True), (65, 11519, 1024, False),
                (65, 11519, 2048, False), (300, 11519, 96, False),
                (65, 11519, 2624, True), (1, 130, 512, True))


def check_writer(M: int, V: int, H: int, int8: bool) -> float:
    """The logits the writer stores: int8 bit for bit ``int8_logits``;
    bf16 equal bit for bit to the fused top-k's own values at its top-10
    (the same accumulators, so the writer stores what the fold sees), and
    within the f32 error bound of a dot product of length H in any order
    of the exact (f64) logits: gamma_H |h| |w| + u |logit|, u = 2^-24."""
    tag = f"{'int8' if int8 else 'bf16'} logits writer M={M} H={H} V={V}"
    if int8:
        h, wq, ws, b = int8_inputs(M, V, M + V + H, H)
        hq, hs = quantize_rows(h)
        got, want = int8_logits_kernel(hq, hs, wq, ws, b), int8_logits(hq, hs, wq, ws, b)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{tag}: not bit-identical to int8_logits, max "
                                 f"|diff| {float((got - want).abs().max()):.3e}")
        print(f"{tag}: bit-identical to the plain version")
        return 0.0
    h, w, b = logits_inputs(M, V, H, seed=M + V + H)
    w_t = w.t().contiguous()
    got = logits_kernel(h, w_t, b)
    vals, idx, _ = logits_top_k_kernel(h, w_t, b, min(10, V))
    if not torch.equal(got.gather(1, idx.long()), vals):
        raise AssertionError(f"{tag}: the written logits at the fused top-10 "
                             "differ from the fold's values")
    ratio = logits_error_ratio(got, h, w, b)
    if ratio > 1.0:
        raise AssertionError(f"{tag}: |kernel - exact| reaches {ratio:.3f} of the "
                             "f32 sum-order bound")
    err = float((got - bf16_logits(h, w, b)).abs().max())
    print(f"{tag}: equal to the fused top-10's values; max |kernel - exact| "
          f"{ratio:.4f} of the f32 bound; max |kernel - plain| {err:.3e}")
    return err


def logits_error_ratio(got, h, w, b) -> float:
    """The largest |got - exact| over its f32 bound, exact = h w + b in
    f64: gamma_H |h| |w| + u |exact|, gamma_H = H u / (1 - H u), u = 2^-24
    (any summation order of the H products, then the bias's rounding)."""
    H, u = h.shape[1], 2.0 ** -24
    hd, wd = h.double(), w.double()
    exact = hd @ wd + b.double()
    tol = H * u / (1 - H * u) * (hd.abs() @ wd.abs()) + u * exact.abs()
    return float(((got.double() - exact).abs() / tol).max())


def phase_writer_kernels() -> dict:
    """The writers at WRITE_SHAPES, and the wide top-k wrappers (writer
    + row 5) at k = 20 and 40 against the plain versions: bf16 to the
    fused top-k's bar (check_topk's), int8 bit for bit.  Returns the
    largest |kernel - plain| of each row."""
    errs = {"fused_logits_top_k": 0.0, "fused_logits_top_k_int8": 0.0}
    for M, V, H, int8 in WRITE_SHAPES:
        key = "fused_logits_top_k_int8" if int8 else "fused_logits_top_k"
        errs[key] = max(errs[key], check_writer(M, V, H, int8))
    for M, k in ((10240, 20), (2048, 40)):
        errs["fused_logits_top_k"] = max(errs["fused_logits_top_k"],
                                         check_topk(M, 11519, k))
        errs["fused_logits_top_k_int8"] = max(errs["fused_logits_top_k_int8"],
                                              check_int8(M, 11519, k))
    return errs


def phase_wide_times(label: str) -> None:
    """Beam 20 and 40 of 512 images (M = 10240, 20480) in bf16 and beam
    20 in int8: the writer alone (events and device time, its bound), and
    the wide top-k wrapper (writer + row 5) against its plain version and
    the library chain (F.linear or torch._int_mm, then torch.topk +
    torch.logsumexp)."""
    H, V = 512, 11500
    for M, k, int8 in ((10240, 20, False), (20480, 40, False), (10240, 20, True)):
        if int8:
            h, wq, ws, b = int8_inputs(M, V, seed=M)
            hq, hs = quantize_rows(h)
            write = functools.partial(int8_logits_kernel, hq, hs, wq, ws, b)
            kernel = functools.partial(int8_top_k_kernel, hq, hs, wq, ws, b, k)
            plain = functools.partial(int8_top_k_plain, hq, hs, wq, ws, b, k)
            library = int8_library_call(hq, hs, wq, ws, b, k)
            moved, peak = nbytes(hq, hs, wq, ws, b), PEAK_INT8
        else:
            h, w, b = logits_inputs(M, V)
            w_t = w.t().contiguous()
            write = functools.partial(logits_kernel, h, w_t, b)
            kernel = functools.partial(logits_top_k_kernel, h, w_t, b, k)
            plain = functools.partial(fused_logits_top_k_plain, h, w, b, k)
            library = topk_library_call(h, w, b, k)
            moved, peak = nbytes(h, w, b), PEAK_BF16
        tag = f"{'int8' if int8 else 'bf16'} M={M} H={H} V={V}"
        w_ms = cuda_ms(write)
        w_dev = sum(device_ms(write).values())
        w_bnd = bound(2.0 * M * H * V, moved + 4 * M * V, peak)
        print(f"time logits writer {tag}: events {w_ms:.4f} ms, device "
              f"{w_dev:.4f} ms, bound {w_bnd[0]:.4f} ms ({w_bnd[1]}; share "
              f"{w_bnd[0] / w_dev:.3f}) [{label}]")
        t, lib, dev, host = logits_yardstick(kernel, plain, library)
        bnd = bound(2.0 * M * H * V, moved + nbytes(*kernel()), peak)
        print(f"time wide top-k {tag} k={k} (writer + top_k_logsumexp): kernel "
              f"{t[0]:.4f} ms, plain {t[1]:.4f} ms, library {lib:.4f} ms, fused "
              f"bound {bnd[0]:.4f} ms ({bnd[1]}); device: kernel {dev[0]:.4f} ms, "
              f"library {dev[1]:.4f} ms; host per call {host:.1f} us [{label}]")


def wide_beam_launches(cfg, vocab, model, feats, c_v) -> dict:
    """One batch through the kernels at each wide beam (and int8 at beam
    20), the counts set to 0 just before and read just after: the LSTM
    step 3 times plus once a step, the bf16 (or int8) logits writer and
    the top-k + lse kernel once a step each."""
    cases = [(f"beam {b}", cfg.replace(beam_size=b)) for b in WIDE_BEAMS]
    cases.append(("int8 beam 20", cfg.replace(beam_size=20, decode_int8=True)))
    counts = dict.fromkeys(DECODE_KERNELS + MODE_KERNELS, 0)
    want = dict(counts)
    torch.cuda.synchronize()
    _ext.reset_launches()   # the wide-beam path's run starts here
    t0 = time.perf_counter()
    steps = []
    for name, c in cases:
        res = make_decode_fns(model, c, vocab)["beam_search"](
            feats, c_v, generator=torch.Generator(device=DEV).manual_seed(2))
        if not bool(torch.isfinite(res.scores).all()):
            raise AssertionError(f"wide-beam {name}: non-finite beam scores")
        steps.append(res.steps)
        want["fused_lstm_step"] += 3 + res.steps
        want["fused_logits_top_k_int8" if c.decode_int8 else "fused_logits_top_k"] += res.steps
        want["top_k_logsumexp"] += res.steps
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {k: _ext.LAUNCHES[k] for k in counts}      # right after
    print(f"wide-beam path: {', '.join(n for n, _ in cases)} on {BATCH} images "
          f"({steps} steps) in {seconds:.2f} s; launches {counts}, expected {want}")
    if counts != want:
        raise AssertionError(f"wide-beam launch counts {counts} != {want}")
    return counts


def phase_wide_beam(cfg, vocab, model, label: str) -> dict:
    """Beams 20 and 40 (bf16) and 20 (int8) on 512 images, 30 steps,
    through ``make_decode_fns``: the path's launch counts; beam 20 and 40
    held to the bf16 decode compare's bar (phase_decode_compare: per step,
    and best-beam captions and scores against the plain and the
    reversed-sum decodes), int8 beam 20 to the int8 mode's
    (phase_mode_compare: per step); then ms per batch, kernel path
    against plain path."""
    batch = next(batchers(BATCH, "val", vocab, 4).eval_batches())
    launches = wide_beam_launches(
        cfg, vocab, model, torch.from_numpy(batch.features).to(DEV),
        torch.from_numpy(batch.cluster_vectors).to(DEV))
    phase_decode_compare(cfg, vocab, model,
                         modes=tuple((f"beam {b}", b) for b in WIDE_BEAMS),
                         seeds=WIDE_SEEDS)
    phase_mode_compare(cfg.replace(beam_size=20), vocab, model,
                       cases=(("int8 beam 20", "decode-int8", "beam_search"),),
                       seeds=WIDE_SEEDS)
    phase_wide_times(label)
    phase_decode_times(cfg, vocab, model, label, cases=tuple(
        (f"beam {b}", cfg.replace(beam_size=b), "beam_search") for b in WIDE_BEAMS)
        + (("int8 beam 20", cfg.replace(beam_size=20, **MODES["decode-int8"]),
            "beam_search"),))
    return launches


# the single-image API: GEN_IMAGES seeded images, each with its
# detections' cluster vector and with an explicit one; whole captions
# may differ from the plain ops' in at most GEN_SLACK calls (the sum
# order's drift, as phase_decode_compare measures it: about 1% of rows)
GEN_IMAGES = 4
GEN_SLACK = 2
GEN_MODES = (("greedy", "greedy", None, False), ("beam 3", "beam_search", 3, True),
             ("sample", "sample", None, False))


def generate_inputs(work: str, n: int, seed: int):
    """``n`` uint8 images [1, 224, 224, 3] as float pixels, their file
    names, a detections JSON (COCO results format) for all but the last,
    and one explicit cluster vector an image."""
    rng = np.random.default_rng(seed)
    names = [f"gen_{i:03d}.jpg" for i in range(n)]
    pixels = [rng.integers(0, 256, (1, 224, 224, 3)).astype(np.float32)
              for _ in names]
    cv = coco_cv(n, seed=seed, zero_every=n + 1).cpu().numpy()
    dets = [{"file_name": name, "category_id": int(c) + 1, "score": 0.9}
            for name, row in zip(names[:-1], cv) for c in np.flatnonzero(row)]
    path = os.path.join(work, "detections.json")
    with open(path, "w") as f:
        json.dump(dets, f)
    return pixels, names, path, cv


def phase_generate(ckpt_dir: str, name: str, work: str, label: str,
                   modes=GEN_MODES) -> dict:
    """The single-image API (``generate.Generator.caption_pixels``, the
    part of ``generate_caption`` after the image read: the card machine
    has no cv2) on the checkpoint ``ckpt_dir/name``: the path's launches
    at every mode of ``modes``, the counts set to 0 before and read
    after; each call again through CheckedOps (per step against the plain
    versions, strict) and the whole captions against a Generator on the
    plain ops (at most GEN_SLACK calls differ); then one caption per mode
    timed on the host clock after a warm-up, VGG16 included (the
    checkpoint's fc2 at batch 1, or a fine-tune model's own VGG16)."""
    pixels, names, dets, cv = generate_inputs(work, GEN_IMAGES, 41)
    calls = [(p, n, v) for p, n, vec in zip(pixels, names, cv)
             for v in (None, vec)]
    gens = {}
    counts = dict.fromkeys(DECODE_KERNELS + MODE_KERNELS, 0)
    torch.cuda.synchronize()
    _ext.reset_launches()   # the generate path's run starts here
    t0 = time.perf_counter()
    steps = 0
    for mode, method, beam, beams in modes:
        gens[mode] = gen = Generator(ckpt_dir, name, method, detections_json=dets,
                                     device=DEV)
        for p, n, v in calls:
            out = gen.caption_pixels(p, n, beam, v, return_beams=beams)
            caption = out[0]["caption"]
            if out[0]["image_id"] != n or not (
                    isinstance(caption, str) if not beams
                    else len(caption) == beam and all(isinstance(c, str) for c in caption)):
                raise AssertionError(f"generate {mode}: malformed result {out}")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {k: _ext.LAUNCHES[k] for k in counts}      # right after
    print(f"generate path ({name}): {len(calls)} calls a mode ({GEN_IMAGES} images, "
          f"detections' and explicit cluster vectors), modes "
          f"{[m[0] for m in modes]}, in {seconds:.2f} s (the first calls build "
          f"VGG16 and the decode weights); launches {counts}")
    if not (counts["fused_lstm_step"] and counts["fused_logits_top_k"]) or (
            any(m[1] == "sample" for m in modes) and not counts["fused_logits_sample"]):
        raise AssertionError(f"generate: the decode kernels did not run: {counts}")
    for mode, method, beam, beams in modes:
        checked = CheckedOps()
        kern = Generator(ckpt_dir, name, method, detections_json=dets,
                         device=DEV, ops=checked.ops())
        plain = Generator(ckpt_dir, name, method, detections_json=dets,
                          device=DEV, ops=PLAIN_OPS)
        same = sum(kern.caption_pixels(p, n, beam, v, return_beams=beams)
                   == plain.caption_pixels(p, n, beam, v, return_beams=beams)
                   for p, n, v in calls)
        share = checked.same / checked.rows
        print(f"generate compare {mode} ({name}): per step, choices identical to the "
              f"plain version's in {share:.5f} of {checked.rows} rows, near-tie "
              f"rows {checked.near}, max |c', h' kernel - plain| "
              f"{checked.state_err:.3e}; whole captions identical to the plain "
              f"ops' in {same} of {len(calls)} calls")
        if checked.bad or share < STEP_SHARE or same < len(calls) - GEN_SLACK:
            raise AssertionError(f"generate {mode}: the kernels disagree with "
                                 "the plain versions")
    for mode, method, beam, beams in modes:
        gen = gens[mode]
        p, n, v = calls[0]
        gen.caption_pixels(p, n, beam, v, return_beams=beams)      # warm-up
        times = []
        for _ in range(5):
            t = time.perf_counter()
            gen.caption_pixels(p, n, beam, v, return_beams=beams)
            times.append((time.perf_counter() - t) * 1e3)
        feat = []
        for _ in range(5):
            t = time.perf_counter()
            gen._features(p).cpu()
            feat.append((time.perf_counter() - t) * 1e3)
        print(f"time generate {mode} ({name}), batch 1: median {np.median(times):.2f} "
              f"ms a caption (min {min(times):.2f}, max {max(times):.2f}; the "
              f"features alone, median {np.median(feat):.2f} ms) [{label}]")
    # the Generators' shared VGG16 (550 MB on the card) would count in
    # the later phases' memory
    feature_extractor.cache_clear()
    return counts


def phase_generate_ag(cfg, trainer, npz: str, out_dir: str, label: str) -> dict:
    """The single-image API on the AG-CVAE the train-ag path trained
    (saved as a checkpoint whose config names the synthetic Caffe npz,
    removed after the phase)."""
    work = os.path.join(out_dir, "generate")
    os.makedirs(work, exist_ok=True)
    try:
        vocab = Vocabulary(["<BOS>", "<EOS>", "<UNK>"]
                           + [f"w{i}" for i in range(VOCAB - 4)])
        save_sidecars(cfg.replace(image_net_weights_path=npz, mode="inference",
                                  gen_max_len=30), vocab, work, "ag")
        save_params(export_flax_params(trainer.model), work, "ag")
        return phase_generate(work, "ag", work, label)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def phase_fidelity(npz: str, work: str, label: str) -> None:
    """``vgg_fidelity.compare`` on the synthetic Caffe npz, the path under
    test on the card: it must PASS; the port's loader on the true file
    against the oracle on a copy with conv5_2 and conv5_3 swapped (what
    the tool sees of a loader that takes that layout) must FAIL."""
    t0 = time.perf_counter()
    ok, report = vgg_fidelity.compare(npz, device=DEV)
    seconds = time.perf_counter() - t0
    print(f"fidelity: {'PASS' if ok else 'FAIL'} on the synthetic npz in "
          f"{seconds:.2f} s: {json.dumps(report)}")
    if not ok:
        raise AssertionError("fidelity: the tool fails on the synthetic npz")
    with np.load(npz) as raw:
        arrays = dict(raw)
    arrays["conv5_2_W"], arrays["conv5_3_W"] = arrays["conv5_3_W"], arrays["conv5_2_W"]
    bad = os.path.join(work, "swapped.npz")
    np.savez(bad, **arrays)
    del arrays
    images = vgg_fidelity.fixed_image(batch=1)
    ref = vgg_fidelity.oracle_fc2(bad, images)
    ours = vgg_fidelity.port_fc2(npz, images, torch.float32, DEV)
    rel = float(np.abs(ours - ref).max()) / (float(np.abs(ref).max()) + 1e-12)
    os.remove(bad)
    print(f"fidelity: the port's loader against the oracle on the swapped "
          f"layout: rel diff {rel:.3e}, {'FAIL' if rel >= report['threshold'] else 'PASS'} "
          f"(threshold {report['threshold']}) [{label}]")
    if rel < report["threshold"]:
        raise AssertionError("fidelity: the swapped layout passes the tool")


# data-parallel training: DP_RANKS processes on the one card, joined over
# gloo (NCCL takes one rank a device); DP_STEPS steps of the AG-CVAE and
# of the GMM-CVAE under the flash CE at the train shapes, SGD, the z noise
# injected, against one process on the global batch (to the CPU test's
# tolerance); then the path with its own noise (the rank-folded fused z)
DP_RANKS, DP_STEPS, DP_TIME_STEPS = 2, 3, 3
DP_RTOL, DP_ATOL = 1e-3, 2e-4
DP_CASES = (("AG", ""), ("GMM", "fused_ce"))


def dp_config(prior: str, ce: str) -> Config:
    return train_config(prior, ce).replace(optimizer="SGD", learning_rate=0.05,
                                           multihost=dist.is_initialized())


def dp_batch(seed: int) -> Batch:
    """One train batch on the host, B = 256 images x 5 captions x 24."""
    feats, labels, dec, lengths, c_v = (t.cpu().numpy() for t in train_arrays(seed))
    B, K, T = TRAIN_IMAGES, TRAIN_CAPTIONS, TRAIN_T
    return Batch(features=feats, dec_inputs=dec.reshape(B, K, T),
                 labels=labels.reshape(B, K, T), lengths=lengths.reshape(B, K),
                 cluster_vectors=c_v, valid=B)


def dp_ops() -> TrainOps:
    """The kernels, with the fused z fed this rank's rows of one global
    eps (drawn on the card from a seed, the same in every process)."""
    eps = torch.randn((TRAIN_ROWS, KZ, LATENT), device=DEV,
                      generator=torch.Generator(device=DEV).manual_seed(5))

    def sample_project(mean, std, w, b, n, seed, step):
        rank, _ = dp_mesh.process_info()
        rows = mean.shape[0]
        return fused_z_plain(mean, std, w, b, n, eps=eps[rank * rows:(rank + 1) * rows])

    return TrainOps(sample_project=sample_project)


def dp_run(prior: str, ce: str, out: str) -> list:
    """DP_STEPS steps in this process (a rank, or one process on the
    global batch): the metrics by step; the final parameters to
    ``out``."""
    trainer = Trainer(dp_config(prior, ce), device=DEV, ops=dp_ops())
    if prior == "GMM":       # fixed cluster draws, this rank's rows
        rank, world = dp_mesh.process_info()
        idx = np.random.default_rng(11).integers(0, CLUSTERS, size=TRAIN_ROWS)
        n = TRAIN_ROWS // world
        trainer.clusters = torch.from_numpy(idx[rank * n:(rank + 1) * n]).to(DEV)
    metrics = [{k: float(v) for k, v in trainer.run_step(dp_batch(20 + i)).items()}
               for i in range(DP_STEPS)]
    if trainer.is_main:
        np.savez(out, **export_flax_params(trainer.model))
    return metrics


def dp_rank(rank: int, world: int, port: int, work: str) -> None:
    """One rank of phase_dp (a spawned process): the compared runs, then
    1 + DP_TIME_STEPS steps of the AG-CVAE and of the GMM-CVAE (flash CE)
    with their own noise, the launches and the step ms; its results in
    ``work``/rank<r>.json."""
    dp_mesh.init_process_group(rank, world, f"tcp://127.0.0.1:{port}", DEV,
                               backend="gloo", timeout=600)
    try:
        result = {p: dp_run(p, ce, os.path.join(work, f"dp_{p}.npz"))
                  for p, ce in DP_CASES}
        batch = dp_batch(30)
        torch.cuda.synchronize()
        _ext.reset_launches()   # this rank's dp path starts here
        for prior, ce in DP_CASES:
            trainer = Trainer(dp_config(prior, ce), device=DEV)
            trainer.run_step(batch)                              # warm-up
            times = []
            for _ in range(DP_TIME_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m = trainer.run_step(batch)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            result[f"ms {prior}"] = times
            result[f"loss {prior}"] = float(m["loss"])
            del trainer
        result["launches"] = dict(_ext.LAUNCHES)                 # right after
        result["seeds"] = [DataParallel.current().seed(s) for s in (1, 2)]
        with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
            json.dump(result, f)
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_dp(out_dir: str, label: str) -> dict:
    """DP_RANKS ranks spawned on the one card over gloo: the AG-CVAE and
    the GMM-CVAE (flash CE) each DP_STEPS SGD steps at B = 256 x 5 x 24
    (each rank 128 images), with the z noise injected and the GMM clusters
    fixed, against the same steps in this process on the global batch:
    every step's loss, rec_loss, kld and grad_norm and every final
    parameter to rtol DP_RTOL, atol DP_ATOL.  Then each rank's launches
    over 1 + DP_TIME_STEPS steps of the AG-CVAE and of the GMM-CVAE
    (flash CE) with their own, rank-folded, noise (every train kernel of
    those paths, the fused z included) and the step's ms on the host
    clock: two processes share one card, so the time measures the code
    path (and gloo's host copies), not a speed-up."""
    work = os.path.join(out_dir, "dp")
    os.makedirs(work, exist_ok=True)
    try:
        t0 = time.perf_counter()
        torch.multiprocessing.start_processes(
            dp_rank, args=(DP_RANKS, free_port(), work), nprocs=DP_RANKS,
            join=True, start_method="spawn")
        seconds = time.perf_counter() - t0
        ranks = []
        for r in range(DP_RANKS):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        for prior, ce in DP_CASES:
            if ranks[0][prior] != ranks[1][prior]:
                raise AssertionError(f"dp {prior}: the ranks' metrics differ")
            one_path = os.path.join(work, f"one_{prior}.npz")
            one = dp_run(prior, ce, one_path)
            worst = 0.0
            for i, (g, w) in enumerate(zip(ranks[0][prior], one)):
                for key in ("loss", "rec_loss", "kld", "grad_norm"):
                    rel = abs(g[key] - w[key]) / abs(w[key])
                    worst = max(worst, rel)
                    if rel > DP_RTOL:
                        raise AssertionError(f"dp {prior} step {i + 1}: {key} "
                                             f"{g[key]:.6f} against {w[key]:.6f}")
            with np.load(os.path.join(work, f"dp_{prior}.npz")) as got, \
                    np.load(one_path) as want:
                excess = max(float((np.abs(got[k] - want[k])
                                    - (DP_ATOL + DP_RTOL * np.abs(want[k]))).max())
                             for k in want.files)
            print(f"dp {prior} ({ce or 'plain CE'}): {DP_RANKS} ranks against one "
                  f"process on the global batch over {DP_STEPS} SGD steps: metrics max "
                  f"rel diff {worst:.2e} (rtol {DP_RTOL}); every parameter within "
                  f"atol {DP_ATOL} + rtol {DP_RTOL} (largest excess {excess:.3e}); "
                  f"loss by step " + ", ".join(f"{m['loss']:.5f}" for m in ranks[0][prior]))
            if excess > 0:
                raise AssertionError(f"dp {prior}: the parameters differ from one "
                                     "process's")
        runs = [train_launches(DP_TIME_STEPS + 1, p == "AG", ce) for p, ce in DP_CASES]
        want = {k: sum(r[k] for r in runs) for k in runs[0]}
        for r, res in enumerate(ranks):
            got = {k: res["launches"][k] for k in want}
            print(f"dp path rank {r}: launches {got}, expected {want}; step ms "
                  + "; ".join(f"{p} {', '.join(f'{t:.2f}' for t in res['ms ' + p])}"
                              f" (loss {res['loss ' + p]:.5f})" for p, _ in DP_CASES)
                  + f"; z seeds of base seeds 1, 2: {res['seeds']}")
            if got != want:
                raise AssertionError(f"dp rank {r} launch counts {got} != {want}")
        if ranks[0]["seeds"] == ranks[1]["seeds"]:
            raise AssertionError("dp: the ranks draw the same noise")
        for prior, ce in DP_CASES:
            print(f"time dp step {prior} ({ce or 'plain CE'}), {DP_RANKS} ranks x "
                  f"{TRAIN_IMAGES // DP_RANKS} images x {TRAIN_CAPTIONS} captions on "
                  f"one card (gloo): rank 0 median {np.median(ranks[0]['ms ' + prior]):.2f} "
                  f"ms, rank 1 {np.median(ranks[1]['ms ' + prior]):.2f} ms; the code "
                  f"path, not a speed-up [{label}]")
        print(f"dp phase: {seconds:.1f} s of spawned ranks (their start included)")
        return ranks[0]["launches"]
    finally:
        shutil.rmtree(work, ignore_errors=True)


PROFILE_STEPS = 5


def port_kernel_names() -> dict:
    """{kernel function name: source file} over the sources in csrc/."""
    names = {}
    for src in sorted(_ext.CSRC_DIR.glob("*.cu*")):
        for name in re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
                               r"(\w+)", src.read_text()):
            names[name] = src.name
    return names


def phase_train_profile(out_dir: str, label: str, prior: str, ce=None) -> None:
    """The kernel path's full-width train step of the ``prior`` model
    under torch.profiler: PROFILE_STEPS steps after 3 warm-up steps.  The
    trace's kernel, memcpy and memset events are timed per step by name
    and by group (the port's kernels one by one, cuBLAS GEMMs, copies,
    other PyTorch kernels) as the union of their intervals, and so are the
    port's kernels by source file and the device's busy time; the idle share is 1 - busy / the step's
    host-clock time under the profiler.  Writes the trace and a summary to
    ``out_dir`` (``train_*`` for the Normal prior, ``ag_train_*`` for
    AG, ``gmm_train_*`` for GMM with the flash CE, ``gmm_hybrid_train_*``
    with the hybrid CE, ``ce="ce_hybrid"``)."""
    from torch.profiler import ProfilerActivity, profile
    trainer = Trainer(train_config(prior, ce), device=DEV)
    arrays = train_arrays()
    prefix = {"Normal": "train", "AG": "ag_train", "GMM": "gmm_train"}[prior]
    if ce == "ce_hybrid":
        prefix = "gmm_hybrid_train"
    for _ in range(3):
        trainer.run_step_arrays(arrays)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            trainer.run_step_arrays(arrays)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / PROFILE_STEPS * 1e3
    trace = os.path.join(out_dir, f"{prefix}_step_trace.json")
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not events:
        raise AssertionError("profile: the trace holds no device events")
    ours = port_kernel_names()
    # each group's and kernel's time is the union of its events' intervals:
    # a kernel launched with programmatic dependent launch starts while the
    # one before it finishes, and its duration counts that wait
    spans, counts = ({}, {}), ({}, {})
    modules = {}
    for e in events:
        # "void (anonymous namespace)::name<512, false>(args)" -> "name" and
        # its template arguments "<512, false>"
        head = e["name"].replace("(anonymous namespace)::", "").split("(")[0]
        short = (head.split("<")[0].split("::")[-1].split() or [""])[-1]
        targs = head[head.index("<"):] if "<" in head else ""
        if e["cat"] != "kernel":
            group = "memcpy / memset"
        elif short in ours:
            group = f"port: {short}{targs} ({ours[short]})"
            modules.setdefault(ours[short], []).append((e["ts"], e["ts"] + e["dur"]))
        elif any(w in e["name"].lower() for w in ("gemm", "xmma", "cutlass")):
            group = "cuBLAS GEMM"
        else:
            group = "other PyTorch kernels"
        for k, key in enumerate((group, e["name"][:120])):
            spans[k].setdefault(key, []).append((e["ts"], e["ts"] + e["dur"]))
            counts[k][key] = counts[k].get(key, 0) + 1
    groups, by_name = ({key: (union_ms(v) / PROFILE_STEPS, counts[k][key])
                        for key, v in spans[k].items()} for k in range(2))
    busy_ms = union_ms((e["ts"], e["ts"] + e["dur"]) for e in events) / PROFILE_STEPS
    print(f"profile: {prior} ({CE_NAMES[ce_flag(trainer.cfg)]}) train step "
          f"{TRAIN_IMAGES} images x {TRAIN_CAPTIONS} "
          f"captions x {TRAIN_T} tokens, {PROFILE_STEPS} steps after 3 warm-up "
          f"[{label}]: {step_ms:.3f} ms/step under the profiler, device busy "
          f"{busy_ms:.3f} ms, idle share {1 - busy_ms / step_ms:.4f}")
    for key, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"profile group {ms:9.4f} ms/step {n / PROFILE_STEPS:6.1f} "
              f"launches/step  {key}")
    for src, v in sorted(modules.items(), key=lambda kv: -union_ms(kv[1])):
        print(f"profile module {union_ms(v) / PROFILE_STEPS:9.4f} ms/step "
              f"{len(v) / PROFILE_STEPS:6.1f} launches/step  {src}")
    for key, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:25]:
        print(f"profile kernel {ms:9.4f} ms/step {n / PROFILE_STEPS:6.1f} "
              f"launches/step  {key}")
    with open(os.path.join(out_dir, f"{prefix}_profile.json"), "w") as f:
        json.dump({"card": label, "prior": prior,
                   "ce": CE_NAMES[ce_flag(trainer.cfg)], "steps": PROFILE_STEPS,
                   "step_ms": step_ms,
                   "busy_ms": busy_ms, "groups": groups, "by_name": by_name,
                   "modules": {src: union_ms(v) / PROFILE_STEPS
                               for src, v in modules.items()}}, f,
                  indent=1)


# the wgmma + TMA kernel templates: the CE forward of both schedules
# (csrc/fused_ce.cuh, <H, WRITE_LG>), the flash CE's backward
# (csrc/fused_ce.cu, <H, DW>), the written logits' backward
# (csrc/fused_ce_mat.cu, <H, DW>), the AG-heads forward and the backward's
# dq pass (csrc/fused_ag_heads.cu, <NC, RES, BWD>) and the backward's
# products (<CT, DW>), the LSTM cell of the decode step and the sequence
# forward (csrc/lstm_cell.cuh, <U, StepEpi | SeqEpi>), and the sequence
# backward's steps and dx (csrc/fused_lstm_seq.cu, <WG, MODE>) and its dW
# products (<CT>), and the fused z forward, dmu/dsigma and dW
# (csrc/fused_z.cu, <CT>), and the decode's logits top-k, int8 top-k and
# sampler (csrc/fused_logits_topk.cu, <logit, RG, RES, BOXES, score, K>): each one's
# instance label from its template arguments (a list: ints, bools and type
# names in order), and its dynamic shared memory (the AG forward's at H =
# HIDDEN with h resident, at 2·HIDDEN with h streamed; the LSTM cell's at E
# = EMBED, H = HIDDEN; the logits kernels' at H = HIDDEN)
SEQ_MODES = ("gates of step T-1", "step", "step 0 (dh0)", "dx")
WGMMA_TEMPLATES = {
    "ce_fwd_kernel": (lambda a: f"<{a[0]}, {'written logits' if a[1] else 'flash'}>",
                      lambda a: _ext.library().vct_fused_ce_fwd_smem(a[0], int(a[1]))),
    "ce_bwd_kernel": (lambda a: f"<{a[0]}, {'dW/db' if a[1] else 'dh'}>",
                      lambda a: _ext.library().vct_fused_ce_bwd_smem(a[0])),
    "ce_mat_bwd_kernel": (lambda a: f"<{a[0]}, {'dW/db' if a[1] else 'dh'}>",
                          lambda a: _ext.library().vct_fused_ce_mat_bwd_smem(a[0])),
    "ag_fwd_kernel": (lambda a: f"<NC={a[0]}, h {'resident' if a[1] else 'streamed'}, "
                                f"{'dq pass' if a[2] else 'forward'}>",
                      lambda a: _ext.library().vct_fused_ag_heads_fwd_smem(
                          HIDDEN if a[1] else 2 * HIDDEN, a[0])),
    "ag_mat_kernel": (lambda a: f"<CT={a[0]}, {'dW' if a[1] else 'dh'}>",
                      lambda a: _ext.library().vct_fused_ag_heads_mat_smem(a[0])),
    "lstm_cell_kernel": (lambda a: f"<U={a[0]}, {a[1]}: "
                                   f"{'decode step' if a[1] == 'StepEpi' else 'sequence forward'}>",
                         lambda a: (lstm_step_layout(EMBED, HIDDEN, a[0])[2] if a[1] == "StepEpi"
                                    else _ext.library().vct_fused_lstm_seq_fwd_smem())),
    "seq_bwd_kernel": (lambda a: f"<WG={a[0]}, {SEQ_MODES[a[1]]}>",
                       lambda a: _ext.library().vct_fused_lstm_seq_bwd_smem(a[0], a[1])),
    "seq_dw_kernel": (lambda a: f"<CT={a[0]}, dW>",
                      lambda a: _ext.library().vct_fused_lstm_seq_dw_smem(a[0])),
    "z_fwd_kernel": (lambda a: f"<CT={a[0]}, forward>",
                     lambda a: _ext.library().vct_fused_z_smem(0, a[0])),
    "z_dmu_kernel": (lambda a: f"<CT={a[0]}, dmu/dsigma>",
                     lambda a: _ext.library().vct_fused_z_smem(1, a[0])),
    "z_dw_kernel": (lambda a: f"<CT={a[0]}, dW>",
                    lambda a: _ext.library().vct_fused_z_smem(2, a[0])),
    "logits_topk_kernel": (
        lambda a: f"<{'int8' if a[0] == 'S8Logit' else 'bf16'}, {64 * a[1]} rows, h "
                  f"{'resident' if a[2] else 'streamed'}, {a[3] or 'runtime'} boxes, "
                  f"{ {'GumbelScore': 'sampler', 'WriteLogits': 'writer'}.get(a[4], 'top-k')}, "
                  f"K={a[5]}>",
        lambda a: _ext.library().vct_fused_logits_top_k_smem(
            HIDDEN, int(a[0] == "S8Logit"), 64 * a[1], int(a[2]))),
    # not a wgmma kernel: the top-k + logsumexp's lists (static shared
    # memory only), K at compile time or, past 16, at run time
    "topk_lse_kernel": (lambda a: f"<K={a[0] or 'run time'}, {a[1]} entries a lane>",
                        lambda a: 0),
}


def template_args(mangled: str, name: str) -> list:
    """The template arguments of a mangled instance of ``name``, in order:
    ints (``Li64E``), bools (``Lb1E``) and the type names of the LSTM
    cell's epilogues (``StepEpi``, ``SeqEpi``) and of the logits kernel's
    policies (``Bf16Logit``, ``S8Logit``, ``RawLogit``, ``GumbelScore``,
    ``WriteLogits``)."""
    rest = mangled[mangled.index(f"{len(name)}{name}I") + len(name) + len(str(len(name))) + 1:]
    rest = rest[:rest.find("Ev")] if "Ev" in rest else rest
    args = []
    for m in re.finditer(r"Li(\d+)E|Lb([01])E|(StepEpi|SeqEpi|Bf16Logit|S8Logit|RawLogit"
                         r"|GumbelScore|WriteLogits)", rest):
        args.append(int(m.group(1)) if m.group(1) else m.group(2) == "1"
                    if m.group(2) else m.group(3))
    return args


def print_template_resources() -> None:
    """Registers, spills and shared memory of the wgmma + TMA kernel
    templates (``WGMMA_TEMPLATES``, and the top-k + logsumexp's
    instances) at every instance, from nvcc's
    -Xptxas=-v output in build.log, and any ptxas warning that it
    serialises an instance's wgmmas (C7515); the dynamic shared memory from
    the libraries' exports (the decode LSTM step's from its layout's)."""
    lines = _ext.build_log.splitlines()
    names = "|".join(WGMMA_TEMPLATES)
    found = 0
    for i, line in enumerate(lines):
        m = re.search(rf"Compiling entry function '(\w*?\d({names})I\w*)'", line)
        if not m:
            continue
        name = m.group(2)
        args = template_args(m.group(1), name)
        label, smem = WGMMA_TEMPLATES[name]
        info = " ".join(lines[i + 1:i + 4])
        regs = re.search(r"Used (\d+) registers", info)
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", info)
        print(f"build: {name}{label(args)}: "
              f"{regs.group(1) if regs else '?'} registers, spill stores / loads "
              f"{spills.group(1) + ' / ' + spills.group(2) + ' B' if spills else '?'}, "
              f"{smem(args)} B dynamic shared memory")
        found += 1
    for line in lines:
        m = re.search(rf"Potential Performance Loss: (.*) in the function "
                      rf"'(\w*?\d({names})I\w*)'", line)
        if m:
            name = m.group(3)
            print(f"build: {name}{WGMMA_TEMPLATES[name][0](template_args(m.group(2), name))}: "
                  f"ptxas: {m.group(1)}")
    if not found:
        print("build: no ptxas report of the wgmma templates (the libraries "
              "were already built)")


def main() -> None:
    if sys.argv[1:] not in ([], ["--profile"]):
        sys.exit(f"chip_smoke: unknown arguments {sys.argv[1:]}; the only "
                 "option is --profile")
    label = card()
    print(f"card: {label}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "chiprun_out", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)

    _ext.library()
    with open(os.path.join(out_dir, "build.log"), "w") as f:
        f.write(_ext.build_log)
    print(f"build: {_ext.build_seconds:.1f} s -> " + ", ".join(
        _ext.library_path(src).name for src in _ext._sources())
        + f" (nvcc output in {out_dir}/build.log)")
    print_template_resources()
    if sys.argv[1:] == ["--profile"]:
        for prior, ce in (("Normal", ""), ("AG", ""), ("GMM", "fused_ce"),
                          ("GMM", "ce_hybrid")):
            phase_train_profile(out_dir, label, prior, ce)
        return

    t0 = time.perf_counter()
    npz = os.path.join(out_dir, "vgg16_weights.npz")
    try:
        run_phases(out_dir, npz, label, t0)
    finally:
        if os.path.exists(npz):
            os.remove(npz)


def run_phases(out_dir: str, npz: str, label: str, t0: float) -> None:
    """Every phase after the build, then the record lines; ``npz``: where
    the synthetic Caffe weights of the VGG16 phases go."""
    errors = {**phase_kernels(), **phase_mode_kernels(), **phase_train_kernels(),
              **phase_ag_kernels(), **phase_ce_kernels(), **phase_ce_mat_kernels()}
    cfg, vocab, model, launches = phase_main_path(out_dir)
    phase_decode_compare(cfg, vocab, model)
    launches.update(phase_mode_paths(cfg, vocab, model, out_dir))
    phase_mode_compare(cfg, vocab, model)
    t_slice = time.perf_counter()
    for name, err in phase_writer_kernels().items():
        errors[name] = max(errors[name], err)
    by_path = {"wide-beam": phase_wide_beam(cfg, vocab, model, label)}
    t_wide = time.perf_counter() - t_slice
    t_npz = time.perf_counter()
    vgg_npz(npz)
    print(f"VGG16 npz (Caffe layout, numpy draws) written in "
          f"{time.perf_counter() - t_npz:.2f} s")
    # (prior, CE flag, tag, the kernels whose launches the record reads from
    # this path, whether the checkpoint round trip runs); the xla-bwd path
    # runs the hybrid's backward kernels, whose launches it checks itself
    for prior, ce, tag, kernels, round_trip in (
            ("Normal", "", "train", TRAIN_KERNELS + ("fused_z_eps",), True),
            ("AG", "", "train-ag", AG_KERNELS, True),
            ("GMM", "fused_ce", "train-gmm", CE_KERNELS, True),
            ("GMM", "ce_hybrid", "train-gmm-hybrid", MAT_KERNELS, False),
            ("GMM", "ce_xla_bwd", "train-gmm-xla-bwd", (), False)):
        tcfg, arrays = train_config(prior, ce), train_arrays()
        trainer, path_launches = phase_train_path(tcfg, arrays, tag)
        launches.update({k: path_launches[k] for k in kernels})
        phase_train_compare(tcfg, train_arrays(seed=10), tag)
        if round_trip:
            phase_round_trip(tcfg, trainer, out_dir, tag)
        if tag == "train-ag":
            t_gen = time.perf_counter()
            by_path["generate"] = phase_generate_ag(tcfg, trainer, npz, out_dir, label)
            t_gen = time.perf_counter() - t_gen
        del trainer
    t_cycle = time.perf_counter()
    for prior, ce, tag in (("AG", "", "resume-ag"),
                           ("GMM", "fused_ce", "resume-gmm")):
        phase_resume(prior, ce, out_dir, tag)
    quality = phase_quality(label)
    with open(os.path.join(out_dir, "quality.json"), "w") as f:
        json.dump(quality, f, indent=1)
    phase_finetune(out_dir, npz, label)
    print(f"resume, quality and finetune phases: "
          f"{time.perf_counter() - t_cycle:.1f} s")
    t_new = time.perf_counter()
    phase_fidelity(npz, out_dir, label)
    os.remove(npz)
    t_fid = time.perf_counter() - t_new
    t_new = time.perf_counter()
    by_path["dp"] = phase_dp(out_dir, label)
    print(f"this slice's phases: wide-beam {t_wide:.1f} s, generate (AG) "
          f"{t_gen:.1f} s, fidelity {t_fid:.1f} s, dp "
          f"{time.perf_counter() - t_new:.1f} s")
    times = {**phase_kernel_times(label), **phase_mode_kernel_times(label),
             **phase_train_kernel_times(label), **phase_ag_kernel_times(label),
             **phase_ce_kernel_times(label), **phase_ce_mat_kernel_times(label)}
    phase_decode_times(cfg, vocab, model, label)
    for prior, tag in (("Normal", "train"), ("AG", "train-ag"), ("GMM", "train-gmm")):
        phase_train_times(train_config(prior), train_arrays(seed=12), label, tag)
    for prior in ("GMM", "Normal"):
        phase_ce_step_times(prior, train_arrays(seed=12), label)
    print(f"phases: {time.perf_counter() - t0:.1f} s")
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "flax", "optax", "orbax", "vae_captioning_tpu"))
    if loaded:
        raise AssertionError(f"the port loaded JAX modules: {loaded[:5]}")

    paths = {**{k: "decode" for k in DECODE_KERNELS},
             **{k: path for path, k in MODE_PATHS.items()},
             **{k: "train" for k in TRAIN_KERNELS}, "fused_z_eps": "check",
             **{k: "train-ag" for k in AG_KERNELS},
             **{k: "train-gmm" for k in CE_KERNELS},
             **{k: "train-gmm-hybrid" for k in MAT_KERNELS}}
    # each kernel's launches on every path that ran it: the first path's
    # (``path``, ``launches``) and this slice's (generate, wide-beam, dp)
    record = {"kernels": [
        {"name": name, **meta, "path": paths[name], "launches": launches[name],
         "paths": {paths[name]: launches[name],
                   **{p: c[name] for p, c in by_path.items() if c.get(name)}},
         "max_abs_err": errors[name], **times[name]}
        for name, meta in KERNELS.items()]}
    print(label)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
