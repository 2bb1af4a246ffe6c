"""Smoke test of the PyTorch port on one NVIDIA GPU (``python3 chip_smoke.py``).

Phases, in order; any failure raises and the script exits nonzero:

1. device: require CUDA, print the card's name and power limit;
2. build: compile the CUDA kernels from ``vae_captioning_torch/csrc``;
3. kernels: each kernel against its plain PyTorch version on the card,
   at the main path's shapes and ragged ones, plus a deliberate tie;
4. main path: the full-width AG-CVAE (random weights from a seed, in the
   Flax layout, through the bridge) decodes synthetic features through
   ``run_inference`` at beam 3, beam 10 and greedy, writing the val/test
   JSON files; the kernels' launch counts must match the steps taken;
   then batches are decoded at beam 3, beam 10 and greedy through the
   kernels, the plain versions and the plain versions summed in reverse
   order, and compared step by step and caption by caption (see
   phase_decode_compare);
5. times: decode batches and each kernel against its plain version.

Before its last lines it checks that no JAX module was loaded.  The line
before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: CUDA is not available; this script needs one GPU")

from vae_captioning_tpu.config import Config  # noqa: E402
from vae_captioning_tpu.data.batcher import CaptionBatcher  # noqa: E402
from vae_captioning_tpu.data.features import FeatureStore  # noqa: E402
from vae_captioning_tpu.data.vocabulary import Vocabulary  # noqa: E402
from vae_captioning_torch import _ext  # noqa: E402
from vae_captioning_torch.bridge import (flax_shapes,  # noqa: E402
                                         load_flax_params)
from vae_captioning_torch.inference import (PLAIN_OPS,  # noqa: E402
                                            REORDERED_OPS, DecodeOps,
                                            make_decode_fns, run_inference)
from vae_captioning_torch.models.cvae import CVAEModel  # noqa: E402
from vae_captioning_torch.ops.fused_logits_topk import (  # noqa: E402
    fused_logits_top_k, fused_logits_top_k_plain)
from vae_captioning_torch.ops.fused_lstm_step import (  # noqa: E402
    fused_lstm_step, fused_lstm_step_plain)

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
}


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


def check_lstm(N: int) -> float:
    args = lstm_inputs(N, seed=N)
    got = fused_lstm_step(*args)
    want = fused_lstm_step_plain(*args)
    torch.cuda.synchronize()
    err = 0.0
    for name, a, r in zip(("c", "h"), got, want):
        diff = (a - r).abs()
        bad = diff > LSTM_ATOL
        if bool(bad.any()) or not bool(torch.isfinite(a).all()):
            raise AssertionError(
                f"fused_lstm_step N={N}: {name}' differs from the plain "
                f"version at {int(bad.sum())} places, max |diff| "
                f"{float(diff.max()):.3e}")
        err = max(err, float(diff.max()))
    print(f"fused_lstm_step N={N} E=256 H=512: max |kernel - plain| {err:.3e}")
    return err


def logits_inputs(M: int, V: int, H: int = 512, seed: int = 0):
    g = torch.Generator(device=DEV).manual_seed(seed)
    h = torch.tanh(torch.randn((M, H), generator=g, device=DEV)).to(torch.bfloat16)
    w = (0.05 * torch.randn((H, V), generator=g, device=DEV)).to(torch.bfloat16)
    b = 0.1 * torch.randn((V,), generator=g, device=DEV)
    return h, w, b


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


def check_topk(M: int, V: int, k: int) -> float:
    h, w, b = logits_inputs(M, V, seed=M + V + k)
    got = fused_logits_top_k(h, w, b, k)
    p_vals, p_idx, p_lse = fused_logits_top_k_plain(h, w, b, k + 1)
    torch.cuda.synchronize()
    tag = f"fused_logits_top_k M={M} V={V} k={k}"
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


def phase_kernels() -> dict:
    """Returns each kernel's largest |kernel - plain| over its checks."""
    lstm = max(check_lstm(N) for N in ROWS)
    topk = max(check_topk(M, V, k) for M in ROWS
               for V in (11500, 11519) for k in (1, 3, 10))
    for k in (1, 3, 10, 16):
        check_topk_ties(k)
    return {"fused_lstm_step": lstm, "fused_logits_top_k": topk}


def turns(fn_kernel, fn_plain, timer) -> tuple:
    """(kernel, plain) times, measured in turns kernel, plain, plain,
    kernel and averaged, so drift in clocks hits both alike."""
    k1, p1, p2, k2 = timer(fn_kernel), timer(fn_plain), timer(fn_plain), timer(fn_kernel)
    return (k1 + k2) / 2, (p1 + p2) / 2


def phase_kernel_times(label: str) -> dict:
    """Each kernel against its plain version at the main path's shapes:
    beam 3 (N = M = 1536, k = 3), beam 10 (5120, k = 10) and greedy (512,
    k = 1).  The record keeps the beam-3 shapes."""
    times = {}
    for N in (1536, 5120, 512):
        args = lstm_inputs(N)
        t = turns(lambda: fused_lstm_step(*args),
                  lambda: fused_lstm_step_plain(*args), cuda_ms)
        times.setdefault("fused_lstm_step", t)
        print(f"time fused_lstm_step N={N} E=256 H=512: kernel {t[0]:.4f} "
              f"ms, plain {t[1]:.4f} ms [{label}]")
    for M, k in ((1536, 3), (5120, 10), (512, 1)):
        h, w, b = logits_inputs(M, 11500)
        t = turns(lambda: fused_logits_top_k(h, w, b, k),
                  lambda: fused_logits_top_k_plain(h, w, b, k), cuda_ms)
        times.setdefault("fused_logits_top_k", t)
        print(f"time fused_logits_top_k M={M} H=512 V=11500 k={k}: kernel "
              f"{t[0]:.4f} ms, plain {t[1]:.4f} ms [{label}]")
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
    rng = np.random.default_rng(cfg.seed)
    params = {}
    for key, shape in flax_shapes(model).items():
        if key.endswith("/embedding"):
            params[key] = rng.standard_normal(shape, dtype=np.float32)
        elif key.endswith("/bias"):
            params[key] = 0.01 * rng.standard_normal(shape, dtype=np.float32)
        else:  # Flax kernels: xavier-uniform bound over [in, out]
            lim = np.float32((6.0 / (shape[0] + shape[1])) ** 0.5)
            params[key] = (2 * rng.random(shape, dtype=np.float32) - 1) * lim
    report = load_flax_params(model, params)
    if report.pending:
        raise AssertionError(f"unexpected pending parameters {report.pending}")
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
    launches = dict(_ext.LAUNCHES)   # read right after the main path
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
    their rtol; indices equal in every row whose plain top-(k+1) values
    hold no near-tie (TIE_GAP)."""

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

    def logits_top_k(self, h, w, b, k):
        got = fused_logits_top_k(h, w, b, k)
        p_vals, p_idx, p_lse = fused_logits_top_k_plain(h, w, b, k + 1)
        compare_topk(f"decode top-{k}", got, (p_vals[:, :k], p_idx[:, :k], p_lse))
        same = (got[1] == p_idx[:, :k]).all(dim=1)
        near = ((p_vals[:, :k] - p_vals[:, 1:]) <= TIE_GAP).any(dim=1)
        self.rows += int(same.numel())
        self.same += int(same.sum())
        self.near += int(near.sum())
        self.bad += int((~same & ~near).sum())
        return got

    def ops(self) -> DecodeOps:
        return DecodeOps(self.lstm_step, self.logits_top_k)


def phase_decode_compare(cfg, vocab, model) -> dict:
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
    Returns {mode: (kernel share, reversed-sum share)}."""
    shares = {}
    for mode, beam in (("beam 3", 3), ("beam 10", 10), ("greedy", 1)):
        c = cfg if beam == 1 else cfg.replace(beam_size=beam)
        fn_name = "greedy" if beam == 1 else "beam_search"
        checked = CheckedOps()
        fns = {name: make_decode_fns(model, c, vocab, ops=ops)[fn_name]
               for name, ops in (("kernel", checked.ops()),
                                 ("plain", PLAIN_OPS),
                                 ("reordered", REORDERED_OPS))}
        same = {"kernel": [], "reordered": []}
        score_err = 0.0
        for seed in DECODE_SEEDS:
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
        k_share = sum(same["kernel"]) / len(DECODE_SEEDS)
        r_share = sum(same["reordered"]) / len(DECODE_SEEDS)
        per = lambda xs: ", ".join(f"{x:.4f}" for x in xs)  # noqa: E731
        print(f"decode compare {mode} ({len(DECODE_SEEDS)} batches of {BATCH} "
              f"images, seeds {DECODE_SEEDS}): per step, top-{beam} indices "
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


def phase_decode_times(cfg, vocab, model, label: str) -> None:
    """ms per decode batch of 512 images and captions/s, kernel path vs
    plain path, by the host clock around work that ends in a copy of the
    tokens to the host."""
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

    for name, c in (("beam 3", cfg), ("beam 10", cfg.replace(beam_size=10)),
                    ("greedy", cfg)):
        fn_name = "greedy" if name == "greedy" else "beam_search"
        kern = make_decode_fns(model, c, vocab)[fn_name]
        plain = make_decode_fns(model, c, vocab, ops=PLAIN_OPS)[fn_name]
        g = torch.Generator(device=DEV).manual_seed(7)
        tk, tp = turns(lambda: kern(feats, c_v, generator=g),
                       lambda: plain(feats, c_v, generator=g), host_ms)
        steps = kern(feats, c_v, generator=g).steps
        print(f"time decode {name}, {BATCH} images, {steps} steps: kernel "
              f"{tk:.2f} ms/batch ({BATCH / tk * 1e3:.0f} captions/s), plain "
              f"{tp:.2f} ms/batch ({BATCH / tp * 1e3:.0f} captions/s) [{label}]")


def main() -> None:
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
    print(f"build: {_ext.build_seconds:.1f} s -> {_ext.library_path().name} "
          f"(nvcc output in {out_dir}/build.log)")

    errors = phase_kernels()
    cfg, vocab, model, launches = phase_main_path(out_dir)
    phase_decode_compare(cfg, vocab, model)
    times = phase_kernel_times(label)
    phase_decode_times(cfg, vocab, model, label)
    jax_modules = sorted(m for m in sys.modules if m.split(".")[0]
                         in ("jax", "jaxlib", "flax", "optax", "orbax"))
    if jax_modules:
        raise AssertionError(f"the port loaded JAX modules: {jax_modules[:5]}")

    record = {"kernels": [
        {"name": name, **meta, "launches": launches[name],
         "max_abs_err": errors[name], "ms": times[name][0],
         "plain_ms": times[name][1]}
        for name, meta in KERNELS.items()]}
    print(label)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
