"""Device time of design variants of three kernels, built from edited copies
of their sources, in turns.

The top-k + logsumexp over written logits (``csrc/topk_lse.cu``) at beam
3 and beam 10 (N = 1536, k = 3; 5120, 10), on ``chip_smoke.py``'s
unfused-decode logits, the fused z eps stream (``csrc/fused_z.cu``,
normals and raw words) at the train shapes (1280 x 100 x 150), and the
flash CE forward (``csrc/fused_ce.cuh``) at the wide cell's H = 1024 (M
= 30,720, V = 11,500), with its box count at compile time or at run
time.  Each variant is one or more text edits of the source (or of a
header it includes) as it stands; an edit that no longer applies fails
the run.  Variants are built side by side
(one nvcc each, all started together) into ``_build/designs/`` and
loaded with ctypes; each is timed by device time (``torch.profiler``)
in the order listed, then in reverse, and checked against the plain
version (``exact``: values and indices, or words and normals, bit for
bit).  Variants that drop work on purpose are marked as not exact.

    python3 kernel_designs.py        # from the repository's root, on a CUDA card
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys

import torch

from vae_captioning_torch import _ext

# (label, edits) on csrc/topk_lse.cu
TOPK_VARIANTS = (
    ("as built", ()),
    ("chunks of 4 float4 a lane", (("constexpr int U = 8;", "constexpr int U = 4;"),)),
    ("chunks of 4 float4, three blocks an SM",
     (("constexpr int U = 8;", "constexpr int U = 4;"),
      ("constexpr int BLOCKS_PER_SM = 2;", "constexpr int BLOCKS_PER_SM = 3;"))),
    ("the stream and logsumexp alone (no top-k; not exact)",
     (("    if (!__any_sync(FULL, mc > tv && mc >= low)) return;", "    return;"),)),
)
# (label, edits) on csrc/fused_z.cu
EPS_VARIANTS = (
    ("as built", ()),
    ("no tail formula (draw4's central path only; not exact)",
     (("  if (__any_sync(__activemask(), tail)) {", "  if (false) {"),)),
    ("spans of 64 rows", (("constexpr int EPS_SPAN = 4800;", "constexpr int EPS_SPAN = 9600;"),)),
)
# (label, edits) on csrc/fused_ce.cuh, built through csrc/fused_ce.cu
CE_FWD_VARIANTS = (
    ("as built (16 boxes at compile time)", ()),
    ("the box count at run time", (("    case 1024: return VCT_FWD(16, 1, true);\n", ""),)),
)


def build(csrc, out_dir, name, source, edits, edited=None):
    """Start nvcc on ``source`` with ``edits`` applied to it (or to the
    header ``edited``), beside copies of the shared headers; returns
    (library path, process)."""
    edited = edited or source
    text = (csrc / edited).read_text()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"kernel_designs: edit no longer applies to {edited}: {old!r}")
        text = text.replace(old, new)
    d = out_dir / name
    d.mkdir(parents=True)
    for header in csrc.glob("*.cuh"):
        shutil.copy(header, d)
    if edited != source:
        shutil.copy(csrc / source, d)
    (d / edited).write_text(text)
    lib = d / "lib.so"
    cmd = [_ext._nvcc(), *_ext.NVCC_FLAGS, "-shared", "-o", str(lib), str(d / source)]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def in_turns(calls: dict, device_ms) -> dict:
    """Device ms of each call, in the order given and then in reverse:
    {name: (first, second)}."""
    first = {name: sum(device_ms(fn).values()) for name, fn in calls.items()}
    second = {name: sum(device_ms(fn).values()) for name, fn in reversed(calls.items())}
    return {name: (first[name], second[name]) for name in calls}


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("kernel_designs: no CUDA device")
    import chip_smoke as cs
    from vae_captioning_torch.ops import fused_ce
    from vae_captioning_torch.ops.fused_z import philox_bits, philox_normals
    from vae_captioning_torch.ops.topk_lse import top_k_logsumexp_plain

    out_dir = _ext.BUILD_DIR / "designs"
    shutil.rmtree(out_dir, ignore_errors=True)
    jobs = {}
    for kind, source, edited, variants in (
            ("topk", "topk_lse.cu", None, TOPK_VARIANTS),
            ("eps", "fused_z.cu", None, EPS_VARIANTS),
            ("ce_fwd", "fused_ce.cu", "fused_ce.cuh", CE_FWD_VARIANTS)):
        for i, (name, edits) in enumerate(variants):
            jobs[(kind, name)] = build(_ext.CSRC_DIR, out_dir, f"{kind}{i}", source, edits,
                                       edited)
    libs = {}
    for key, (lib, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"kernel_designs: nvcc failed for {key}:\n{log}")
        libs[key] = ctypes.CDLL(str(lib))
    P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    for lib in libs.values():
        if hasattr(lib, "vct_top_k_logsumexp"):
            lib.vct_top_k_logsumexp.argtypes = [P] * 4 + [I] * 4 + [P]
        if hasattr(lib, "vct_fused_z_eps"):
            lib.vct_fused_z_eps.argtypes = [P] + [I] * 3 + [U, U, I, I, P]
        if hasattr(lib, "vct_fused_ce_fwd"):
            lib.vct_fused_ce_fwd.argtypes = [P] * 7 + [I] * 4 + [P]
    dev, label = cs.DEV, cs.card()
    sms = _ext.sm_count(dev.index)

    def top_k(lib, x, k):
        N, V = x.shape
        vals = torch.empty((N, k), device=dev)
        idx = torch.empty((N, k), dtype=torch.int32, device=dev)
        lse = torch.empty((N,), device=dev)
        _ext.check_launch(lib.vct_top_k_logsumexp(
            x.data_ptr(), vals.data_ptr(), idx.data_ptr(), lse.data_ptr(), N, V, k, sms,
            _ext.stream_ptr(dev)), "top_k_logsumexp variant")
        return vals, idx, lse

    def eps(lib, shape, raw):
        N, K, L = shape
        out = torch.empty(shape, dtype=torch.int32 if raw else torch.float32, device=dev)
        _ext.check_launch(lib.vct_fused_z_eps(out.data_ptr(), N, L, K, 5, 6, int(raw), sms,
                                              _ext.stream_ptr(dev)), "fused_z_eps variant")
        return out

    for N, k in ((1536, 3), (5120, 10)):
        x = cs.unfused_logits(N, 11500, seed=N)
        want = top_k_logsumexp_plain(x, k)
        calls = {name: (lambda lib=lib: top_k(lib, x, k))
                 for (kind, name), lib in libs.items() if kind == "topk"}
        for name, (a, b) in in_turns(calls, cs.device_ms).items():
            vals, idx, _ = calls[name]()
            exact = torch.equal(vals, want[0]) and torch.equal(idx, want[1])
            print(f"top_k_logsumexp N={N} V=11500 k={k}, {name}: device {a:.4f} / {b:.4f} ms; "
                  f"exact {exact} [{label}]")
    shape = (cs.TRAIN_ROWS, cs.KZ, cs.LATENT)
    words, normals = philox_bits(5, 6, *shape, device=dev), philox_normals(5, 6, *shape, device=dev)
    for raw in (False, True):
        calls = {name: (lambda lib=lib: eps(lib, shape, raw))
                 for (kind, name), lib in libs.items() if kind == "eps"}
        for name, (a, b) in in_turns(calls, cs.device_ms).items():
            got = calls[name]()
            exact = (torch.equal(got.long() & 0xFFFFFFFF, words) if raw
                     else torch.equal(got, normals))
            print(f"fused_z_eps {'x'.join(map(str, shape))} {'words' if raw else 'normals'}, "
                  f"{name}: device {a:.4f} / {b:.4f} ms; exact {exact} [{label}]")

    M, H, V = cs.TRAIN_T * cs.TRAIN_ROWS, cs.WIDE_HIDDEN, cs.VOCAB
    ops = fused_ce.prepare(*cs.ce_inputs(M, V, seed=13, labels=cs.train_ce_labels(), H=H)[:4])
    plan = fused_ce.ce_fwd_plan(M, V, sms, fused_ce.fwd_block(H)[0])
    want = fused_ce.ce_fwd_plain(*ops)

    def ce_fwd(lib):
        part = torch.empty(plan.part, device=dev)
        out = torch.empty((2, M), device=dev)
        _ext.check_launch(lib.vct_fused_ce_fwd(
            *(t.data_ptr() for t in ops), part.data_ptr(), out[0].data_ptr(),
            out[1].data_ptr(), M, H, V, plan.chunk_tiles, _ext.stream_ptr(dev)),
            "fused_ce_fwd variant")
        return out

    calls = {name: (lambda lib=lib: ce_fwd(lib))
             for (kind, name), lib in libs.items() if kind == "ce_fwd"}
    for name, (a, b) in in_turns(calls, cs.device_ms).items():
        err = float((calls[name]()[0] - want[0]).abs().max())
        print(f"fused_linear_ce_fwd M={M} H={H} V={V}, {name}: device {a:.4f} / {b:.4f} ms; "
              f"max |lse - plain| {err:.3e} [{label}]")


if __name__ == "__main__":
    main()
