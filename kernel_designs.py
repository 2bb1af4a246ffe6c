"""Device time of design variants of four kernels, built from edited copies
of their sources, in turns.

The top-k + logsumexp over written logits (``csrc/topk_lse.cu``) at beam
3 and beam 10 (N = 1536, k = 3; 5120, 10), on ``chip_smoke.py``'s
unfused-decode logits, the fused z eps stream (``csrc/fused_z.cu``,
normals and raw words) at the train shapes (1280 x 100 x 150), and the
CE forward (``csrc/fused_ce.cuh``, the flash forward built through
``fused_ce.cu`` and the written-logits one through ``fused_ce_mat.cu``)
at the wide cell's H = 1024 (M = 30,720, V = 11,500): clusters of 2
64-row blocks along M sharing each W box by TMA multicast (as built),
the 64-row blocks alone, clusters of 4, the two warpgroups of a block on
column halves of every tile (the flash forward; as built it takes alternate
tiles), the box count at run time, the fold
left out (the product stream alone; not exact) in clusters and alone,
each release a cluster-scope fence, and the fold without its exps or its
biases (not exact), each checked against the plain version (lse and ll within
chip_smoke.py's tolerance) and against the built kernel (bit for bit,
the written logits too).  Each variant is one or more text edits of the
source (or of a header it includes) as it stands; an edit that no longer
applies fails the run.  Variants are built side by side
(one nvcc each, all started together) into ``_build/designs/`` and
loaded with ctypes; each is timed by device time (``torch.profiler``)
in the order listed, then in reverse, and checked against the plain
version (``exact``: values and indices, or words and normals, bit for
bit).  Variants that drop work on purpose are marked as not exact.

The flash CE backward (``csrc/fused_ce.cu``) at the wide cell's H =
1024: its clusters of two column halves as built, clusters of 2 Q tiles
x 2 column halves sharing each K part by TMA multicast, the column
tiles of ``ce_bwd_wide_kernel``, a cluster barrier every tile, and the exchange left out (not
exact), each checked against the plain version (within chip_smoke.py's
tolerances) and against the built kernel (bit for bit).

    python3 kernel_designs.py            # from the repository's root, on a CUDA card
    python3 kernel_designs.py ce_fwd       # the named groups only (topk, eps,
                                           # ce_fwd, ce_bwd_wide)
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
# the CE forward's shape rule past 512 with the launches of the resident
# 64-row blocks alone, and its fold of a tile (and, with the
# written logits, the tile's store), as csrc/fused_ce.cuh states them; the
# cluster ring's release of a stage (csrc/row_ring.cuh)
_FWD_ALONE = (("  return !fixed_width(H) && fwd_block(H, write_lg) % 2 != 0 ? FWD_CLUSTER : 0;",
               "  return 0;"),
              ("  return VCT_FWD(0, 1, false, 1);\n",
               "  if (H == 1024) return VCT_FWD(16, 1, true, 1);\n"
               "  return fwd_block(H, WRITE_LG) % 2 ? VCT_FWD(0, 1, true, 1) : VCT_FWD(0, 1, false, 1);\n"))
_NO_FOLD = ("    if (RG == 1 && v0 >= V) continue;", "    continue;")
_FENCED_RELEASE = ("row_ring.cuh", "mbar_arrive_cluster(empty_at[r] + off)",
                   "mbar_arrive_remote(empty_at[r] + off)")
# The flash forward's clusters on the column split of a tile: both warpgroups
# of a 64-row block on every tile, each 64 of its columns (m64n64), as the
# written-logits forward runs (which builds as it is)
_HALVES_LABEL = "clusters of 2, warpgroups on column halves of every tile (flash only)"
_HALVES = (("  static constexpr bool ALTERNATE = RG == 1 && CLUSTER > 1 && !WRITE_LG;",
            "  static constexpr bool ALTERNATE = false;"),)
# (label, edits) on csrc/fused_ce.cuh (or the header an edit names), built
# through csrc/fused_ce.cu and csrc/fused_ce_mat.cu
CE_FWD_VARIANTS = (
    ("as built: clusters of 2 along M, W boxes multicast (flash: warpgroups on "
     "alternate tiles)", ()),
    ("64-row blocks alone, no cluster", _FWD_ALONE),
    ("clusters of 4 along M", (("constexpr int FWD_CLUSTER = 2;", "constexpr int FWD_CLUSTER = 4;"),
                               ("row_ring.cuh", "(RES && CLUSTER == 2)", "(RES && CLUSTER == 4)"))),
    ("clusters of 2, the box count at run time",
     (("    return H == 1024 ? VCT_FWD(16, 1, true, FWD_CLUSTER) : VCT_FWD(0, 1, true, FWD_CLUSTER);",
       "    return VCT_FWD(0, 1, true, FWD_CLUSTER);"),)),
    (_HALVES_LABEL, _HALVES),
    ("clusters of 2, no fold: the product stream alone (not exact)", (_NO_FOLD,)),
    ("blocks alone, no fold: the product stream alone (not exact)", (_NO_FOLD, *_FWD_ALONE)),
    ("clusters of 2, each release at cluster scope (mbarrier.arrive.release.cluster)",
     (_FENCED_RELEASE,)),
    ("clusters of 2, the fold's exps left out (not exact)",
     (("        se += ex2(fmaf(acc[4 * n + 2 * ii], LOG2E, -ms)) +\n"
       "              ex2(fmaf(acc[4 * n + 2 * ii + 1], LOG2E, -ms));",
       "        se += fmaf(acc[4 * n + 2 * ii], LOG2E, -ms) +\n"
       "              fmaf(acc[4 * n + 2 * ii + 1], LOG2E, -ms);"),)),
    ("clusters of 2, the biases not loaded (not exact)",
     (("        bias[2 * n + j] = col < V ? __ldg(&b[col]) : NEG;",
       "        bias[2 * n + j] = col < V ? 0.0f : NEG;"),)),
)
# the flash CE backward's exchange of partial logits (ce_bwd_cluster_kernel)
_EXCHANGE = """    if (i > 0) mbar_wait<true>(xch_free, (i - 1) & 1);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      st_async(peer_xch + (c * BWD_THREADS + tid) * 16,
               make_float4(sacc[4 * c], sacc[4 * c + 1], sacc[4 * c + 2], sacc[4 * c + 3]),
               peer_full);
    mbar_wait<true>(xch_full, i & 1);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float4 v = reinterpret_cast<const float4*>(xch)[c * BWD_THREADS + tid];
      sacc[4 * c] += v.x;
      sacc[4 * c + 1] += v.y;
      sacc[4 * c + 2] += v.z;
      sacc[4 * c + 3] += v.w;
    }
"""
_RELEASE = """    if (tid == 0 && i + 1 < n_tiles) {
      mbar_expect_tx(xch_full, P::XCH);
      mbar_arrive_remote(peer_free);
    }
"""
# Clusters of 2 Q tiles x 2 column halves (rank x + 2z): the two CTAs of a
# column half share each K part, each warpgroup leader loading a quarter of
# it into both by TMA multicast (hopper.cuh's tma_load_multicast), and
# refill a stage only once the other Q tile's warpgroup has released it
# too; the grid's Q tiles rounded up to 2
_MULTICAST = (
    ("(STAGES + 3) * sizeof(uint64_t);", "(STAGES + 3 + 2 * STAGES) * sizeof(uint64_t);"),
    ("  uint64_t* xch_free = xch_full + 1;  // the peer has read this CTA's last partial\n",
     "  uint64_t* xch_free = xch_full + 1;  // the peer has read this CTA's last partial\n"
     "  uint64_t* partner_free = xch_free + 1;\n"),
    ("  const int e0 = rank * CLUSTER_CT;", "  const int e0 = (rank / 2) * CLUSTER_CT;"),
    ("  const uint32_t peer = rank ^ 1;\n",
     "  const uint32_t peer = rank ^ 2;\n"
     "  const uint32_t partner_free_at = cluster_map(smem_addr(partner_free), rank ^ 1);\n"),
    ("""    if (wg == 0) load_boxes<0, P::BOXES / 2>(dst, &k_map, &full[s], row, e0);
    else load_boxes<P::BOXES / 2, P::BOXES>(dst, &k_map, &full[s], row, e0);
""", """    const int c0 = (P::BOXES / 2) * wg + 2 * (rank & 1);
    const uint16_t pair = static_cast<uint16_t>(3u << (rank & ~1u));
    mbar_expect_tx(&full[s], (P::BOXES / 2) * BOX_BYTES);
    tma_load_multicast(dst + c0 * BOX_BYTES, &k_map, &full[s], e0 + c0 * BOX, row, pair);
    tma_load_multicast(dst + (c0 + 1) * BOX_BYTES, &k_map, &full[s], e0 + (c0 + 1) * BOX,
                       row, pair);
"""),
    ("    mbar_init(xch_free, 1);\n",
     "    mbar_init(xch_free, 1);\n"
     "    for (int k = 0; k < 2 * P::STAGES; ++k) mbar_init(&partner_free[k], 1);\n"),
    ("      if (leader && i - 1 + P::STAGES < n_tiles) load_tile(i - 1 + P::STAGES);\n",
     """      if (leader && i - 1 + P::STAGES < n_tiles) {
        const int k = ((i - 1) % P::STAGES) * 2 + wg;
        mbar_arrive_remote(partner_free_at + k * sizeof(uint64_t));
        mbar_wait<true>(&partner_free[k], ((i - 1) / P::STAGES) & 1);
        load_tile(i - 1 + P::STAGES);
      }
"""),
    ("  // the [64, 512] f32 block of dh, or of this split's dW partial\n",
     "  if (blockIdx.x >= q_tiles) return;\n"
     "  // the [64, 512] f32 block of dh, or of this split's dW partial\n"),
    ("  attr[0].val.clusterDim.x = 1;", "  attr[0].val.clusterDim.x = 2;"),
    ("  cfg.gridDim = dim3(q_tiles, splits, CLUSTER);",
     "  cfg.gridDim = dim3((q_tiles + 1) / 2 * 2, splits, CLUSTER);"),
)
# (label, edits) on csrc/fused_ce.cu: the flash CE's dh and dW/db at H = 1024
CE_BWD_WIDE_VARIANTS = (
    ("as built: clusters of 2 column halves", ()),
    ("clusters of 2 Q tiles x 2 column halves, K parts multicast", _MULTICAST),
    ("column tiles, ce_bwd_wide_kernel",
     (("constexpr bool cluster_width(int H) { return H == CLUSTER_H; }",
       "constexpr bool cluster_width(int H) { return false; }"),)),
    ("a cluster barrier every tile after the exchange",
     ((_EXCHANGE, _EXCHANGE + "    cluster_arrive();\n    cluster_wait();\n"),)),
    ("no exchange: each CTA its own half of the logits (not exact)",
     ((_EXCHANGE, ""), (_RELEASE, ""))),
)
GROUPS = ("topk", "eps", "ce_fwd", "ce_bwd_wide")
# each group's builds: (library kind, source, header edited or None, variants)
BUILDS = {
    "topk": (("topk", "topk_lse.cu", None, TOPK_VARIANTS),),
    "eps": (("eps", "fused_z.cu", None, EPS_VARIANTS),),
    "ce_fwd": (("ce_fwd", "fused_ce.cu", "fused_ce.cuh", CE_FWD_VARIANTS),
               ("ce_mat_fwd", "fused_ce_mat.cu", "fused_ce.cuh", CE_FWD_VARIANTS)),
    "ce_bwd_wide": (("ce_bwd_wide", "fused_ce.cu", None, CE_BWD_WIDE_VARIANTS),),
}


def edit_files(csrc, edits, edited) -> dict:
    """{file: its text with ``edits`` applied}: an edit (old, new) to
    ``edited``, an edit (file, old, new) to that file of ``csrc``; an edit
    whose text is not there stops the run."""
    texts = {}
    for edit in edits:
        file, old, new = edit if len(edit) == 3 else (edited, *edit)
        text = texts.get(file) or (csrc / file).read_text()
        if old not in text:
            raise SystemExit(f"kernel_designs: edit no longer applies to {file}: {old!r}")
        texts[file] = text.replace(old, new)
    return texts


def build(csrc, out_dir, name, source, edits, edited=None):
    """Start nvcc on ``source`` with ``edits`` applied to it (or to the
    header ``edited``, or to the file an edit names: ``edit_files``),
    beside copies of the shared headers; returns (library path,
    process)."""
    d = out_dir / name
    d.mkdir(parents=True)
    for header in csrc.glob("*.cuh"):
        shutil.copy(header, d)
    shutil.copy(csrc / source, d)
    for file, text in edit_files(csrc, edits, edited or source).items():
        (d / file).write_text(text)
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
    groups = sys.argv[1:] or GROUPS
    if set(groups) - set(GROUPS):
        sys.exit(f"kernel_designs: groups are {GROUPS}, not {groups}")
    if not torch.cuda.is_available():
        sys.exit("kernel_designs: no CUDA device")
    import chip_smoke as cs

    out_dir = _ext.BUILD_DIR / "designs"
    shutil.rmtree(out_dir, ignore_errors=True)
    jobs = {}
    for kind, source, edited, variants in (b for g in groups for b in BUILDS[g]):
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
            lib.vct_fused_ce_dh.argtypes = [P] * 7 + [I] * 3 + [P]
            lib.vct_fused_ce_dwdb.argtypes = [P] * 10 + [I] * 5 + [P]
            lib.vct_fused_ce_fwd_cluster.argtypes = [I, I]
        if hasattr(lib, "vct_fused_ce_mat_fwd"):
            lib.vct_fused_ce_mat_fwd.argtypes = [P] * 8 + [I] * 4 + [P]
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

    if "topk" in groups:
        time_topk(libs, label, top_k)
    if "eps" in groups:
        time_eps(libs, dev, label, eps)
    if "ce_fwd" in groups:
        time_ce_fwd(libs, dev, label, sms)
    if "ce_bwd_wide" in groups:
        time_ce_bwd_wide(libs, dev, label)


def time_topk(libs, label, top_k) -> None:
    """The top-k + logsumexp variants at beam 3 and beam 10."""
    import chip_smoke as cs
    from vae_captioning_torch.ops.topk_lse import top_k_logsumexp_plain

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


def time_eps(libs, dev, label, eps) -> None:
    """The eps stream's variants, normals and raw words."""
    import chip_smoke as cs
    from vae_captioning_torch.ops.fused_z import philox_bits, philox_normals

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


# the widths past 512 other than 1024 at which the shape rule's choice
# (clusters or blocks alone, both with the box count at run time) is
# timed: the narrowest and widest resident widths of each forward
RULE_WIDTHS = ((576, False), (1280, False), (576, True), (1152, True))


def time_ce_fwd(libs, dev, label, sms) -> None:
    """Both CE forwards' variants at the wide cell's H = 1024 (the train
    batch's labels), by device time in turns, against the plain version
    and the built kernel; then, at ``RULE_WIDTHS``, the built kernel
    against the blocks alone (and, in the flash forward, the warpgroups
    on column halves).  Each variant's plan takes its own shape
    rule's cluster (asked from its flash library), and its line the L2
    bytes reckoned for it (chip_smoke.fwd_l2_bytes)."""
    names = [name for name, _ in CE_FWD_VARIANTS]
    for wl in (False, True):
        time_ce_fwd_at(libs, dev, label, sms, 1024, wl, names)
    for H, wl in RULE_WIDTHS:
        halves = [] if wl else [_HALVES_LABEL]
        time_ce_fwd_at(libs, dev, label, sms, H, wl, names[:2] + halves)


def time_ce_fwd_at(libs, dev, label, sms, H: int, wl: bool, names) -> None:
    """The variants ``names`` of one forward (flash, or written logits
    where ``wl``) at M = 30,720, V = 11,500 and width H."""
    import chip_smoke as cs
    from vae_captioning_torch.ops import fused_ce

    M, V = cs.TRAIN_T * cs.TRAIN_ROWS, cs.VOCAB
    ops = fused_ce.prepare(*cs.ce_inputs(M, V, seed=13, labels=cs.train_ce_labels(), H=H)[:4])
    want = fused_ce.ce_fwd_plain(*ops)
    rows = fused_ce.fwd_block(H, wl)[0]
    kind, tag = ("ce_mat_fwd", "fused_linear_ce_mat_fwd") if wl else ("ce_fwd", "fused_linear_ce_fwd")

    def forward(name):
        # the plan takes the shipped clusters; clusters of 4 run on their
        # chunks (the launch rounds its row blocks to whole clusters)
        cluster = libs["ce_fwd", name].vct_fused_ce_fwd_cluster(H, int(wl))
        plan = fused_ce.ce_fwd_plan(M, V, sms, rows, min(cluster, fused_ce.FWD_CLUSTER))
        part = torch.empty(plan.part, device=dev)
        out = torch.empty((2, M), device=dev)
        ptrs = [t.data_ptr() for t in ops] + [part.data_ptr()]
        if wl:
            lg = torch.empty((M, fused_ce.logits_pitch(V)), dtype=torch.bfloat16, device=dev)
            err = libs[kind, name].vct_fused_ce_mat_fwd(
                *ptrs, lg.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), M, H, V,
                plan.chunk_tiles, _ext.stream_ptr(dev))
        else:
            err = libs[kind, name].vct_fused_ce_fwd(
                *ptrs, out[0].data_ptr(), out[1].data_ptr(), M, H, V, plan.chunk_tiles,
                _ext.stream_ptr(dev))
        _ext.check_launch(err, f"{tag} variant")
        return (out[0], out[1], lg) if wl else (out[0], out[1])

    calls = {name: (lambda name=name: forward(name)) for name in names}
    built = calls[names[0]]()
    for name, (a, b) in in_turns(calls, cs.device_ms).items():
        got = calls[name]()
        rel = [cs.rel_err(g, r)[1] for g, r in zip(got, want)]
        ok = all(x <= cs.CE_FWD_RTOL for x in rel)
        same = all(torch.equal(g, r) for g, r in zip(got, built))
        cluster = libs["ce_fwd", name].vct_fused_ce_fwd_cluster(H, int(wl))
        print(f"{tag} M={M} H={H} V={V}, {name}: device {a:.4f} / {b:.4f} ms; "
              f"max |kernel - plain| / max lse, ll {rel[0]:.2e}, {rel[1]:.2e}: exact "
              f"(within {cs.CE_FWD_RTOL}) {ok}; bit for bit with the built kernel "
              f"{same}; L2 bytes reckoned "
              f"{cs.fwd_l2_bytes(M, H, V, wl, cluster) / 1e9:.3f} GB [{label}]")
        del got


def time_ce_bwd_wide(libs, dev, label) -> None:
    """dh and dW/db of each variant at M = 30,720, H = 1024, V = 11,500
    (the train batch's labels), by device time in turns, against the
    plain version and the built kernel."""
    import chip_smoke as cs
    from vae_captioning_torch.ops import fused_ce

    M, H, V = cs.TRAIN_T * cs.TRAIN_ROWS, cs.WIDE_HIDDEN, cs.VOCAB
    h, w, b, labels, weights = cs.ce_inputs(M, V, seed=13, labels=cs.train_ce_labels(), H=H)
    ops = fused_ce.prepare(h, w, b, labels)
    lse, _ = fused_ce.ce_fwd_plain(h, w, b, labels)
    plan = fused_ce.ce_bwd_plan(M, H, V)
    want = (fused_ce.ce_dh_plain(h, w, b, labels, lse, weights),
            *fused_ce.ce_dwdb_plain(h, w, b, labels, lse, weights))
    ptrs = [t.data_ptr() for t in (*ops, lse, weights)]

    def dh(lib):
        out = torch.empty((plan.dh_rows, H), device=dev)
        _ext.check_launch(lib.vct_fused_ce_dh(*ptrs, out.data_ptr(), M, H, V,
                                              _ext.stream_ptr(dev)), "fused_ce_dh variant")
        return (out[:M],)

    def dwdb(lib):
        parts = [torch.empty(plan.dw_part, device=dev), torch.empty(plan.db_part, device=dev)]
        dw, db = torch.empty((V, H), device=dev), torch.empty((V,), device=dev)
        _ext.check_launch(lib.vct_fused_ce_dwdb(
            *ptrs, *(t.data_ptr() for t in (*parts, dw, db)), M, H, V, plan.splits,
            plan.dwdb_per, _ext.stream_ptr(dev)), "fused_ce_dwdb variant")
        return dw, db

    variants = {name: lib for (kind, name), lib in libs.items() if kind == "ce_bwd_wide"}
    built = {fn: fn(variants[CE_BWD_WIDE_VARIANTS[0][0]]) for fn in (dh, dwdb)}
    for fn, tols, refs in ((dh, (cs.CE_GRAD_RTOL,), want[:1]),
                           (dwdb, (cs.CE_GRAD_RTOL, cs.CE_DB_RTOL), want[1:])):
        calls = {name: (lambda lib=lib: fn(lib)) for name, lib in variants.items()}
        for name, (a, b_) in in_turns(calls, cs.device_ms).items():
            got = calls[name]()
            rel = [cs.rel_err(g, r)[1] for g, r in zip(got, refs)]
            ok = all(x <= t for x, t in zip(rel, tols))
            same = all(torch.equal(g, r) for g, r in zip(got, built[fn]))
            print(f"fused_linear_ce_{fn.__name__} M={M} H={H} V={V}, {name}: device "
                  f"{a:.4f} / {b_:.4f} ms; max |kernel - plain| / max "
                  f"{', '.join(f'{x:.2e}' for x in rel)}: exact (within "
                  f"{', '.join(map(str, tols))}) {ok}; bit for bit with the built "
                  f"kernel {same} [{label}]")


if __name__ == "__main__":
    main()
