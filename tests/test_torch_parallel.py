"""Data-parallel training in the port (vae_captioning_torch/parallel/ and
the Trainer's hooks) against one process and against the JAX ``dp`` mesh.

* ``prepare_process_batch`` / ``pad_to_multiple``: the cases of
  tests/test_parallel.py, output for output against the JAX functions.
* The rank fold of the fused z seed against the JAX formula of
  tests/test_kernel_shard.py.
* Two ranks over gloo on the CPU (spawned processes): 5 SGD steps of the
  Normal-prior CVAE and 3 of the GMM-CVAE under ``fused_ce``, on a batch
  of 5 images x 2 captions (padded to 6 images over the ranks) whose
  ranks hold different numbers of tokens, must follow one process on
  the global batch (rtol 1e-3, as tests/test_parallel.py holds the JAX
  mesh to one device) and the JAX train step over a 2-device mesh (to
  tests/test_torch_train.py's METRIC_RTOL, the port's standard against
  JAX).  The z noise is injected: every run is handed the JAX fused z's
  debug eps for the global rows (``fused_z._normal_tile`` patched, as in
  tests/test_torch_train.py), each rank its own rows of it; the GMM
  cluster draws are fixed indices, each rank its rows.
* A 2-rank resume (the GMM-CVAE with caption dropout, its own noise)
  equals the uninterrupted 2-rank run bit for bit, and the ranks' noise
  differs."""

import os
import pickle
import re
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from vae_captioning_torch.bridge import export_flax_params
from vae_captioning_torch.checkpoint import Checkpointer
from vae_captioning_torch.config import Config
from vae_captioning_torch.data.batcher import Batch
from vae_captioning_torch.models.cvae import TrainOps
from vae_captioning_torch.ops.fused_z import fused_z_plain
from vae_captioning_torch.parallel import kernel_shard, mesh
from vae_captioning_torch.train import Trainer

B, K, T, V = 5, 2, 6, 50
CLUSTERS = 12
WORLD = 2
JAX_DEVICES = WORLD     # the JAX mesh: as many devices as ranks
ROWS = 6 * K            # caption rows of the batch padded to 6 images
STEPS = {"Normal": 5, "GMM": 3}
RESUME_STEPS = 2        # then saved, restored, RESUME_STEPS more
# the port against the JAX package (tests/test_torch_train.py)
METRIC_RTOL = 3e-3


def _cfg_kw(prior: str) -> dict:
    kw = dict(embed_size=128, encoder_hidden=128, decoder_hidden=128,
              latent_size=16, gen_z_samples=4, prior=prior,
              compute_dtype="bfloat16", optimizer="SGD", learning_rate=0.05,
              batch_size=B, num_captions=K)
    if prior == "GMM":
        kw.update(use_c_v=True, num_clusters=CLUSTERS, fused_ce=True)
    return kw


def _port_cfg(prior: str, **kw) -> Config:
    cfg = Config(**{**_cfg_kw(prior), **kw})
    cfg.vocab_size = V
    return cfg


def _batches(n: int, seed: int):
    """(features, labels, dec inputs, lengths, c_v) of B images x K
    captions, flat; lengths 2..T, so the ranks' token counts differ."""
    out = []
    rng = np.random.default_rng(seed)
    for _ in range(n):
        lens = rng.integers(2, T + 1, size=B * K).astype(np.int32)
        enc = rng.integers(3, V, size=(B * K, T)).astype(np.int32)
        dec = np.roll(enc, 1, axis=1)
        dec[:, 0] = 1
        pad = np.arange(T)[None, :] >= lens[:, None]
        enc[pad] = 0
        dec[pad] = 0
        cv = np.zeros((B, CLUSTERS), np.float32)
        for row in cv[1:]:
            row[rng.choice(CLUSTERS, size=rng.integers(1, 4), replace=False)] = 1
        cv[1:] /= cv[1:].sum(axis=1, keepdims=True)
        out.append((rng.normal(size=(B, 4096)).astype(np.float32), enc, dec,
                    lens, cv))
    return out


def _batch(arrays) -> Batch:
    feats, enc, dec, lens, cv = arrays
    return Batch(features=feats, dec_inputs=dec.reshape(B, K, T),
                 labels=enc.reshape(B, K, T), lengths=lens.reshape(B, K),
                 cluster_vectors=cv, valid=B)


def _rank_rows(a: np.ndarray) -> np.ndarray:
    """This process's rows of a [caption rows, ...] array of the global
    batch (a whole rank's share; the padding rows past B·K included)."""
    rank, world = mesh.process_info()
    n = -(-B // world) * world * K // world
    return a[rank * n:(rank + 1) * n]


def _ops(eps: np.ndarray) -> TrainOps:
    """The fused z fed this rank's rows of the global ``eps``."""
    def sample_project(mean, std, w, b, n, seed, step):
        rank, _ = mesh.process_info()
        rows = mean.shape[0]
        e = torch.from_numpy(eps[rank * rows:(rank + 1) * rows])
        return fused_z_plain(mean, std, w, b, n, eps=e)
    return TrainOps(sample_project=sample_project)


def _run(prior: str, flat: dict, batches, eps=None, clusters=None,
         resume_dir=None, **cfg_kw) -> dict:
    """A Trainer's steps on ``batches`` in this process, one rank of a
    group when there is one: its metrics by step and final parameters;
    with ``resume_dir``, RESUME_STEPS steps, the train state saved and
    restored into a fresh Trainer, RESUME_STEPS more."""
    cfg = _port_cfg(prior, multihost=dist.is_initialized(), **cfg_kw)
    ops = TrainOps() if eps is None else _ops(eps)

    def trainer() -> Trainer:
        t = Trainer(cfg.replace(), device="cpu", params=flat, ops=ops)
        if clusters is not None:
            t.clusters = torch.from_numpy(_rank_rows(clusters))
        return t

    t = trainer()
    metrics, state = [], None
    for i, arrays in enumerate(batches):
        if resume_dir is not None and i == RESUME_STEPS:
            ckpt = Checkpointer(resume_dir, "dp")
            t.save_checkpoint(ckpt)
            state = ckpt.restore() if t.is_main else None
            t = trainer()
            t.restore_from(ckpt)
        metrics.append({k: float(v) for k, v in
                        t.run_step(_batch(arrays)).items()})
    return {"metrics": metrics, "params": export_flax_params(t.model),
            "state_rng": None if state is None else
            {k: v for k, v in state.arrays.items() if k.startswith("rng/")}}


def _worker(rank: int, world: int, port: int, jobs: list, out: str) -> None:
    torch.set_num_threads(1)
    mesh.init_process_group(rank, world, f"tcp://127.0.0.1:{port}", "cpu",
                            backend="gloo", timeout=120)
    try:
        results = [_run(**job) for job in jobs]
        with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(jobs: list, out: str) -> list:
    """``jobs`` run on WORLD ranks; each rank's results."""
    mp.start_processes(_worker, args=(WORLD, _free_port(), jobs, out),
                       nprocs=WORLD, join=True, start_method="spawn")
    results = []
    for rank in range(WORLD):
        with open(os.path.join(out, f"rank{rank}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


# ----------------------------------------------------------------------
# batch slicing and the seed fold against the JAX functions
# ----------------------------------------------------------------------

def _fake_flat_batch(B_, K_, T_=6, F=16):
    """Row-identifiable contents, as tests/test_parallel.py builds them."""
    feats = np.stack([np.full((F,), i, np.float32) for i in range(B_)])
    enc = np.stack([np.full((T_,), 100 * (j // K_) + j % K_, np.int32)
                    for j in range(B_ * K_)])
    lengths = np.arange(B_ * K_, dtype=np.int32) + 1
    c_v = np.stack([np.full((90,), i, np.float32) for i in range(B_)])
    return (feats, enc, enc + 1, lengths, c_v)


CASES = ([("slices", B_, K_, 8 * P, P, pid) for P in (2, 4, 8)
          for B_, K_ in ((16, 1), (16, 5), (13, 5)) for pid in range(P)]
         + [("slices", 13, 5, 8, 1, 0), ("slices", 7, 3, 2, 2, 1),
            ("raises", 8, 2, 8, 3, 0), ("raises", 8, 2, 8, 2, 2),
            ("raises", 8, 4, 8, 1, 0), ("pad", 5, 0, 8, 0, 0),
            ("pad", 8, 0, 8, 0, 0), ("pad", 7, 0, 2, 0, 0)])


@pytest.mark.parametrize("kind,B_,K_,n_devices,P,pid", CASES)
def test_batch_prep_matches_jax(kind, B_, K_, n_devices, P, pid):
    from vae_captioning_tpu.parallel import mesh as jmesh

    if kind == "pad":
        x = np.arange(B_ * 3, dtype=np.float32).reshape(B_, 3) + 1
        got, want = (mesh.pad_to_multiple(x, n_devices),
                     jmesh.pad_to_multiple(x, n_devices))
        np.testing.assert_array_equal(got, want)
        assert got.shape[0] % n_devices == 0
        return
    arrays = _fake_flat_batch(B_, 2 if kind == "raises" else K_)
    if kind == "raises":
        with pytest.raises(ValueError) as want:
            jmesh.prepare_process_batch(arrays, K_, n_devices, P=P, pid=pid)
        with pytest.raises(ValueError, match=re.escape(str(want.value))):
            mesh.prepare_process_batch(arrays, K_, n_devices, P=P, pid=pid)
        return
    got = mesh.prepare_process_batch(arrays, K_, n_devices, P=P, pid=pid)
    want = jmesh.prepare_process_batch(arrays, K_, n_devices, P=P, pid=pid)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_rank_seed_fold_matches_jax():
    """The port folds (seed, rank) as the JAX shard wrapper folds (seed,
    axis_index): seed ^ (axis_index + 1) * int32(0x9E3779B9), wrapping."""
    import jax.numpy as jnp

    for seed in (0, 3, 0x7FFFFFFF, 0x80000001, 0xFFFFFFFF):
        for rank in range(8):
            mix = (jnp.int32(rank) + 1) * jnp.int32(-1640531527)
            want = int((jnp.asarray(seed, jnp.uint32)
                        ^ mix.astype(jnp.uint32)).astype(jnp.uint32))
            assert kernel_shard.fold_seed(seed, rank) == want
    dp = kernel_shard.DataParallel(1, 2)
    assert dp.seed(5) == kernel_shard.fold_seed(5, 1)
    assert kernel_shard.SINGLE.seed(5) == 5
    seeds = {kernel_shard.DataParallel(r, 8).seed(42) for r in range(8)}
    assert len(seeds) == 8


# ----------------------------------------------------------------------
# two ranks against one process and the JAX mesh
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_runs():
    """Per prior: the Flax parameters (flat numpy), the batches, the
    global eps, the GMM clusters and the JAX mesh step's metrics and
    final parameters."""
    import jax
    import jax.numpy as jnp
    from flax.traverse_util import flatten_dict
    from jax.experimental import pallas as pl

    from test_torch_train import _fake_normal
    from vae_captioning_tpu import train as jtrain
    from vae_captioning_tpu.config import Config as JConfig
    from vae_captioning_tpu.ops import fused_z as jfz
    from vae_captioning_tpu.parallel import mesh as jmesh

    runs = {}
    idx = np.random.default_rng(11).integers(0, CLUSTERS, size=ROWS)
    orig = (pl.pallas_call, jfz._normal_tile, jax.random.categorical)
    pl.pallas_call = lambda *a, **k: orig[0](*a, **{**k, "interpret": True})
    jfz._normal_tile = _fake_normal
    jax.random.categorical = lambda key, logits, axis=-1, **kw: jnp.asarray(
        idx[:logits.shape[0]], jnp.int32)
    try:
        eps = np.array(jfz.sample_project_debug_eps(
            jnp.asarray([0, 0], jnp.int32), ROWS, 16, 4))
        for prior, steps in STEPS.items():
            cfg = JConfig(**_cfg_kw(prior))
            cfg.vocab_size = V
            cfg.fused_force = True
            _, params = jtrain.init_model(cfg.replace(fused_force=False),
                                          jax.random.PRNGKey(0))
            model = jtrain.build_model(cfg)
            tx = jtrain.make_optimizer(cfg)
            step = jtrain.make_train_step(model, tx, cfg, donate=False)
            jm = jmesh.create_mesh(jax.devices()[:JAX_DEVICES])
            state = jtrain.TrainState.create(jmesh.replicate(params, jm), tx)
            batches = _batches(steps, seed=len(prior))
            metrics = []
            for feats, enc, dec, lens, cv in batches:
                c_v = cv if prior == "GMM" else np.zeros((B, 90), np.float32)
                arrays = jmesh.prepare_process_batch(
                    (feats, enc, dec, lens, c_v), K, JAX_DEVICES)
                state, m = step(state, *jmesh.shard_batch(arrays, jm),
                                jax.random.PRNGKey(1))
                metrics.append({k: float(v) for k, v in m.items()})
            flat = {"/".join(k): np.asarray(v) for k, v in
                    flatten_dict(jax.device_get(params)).items()}
            final = {"/".join(k): np.asarray(v) for k, v in
                     flatten_dict(jax.device_get(state.params)).items()}
            runs[prior] = dict(flat=flat, batches=batches, eps=eps,
                               clusters=idx if prior == "GMM" else None,
                               metrics=metrics, params=final)
    finally:
        pl.pallas_call, jfz._normal_tile, jax.random.categorical = orig
    return runs


@pytest.fixture(scope="module")
def two_ranks(jax_runs, tmp_path_factory):
    """Every 2-rank run in one spawn: the two priors on the injected
    noise, then the resume and the uninterrupted run it must equal."""
    out = str(tmp_path_factory.mktemp("dp_ranks"))
    gmm = jax_runs["GMM"]
    resume = dict(prior="GMM", flat=gmm["flat"], dec_keep_rate=0.75,
                  optimizer="Adam", learning_rate=1e-3,
                  batches=_batches(2 * RESUME_STEPS, seed=21))
    jobs = [dict(prior=p, flat=r["flat"], batches=r["batches"], eps=r["eps"],
                 clusters=r["clusters"]) for p, r in jax_runs.items()]
    jobs += [dict(resume, resume_dir=os.path.join(out, "ckpt")), resume]
    return _spawn(jobs, out)


def _close(got: dict, want: dict, rtol: float, atol: float, what: str):
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=rtol, atol=atol,
                                   err_msg=f"{what}: {key}")


@pytest.mark.parametrize("prior", list(STEPS))
def test_two_ranks_follow_one_process_and_the_jax_mesh(jax_runs, two_ranks,
                                                       prior):
    job = list(STEPS).index(prior)
    run = jax_runs[prior]
    ranks = [two_ranks[r][job] for r in range(WORLD)]
    # every rank holds the same parameters and global metrics
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    for key, value in ranks[0]["params"].items():
        np.testing.assert_array_equal(value, ranks[1]["params"][key])
    # the ranks' token counts differ
    counts = []
    for rank in range(WORLD):
        Bp = -(-B // WORLD) * WORLD
        enc = np.pad(run["batches"][0][1], ((0, (Bp - B) * K), (0, 0)))
        n = Bp * K // WORLD
        counts.append(int((enc[rank * n:(rank + 1) * n] != 0).sum()))
    assert counts[0] != counts[1], counts
    one = _run(prior, run["flat"], run["batches"], eps=run["eps"],
               clusters=run["clusters"])
    keys = ("loss", "rec_loss", "kld", "grad_norm")
    for i, (g, w, j) in enumerate(zip(ranks[0]["metrics"], one["metrics"],
                                      run["metrics"])):
        _close({k: g[k] for k in keys}, {k: w[k] for k in keys}, 1e-3, 0,
               f"{prior} step {i + 1}, 2 ranks against 1 process")
        _close({k: g[k] for k in keys}, {k: j[k] for k in keys},
               METRIC_RTOL, 0, f"{prior} step {i + 1}, 2 ranks against JAX")
    _close(ranks[0]["params"], one["params"], 1e-3, 2e-4,
           f"{prior} parameters, 2 ranks against 1 process")
    # against JAX the moves are compared on average, as in
    # tests/test_torch_train.py
    for key in ("decoder/rnn_logits/kernel", "encoder/q_heads/kernel",
                "decoder/lstm/cell_0/kernel"):
        moved_t = ranks[0]["params"][key] - run["flat"][key]
        moved_j = run["params"][key] - run["flat"][key]
        assert (np.abs(moved_t - moved_j).mean()
                <= 0.02 * np.abs(moved_j).mean()), key


def test_two_rank_resume_equals_the_uninterrupted_run(two_ranks):
    n = len(STEPS)
    for rank in range(WORLD):
        resumed, whole = two_ranks[rank][n], two_ranks[rank][n + 1]
        assert resumed["metrics"] == whole["metrics"]
        for key, value in whole["params"].items():
            np.testing.assert_array_equal(resumed["params"][key], value)
    # the saved state holds both ranks' generators, and they differ
    rng = two_ranks[0][n]["state_rng"]
    assert set(rng) == {"rng/seeds", "rng/dropout", "rng/clusters"}
    for key in ("rng/dropout", "rng/clusters"):
        assert rng[key].shape[0] == WORLD
        assert not np.array_equal(rng[key][0], rng[key][1]), key
    np.testing.assert_array_equal(rng["rng/seeds"][0], rng["rng/seeds"][1])


def test_one_rank_hooks_are_the_identity():
    dp = kernel_shard.SINGLE
    labels = np.array([[[5, 6, 0], [0, 0, 0]], [[7, 0, 0], [8, 9, 4]]])
    assert dp.counts(labels) is None and dp.seed(7) == 7
    # on ranks, the global host batch's counts: non-PAD labels, and rows
    # holding one (the all-PAD row counts in neither)
    assert kernel_shard.DataParallel(1, 2).counts(labels) == (6.0, 3.0)
    t = torch.tensor([3.0, 4.0])
    mesh.all_reduce_sum_([t])
    assert t.tolist() == [3.0, 4.0]
    assert mesh.process_info() == (0, 1) and mesh.gather_objects(5) == [5]
    with pytest.raises(RuntimeError, match="process group"):
        Trainer(_port_cfg("Normal", multihost=True), device="cpu")
