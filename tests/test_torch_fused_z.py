"""The port's fused z sampling + projection
(vae_captioning_torch/ops/fused_z.py): its Philox generator, and its
plain versions against the JAX package's ``sample_project_xla`` and its
``fused_sample_project`` kernels run in interpret mode.

The JAX kernels draw from the TPU's on-chip generator, which has no
interpreter lowering; as ``tests/test_fused_z.py`` does, ``_normal_tile``
is patched to a deterministic function of (row, column, sample), and the
port is handed the same numbers as an explicit eps.  The products then
agree up to f32 sum order: the bf16 output to one bf16 step (2e-2), the
f32 gradients to 1e-3 of each gradient's largest element."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from vae_captioning_tpu.ops import fused_z as jfz
from vae_captioning_torch.ops import fused_z as tfz
from vae_captioning_torch.ops.fused_z import (bits_to_normal, fused_z,
                                              fused_z_eps, fused_z_plain,
                                              philox4x32, philox_normals)

OUT_TOL = 2e-2       # bf16 output: one bf16 step of values of size ~1
GRAD_RTOL = 1e-3     # f32 gradients, of each one's max-abs


def _fake_normal(seed0, seed1, s, tag, shape):
    r = (jax.lax.broadcasted_iota(jnp.int32, shape, 0) * 37
         + jax.lax.broadcasted_iota(jnp.int32, shape, 1) * 11 + s * 101)
    return ((r % 97).astype(jnp.float32) / 48.5) - 1.0


@pytest.fixture()
def interpreted(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(jfz.pl, "pallas_call", patched)
    monkeypatch.setattr(jfz, "_normal_tile", _fake_normal)


def _problem(B=16, L=150, E=64, K=7, seed=0):
    rng = np.random.default_rng(seed)
    return dict(mean=rng.normal(size=(B, L)).astype(np.float32),
                std=rng.uniform(0.3, 1.5, size=(B, L)).astype(np.float32),
                w=rng.normal(0, 0.05, size=(K * L, E)).astype(np.float32),
                b=rng.normal(size=(E,)).astype(np.float32)), K


def _close(got, want, rtol_of_max, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want).max()
    bound = rtol_of_max * max(np.abs(want).max(), 1e-6)
    assert err <= bound, f"{what}: max |diff| {err:.3e} > {bound:.3e}"


# ----------------------------------------------------------------------
# the generator
# ----------------------------------------------------------------------

@pytest.mark.parametrize("ctr,key,want", [
    # Random123's known-answer vectors for Philox-4x32-10
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0), (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, want):
    words = philox4x32(tuple(torch.tensor([c], dtype=torch.int64) for c in ctr),
                       *key)
    assert tuple(int(w) for w in words) == want


def test_bits_to_normal_transform():
    bits = torch.tensor([0, 2 ** 31, 2 ** 32 - 1], dtype=torch.int64)
    z = bits_to_normal(bits)
    # 23-bit uniforms 0, 1/2 and 1 - 2^-23, clipped as _normal_tile clips
    # them, then its f32 arithmetic
    u = jnp.clip(jnp.asarray([0.0, 0.5, 1 - 2.0 ** -23], jnp.float32),
                 1e-7, 1.0 - 1e-7)
    want = 1.4142135623730951 * jax.lax.erf_inv(2.0 * u - 1.0)
    np.testing.assert_allclose(z.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    assert z[1] == 0.0


def test_stream_is_deterministic_and_independent_of_tiling():
    full = philox_normals(11, 3, 40, 5, 150)
    assert full.shape == (40, 5, 150) and full.dtype == torch.float32
    assert torch.equal(full, philox_normals(11, 3, 40, 5, 150))
    assert torch.equal(full[13:29], philox_normals(11, 3, 16, 5, 150, row0=13))
    # fewer samples or columns: the same elements, a prefix of each row
    assert torch.equal(full[:, :2, :37], philox_normals(11, 3, 40, 2, 37))
    assert torch.equal(full, fused_z_eps(11, 3, 40, 5, 150))


def test_streams_differ_by_seed_step_and_sample():
    a = philox_normals(1, 0, 32, 4, 150)
    assert not torch.equal(a, philox_normals(2, 0, 32, 4, 150))
    assert not torch.equal(a, philox_normals(1, 1, 32, 4, 150))
    for s in range(1, 4):
        assert not torch.equal(a[:, 0], a[:, s])
        assert float(torch.corrcoef(torch.stack(
            [a[:, 0].flatten(), a[:, s].flatten()]))[0, 1]).__abs__() < 0.05


def test_moments():
    # 1.2 M draws: standard errors 9e-4 (mean) and 1.3e-3 (variance)
    z = philox_normals(7, 42, 800, 10, 150).double()
    assert abs(float(z.mean())) < 5e-3
    assert abs(float(z.var()) - 1.0) < 7e-3
    assert float(z.abs().max()) < 5.5      # the clip bounds |z| by 5.33
    # the tails: P(|z| > 2) = 0.0455
    assert abs(float((z.abs() > 2).double().mean()) - 0.0455) < 2e-3


# ----------------------------------------------------------------------
# the plain versions against the JAX package
# ----------------------------------------------------------------------

@pytest.mark.parametrize("L", [150, 256])
def test_plain_matches_sample_project_xla(L):
    arrs, K = _problem(L=L)
    eps = np.random.default_rng(1).normal(size=(16, K, L)).astype(np.float32)
    want = jfz.sample_project_xla(None, *(jnp.asarray(arrs[k]) for k in
                                          ("mean", "std", "w", "b")), K,
                                  jnp.asarray(eps))
    t = {k: torch.from_numpy(v) for k, v in arrs.items()}
    got = fused_z_plain(t["mean"], t["std"], t["w"].t(), t["b"], K,
                        eps=torch.from_numpy(eps))
    assert got.dtype == torch.bfloat16 and got.shape == (16, 64)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=OUT_TOL, atol=OUT_TOL)


def test_plain_matches_jax_kernels_forward_and_gradients(interpreted):
    arrs, K = _problem(seed=3)
    B, L = arrs["mean"].shape
    sd = jnp.asarray([5, 9], jnp.int32)
    # the numbers the patched kernels draw, handed to the port
    eps = np.array(jfz.sample_project_debug_eps(sd, B, L, K))
    assert eps.shape == (B, K, L) and np.unique(eps).size > 50
    cot = np.random.default_rng(9).normal(size=(B, 64)).astype(np.float32)

    def loss(mean, std, w, b):
        out = jfz.fused_sample_project(sd, mean, std, w, b, K)
        return jnp.sum(out.astype(jnp.float32) * cot), out

    names = ("mean", "std", "w", "b")
    (_, j_out), j_grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3),
                                             has_aux=True)(
        *(jnp.asarray(arrs[k]) for k in names))
    t = {k: torch.tensor(v, requires_grad=True) for k, v in arrs.items()}
    w_t = t["w"].detach().t().contiguous().requires_grad_()
    out = fused_z_plain(t["mean"], t["std"], w_t, t["b"], K,
                        eps=torch.from_numpy(eps))
    (out.float() * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.float().detach().numpy(),
                               np.asarray(j_out, np.float32),
                               rtol=OUT_TOL, atol=OUT_TOL)
    got = {"mean": t["mean"].grad, "std": t["std"].grad,
           "w": w_t.grad.t(), "b": t["b"].grad}
    for name, jg in zip(names, j_grads):
        assert got[name].dtype == torch.float32
        _close(got[name].numpy(), jg, GRAD_RTOL, f"d{name}")


def test_wrapper_on_cpu_is_the_plain_version_on_its_stream():
    arrs, K = _problem(B=8, L=150, E=64, K=3, seed=4)
    t1 = {k: torch.tensor(v, requires_grad=True) for k, v in arrs.items()}
    t2 = {k: torch.tensor(v, requires_grad=True) for k, v in arrs.items()}
    a = fused_z(t1["mean"], t1["std"], t1["w"].t(), t1["b"], K, 123, 4)
    eps = philox_normals(123, 4, 8, K, 150)
    b = fused_z_plain(t2["mean"], t2["std"], t2["w"].t(), t2["b"], K, eps=eps)
    assert torch.equal(a, b)
    a.float().sum().backward()
    b.float().sum().backward()
    for k in arrs:
        assert torch.equal(t1[k].grad, t2[k].grad), k
    with pytest.raises(ValueError, match="32-bit"):
        fused_z(t1["mean"], t1["std"], t1["w"].t(), t1["b"], K, 2 ** 32, 0)


# ----------------------------------------------------------------------
# the kernels' plan (what the CUDA launches take, and their workspaces)
# ----------------------------------------------------------------------

# (N, K_z, L, E): the train shapes, ragged rows, one row, one row past a
# tile, one sample, latent widths of whole boxes, of one partial box and
# odd, every column width, two column chunks, and K_z L not a multiple of 8
PLAN_SHAPES = [(1280, 100, 150, 256), (1000, 100, 150, 256), (1, 100, 150, 256),
               (65, 7, 37, 128), (65, 3, 37, 128), (1000, 1, 256, 64),
               (1280, 3, 150, 512), (300, 5, 150, 512), (65, 3, 256, 192),
               (70, 3, 150, 64), (129, 9, 21, 320), (4, 1, 3, 64)]


def _fwd_splits(plan, K):
    """The forward's step ranges [start, end) of (sample, box) steps t =
    s·boxes + c, as the kernel takes them from ``fwd_per``."""
    steps = K * plan.boxes
    return [(z * plan.fwd_per, min(steps, (z + 1) * plan.fwd_per))
            for z in range(plan.fwd_splits)]


def _bwd_samples(plan, K, a, split):
    """The samples a dμ/dσ partial of class a and split sums (in every
    column chunk), as the kernel takes them: a + classes·m for m in the
    split's range (possibly none, when a class has fewer samples)."""
    m0 = split * plan.bwd_per
    return [a + plan.classes * m for m in range(m0, m0 + plan.bwd_per)
            if a + plan.classes * m < K]


def _box_columns(plan, L, s, c):
    """The latent columns of W's box c of sample s, and where it starts
    in W's row: the plan's frame, box column p = latent 64c − d + p."""
    d = (s * L) % 8
    lb = 64 * c - d
    return range(max(lb, 0), min(lb + 64, L)), s * L + lb


@pytest.mark.parametrize("N,K,L,E", PLAN_SHAPES)
def test_plan_forward_splits_cover_each_step_once(N, K, L, E):
    """The forward's splits cover every (sample, box) step once, none is
    empty, every box starts W's read on 16 bytes (TMA's rule), and a
    sample's boxes hold each of its latent columns once."""
    plan = tfz.z_plan(N, K, L, E)
    ranges = _fwd_splits(plan, K)
    assert all(a < b for a, b in ranges)
    steps = [t for a, b in ranges for t in range(a, b)]
    assert steps == list(range(K * plan.boxes))
    for s in range(K):
        cols = []
        for c in range(plan.boxes):
            box, x0 = _box_columns(plan, L, s, c)
            assert x0 % 8 == 0 and x0 >= 0
            cols += list(box)
        assert cols == list(range(L))
    assert plan.pitch % 8 == 0 and plan.pitch >= K * L
    assert E % plan.ct == 0 and plan.ct in (64, 128, 192, 256)


@pytest.mark.parametrize("N,K,L,E", PLAN_SHAPES)
def test_plan_backward_splits_cover_each_sample_once(N, K, L, E):
    """The dμ/dσ partials of each column chunk cover every sample once,
    and the samples of a class share one shift d, so that their boxes
    are one frame of latent columns."""
    plan = tfz.z_plan(N, K, L, E)
    seen = [s for a in range(plan.classes) for z in range(plan.bwd_splits)
            for s in _bwd_samples(plan, K, a, z)]
    assert sorted(seen) == list(range(K))
    for a in range(plan.classes):
        assert len({(s * L) % 8 for z in range(plan.bwd_splits)
                    for s in _bwd_samples(plan, K, a, z)}) <= 1
    chunks = E // plan.ct
    assert plan.bwd_part[1] == chunks * plan.classes * plan.bwd_splits


@pytest.mark.parametrize("N,K,L,E", PLAN_SHAPES)
def test_plan_workspaces_within_bound(N, K, L, E):
    """The partials pad rows to 128-row blocks and latent columns to the
    boxes, and a wave of blocks writes at most one partial each: at most
    max(SMs, blocks of one split) partial tiles of 128 rows."""
    sms = 132
    plan = tfz.z_plan(N, K, L, E, sms)
    row_blocks = -(-N // 128)
    chunks = E // plan.ct
    assert plan.fwd_part == (plan.fwd_splits, 128 * row_blocks, E)
    fwd_units = row_blocks * chunks
    assert plan.fwd_splits * fwd_units <= max(sms, fwd_units)
    bwd_units = row_blocks * plan.boxes * chunks * plan.classes
    assert plan.bwd_part == (2, chunks * plan.classes * plan.bwd_splits,
                             128 * row_blocks, 64 * plan.boxes)
    assert plan.bwd_splits * bwd_units <= max(sms, bwd_units)
    assert 64 * plan.boxes >= L + max((s * L) % 8 for s in range(plan.classes))


def test_plan_at_the_train_shapes():
    """N = 1280, K_z = 100, L = 150, E = 256: one column chunk (each
    normal drawn once in the forward), shifts d in {0, 2, 4, 6} (4
    classes, 3 boxes a sample), 130 forward blocks and 120 dμ/dσ blocks on
    132 SMs, and 16.25 MiB + 7.5 MiB of f32 partials."""
    plan = tfz.z_plan(1280, 100, 150, 256, 132)
    assert (plan.ct, plan.pitch, plan.classes, plan.boxes) == (256, 15000, 4, 3)
    assert (plan.fwd_per, plan.fwd_splits) == (24, 13)
    assert (plan.bwd_per, plan.bwd_splits) == (25, 1)
    assert 10 * plan.fwd_splits == 130
    assert plan.bwd_part[1] * 10 * plan.boxes == 120
    assert np.prod(plan.fwd_part) * 4 == 16.25 * 2**20
    assert np.prod(plan.bwd_part) * 4 == 7.5 * 2**20


@pytest.mark.parametrize("E,ct", [(64, 64), (128, 128), (192, 192), (256, 256),
                                  (320, 64), (384, 192), (512, 256)])
def test_plan_column_width(E, ct):
    """The widest width the kernels are built for that divides E: at E ≤
    256 one block column covers E."""
    assert tfz.z_plan(10, 2, 150, E).ct == ct
