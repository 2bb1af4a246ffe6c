"""Port of the fused logits + top-k + logsumexp: its plain version (what
the wrapper runs on CPU tensors) against the JAX kernel in Pallas
interpret mode and against the JAX reference ``fused_logits_top_k_xla``.

Indices must be equal; values within rtol 1e-5 and the logsumexp within
rtol 1e-4 (f32 sums in another order), as the JAX kernel's own test
holds them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from vae_captioning_tpu.ops import fused_logits_topk as jfl
from vae_captioning_torch import _ext
from vae_captioning_torch.ops.fused_logits_topk import (
    fused_logits_sample, fused_logits_top_k, fused_logits_top_k_int8,
    chunk_plan, fused_logits_top_k_plain, quantize_logits_weights,
    stable_top_k)


@pytest.fixture()
def interpreted(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(jfl.pl, "pallas_call", patched)
    yield jfl.fused_logits_top_k.__wrapped__  # un-jitted so the patch applies


def _assert_matches(port, want):
    vals, idx, lse = port
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(vals.numpy(), np.asarray(want[0]), rtol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want[2]), rtol=1e-4)


# the shape and k grid of tests/test_fused_logits_topk.py
@pytest.mark.parametrize("shape_k", [
    ((256, 64, 3840), 3),     # exact JAX block multiples
    ((300, 64, 4000), 5),     # row + vocab padding on the TPU
    ((8, 32, 7680), 1),       # multi-tile vocab, tiny rows
    ((512, 128, 4096), 10),   # k = reference beam size
])
def test_plain_matches_jax_kernel_and_reference(interpreted, shape_k):
    (M, H, V), k = shape_k
    rng = np.random.default_rng(M + V + k)
    h = rng.normal(size=(M, H)).astype(np.float32)
    w = rng.normal(size=(H, V)).astype(np.float32)
    b = rng.normal(size=(V,)).astype(np.float32)
    port = fused_logits_top_k_plain(torch.from_numpy(h), torch.from_numpy(w),
                                    torch.from_numpy(b), k)
    assert port[0].dtype == torch.float32 and port[1].dtype == torch.int32
    jargs = (jnp.asarray(h), jnp.asarray(w), jnp.asarray(b))
    _assert_matches(port, interpreted(*jargs, k))
    _assert_matches(port, jfl.fused_logits_top_k_xla(*jargs, k))


@pytest.mark.parametrize("k", [1, 3, 10, 16])
def test_ties_go_to_the_lowest_index(interpreted, k):
    """W = 0, so the logits are the bias exactly; duplicated bias entries
    tie across vocab tiles, and the lowest index must win on both sides."""
    M, H, V = 8, 32, 7700
    b = np.zeros(V, np.float32)
    b[[6000, 100, 3900]] = 5.0
    b[[7699, 7, 3840, 3839]] = 4.0
    h = np.ones((M, H), np.float32)
    w = np.zeros((H, V), np.float32)
    want_idx = [100, 3900, 6000, 7, 3839, 3840, 7699]
    want_idx += [i for i in range(V) if i not in want_idx][:max(0, k - 7)]
    vals, idx, lse = fused_logits_top_k(torch.from_numpy(h),
                                        torch.from_numpy(w),
                                        torch.from_numpy(b), k)
    assert (idx.numpy() == np.asarray(want_idx[:k])[None, :]).all()
    _assert_matches((vals, idx, lse),
                    interpreted(jnp.asarray(h), jnp.asarray(w),
                                jnp.asarray(b), k))
    np.testing.assert_allclose(
        lse.numpy(), float(jax.scipy.special.logsumexp(jnp.asarray(b))),
        rtol=1e-5)


def test_stable_top_k_orders_ties_by_index():
    x = torch.tensor([[1.0, 3.0, 3.0, -0.0, 0.0, 3.0, 0.0]])
    vals, idx = stable_top_k(x, 6)
    assert idx.tolist() == [[1, 2, 5, 0, 3, 4]]
    assert vals.tolist() == [[3.0, 3.0, 3.0, 1.0, 0.0, 0.0]]


def test_wrapper_takes_plain_version_on_cpu():
    rng = np.random.default_rng(0)
    h = torch.from_numpy(rng.normal(size=(12, 32)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(32, 300)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(300,)).astype(np.float32))
    before = _ext.LAUNCHES["fused_logits_top_k"]
    got = fused_logits_top_k(h.to(torch.bfloat16), w.to(torch.bfloat16), b, 4)
    want = fused_logits_top_k_plain(h, w, b, 4)
    assert _ext.LAUNCHES["fused_logits_top_k"] == before
    for a, r in zip(got, want):
        torch.testing.assert_close(a, r, rtol=0, atol=0)


@pytest.mark.parametrize("V", [100, 11500, 11519])
@pytest.mark.parametrize("M", [1, 512, 1536, 5120, 200000])
def test_vocab_split_covers_the_vocab(M, V):
    """The plan's chunks cover the vocabulary's 128-column tiles, none
    empty; the blocks cover the rows; the partials fit their workspace."""
    for k, rows, resident in ((1, 128, True), (3, 128, True), (10, 64, True),
                              (16, 64, False)):
        plan = chunk_plan(M, V, k, rows, resident, sms=132)
        tiles = -(-V // 128)
        assert (plan.chunks - 1) * plan.chunk_tiles < tiles
        assert tiles <= plan.chunks * plan.chunk_tiles
        assert plan.list_k >= k and plan.list_k in (1, 3, 10, 16)
        assert (plan.rows, plan.resident) == (rows, resident)
        assert plan.parts == plan.chunks * (2 if plan.rows == 64 else 1)
        assert plan.parts * M * (8 * plan.list_k + 8) <= max(
            64 << 20, M * (8 * plan.list_k + 8) * plan.parts // plan.chunks)


@pytest.mark.parametrize("M,V,chunks,chunk_tiles", [
    (512, 11500, 30, 3), (1536, 11500, 10, 9), (5120, 11500, 13, 7),
    (1, 11519, 90, 1)])
def test_plan_at_the_main_path_shapes(M, V, chunks, chunk_tiles):
    """The chunks by wave fill over 132 SMs for the 128-row blocks the
    decode's width takes (the block shape's own card test holds that)."""
    plan = chunk_plan(M, V, 3, 128, True, sms=132)
    assert (plan.chunks, plan.chunk_tiles, plan.parts) == (chunks, chunk_tiles, chunks)


def test_plan_takes_the_forced_rows():
    plan = chunk_plan(512, 11500, 1, rows=64)
    assert plan.rows == 64 and plan.parts == 2 * plan.chunks
    wide = chunk_plan(512, 11500, 1)
    assert wide.rows == 128 and wide.parts == wide.chunks


def test_wrappers_take_either_layout_of_the_head_on_cpu():
    """The decode stores the head column-major; the wrappers give the same
    result for it and for the same head row-major."""
    rng = np.random.default_rng(1)
    h = torch.from_numpy(rng.normal(size=(9, 64)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(64, 300)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(300,)).astype(np.float32))
    h16, w16 = h.to(torch.bfloat16), w.to(torch.bfloat16)
    col = w16.t().contiguous().t()
    assert col.t().is_contiguous() and torch.equal(col, w16)
    for a, r in zip(fused_logits_top_k(h16, w16, b, 5),
                    fused_logits_top_k(h16, col, b, 5)):
        assert torch.equal(a, r)
    assert torch.equal(fused_logits_sample(h16, w16, b, 3, 4, 0.9),
                       fused_logits_sample(h16, col, b, 3, 4, 0.9))
    wq, ws = quantize_logits_weights(w)
    for a, r in zip(fused_logits_top_k_int8(h, wq, ws, b, 4),
                    fused_logits_top_k_int8(h, wq.contiguous(), ws, b, 4)):
        assert torch.equal(a, r)


def test_wrapper_rejects_tensors_on_mixed_devices():
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        fused_logits_top_k(torch.zeros(2, 32, dtype=torch.bfloat16),
                           torch.zeros(32, 64, dtype=torch.bfloat16,
                                       device="meta"),
                           torch.zeros(64), 3)
