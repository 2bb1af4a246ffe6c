"""The written logits' layout past the fused kernels' lists of 16, on the
CPU: the writer stores its f32 logits by TMA into rows of
``logits_pitch(V)`` floats (16-byte rows, as a tensor map needs them) and
hands over the ``[M, V]`` view; the top-k + logsumexp reads that view at
its pitch (``row_pitch``).  Here the pitch and the view, the pitch the
top-k wrapper reads, and the plain top-k + logsumexp on pitched rows
against the same on the contiguous copy (bit for bit) and against the
JAX package's Pallas kernel in interpret mode.  Also the profiler's
whole-trace check (``trace_report.partial_trace``) that
``chip_smoke.kernel_events`` applies before it takes a trace.

The kernels themselves run only on the card (tests/test_torch_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from vae_captioning_tpu.ops import topk_pallas as jtp
from vae_captioning_torch import _ext
from vae_captioning_torch.ops.fused_logits_topk import (
    fused_logits_top_k, fused_logits_top_k_plain, logits_pitch, pitched_logits)
from vae_captioning_torch.ops.topk_lse import (row_pitch, top_k_logsumexp,
                                               top_k_logsumexp_plain)
from vae_captioning_torch.utils.trace_report import partial_trace


@pytest.mark.parametrize("V,want", [(1, 4), (3, 4), (4, 4), (130, 132),
                                    (11500, 11500), (11519, 11520)])
def test_logits_pitch_rounds_rows_to_16_bytes(V, want):
    assert logits_pitch(V) == want
    assert logits_pitch(V) * 4 % 16 == 0 and V <= logits_pitch(V) < V + 4


@pytest.mark.parametrize("M,V", [(3, 11519), (5, 130), (2, 11500), (0, 11519)])
def test_pitched_logits_is_the_view_of_padded_rows(M, V):
    x = pitched_logits(M, V, "cpu")
    assert x.shape == (M, V) and x.dtype == torch.float32
    assert x.stride() == (logits_pitch(V), 1)
    assert x.untyped_storage().nbytes() == 4 * M * logits_pitch(V)
    assert x.is_contiguous() == (V == logits_pitch(V) or M <= 1)


def test_row_pitch_reads_the_row_stride():
    x = torch.zeros((6, 20))
    assert row_pitch(x) == 20
    assert row_pitch(x[:, 3:18]) == 20
    assert row_pitch(pitched_logits(4, 11519, "cpu")) == 11520
    assert row_pitch(x[:1, :7]) == 7          # a single row: its own width
    assert row_pitch(x[::2]) == 40


@pytest.mark.parametrize("bad", [lambda: torch.zeros((5, 4)).t(),
                                 lambda: torch.zeros((1, 9)).expand(4, 9),
                                 lambda: torch.zeros((6, 20))[:, ::2]])
def test_row_pitch_refuses_rows_that_are_not_contiguous_and_apart(bad):
    with pytest.raises(ValueError, match="rows must be contiguous and apart"):
        row_pitch(bad())


def _logits(N, V, seed):
    """Unit normals, each row's maximum planted at three columns and a
    runner-up at two more (ties go to the lowest column)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, V)).astype(np.float32)
    top = x.max(axis=1) + 1.0
    for r in range(N):
        cols = rng.choice(V, size=5, replace=False)
        x[r, cols[:3]] = top[r]
        x[r, cols[3:]] = top[r] - 0.5
    return x


def _pitched(x: np.ndarray) -> torch.Tensor:
    """x as the writer hands its logits over: the [N, V] view of rows
    logits_pitch(V) floats apart, the pad columns filled with NaN."""
    N, V = x.shape
    view = pitched_logits(N, V, "cpu")
    view.as_strided((N, logits_pitch(V)), (logits_pitch(V), 1)).fill_(float("nan"))
    view.copy_(torch.from_numpy(x))
    return view


@pytest.mark.parametrize("k", [20, 40, 65])
def test_top_k_logsumexp_on_pitched_rows_matches_the_contiguous_copy(k):
    """k of the wide beams (one and two entries a lane) and of the sort
    past 64, at the ragged vocabulary: the pad columns (NaN) are never
    read, and values, indices and logsumexp equal the contiguous copy's
    bit for bit."""
    x = _pitched(_logits(7, 11519, seed=k))
    assert not x.is_contiguous()
    got = top_k_logsumexp(x, k)
    want = top_k_logsumexp_plain(x.contiguous(), k)
    for a, r in zip(got, want):
        assert torch.equal(a, r)
    assert bool(torch.isfinite(got[2]).all())


@pytest.fixture()
def interpreted(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(jtp.pl, "pallas_call", patched)
    yield jax.jit(jtp.top_k_logsumexp_pallas.__wrapped__, static_argnums=1)


@pytest.mark.parametrize("k", [20, 40])
def test_pitched_rows_match_the_jax_kernel(interpreted, k):
    """The port's top-k + logsumexp on pitched rows against the JAX
    package's Pallas kernel (interpret mode) on the same values: values
    and indices equal, the logsumexp to an f32 sum order (rtol 1e-6)."""
    x = _logits(8, 11519, seed=100 + k)
    vals, idx, lse = top_k_logsumexp(_pitched(x), k)
    jv, ji, jl = interpreted(jnp.asarray(x), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl), rtol=1e-6)


def test_wide_top_k_on_the_cpu_takes_the_plain_version():
    """Past K_MAX on CPU tensors the wrapper launches nothing."""
    rng = np.random.default_rng(3)
    h = torch.from_numpy(rng.normal(size=(5, 32)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(0.1 * rng.normal(size=(32, 130)).astype(np.float32)).to(torch.bfloat16)
    b = torch.from_numpy(rng.normal(size=(130,)).astype(np.float32))
    _ext.reset_launches()
    got = fused_logits_top_k(h, w, b, 20)
    assert _ext.LAUNCHES["fused_logits_top_k"] == _ext.LAUNCHES["top_k_logsumexp"] == 0
    for a, r in zip(got, fused_logits_top_k_plain(h, w, b, 20)):
        assert torch.equal(a, r)


def _events(counts):
    return [(name, 10.0 * i, 1.5) for name, n in counts.items() for i in range(n)]


@pytest.mark.parametrize("counts,reps", [({"gemm": 5}, 5),
                                         ({"gemm": 10, "merge": 5}, 5),
                                         ({"Memcpy DtoD": 3, "k": 6}, 3),
                                         ({"k": 1}, 1)])
def test_a_whole_trace_is_taken(counts, reps):
    assert partial_trace(_events(counts), reps) is None


@pytest.mark.parametrize("counts,reps,said", [
    ({}, 5, "no device event"),
    ({"gemm": 4}, 5, "'gemm': 4"),
    ({"gemm": 5, "merge": 4}, 5, "1 of 2 names"),
    ({"gemm": 10, "merge": 7}, 5, "'merge': 7"),
    ({"a": 1, "b": 2}, 3, "2 of 2 names")])
def test_a_trace_that_lost_events_is_refused(counts, reps, said):
    """A trace where some kernel occurs a count that is not a multiple of
    the calls (the profiler lost some of its events) would undercount the
    device time: it is refused, with the reason."""
    flaw = partial_trace(_events(counts), reps)
    assert flaw is not None and said in flaw
