"""Device time per decode batch, by kernel, of the port's decode.

Runs ``chip_smoke.py``'s full-width AG-CVAE (random weights from a seed)
over one batch of 512 synthetic images at beam 3, beam 10 and greedy, and
at beam 3 with the logits written (``fused_decode=False``: the top-k +
logsumexp over them), each batch once to warm up and then ``REPS`` times under
``torch.profiler``, and prints for each mode the device time per batch of
each kernel (and its launches per batch) and their sum: what the card
spends, which the host-clock times of ``chip_smoke.py``'s
``phase_decode_times`` cannot show where the host bounds the batch.
Then three kernels' wrappers alone: the top-k + logsumexp over written
logits at beam 3 and beam 10 (N = 1536, k = 3; 5120, 10), in turns with
``torch.topk`` + ``torch.logsumexp``; the fused z eps stream at the train
shapes (1280 x 100 x 150); and the fused logits top-k at each mode's
shape (M = 512, k = 1; 1536, 3; 5120, 10) on that model's head as the
decode stores it (``DecodeWeights.of``): CUDA events, device time and
host time per call.
It uses only what ``chip_smoke.py`` and the decode API have held since
the decode modes were ported, so the same script times an older checkout
of the repository too.

    python3 decode_profile.py        # from the repository's root, on a CUDA card
"""

from __future__ import annotations

import functools
import sys

import torch

REPS = 3


def kernel_name(name: str) -> str:
    """A profiler kernel name without its return type, namespace and
    parameters."""
    return name.replace("void ", "").replace("(anonymous namespace)::", "").split("(")[0]


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("decode_profile: no CUDA device")
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile

    from vae_captioning_torch.inference import DecodeWeights, make_decode_fns
    from vae_captioning_torch.ops.fused_logits_topk import fused_logits_top_k
    from vae_captioning_torch.ops.fused_z import fused_z_eps
    from vae_captioning_torch.ops.topk_lse import top_k_logsumexp

    label = cs.card()
    cfg, vocab, model = cs.full_width_model()
    batch = next(cs.batchers(cs.BATCH, "val", vocab, 6).eval_batches())
    feats = torch.from_numpy(batch.features).to(cs.DEV)
    c_v = torch.from_numpy(batch.cluster_vectors).to(cs.DEV)
    for name, c, fn_name in (("beam 3", cfg, "beam_search"),
                             ("beam 10", cfg.replace(beam_size=10), "beam_search"),
                             ("greedy", cfg, "greedy"),
                             ("beam 3 unfused", cfg.replace(fused_decode=False),
                              "beam_search")):
        fn = make_decode_fns(model, c, vocab)[fn_name]
        g = torch.Generator(device=cs.DEV).manual_seed(7)
        fn(feats, c_v, generator=g).tokens.cpu()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                fn(feats, c_v, generator=g).tokens.cpu()
            torch.cuda.synchronize()
        times, counts = {}, {}
        for e in prof.events():
            if e.device_type.name == "CUDA":
                key = kernel_name(e.name)[:48]
                times[key] = times.get(key, 0.0) + e.device_time_total / REPS / 1e3
                counts[key] = counts.get(key, 0) + 1 / REPS
        top = sorted(times.items(), key=lambda kv: -kv[1])
        print(f"decode {name}, {cs.BATCH} images: device {sum(times.values()):.3f} "
              f"ms/batch; " + ", ".join(f"{k} {v:.3f}" for k, v in top[:6])
              + f" [{label}]")
        print(f"decode {name} kernels (ms/batch, launches/batch): "
              + "; ".join(f"{k} {v:.3f} x{counts[k]:.0f}" for k, v in top))
    # the top-k + logsumexp over written logits alone (row 5), by events
    # and device time, in turns with its library chain (kernel, chain,
    # chain, kernel); then the eps stream (row 10) at the train shapes
    for N, k in ((1536, 3), (5120, 10)):
        x = cs.unfused_logits(N, 11500, seed=N)
        kernel = functools.partial(top_k_logsumexp, x, k)

        def chain():
            return torch.topk(x, k, dim=1), torch.logsumexp(x, dim=1)

        ev = [cs.cuda_ms(f) for f in (kernel, chain, chain, kernel)]
        dv = [sum(cs.device_ms(f).values()) for f in (kernel, chain, chain, kernel)]
        print(f"top_k_logsumexp N={N} V=11500 k={k}: events {(ev[0] + ev[3]) / 2:.4f} ms, "
              f"device {(dv[0] + dv[3]) / 2:.4f} ms; torch.topk + torch.logsumexp: "
              f"events {(ev[1] + ev[2]) / 2:.4f} ms, device {(dv[1] + dv[2]) / 2:.4f} ms; "
              f"host per call {cs.host_us(kernel):.1f} us [{label}]")
    eps = functools.partial(fused_z_eps, 5, 6, cs.TRAIN_ROWS, cs.KZ, cs.LATENT, device=cs.DEV)
    print(f"fused_z_eps {cs.TRAIN_ROWS}x{cs.KZ}x{cs.LATENT}: events "
          f"{(cs.cuda_ms(eps) + cs.cuda_ms(eps)) / 2:.4f} ms, device "
          f"{(sum(cs.device_ms(eps).values()) + sum(cs.device_ms(eps).values())) / 2:.4f} ms "
          f"[{label}]")
    weights = DecodeWeights.of(model)
    g = torch.Generator(device=cs.DEV).manual_seed(11)
    torch.set_grad_enabled(False)            # as the decode calls it
    for M, k in ((512, 1), (1536, 3), (5120, 10)):
        h = torch.tanh(torch.randn((M, weights.head_w.shape[0]), generator=g,
                                   device=cs.DEV)).to(torch.bfloat16)
        call = functools.partial(fused_logits_top_k, h, weights.head_w,
                                 weights.head_b, k)
        events = (cs.cuda_ms(call) + cs.cuda_ms(call)) / 2
        device = sum(cs.device_ms(call).values())
        print(f"fused_logits_top_k M={M} k={k} on the stored head: events "
              f"{events:.4f} ms, device {device:.4f} ms, host per call "
              f"{cs.host_us(call):.1f} us [{label}]")


if __name__ == "__main__":
    main()
