"""Device time per decode batch, by kernel, of the port's fused decode.

Runs ``chip_smoke.py``'s full-width AG-CVAE (random weights from a seed)
over one batch of 512 synthetic images at beam 3, beam 10 and greedy,
each batch once to warm up and then ``REPS`` times under
``torch.profiler``, and prints for each mode the device time per batch of
each kernel and their sum: what the card spends, which the host-clock
times of ``chip_smoke.py``'s ``phase_decode_times`` cannot show where
the host bounds the batch.  It uses only what ``chip_smoke.py`` and the
decode API have held since the port's first slice, so the same script
times an older checkout of the repository too.

    python3 decode_profile.py        # from the repository's root, on a CUDA card
"""

from __future__ import annotations

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

    from vae_captioning_torch.inference import make_decode_fns

    label = cs.card()
    cfg, vocab, model = cs.full_width_model()
    batch = next(cs.batchers(cs.BATCH, "val", vocab, 6).eval_batches())
    feats = torch.from_numpy(batch.features).to(cs.DEV)
    c_v = torch.from_numpy(batch.cluster_vectors).to(cs.DEV)
    for name, c, fn_name in (("beam 3", cfg, "beam_search"),
                             ("beam 10", cfg.replace(beam_size=10), "beam_search"),
                             ("greedy", cfg, "greedy")):
        fn = make_decode_fns(model, c, vocab)[fn_name]
        g = torch.Generator(device=cs.DEV).manual_seed(7)
        fn(feats, c_v, generator=g).tokens.cpu()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                fn(feats, c_v, generator=g).tokens.cpu()
            torch.cuda.synchronize()
        times = {}
        for e in prof.events():
            if e.device_type.name == "CUDA":
                key = kernel_name(e.name)[:48]
                times[key] = times.get(key, 0.0) + e.device_time_total / REPS / 1e3
        top = sorted(times.items(), key=lambda kv: -kv[1])
        print(f"decode {name}, {cs.BATCH} images: device {sum(times.values()):.3f} "
              f"ms/batch; " + ", ".join(f"{k} {v:.3f}" for k, v in top[:6])
              + f" [{label}]")


if __name__ == "__main__":
    main()
