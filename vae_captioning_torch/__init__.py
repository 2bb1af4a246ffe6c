"""vae_captioning_torch — the PyTorch / CUDA port of vae_captioning_tpu.

On precomputed VGG16 fc2 features, run on an NVIDIA H100 through
hand-written CUDA kernels: the decode path of the CVAEs in every mode
(``csrc/fused_lstm_step.cu``; ``csrc/fused_logits_topk.cu``: bf16 and
int8 top-k, Gumbel-max sampling; ``csrc/topk_lse.cu``: top-k over
written logits) and the train step of the AG-, GMM- and Normal-prior
CVAEs and the baseline (``csrc/fused_lstm_seq.cu``, ``csrc/fused_z.cu``,
``csrc/fused_ag_heads.cu``, and the linear CE under its three schedules,
``csrc/fused_ce.cu`` and ``csrc/fused_ce_mat.cu``, forward and
backward).  Module names mirror
``vae_captioning_tpu`` so each counterpart is easy to find; the JAX
package stays the reference the port is tested against.

The package imports ``torch`` and never ``jax``, and nothing of
``vae_captioning_tpu``: ``config``, ``data`` and ``utils`` are its own
copies of the JAX package's numpy modules, so ``config.json`` and
``vocab.json`` move between the two.
"""

__version__ = "0.1.0"

import torch as _torch

# The reference computes its f32 products (the image, cluster-vector and z
# embeddings) in full f32 (Precision.HIGHEST); TF32 would keep about three
# decimal digits.  Stated here, for every entry point of the port.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
