"""The PyTorch port imports, decodes and trains without jax, flax, optax,
orbax, cv2 or h5py.  The test process itself has jax loaded
(tests/conftest.py), so the check runs in a fresh interpreter where
those imports are blocked."""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import importlib, importlib.abc, pkgutil, sys, tempfile

    BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "cv2", "h5py")

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())

    import numpy as np
    import torch
    import vae_captioning_torch

    modules = [m.name for m in pkgutil.walk_packages(
        vae_captioning_torch.__path__, "vae_captioning_torch.")]
    for name in modules:
        importlib.import_module(name)

    from vae_captioning_tpu.config import Config
    from vae_captioning_tpu.data.batcher import CaptionBatcher
    from vae_captioning_tpu.data.features import FeatureStore
    from vae_captioning_tpu.data.vocabulary import Vocabulary
    from vae_captioning_torch.models.cvae import CVAEModel
    from vae_captioning_torch.inference import run_inference

    cfg = Config(embed_size=32, latent_size=16, decoder_hidden=32,
                 gen_z_samples=4, prior="AG", use_c_v=True, gen_max_len=4,
                 beam_size=2)
    vocab = Vocabulary(["<BOS>", "<EOS>", "<UNK>", "a", "b", "c"])
    cfg.vocab_size = vocab.vocab_size
    model = CVAEModel.from_config(cfg)
    names = [f"im{i}.jpg" for i in range(3)]
    rng = np.random.default_rng(0)
    batcher = CaptionBatcher(
        names, {n: [[vocab.bos_id, 4, vocab.eos_id]] for n in names}, 2,
        feature_store=FeatureStore(names, rng.normal(size=(3, 4096))),
        cluster_vectors={n: rng.random(91) for n in names},
        filename_to_imid={n: i for i, n in enumerate(names)})
    with tempfile.TemporaryDirectory() as out:
        written = run_inference(cfg, model, vocab, batcher, batcher, out)
    assert set(written) == {"val", "test"}, written

    from vae_captioning_torch.train import Trainer
    tcfg = Config(embed_size=32, latent_size=8, encoder_hidden=32,
                  decoder_hidden=32, gen_z_samples=2, prior="Normal",
                  num_captions=1, num_epochs=1, num_ex_per_epoch=2,
                  batch_size=2, prefetch_batches=1)
    trainer = Trainer(tcfg, vocab_size=vocab.vocab_size, device="cpu")
    with tempfile.TemporaryDirectory() as out:
        metrics = trainer.fit(batcher, batcher, checkpoint_dir=out,
                              log_every=1)
    assert trainer.host_step >= 1 and metrics["loss"] == metrics["loss"]
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not loaded, loaded
    print("PORT_MODULES", len(modules))
""")


def test_port_imports_and_decodes_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split("PORT_MODULES")[1].split()[0])
    assert n_modules >= 17
