"""The PyTorch port stands alone: it imports, decodes and trains without
jax, flax, optax, orbax, cv2, h5py or any module of the JAX package
(``vae_captioning_tpu``).  The test process itself has jax loaded
(tests/conftest.py), so the check runs in a fresh interpreter where
those imports are blocked; and a static check parses every source of the
port, ``chip_smoke.py`` and the chip scripts beside it, for an import of
the JAX package."""

import ast
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "vae_captioning_torch")
JAX_PACKAGE = "vae_captioning_tpu"

SCRIPT = textwrap.dedent("""
    import importlib, importlib.abc, pkgutil, sys, tempfile

    BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "cv2", "h5py",
               "vae_captioning_tpu")

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
    for name in ("generate", "models.vgg_fidelity", "parallel.mesh",
                 "parallel.kernel_shard"):
        assert "vae_captioning_torch." + name in modules, name

    from vae_captioning_torch.config import Config
    from vae_captioning_torch.data.batcher import CaptionBatcher
    from vae_captioning_torch.data.features import FeatureStore
    from vae_captioning_torch.data.vocabulary import Vocabulary
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
    for prior in ("Normal", "AG"):
        tcfg = Config(embed_size=32, latent_size=8, encoder_hidden=32,
                      decoder_hidden=32, gen_z_samples=2, prior=prior,
                      use_c_v=prior == "AG", num_captions=1, num_epochs=1,
                      num_ex_per_epoch=2, batch_size=2, prefetch_batches=1,
                      logging=True, log_dir=tempfile.mkdtemp())
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
    assert n_modules >= 30


def _sources():
    paths = [os.path.join(REPO, f) for f in (
        "chip_smoke.py", "decode_profile.py", "kernel_designs.py", "sass_compare.py",
        os.path.join("examples", "generate_caption_example_torch.py"))]
    for root, _, files in os.walk(PORT):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def _jax_package_imports(source: str):
    """(line, statement) of every import of the JAX package in a module's
    source; names in docstrings and comments do not count."""
    found = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")):
            names = [node.args[0].value]
        else:
            continue
        found += [(node.lineno, n) for n in names
                  if n.split(".")[0] == JAX_PACKAGE]
    return found


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_source_imports_the_jax_package(path):
    with open(path) as f:
        source = f.read()
    assert _jax_package_imports(source) == [], path


def test_the_import_check_sees_every_form():
    src = textwrap.dedent("""
        \"\"\"The counterpart of vae_captioning_tpu/ops/x.py.\"\"\"
        # from vae_captioning_tpu import config
        import os
        import vae_captioning_tpu.config as c
        from vae_captioning_tpu.data import batcher
        def f():
            from vae_captioning_tpu import train
            return importlib.import_module("vae_captioning_tpu.ops")
    """)
    lines = [line for line, _ in _jax_package_imports(src)]
    assert sorted(lines) == [5, 6, 8, 9]
