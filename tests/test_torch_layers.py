"""``HighwayNetwork`` (vae_captioning_torch/ops/layers.py) against the
JAX package's (vae_captioning_tpu/ops/layers.py): the Flax tree (``h_i``,
``t_i`` Dense layers) through ``bridge.load_flax_params``, outputs to
rtol 1e-5 (f32 products in another order), the transform gate's −1.0
bias at init, and tests/test_ops.py's carry check with zeroed weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from vae_captioning_tpu.ops.layers import HighwayNetwork as JaxHighway
from vae_captioning_torch.bridge import (export_flax_params, flax_shapes,
                                         load_flax_params)
from vae_captioning_torch.ops.layers import HighwayNetwork


@pytest.mark.parametrize("num_layers", [1, 2, 3])
def test_highway_matches_jax_through_the_bridge(num_layers):
    x = np.random.default_rng(num_layers).normal(size=(6, 24)).astype(np.float32)
    jhw = JaxHighway(num_layers=num_layers)
    params = jhw.init(jax.random.PRNGKey(num_layers), jnp.asarray(x))["params"]
    flat = {"/".join(k): np.asarray(v)
            for k, v in flatten_dict(jax.device_get(params)).items()}
    hw = HighwayNetwork(24, num_layers)
    assert flax_shapes(hw) == {k: v.shape for k, v in flat.items()}
    load_flax_params(hw, flat)
    want = np.asarray(jhw.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = hw(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    back = export_flax_params(hw)
    assert all(np.array_equal(back[k], flat[k]) for k in flat)


def test_highway_init_and_carry():
    hw = HighwayNetwork(16, num_layers=2)
    for i in range(2):
        assert torch.all(getattr(hw, f"t_{i}").bias == -1.0)
        assert torch.all(getattr(hw, f"h_{i}").bias == 0.0)
    with torch.no_grad():
        for name, p in hw.named_parameters():
            if not name.startswith("t_") or not name.endswith("bias"):
                p.zero_()
        y = hw(torch.ones(4, 16))
    # zero weights: the gate is sigmoid(-1) and relu(0) = 0, so each layer
    # carries sigmoid(1) of its input
    carry = 1 / (1 + np.exp(-1.0))
    np.testing.assert_allclose(y.numpy(), carry ** 2, rtol=1e-6)
