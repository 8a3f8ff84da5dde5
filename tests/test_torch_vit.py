"""Port parity, `models/common.py` transformer blocks and the ViT
(with a position grid resized from its checkpoint's), `comfy3d_tpu_torch`
against `comfy3d_tpu` on the same numpy inputs and weights."""

import pytest

# CPU parity tier of the port; kept out of the smoke manifest
pytestmark = pytest.mark.heavy

import jax
import jax.numpy as jnp
import numpy as np
import torch

from comfy3d_tpu.models import common as jc

from comfy3d_tpu_torch import convert
from comfy3d_tpu_torch.models import common as tc

from tests.test_torch_common import _block_case, _load, _np, _params


@pytest.mark.parametrize("name", [
    "basic_block", "transformer1d", "vit_self_attention", "vit_block"])
def test_transformer_block_matches_jax(name):
    jmod, args, tmod, to_sd = _block_case(name)
    params = _params(jmod, *map(jnp.asarray, args))
    ref = jax.jit(jmod.apply)({"params": params}, *map(jnp.asarray, args))
    _load(tmod, to_sd(params))
    with torch.no_grad():
        out = tmod(*map(torch.as_tensor, args))
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("image", [48, 24])
def test_vit_with_a_resized_position_grid_matches_jax(image):
    """Patch 8: a 6² grid from the checkpoint's 4² (up), and a 3² one
    (down)."""
    kw = dict(hidden=32, layers=2, heads=4, mlp_dim=64, patch=8,
              pretrain_grid=4)
    x = np.random.RandomState(3).rand(2, image, image, 3).astype(np.float32)
    jmod = jc.ViT(**kw)
    params = _params(jmod, jnp.asarray(x), seed=4)
    ref = jax.jit(jmod.apply)({"params": params}, jnp.asarray(x))
    port = _load(tc.ViT(**kw), convert.vit_state_dict_from_flax(params))
    with torch.no_grad():
        out = port(torch.as_tensor(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        _np(tc.imagenet_normalize(torch.as_tensor(x).permute(0, 3, 1, 2))),
        np.asarray(jc.imagenet_normalize(jnp.asarray(x))).transpose(
            0, 3, 1, 2), atol=1e-6, rtol=0)
