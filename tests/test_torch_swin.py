"""The port's Swin backbone against ``fusionocc_tpu.nn.swin.SwinTransformer``.

Same numpy-drawn weights (carried by ``weights.state_dict_from_flax``), same
images; every output (the stage-0 stereo feature and the normed
out_indices features) must agree within 1e-4 in fp32.  JAX runs its window
attention either unfused (XLA) or through the Pallas kernel in interpret
mode; the port's op runs its plain version on the CPU.  The shapes cover
window padding, shifted blocks, odd sizes at PatchMerging and the
production window 12 with head_dim 32.
"""
import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusionocc_tpu import config as jcfg
from fusionocc_tpu.nn.swin import SwinTransformer as JSwin
from fusionocc_tpu_torch import config as tcfg
from fusionocc_tpu_torch.nn.layers import LayerNorm
from fusionocc_tpu_torch.nn.swin import SwinTransformer
from fusionocc_tpu_torch.weights import state_dict_from_flax

from test_torch_slice import random_variables
from torch_threads import one_torch_thread  # noqa: E402,F401


@pytest.mark.parametrize('preset,hw,fused', [
    ('tiny', (64, 128), False),
    ('tiny', (72, 40), True),       # 18x10 tokens: padding, odd merges
    ('midsize', (176, 352), True),  # window 12, head_dim 32
    ('midsize', (176, 352), False),
])
def test_swin_matches_jax(preset, hw, fused):
    jc = getattr(jcfg, f'{preset}_model_config')()
    tc = getattr(tcfg, f'{preset}_model_config')()
    jswin_cfg = dataclasses.replace(jc.swin, fused_attn=fused)
    x = np.random.RandomState(1).rand(2, *hw, 3).astype(np.float32)

    jmod = JSwin(jswin_cfg, dtype=jnp.float32)
    params = random_variables(
        lambda: jmod.init(jax.random.PRNGKey(0), x), seed=5)['params']
    want = jax.jit(lambda p, x: jmod.apply({'params': p}, x))(params, x)

    sd = state_dict_from_flax({'img_backbone': params}, {}, tc)
    prefix = 'img_backbone.'
    model = SwinTransformer(tc.swin)
    model.load_state_dict({k[len(prefix):]: v for k, v in sd.items()},
                          strict=True)
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    assert len(got) == len(want) == 1 + len(tc.swin.out_indices)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def test_layer_norm_matches_flax_epsilon():
    """eps 1e-6 as flax's default (torch and mmcv use 1e-5): visible on
    tokens of small variance."""
    rng = np.random.RandomState(0)
    x = (3e-3 * rng.randn(4, 32)).astype(np.float32)
    scale = (1 + 0.1 * rng.randn(32)).astype(np.float32)
    bias = (0.1 * rng.randn(32)).astype(np.float32)
    want = fnn.LayerNorm().apply({'params': {'scale': scale, 'bias': bias}},
                                 x)
    ln = LayerNorm(32)
    ln.load_state_dict({'weight': torch.from_numpy(scale),
                        'bias': torch.from_numpy(bias)})
    with torch.inference_mode():
        got = ln(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
