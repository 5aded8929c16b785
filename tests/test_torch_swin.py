"""The port's Swin backbone against ``fusionocc_tpu.nn.swin.SwinTransformer``.

Same numpy-drawn weights (carried by ``weights.state_dict_from_flax``), same
images; every output (the stage-0 stereo feature and the normed
out_indices features) must agree within 1e-4 in fp32.  JAX runs its window
attention either unfused (XLA) or through the Pallas kernel in interpret
mode; the port's op runs its plain version on the CPU.  The shapes cover
window padding, shifted blocks, odd sizes at PatchMerging and the
production window 12 with head_dim 32.  The port's Swin runs under
``inference_mode`` there, so through the glue ops (``ops/swin_glue.py``);
the eval path through them equals the training composition bit for bit.
"""
import collections
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
from fusionocc_tpu_torch.nn.swin import SwinBlock, SwinTransformer
from fusionocc_tpu_torch.ops import swin_glue
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


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('residual', [False, True])
@pytest.mark.parametrize('shift', [False, True])
@pytest.mark.parametrize('hw', [(8, 8), (6, 7)])
def test_eval_glue_equals_training_composition(hw, shift, residual, dtype):
    """A block through ``window_in`` / ``window_out`` (eval, autograd off:
    the previous block's residual add folded in when there is one) equals
    the training composition bit for bit; 6x7 in windows of 4 pads both
    axes, the shift is 0 or w/2, B = 2."""
    C, heads, w = 16, 2, 4
    g = torch.Generator().manual_seed(3)
    blk = SwinBlock(C, heads, w, shift, mlp_ratio=2, qkv_bias=True).eval()
    with torch.no_grad():
        for p in blk.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    x, r = (torch.randn(2, hw[0] * hw[1], C, generator=g).to(dtype)
            for _ in range(2))
    r = r if residual else None
    with torch.no_grad():
        got_x, got_y = blk.infer(x, r, hw)
    want = blk(x if r is None else x + r, hw).detach()
    got = got_x + got_y
    assert got.dtype == want.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize('training,grad', [(False, False), (False, True),
                                           (True, False), (True, True)])
def test_glue_ops_only_in_eval_without_autograd(training, grad, monkeypatch):
    """The backbone calls each glue op once a block in eval mode with
    autograd off, and neither otherwise (training's ``no_grad`` pass of
    an adjacent frame included)."""
    cfg = tcfg.tiny_model_config().swin
    model = SwinTransformer(cfg).train(training)
    calls = collections.Counter()
    for name in ('window_in_op', 'window_out_op'):
        def counted(*args, _real=getattr(swin_glue, name), _name=name):
            calls[_name] += 1
            return _real(*args)
        monkeypatch.setattr(swin_glue, name, counted)
    x = torch.from_numpy(np.random.RandomState(2).rand(2, 40, 72, 3)
                         .astype(np.float32))
    with torch.set_grad_enabled(grad):
        model(x)
    n = 0 if training or grad else sum(cfg.depths)
    assert calls == collections.Counter(window_in_op=n, window_out_op=n)
