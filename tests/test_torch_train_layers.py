"""The port's layers in training mode.

- ``BatchNorm`` (NCHW) and ``MaskedBatchNorm`` (z-folded lanes and cells)
  against the JAX package's with ``train=True`` on the same numpy inputs:
  the output, the gradients of the input, scale and bias for a random
  cotangent, and the running statistics after one call (flax's momenta 0.9
  and 0.99, the biased batch variance), within 1e-5 absolute and relative.
- The stochastic parts, by contract (JAX draws from its own generator, so
  draws are not compared): ``drop_path`` drops whole samples, ``dropout``
  single elements, the depth-input drop whole views without rescaling;
  kept entries are scaled by 1 / keep (``dropout``, ``drop_path``); the
  keep rate is within 4 binomial standard deviations of 1 - rate; the same
  generator seed gives the same draws; nothing is drawn in eval mode.
- ``with_cp``: a Swin backbone in training with drop path, checkpointed or
  not, from the same generator seed gives the same output and the same
  gradients (a mask drawn anew in the recompute would not), and
  ``remat_bev`` leaves the running statistics as one forward does.
- Modules are built in eval mode.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusionocc_tpu.nn.layers import BatchNorm as JBatchNorm
from fusionocc_tpu.nn.layers import MaskedBatchNorm as JMaskedBatchNorm
from fusionocc_tpu_torch import config as tcfg
from fusionocc_tpu_torch.data.synthetic import synthetic_batch
from fusionocc_tpu_torch.models.fusion_occ import FusionOcc, init_weights
from fusionocc_tpu_torch.models.lidar_encoder import SparseEncoder
from fusionocc_tpu_torch.models.lss import CrossModalLSS
from fusionocc_tpu_torch.nn import layers
from fusionocc_tpu_torch.nn.swin import SwinTransformer
from fusionocc_tpu_torch.train import loop
from torch_threads import one_torch_thread  # noqa: E402,F401

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x, grad=False):
    return torch.tensor(np.asarray(x), requires_grad=grad)


def _stats(rng, c):
    return ({'mean': (0.1 * rng.randn(c)).astype(np.float32),
             'var': rng.uniform(0.5, 1.5, c).astype(np.float32)},
            {'scale': (1 + 0.1 * rng.randn(c)).astype(np.float32),
             'bias': (0.1 * rng.randn(c)).astype(np.float32)})


def _load(bn, stats, params):
    with torch.no_grad():
        bn.weight.copy_(_t(params['scale']))
        bn.bias.copy_(_t(params['bias']))
        bn.running_mean.copy_(_t(stats['mean']))
        bn.running_var.copy_(_t(stats['var']))
    bn.train()
    return bn


def _jax_train(module, params, stats, args, cot):
    """JAX's output, d_x, d_params and new batch_stats of one train call."""
    def f(p, x):
        y, mut = module.apply({'params': p, 'batch_stats': stats}, x,
                              *args[1:], train=True, mutable=['batch_stats'])
        return y, mut['batch_stats']
    y, vjp_fn, new = jax.vjp(f, params, jnp.asarray(args[0]), has_aux=True)
    dp, dx = vjp_fn(jnp.asarray(cot))
    return (np.asarray(y), np.asarray(dx), jax.tree.map(np.asarray, dp),
            jax.tree.map(np.asarray, new))


def test_batchnorm_train_matches_jax():
    rng = np.random.RandomState(0)
    x = (2 * rng.randn(4, 5, 6, 3) + 1).astype(np.float32)      # NHWC
    cot = rng.randn(*x.shape).astype(np.float32)
    stats, params = _stats(rng, 3)
    y, dx, dp, new = _jax_train(
        JBatchNorm(), {'BatchNorm_0': params}, {'BatchNorm_0': stats},
        (x,), cot)
    bn = _load(layers.BatchNorm(3), stats, params)
    xt = _t(x.transpose(0, 3, 1, 2), True)
    out = bn(xt)
    out.backward(_t(cot.transpose(0, 3, 1, 2)))
    np.testing.assert_allclose(out.detach().numpy().transpose(0, 2, 3, 1), y,
                               **TOL)
    np.testing.assert_allclose(xt.grad.numpy().transpose(0, 2, 3, 1), dx,
                               **TOL)
    np.testing.assert_allclose(bn.weight.grad.numpy(),
                               dp['BatchNorm_0']['scale'], **TOL)
    np.testing.assert_allclose(bn.bias.grad.numpy(),
                               dp['BatchNorm_0']['bias'], **TOL)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               new['BatchNorm_0']['mean'], **TOL)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               new['BatchNorm_0']['var'], **TOL)
    assert int(bn.num_batches_tracked) == 1


@pytest.mark.parametrize('layout', ['zfold', 'cells'])
def test_masked_batchnorm_train_matches_jax(layout):
    """Statistics over the active cells only; in the z-folded layout the
    F*C lanes collapse to C channels and the count is the active cells."""
    rng = np.random.RandomState(1)
    C, F = 3, 4
    if layout == 'zfold':
        x = rng.randn(2, 5, F * C).astype(np.float32) + 0.5
        mask = rng.rand(2, 5, F) > 0.4
    else:
        x = rng.randn(2, 5, 6, C).astype(np.float32) + 0.5
        mask = rng.rand(2, 5, 6) > 0.4
    cot = rng.randn(*x.shape).astype(np.float32)
    stats, params = _stats(rng, C)
    y, dx, dp, new = _jax_train(
        JMaskedBatchNorm(fold=F if layout == 'zfold' else 0), params, stats,
        (x, jnp.asarray(mask)), cot)
    bn = _load(layers.MaskedBatchNorm(C), stats, params)
    xt = _t(x, True)
    out = bn(xt, _t(mask))
    out.backward(_t(cot))
    np.testing.assert_allclose(out.detach().numpy(), y, **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), dx, **TOL)
    np.testing.assert_allclose(bn.weight.grad.numpy(), dp['scale'], **TOL)
    np.testing.assert_allclose(bn.bias.grad.numpy(), dp['bias'], **TOL)
    np.testing.assert_allclose(bn.running_mean.numpy(), new['mean'], **TOL)
    np.testing.assert_allclose(bn.running_var.numpy(), new['var'], **TOL)


def _binomial_ok(kept: int, n: int, keep: float) -> bool:
    return abs(kept - n * keep) <= 4 * (n * keep * (1 - keep)) ** 0.5


def test_dropout_contract():
    x = torch.rand(64, 50) + 0.5
    with layers.random_scope(torch.Generator().manual_seed(3)):
        y = layers.dropout(x, 0.3)
    with layers.random_scope(torch.Generator().manual_seed(3)):
        again = layers.dropout(x, 0.3)
    kept = y != 0
    assert torch.equal(y, again)
    torch.testing.assert_close(y[kept], x[kept] / 0.7)
    assert _binomial_ok(int(kept.sum()), x.numel(), 0.7)
    assert kept.any(dim=1).all() and (~kept).any(dim=1).all()  # per element


def test_drop_path_contract():
    B = 4000
    x = torch.rand(B, 3, 5) + 0.5
    with layers.random_scope(torch.Generator().manual_seed(4)):
        keep = layers.keep_mask((B,), 0.2, x.device)
    with layers.random_scope(torch.Generator().manual_seed(4)):
        assert torch.equal(keep, layers.keep_mask((B,), 0.2, x.device))
    y = layers.drop_path(x, keep, 0.2)
    torch.testing.assert_close(y[keep], x[keep] / 0.8)
    assert bool((y[~keep] == 0).all())
    assert _binomial_ok(int(keep.sum()), B, 0.8)


def test_draws_need_a_generator():
    with pytest.raises(RuntimeError, match='random_scope'):
        layers.keep_mask((3,), 0.5, 'cpu')


def test_depth_drop_contract():
    """Per view, the depth input is the one-hot map or zeros (not
    rescaled), kept with probability 1 - depth_drop_rate; eval draws
    nothing."""
    cfg = tcfg.tiny_model_config()
    vt = CrossModalLSS(cfg.vt, cfg.grid, cfg.img_neck_out_channels).eval()
    B, N, (h, w) = 30, 2, cfg.feat_size
    D = cfg.grid.num_depth_bins
    g = torch.Generator().manual_seed(0)
    sparse = torch.rand(B, N, *cfg.input_size, generator=g) * 8 + 1
    x = torch.randn(B, N, h, w, cfg.img_neck_out_channels, generator=g)
    seen = []
    vt.depth_encoder.register_forward_pre_hook(
        lambda m, a: seen.append(a[0].detach()))
    idx_coor = torch.zeros(B, N, D, h, w, 3)
    from fusionocc_tpu_torch.ops.bev_pool import prepare_pooling_index
    idx = prepare_pooling_index(idx_coor, cfg.grid)
    mlp = torch.randn(B, N, 27, generator=g)
    with torch.no_grad():
        vt(x, sparse, mlp, idx)                              # eval
        vt.train()
        with layers.random_scope(torch.Generator().manual_seed(1)):
            vt(x, sparse, mlp, idx)
    full, dropped = (s.reshape(B * N, D, -1) for s in seen)
    assert bool((full.sum(dim=(1, 2)) > 0).all())
    kept = (dropped == full).all(dim=2).all(dim=1)
    zero = (dropped == 0).all(dim=2).all(dim=1)
    assert bool((kept | zero).all())
    assert _binomial_ok(int(kept.sum()), B * N, 1 - cfg.vt.depth_drop_rate)


def _swin_cfg(with_cp):
    return dataclasses.replace(tcfg.tiny_model_config().swin,
                               drop_path_rate=0.5, with_cp=with_cp)


def test_with_cp_recompute_sees_the_drawn_masks():
    x = torch.rand(2, 64, 128, 3, generator=torch.Generator().manual_seed(0))
    results = []
    for with_cp in (False, True):
        torch.manual_seed(0)
        model = SwinTransformer(_swin_cfg(with_cp))
        model.train()
        with layers.random_scope(torch.Generator().manual_seed(9)):
            outs = model(x)
        sum(o.square().sum() for o in outs).backward()
        results.append(([o.detach() for o in outs],
                        {n: p.grad for n, p in model.named_parameters()}))
    (out0, g0), (out1, g1) = results
    for a, b in zip(out0, out1):
        torch.testing.assert_close(a, b)
    for name in g0:
        torch.testing.assert_close(g1[name], g0[name], msg=name)
    # the draws did drop paths: the same seed without drop path differs
    torch.manual_seed(0)
    model = SwinTransformer(dataclasses.replace(_swin_cfg(False),
                                                drop_path_rate=0.0))
    assert not torch.allclose(model(x)[-1], out0[-1])


def test_remat_bev_matches_plain_training_forward():
    """``remat_bev`` recomputes the BEV trunk in the backward: the same
    gradients, and its BatchNorms' running statistics moved once."""
    runs = []
    for remat in (False, True):
        cfg = tcfg.tiny_model_config(use_lidar=False, remat_bev=remat)
        model = init_weights(FusionOcc(cfg, device='cpu'),
                             torch.Generator().manual_seed(0))
        batch = synthetic_batch(cfg, 1, 0, num_points=256, device='cpu')
        tc = tcfg.TrainConfig(model=cfg)
        loss, _ = loop.compute_loss(model, tc, batch,
                                    torch.Generator().manual_seed(2))
        loss.backward()
        runs.append(model)
    plain, remat = runs
    for (name, a), b in zip(plain.state_dict().items(),
                            remat.state_dict().values()):
        torch.testing.assert_close(b, a, msg=name)
    for (name, a), b in zip(plain.named_parameters(), remat.parameters()):
        torch.testing.assert_close(b.grad, a.grad, msg=name)


def test_modules_are_built_in_eval_mode():
    cfg = tcfg.tiny_model_config()
    cfg = dataclasses.replace(cfg, lidar=dataclasses.replace(
        cfg.lidar, backend='zfold', zconv='zband'))
    for module in (FusionOcc(cfg, device='cpu'), SwinTransformer(cfg.swin),
                   SparseEncoder(cfg.lidar, cfg.grid, device='cpu'),
                   layers.BatchNorm(4), layers.MaskedBatchNorm(4)):
        assert not any(m.training for m in module.modules()), module
