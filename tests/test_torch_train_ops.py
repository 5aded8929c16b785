"""The port's kernel ``Function``s against the JAX package's custom VJPs.

Each of K1, K2 and K3 is a ``torch.autograd.Function`` whose forward is the
kernel (its plain version on the CPU) and whose backward is the JAX
package's own backward, written in PyTorch.  Here each one's forward and
its gradients for a random cotangent are held against JAX's
``custom_vjp`` on the same numpy inputs (fp32, CPU; JAX's Pallas kernels in
interpret mode):

- K2: ``fused_window_attention`` at window 12 (N = 144), shift 0 and 6, on
  window grids of a padded feature map, and a shifted Swin block with
  ``fused_attn=True`` on a 14 x 20 map (padded to 24 x 24): the block's
  output and every parameter's gradient;
- K1: ``bev_pool`` on a random frustum (``_bev_pool_flat``'s VJP, the
  Pallas segsum forward), the index's ``order_by_feat`` equal to JAX's, and
  the reference kernel's toy self-test (loss 4.4, its known gradients);
- K3: ``zwin_conv_apply`` (block_v=8, n_win=4), SubM and stride 2.

Each backward also equals autograd through the plain version (the port's
own check, as ``chip_smoke.py`` phase 7 makes it on the card), the K1 one
with a bf16 output as well (the backward sees the cast's cotangent).

Tolerances: forwards 1e-5; gradients within 1e-5 absolute plus 1e-4
relative (fp32 sums in another order), the Swin block's parameter
gradients (sums over 560 tokens, of order 1) within 1e-4 absolute plus
1e-4 relative; the toy self-test 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusionocc_tpu.config import GridConfig as JGrid
from fusionocc_tpu.nn.swin import SwinBlock as JSwinBlock
from fusionocc_tpu.ops import sparse_conv as jsc
from fusionocc_tpu.ops import zfold as jzf
from fusionocc_tpu.ops.bev_pool import bev_pool as j_bev_pool
from fusionocc_tpu.ops.bev_pool import \
    prepare_pooling_index as j_prepare_pooling_index
from fusionocc_tpu.ops.pallas.window_attn import fused_window_attention
from fusionocc_tpu.ops.pallas.zwin_conv import zwin_conv_apply
from fusionocc_tpu_torch import config as tcfg
from fusionocc_tpu_torch.config import GridConfig as TGrid
from fusionocc_tpu_torch.nn.swin import SwinBlock
from fusionocc_tpu_torch.ops import bev_pool as tbp
from fusionocc_tpu_torch.ops import window_attn as twa
from fusionocc_tpu_torch.ops import zwin_conv as tzw
from fusionocc_tpu_torch.weights import state_dict_from_flax

from test_sparse_conv import _random_sparse
from test_torch_lidar_ops import ZWIN_CASES
from test_torch_ops import _random_pool_problem
from torch_threads import one_torch_thread  # noqa: E402,F401

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
BLOCK_TOL = dict(rtol=1e-4, atol=1e-4)   # weight grads sum over 560 tokens


def _t(x, grad=False):
    return torch.tensor(np.asarray(x), requires_grad=grad)


def _vjp_both(jfn, tfn, args, cot, grad_idx):
    """JAX's forward and VJP of jfn, the port's forward and autograd
    gradients of tfn, on the same numpy args; grads for args[grad_idx]."""
    jargs = [jnp.asarray(a) for a in args]

    def jf(*diff):
        full = list(jargs)
        for i, d in zip(grad_idx, diff):
            full[i] = d
        return jfn(*full)
    jout, vjp = jax.vjp(jf, *[jargs[i] for i in grad_idx])
    jgrads = vjp(jnp.asarray(cot))
    targs = [_t(a, i in grad_idx) for i, a in enumerate(args)]
    tout = tfn(*targs)
    tout.backward(_t(cot))
    return (np.asarray(jout), [np.asarray(g) for g in jgrads],
            tout.detach().numpy(), [targs[i].grad.numpy() for i in grad_idx])


# (shift, nWh, nWw, images): window 12 on a padded map's window grid
WA_CASES = [(0, 2, 2, 1), (6, 2, 2, 1), (6, 1, 3, 2)]


@pytest.mark.parametrize('shift,nWh,nWw,b', WA_CASES)
def test_window_attention_function_matches_jax(shift, nWh, nWw, b):
    w, heads, c = 12, 2, 64
    n, bn = w * w, b * nWh * nWw
    rng = np.random.RandomState(shift + nWw)
    q, k, v = (rng.randn(bn, n, c).astype(np.float32) for _ in range(3))
    bias = rng.randn(heads, n, n).astype(np.float32)
    cot = rng.randn(bn, n, c).astype(np.float32)
    geom = (nWh, nWw, w, shift, heads)
    jout, jgrads, tout, tgrads = _vjp_both(
        lambda *a: fused_window_attention(*a, *geom),
        lambda *a: twa.window_attention(*a, *geom),
        (q, k, v, bias), cot, (0, 1, 2, 3))
    np.testing.assert_allclose(tout, jout, **FWD_TOL)
    for name, got, want in zip('qkvb', tgrads, jgrads):
        np.testing.assert_allclose(got, want, **GRAD_TOL, err_msg=name)
    # the same backward against autograd through the plain version
    targs = [_t(a, True) for a in (q, k, v, bias)]
    twa.window_attention_plain(*targs, *geom).backward(_t(cot))
    for name, got, t in zip('qkvb', tgrads, targs):
        np.testing.assert_allclose(got, t.grad.numpy(), **GRAD_TOL,
                                   err_msg=name)


def test_swin_block_with_padding_matches_jax():
    """A shifted block, window 12, on a 14 x 20 map (padded to 24 x 24):
    JAX with the fused kernel and its custom VJP against the port."""
    H, W, C, heads = 14, 20, 64, 2
    jblock = JSwinBlock(C, heads, 12, shift=True, mlp_ratio=4,
                        qkv_bias=True, drop_path_rate=0.0, fused_attn=True)
    rng = np.random.RandomState(7)
    x = rng.randn(2, H * W, C).astype(np.float32)
    cot = rng.randn(2, H * W, C).astype(np.float32)
    shapes = jax.eval_shape(lambda: jblock.init(jax.random.PRNGKey(0),
                                                jnp.asarray(x), (H, W)))
    params = jax.tree.map(
        lambda s: (0.2 * rng.randn(*s.shape)).astype(np.float32),
        shapes['params'])

    def jf(p, xx):
        return jblock.apply({'params': p}, xx, (H, W))
    jout, vjp = jax.vjp(jf, params, jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(cot))

    # the block's leaves under a model tree, renamed by the port's rules
    def named(tree):
        sd = state_dict_from_flax({'img_backbone': {'stage2_block1': tree}},
                                  {}, tcfg.tiny_model_config())
        prefix = 'img_backbone.stages.2.blocks.1.'
        return {k[len(prefix):]: v for k, v in sd.items()
                if not k.endswith('relative_position_index')}
    block = SwinBlock(C, heads, 12, True, 4, True)
    block.load_state_dict({**block.state_dict(),
                           **named(jax.tree.map(np.asarray, params))})
    xt = _t(x, True)
    out = block(xt, (H, W))
    out.backward(_t(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **FWD_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), **GRAD_TOL)
    want = named(jax.tree.map(np.asarray, jgp))
    got = {n: p.grad for n, p in block.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                   **BLOCK_TOL, err_msg=name)


POOL_GRID = dict(x=(-4, 4, 1.0), y=(-4, 4, 1.0), z=(-1, 3, 1.0))


@pytest.mark.parametrize('B,N,D,H,W,C,seed', [
    (1, 2, 8, 16, 16, 8, 0),      # P = 4096: JAX's forward is Pallas segsum
    (2, 2, 5, 3, 7, 4, 1),
])
def test_bev_pool_function_matches_jax(B, N, D, H, W, C, seed):
    kw = dict(POOL_GRID, depth=(1.0, 1.0 + D, 1.0))
    jg, tg = JGrid(**kw), TGrid(**kw)
    coor, depth, feat = _random_pool_problem(B, N, D, H, W, C, tg, seed)
    ji = j_prepare_pooling_index(jnp.asarray(coor), jg)
    ti = tbp.prepare_pooling_index(_t(coor), tg)
    np.testing.assert_array_equal(ti.order_by_feat.numpy(),
                                  np.asarray(ji.order_by_feat))
    cot = np.random.RandomState(seed + 10).randn(
        B, tg.size_z, tg.size_y, tg.size_x, C).astype(np.float32)
    jout, jgrads, tout, tgrads = _vjp_both(
        lambda d, f: j_bev_pool(d, f, ji, jg),
        lambda d, f: tbp.bev_pool(d, f, ti, tg), (depth, feat), cot, (0, 1))
    np.testing.assert_allclose(tout, jout, rtol=1e-4, atol=1e-4)
    for name, got, want in zip(('depth', 'feat'), tgrads, jgrads):
        np.testing.assert_allclose(got, want, **GRAD_TOL, err_msg=name)


@pytest.mark.parametrize('out_dtype', [torch.float32, torch.bfloat16])
def test_bev_pool_backward_matches_plain_autograd(out_dtype):
    """``bev_pool_bwd`` against autograd through ``bev_pool_plain`` (and
    the cast to ``out_dtype``) on a rig-like index with long runs."""
    tg = TGrid(**POOL_GRID, depth=(1.0, 9.0, 1.0))
    coor, depth, feat = _random_pool_problem(2, 2, 8, 6, 8, 8, tg, 3)
    idx = tbp.prepare_pooling_index(_t(coor), tg)
    nvox = 2 * tg.size_z * tg.size_y * tg.size_x
    cot = torch.randn(nvox, 8, generator=torch.Generator().manual_seed(4)
                      ).to(out_dtype)
    grads = []
    for fn in (lambda d, f: tbp.bev_pool_flat(d, f, idx, nvox, out_dtype),
               lambda d, f: tbp.bev_pool_plain(d, f, idx, nvox).to(out_dtype)):
        d, f = _t(depth.reshape(-1), True), _t(feat.reshape(-1, 8), True)
        fn(d, f).backward(cot)
        grads.append((d.grad, f.grad))
    for got, want in zip(*grads):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **GRAD_TOL)


def test_bev_pool_toy_selftest_gradients():
    """The reference kernel's self-test (tests/test_bev_pool.py): 8 frustum
    points, 4 pixel rows of 2 channels, D = 2; loss 4.4 and its known depth
    and feat gradients, through the port's ``Function``."""
    depth = _t(np.float32([0.3, 0.4, 0.2, 0.1, 0.7, 0.6, 0.8, 0.9]), True)
    feat = _t(np.ones((4, 2), np.float32), True)
    nvox = 8
    ranks_feat = torch.tensor([0, 0, 1, 2, 1, 2, 3, 3], dtype=torch.int32)
    ranks_bev = torch.tensor([0, 0, 1, 1] + [nvox] * 4, dtype=torch.int32)
    bounds = torch.searchsorted(ranks_bev, torch.arange(nvox + 1,
                                                        dtype=torch.int32),
                                out_int32=True)
    idx = tbp.PoolingIndex(
        torch.tensor([0, 4, 1, 6, 2, 3, 5, 7], dtype=torch.int32), ranks_feat,
        ranks_bev, bounds, tbp.long_runs(bounds, tbp.MAX_SHORT_RUN),
        tbp.MAX_SHORT_RUN,
        torch.argsort(ranks_feat, stable=True).to(torch.int32))
    loss = tbp.bev_pool_flat(depth, feat, idx, nvox).sum()
    loss.backward()
    assert abs(loss.item() - 4.4) < 1e-6
    np.testing.assert_allclose(depth.grad.numpy(), [2, 2, 0, 0, 2, 0, 2, 0],
                               atol=1e-6)
    np.testing.assert_allclose(
        feat.grad.numpy(), [[1.0, 1.0], [0.4, 0.4], [0.8, 0.8], [0, 0]],
        atol=1e-6)


def test_bev_pool_backward_needs_order_by_feat():
    idx = tbp.prepare_pooling_index(
        torch.zeros(1, 1, 2, 1, 1, 3), TGrid(**POOL_GRID,
                                             depth=(1.0, 3.0, 1.0)))
    d = torch.ones(2, requires_grad=True)
    out = tbp.bev_pool_flat(d, torch.ones(1, 8), idx._replace(
        order_by_feat=None), 128)
    with pytest.raises(ValueError, match='order_by_feat'):
        out.sum().backward()


@pytest.mark.parametrize('case', ['subm', 'strided'])
def test_zwin_function_matches_jax(case):
    seed, shape, B, V, cin, cout, cap, pts, down = ZWIN_CASES[case]
    rng = np.random.RandomState(seed)
    sp = _random_sparse(rng, B, V, shape, cin, density_pts=pts)
    zv = jzf.zfold_regroup(sp, shape, capacity=cap, fold=8)
    sshape = jzf.super_shape(shape, 8)
    if down is None:
        nbr, _ = jsc.stage_indices_table(jzf.as_sparse(zv), sshape, None)
        mask, f_out, stride = zv.mask, 8, 1
    else:
        _, ((_, _, mask, nbr), _) = jsc.stage_indices_table(
            jzf.as_sparse(zv), sshape, down)
        f_out = min(8, jsc.out_shape_strided(shape)[2])
        stride = 2
    w = (rng.randn(27, cin, cout) * 0.1).astype(np.float32)
    feats = np.asarray(zv.feats)
    cot = rng.randn(*nbr.shape[:2], f_out * cout).astype(np.float32)
    geom = (8, f_out, stride)
    jout, jgrads, tout, tgrads = _vjp_both(
        lambda f, m, n, k: zwin_conv_apply(f, m, n, k, *geom, block_v=8,
                                           n_win=4),
        lambda f, m, n, k: tzw.zwin_conv(f, m, n, k, *geom),
        (feats, np.asarray(mask), np.asarray(nbr), w), cot, (0, 3))
    assert np.abs(jout).max() > 0
    np.testing.assert_allclose(tout, jout, **FWD_TOL)
    for name, got, want in zip(('feats', 'weight'), tgrads, jgrads):
        np.testing.assert_allclose(got, want, **GRAD_TOL, err_msg=name)
    # the Function's backward against autograd through the plain version
    f, k = _t(feats, True), _t(w, True)
    tzw.zwin_conv_plain(f, _t(mask), _t(nbr), k, *geom).backward(_t(cot))
    np.testing.assert_allclose(tgrads[0], f.grad.numpy(), **GRAD_TOL)
    np.testing.assert_allclose(tgrads[1], k.grad.numpy(), **GRAD_TOL)


def test_zwin_backward_saves_only_its_inputs():
    """The ``Function`` keeps (feats, mask, nbr, weight) for the backward,
    no output or gathered tensor (JAX's residuals)."""
    rng = np.random.RandomState(0)
    feats = _t(rng.randn(1, 6, 16).astype(np.float32), True)
    weight = _t(rng.randn(27, 2, 3).astype(np.float32), True)
    nbr = torch.from_numpy(rng.randint(0, 7, (1, 6, 27)).astype(np.int32))
    mask = torch.ones(1, 6, dtype=torch.bool)
    out = tzw.zwin_conv(feats, mask, nbr, weight, 8, 8, 1)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 4
    assert saved[0].data_ptr() == feats.data_ptr()
    assert saved[3].data_ptr() == weight.data_ptr()
