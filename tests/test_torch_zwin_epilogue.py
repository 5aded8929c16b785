"""The fused zwin epilogue (``zwin_fuse=True``) against the JAX package
(CPU).

Inputs are made with numpy from a seed and handed to both packages.

- ``zwin_conv_epi_plain`` against JAX ``zwin_conv_infer(..., affine=,
  act=True, lane_exp=)``, the Pallas kernel with ``_epilogue_in_kernel`` in
  interpret mode with block_v=8 (as tests/test_zwin.py runs it) and a
  window over every input row, so no block takes JAX's overflow patch
  (which rounds its sums to the output dtype before the affine), SubM and
  stride 2, on tests/test_torch_lidar_ops.py's fixtures, with
  BatchNorm statistics away from the identity and about a third of the
  output lanes off: fp32 within atol 1e-5, rtol 1e-4 (sums in another
  order); bf16 within one bf16 ulp (rtol 2^-7, and atol 1e-5 where the
  ReLU meets a sum near zero).  ``MaskedBatchNorm.scale_shift`` is JAX's
  affine query (``MaskedBatchNorm(x=None)``) within one fp32 ulp (the two
  packages' rsqrt round apart).
- The tiny encoder with ``zwin_fuse=True`` against JAX's ``SparseEncoder``
  with ``zwin_fuse=True`` on the same weights (random BatchNorm
  statistics), at ``dense_from`` 3 and 4, within 1e-4; and against the
  port's unfused encoder on the same weights.
- ``zwin_conv_epi_cuda`` refuses CPU tensors, and ``zwin_conv_epi`` takes
  the plain version on them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusionocc_tpu import config as jcfg
from fusionocc_tpu.data.synthetic import synthetic_batch as j_synthetic_batch
from fusionocc_tpu.models.lidar_encoder import SparseEncoder as JSparseEncoder
from fusionocc_tpu.nn.layers import MaskedBatchNorm as JMaskedBatchNorm
from fusionocc_tpu.ops import sparse_conv as jsc
from fusionocc_tpu.ops import zfold as jzf
from fusionocc_tpu.ops.pallas.zwin_conv import _prepare, zwin_conv_infer
from fusionocc_tpu_torch import config as tcfg
from fusionocc_tpu_torch.models.lidar_encoder import SparseEncoder
from fusionocc_tpu_torch.nn.layers import MaskedBatchNorm
from fusionocc_tpu_torch.ops import zwin_conv as tzw
from fusionocc_tpu_torch.weights import state_dict_from_flax

from test_sparse_conv import _random_sparse
from test_torch_lidar_model import ENC_TOL, _snap
from test_torch_lidar_ops import ZWIN_CASES, _t
from test_torch_slice import random_variables
from torch_threads import one_torch_thread  # noqa: E402,F401

EPI_TOL = {'float32': dict(atol=1e-5, rtol=1e-4),
           'bfloat16': dict(atol=1e-5, rtol=2 ** -7)}


def _bn_pair(rng, c):
    """A port MaskedBatchNorm and JAX's variables with the same random
    statistics and parameters."""
    v = {'mean': 0.3 * rng.randn(c), 'var': rng.uniform(0.5, 1.5, c),
         'scale': 1 + 0.2 * rng.randn(c), 'bias': 0.2 * rng.randn(c)}
    v = {k: x.astype(np.float32) for k, x in v.items()}
    bn = MaskedBatchNorm(c)
    with torch.no_grad():
        for name, key in (('running_mean', 'mean'), ('running_var', 'var'),
                          ('weight', 'scale'), ('bias', 'bias')):
            getattr(bn, name).copy_(_t(v[key]))
    jvars = {'params': {'scale': v['scale'], 'bias': v['bias']},
             'batch_stats': {'mean': v['mean'], 'var': v['var']}}
    return bn, jvars


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('case', ['subm', 'strided'])
def test_zwin_epi_plain_matches_jax_infer(case, dtype):
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
        f_out, stride = min(8, jsc.out_shape_strided(shape)[2]), 2
    w = jnp.asarray(rng.randn(27, cin, cout), jnp.float32) * 0.1
    lane = rng.rand(*nbr.shape[:2], f_out) > 0.35
    bn, jvars = _bn_pair(rng, cout)
    inv, shift = JMaskedBatchNorm(channels=cout).apply(jvars, None, None)
    with torch.no_grad():
        t_inv, t_shift = bn.scale_shift()
    # rsqrt rounds within an ulp of each other in the two packages
    np.testing.assert_allclose(t_inv.numpy(), np.asarray(inv), rtol=1e-6)
    np.testing.assert_allclose(t_shift.numpy(), np.asarray(shift),
                               rtol=1e-6, atol=1e-7)

    # a window over all input rows: no block overflows it, so every row
    # goes through _epilogue_in_kernel (JAX's overflow patch rounds its sums
    # to the output dtype before the affine)
    n_win = zv.feats.shape[1] // 8
    assert not np.asarray(_prepare(nbr, zv.feats.shape[1], 8, n_win)[2]).any()
    jdt = getattr(jnp, dtype)
    feats = zv.feats.astype(jdt)
    want = np.asarray(zwin_conv_infer(
        feats, mask, nbr, w, 8, f_out, stride, block_v=8, n_win=n_win,
        affine=(jnp.tile(inv, f_out), jnp.tile(shift, f_out)), act=True,
        lane_exp=jzf.expand_lane_mask(jnp.asarray(lane), cout, jdt)
    ).astype(jnp.float32))
    got = tzw.zwin_conv_epi(
        _t(feats.astype(jnp.float32)).to(getattr(torch, dtype)), _t(mask),
        _t(nbr), _t(w), 8, f_out, stride, t_inv.repeat(f_out),
        t_shift.repeat(f_out), _t(lane))
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == want.shape
    assert (want > 0).mean() > 0.05 and (want == 0).mean() > 0.3
    np.testing.assert_allclose(got.float().numpy(), want, **EPI_TOL[dtype])


def _encoder_pair(dense_from):
    """The tiny zwin encoder with zwin_fuse=True in both packages, on the
    same random weights, and the port's unfused encoder on them."""
    lidar = dict(backend='zfold', zconv='zwin', zwin_block=16, zwin_nwin=4,
                 dense_from=dense_from, zwin_fuse=True)
    jc = jcfg.tiny_model_config()
    jlc = dataclasses.replace(jc.lidar, **lidar)
    tc = tcfg.tiny_model_config(
        lidar=dataclasses.replace(tcfg.tiny_model_config().lidar, **lidar))
    jbatch = j_synthetic_batch(jc, 1, 0)
    pts, pmask = _snap(jbatch.points), np.asarray(jbatch.points_mask)
    jenc = JSparseEncoder(jlc, jc.grid)
    args = (jnp.asarray(pts), jnp.asarray(pmask))
    variables = random_variables(
        lambda: jenc.init(jax.random.PRNGKey(0), *args), seed=6)
    want = np.asarray(jax.jit(jenc.apply)(variables, *args))
    sd = state_dict_from_flax({'lidar_encoder': variables['params']},
                              {'lidar_encoder': variables['batch_stats']}, tc)
    sd = {k.split('.', 1)[1]: v for k, v in sd.items()}
    encs = []
    for fuse in (True, False):
        enc = SparseEncoder(
            dataclasses.replace(tc.lidar, zwin_fuse=fuse), tc.grid,
            device='cpu')
        enc.load_state_dict(sd, strict=True)
        encs.append(enc)
    return want, encs, torch.from_numpy(pts), torch.from_numpy(pmask)


@pytest.mark.parametrize('dense_from', [3, 4])
def test_fused_encoder_matches_jax(dense_from):
    want, (fused, unfused), pts, pmask = _encoder_pair(dense_from)
    assert all(c.fuse for c in fused.modules() if hasattr(c, 'fuse'))
    calls = []
    real = tzw.zwin_conv_epi_plain

    def count(*args):
        calls.append(args[0].shape)
        return real(*args)
    tzw.zwin_conv_epi_plain = count
    try:
        with torch.inference_mode():
            got = fused(pts, pmask)
    finally:
        tzw.zwin_conv_epi_plain = real
    with torch.inference_mode():
        plain = unfused(pts, pmask)
    assert len(calls) == 9           # every sparse-stage conv went fused
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got.numpy(), want, **ENC_TOL)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **ENC_TOL)


def test_zwin_epi_cuda_refuses_cpu_tensors():
    f = torch.zeros(1, 4, 8 * 2)
    args = (f, torch.ones(1, 4, dtype=torch.bool),
            torch.zeros(1, 4, 27, dtype=torch.int32), torch.zeros(27, 2, 3),
            8, 8, 1, torch.ones(24), torch.zeros(24),
            torch.ones(1, 4, 8, dtype=torch.bool))
    with pytest.raises(ValueError, match='CUDA'):
        tzw.zwin_conv_epi_cuda(*args)
    assert torch.equal(tzw.zwin_conv_epi(*args),
                       tzw.zwin_conv_epi_plain(*args))
