"""The port's int8 quantization (``fusionocc_tpu_torch.quant``) against
``fusionocc_tpu.quant`` on the same seeded numpy inputs.

- The weight-only state dict: JAX's ``quantize_tree`` of a flax tree, then
  ``weights`` maps it, equals the port's ``quantize_state_dict`` of the
  mapped tree bit for bit (int8 payloads and fp32 scales), whole or with
  ``include=('img_backbone',)``, and ``quantized_size_bytes`` agrees
  with JAX's accounting (``size_bytes``: JAX's own function misaligns its
  two trees, a defect the port does not mirror).
- ``int8_linear`` against ``int8_dot_general`` (a flax ``Dense`` product)
  and ``int8_dot`` against ``int8_dot``, in fp32 and bf16: the int32
  accumulators are equal and the outputs within one ulp of the output
  dtype.
- The tiny multi-modal model (z-folded LiDAR path, fp32): the
  ``int8_dense`` forward and the ``--int8-weights`` forward against JAX's
  on the same weights and batch.  Logits agree to 1.5e-5 of their largest
  magnitude and at least 99.9 % of voxels take JAX's class: an fp32
  difference upstream of a quantizer can move one activation by one
  quantization step (measured: 8.5e-6 of it with ``int8_dense``, 4.8e-7
  with int8 weights).  The quantization must show: the port's quantized
  logits are at most half as far from JAX's as from its own fp32 ones
  (``int8_dense`` moves the tiny model's logits by 2.7e-5 of their
  magnitude, int8 weights by 9.3e-3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusionocc_tpu import config as jcfg
from fusionocc_tpu import quant as jquant
from fusionocc_tpu.data.synthetic import synthetic_batch as j_synthetic_batch
from fusionocc_tpu.models.fusion_occ import FusionOcc as JFusionOcc
from fusionocc_tpu_torch import config as tcfg
from fusionocc_tpu_torch import quant
from fusionocc_tpu_torch.data.synthetic import synthetic_batch
from fusionocc_tpu_torch.models.fusion_occ import FusionOcc
from fusionocc_tpu_torch.weights import (flatten_tree, slice_rules,
                                         state_dict_from_flax)

from test_torch_slice import _init_fn, random_variables
from torch_threads import one_torch_thread  # noqa: E402,F401

LIDAR = dict(backend='zfold', zconv='zband')


def _config(pkg, preset, **kw):
    cfg = getattr(pkg, f'{preset}_model_config')(use_lidar=True, **kw)
    return dataclasses.replace(cfg,
                               lidar=dataclasses.replace(cfg.lidar, **LIDAR))


def _variables(preset, seed=3):
    """A numpy-drawn flax tree of the preset's shapes (no JAX compile)."""
    jc = _config(jcfg, preset)
    jbatch = j_synthetic_batch(jc, 1, 0, num_points=96)
    return random_variables(_init_fn(JFusionOcc(jc), jbatch), seed=seed)


@pytest.mark.parametrize('preset,include', [
    ('tiny', ()), ('tiny', ('img_backbone',)), ('midsize', ()),
    ('midsize', ('bev_backbone', 'lidar_encoder'))])
def test_quantized_state_dict_equals_quantize_tree(preset, include):
    tc = _config(tcfg, preset)
    v = _variables(preset)
    params = v['params']
    jq, jmeta = jquant.quantize_tree(params, include=include)
    jflat_q, jflat_s = flatten_tree(jq), flatten_tree(jmeta)
    # the int8 tree mapped by weights: payloads stay int8 (exact in fp32)
    want_q = state_dict_from_flax(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jq),
        v['batch_stats'], tc)
    sd = state_dict_from_flax(params, v['batch_stats'], tc)
    qsd, scales = quant.quantize_state_dict(sd, tc, include=include)
    rules = slice_rules(tc)['params']
    n_int8 = 0
    for fpath, leaf in jflat_q.items():
        tkey, conv = rules[fpath]
        if np.asarray(leaf).dtype == np.int8:
            n_int8 += 1
            assert qsd[tkey].dtype == torch.int8, fpath
            np.testing.assert_array_equal(
                qsd[tkey].numpy(), conv(np.asarray(leaf)), err_msg=fpath)
            s = np.asarray(jflat_s[fpath]).reshape(-1)
            np.testing.assert_array_equal(
                scales[tkey].reshape(-1).numpy(), s, err_msg=fpath)
        else:
            assert tkey not in scales, fpath
            np.testing.assert_array_equal(qsd[tkey].numpy(),
                                          want_q[tkey].numpy(), err_msg=fpath)
    assert n_int8 == len(scales) > 0
    if include:
        assert all(any(k.startswith(p) for p in
                       ('img_backbone', 'img_bev_encoder_backbone',
                        'lidar_encoder')) for k in scales)
    assert quant.quantized_size_bytes(qsd, scales, tc) == \
        size_bytes(jq, jmeta)
    # dequantized into the compute dtype, as JAX's dequantize_tree
    jdeq = flatten_tree(jquant.dequantize_tree(jq, jmeta,
                                               dtype=jnp.bfloat16))
    deq = quant.dequantize_state_dict(qsd, scales, torch.bfloat16)
    for fpath, leaf in jdeq.items():
        tkey, conv = rules[fpath]
        if tkey in scales:
            np.testing.assert_array_equal(
                deq[tkey].float().numpy(),
                conv(np.asarray(leaf, np.float32)), err_msg=fpath)


def size_bytes(jq, jmeta):
    """JAX's ``quantized_size_bytes`` accounting over ``quantize_tree``'s
    output, each leaf paired with its own scale.  (JAX's function zips the
    flattened trees, and its meta tree's ``()`` leaves of unquantized
    tensors flatten to nothing, so it pairs leaves with other leaves'
    scales and stops early: on the tiny model it counts 3,692,572 fp32
    bytes of 5,391,692.)"""
    q_bytes = fp_bytes = 0
    flat_s = flatten_tree(jmeta)
    for path, leaf in flatten_tree(jq).items():
        n = int(np.prod(np.shape(leaf)))
        fp_bytes += n * 4
        if np.asarray(leaf).dtype == np.int8:
            q_bytes += n + int(np.prod(np.shape(flat_s[path]))) * 4
        else:
            q_bytes += n * 4
    return {'quantized_bytes': q_bytes, 'fp32_bytes': fp_bytes,
            'ratio': round(fp_bytes / max(q_bytes, 1), 2)}


def _ulp(a: np.ndarray, dtype) -> np.ndarray:
    """One unit in the last place of ``dtype`` at |a|."""
    mant = {np.float32: 23, 'bfloat16': 7}[dtype]
    e = np.floor(np.log2(np.maximum(np.abs(a), 1e-30)))
    return 2.0 ** (e - mant)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('shape', [(3, 40, 64, 48), (130, 128, 384)])
def test_int8_linear_matches_int8_dot_general(dtype, shape):
    rng = np.random.RandomState(7)
    *lead, K, N = shape
    x = rng.randn(*lead, K).astype(np.float32) * 3.0
    w = (rng.randn(K, N) * K ** -0.5).astype(np.float32)
    jd = getattr(jnp, dtype)
    td = getattr(torch, dtype)
    dn = (((len(lead),), (0,)), ((), ()))
    want = jquant.int8_dot_general(jnp.asarray(x, jd), jnp.asarray(w, jd), dn)
    # the accumulators: JAX's quantizers on the same operands
    xf = jnp.asarray(x, jd).astype(jnp.float32)
    xs = jnp.maximum(jnp.max(jnp.abs(xf)), 1e-12) / 127.0
    xq = jnp.clip(jnp.round(xf / xs), -127, 127).astype(jnp.int8)
    wf = jnp.asarray(w, jd).astype(jnp.float32)
    ws = jnp.maximum(jnp.max(jnp.abs(wf), axis=0), 1e-12) / 127.0
    wq = jnp.clip(jnp.round(wf / ws), -127, 127).astype(jnp.int8)
    acc = np.asarray(jax.lax.dot_general(xq, wq, dn,
                                         preferred_element_type=jnp.int32))

    tx = torch.from_numpy(x).to(td)
    tw = torch.from_numpy(w.T.copy()).to(td)     # (N, K), torch's layout
    got = quant.int8_linear(tx, tw)
    assert got.dtype == td and tuple(got.shape) == want.shape
    txq, txs = quant._quantize_activation(tx.float(), -127)
    np.testing.assert_array_equal(txq.numpy(), np.asarray(xq))
    twf = tw.float()
    tws = torch.clamp_min(twf.abs().amax(dim=1), 1e-12) / 127.0
    twq = torch.clamp(torch.round(twf / tws[:, None]), -127, 127
                      ).to(torch.int8)
    np.testing.assert_array_equal(twq.numpy().T, np.asarray(wq))
    tacc = quant.int8_mm(txq.reshape(-1, K), twq.t())
    np.testing.assert_array_equal(tacc.numpy().reshape(acc.shape), acc)
    want_f = np.asarray(want.astype(jnp.float32))
    got_f = got.float().numpy()
    assert np.all(np.abs(got_f - want_f)
                  <= _ulp(want_f, np.float32 if dtype == 'float32'
                          else 'bfloat16'))


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('static_scale', [False, True])
def test_int8_dot_matches_jax(dtype, static_scale):
    rng = np.random.RandomState(1)
    x = rng.randn(5, 7, 64).astype(np.float32)
    w = rng.randn(64, 32).astype(np.float32)
    q, meta = jquant.quantize_tree({'kernel': w})
    wq, ws = np.asarray(q['kernel']), np.asarray(meta['kernel'])
    xs = 0.02 if static_scale else None
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jquant.int8_dot(jnp.asarray(x, jd), jnp.asarray(wq),
                                      jnp.asarray(ws), x_scale=xs))
    got = quant.int8_dot(torch.from_numpy(x).to(td), torch.from_numpy(wq),
                         torch.from_numpy(ws), x_scale=xs)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert np.all(np.abs(got.numpy() - want) <= _ulp(want, np.float32))


def test_int8_mm_plain_is_exact_at_the_extremes():
    a = torch.full((3, 4096), -128, dtype=torch.int8)
    b = torch.full((4096, 8), -128, dtype=torch.int8)
    assert int(quant.int8_mm(a, b)[0, 0]) == 4096 * 128 * 128
    rng = np.random.RandomState(0)
    a = rng.randint(-128, 128, (17, 96)).astype(np.int8)
    b = rng.randint(-128, 128, (96, 40)).astype(np.int8)
    want = a.astype(np.int64) @ b.astype(np.int64)
    np.testing.assert_array_equal(
        quant.int8_mm(torch.from_numpy(a), torch.from_numpy(b)).numpy(), want)


def test_calibrate_activation_scale():
    acts = [np.array([0.5, -2.0]), torch.tensor([[1.0, -3.5]])]
    assert quant.calibrate_activation_scale(acts) == \
        jquant.calibrate_activation_scale([np.array([0.5, -2.0]),
                                           np.array([[1.0, -3.5]])])


@pytest.fixture(scope='module')
def int8_pair():
    """JAX's tiny multi-modal forward with and without ``int8_dense`` and
    with weight-only int8, and the port's on the same weights and batch."""
    jc = _config(jcfg, 'tiny')
    tc = _config(tcfg, 'tiny')
    jbatch = j_synthetic_batch(jc, 1, 0, num_points=512)
    jmodel = JFusionOcc(jc)
    variables = random_variables(_init_fn(jmodel, jbatch), seed=3)
    jmodel_q = JFusionOcc(dataclasses.replace(
        jc, swin=dataclasses.replace(jc.swin, int8_dense=True)))
    fwd = jax.jit(lambda v, b: jmodel.apply(v, b, train=False)['occ_logits'])
    fwd_q = jax.jit(lambda v, b: jmodel_q.apply(v, b, train=False)[
        'occ_logits'])
    q, meta = jquant.quantize_tree(variables['params'])
    v_w8 = dict(variables, params=jquant.dequantize_tree(q, meta,
                                                         dtype=jc.dtype))
    jout = {'fp32': np.asarray(fwd(variables, jbatch)),
            'int8': np.asarray(fwd_q(variables, jbatch)),
            'int8_weights': np.asarray(fwd(v_w8, jbatch))}

    sd = state_dict_from_flax(variables['params'], variables['batch_stats'],
                              tc)
    batch = synthetic_batch(tc, 1, 0, num_points=512, device='cpu')
    tout = {}
    for mode in ('fp32', 'int8', 'int8_weights'):
        cfg = tc
        if mode == 'int8':
            cfg = dataclasses.replace(tc, swin=dataclasses.replace(
                tc.swin, int8_dense=True))
        model = FusionOcc(cfg, device='cpu')
        model.load_state_dict(sd, strict=True)
        if mode == 'int8_weights':
            sizes = quant.load_int8_weights(model, cfg)
            assert sizes == size_bytes(q, meta)
        with torch.inference_mode():
            tout[mode] = model(batch)['occ_logits'].numpy()
    return jout, tout


@pytest.mark.parametrize('mode', ['int8', 'int8_weights'])
def test_int8_forward_matches_jax(int8_pair, mode):
    jout, tout = int8_pair
    scale = np.abs(jout[mode]).max()
    np.testing.assert_allclose(tout[mode], jout[mode], rtol=0,
                               atol=1.5e-5 * scale)
    agree = np.mean(tout[mode].argmax(-1) == jout[mode].argmax(-1))
    assert agree >= 0.999, agree
    # the port is nearer JAX's quantized logits than its own fp32 ones
    assert (np.abs(tout[mode] - jout[mode]).max()
            < 0.5 * np.abs(tout[mode] - tout['fp32']).max())
    np.testing.assert_allclose(tout['fp32'], jout['fp32'], rtol=1e-4,
                               atol=1e-4)
