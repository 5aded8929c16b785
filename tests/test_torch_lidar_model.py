"""The port's LiDAR encoder and multi-modal model against the JAX package.

Both sides carry the same random weights: a flax tree drawn with numpy from
a seed (``test_torch_slice.random_variables``), run by JAX and carried into
the port by ``weights.state_dict_from_flax`` (a strict ``load_state_dict``).
Both see the same synthetic batch with its points snapped to multiples of
2^-8, so JAX's prefix-sum voxel means are exact (``_snap``).  On the CPU
the port's kernels run as their plain versions.

- tiny, ``backend='zfold'``, ``zconv='zwin'``: JAX runs its Pallas zwin
  kernel in interpret mode with ``zwin_block=16, zwin_nwin=4`` (as
  tests/test_zwin.py does); the cloud overflows the voxel capacity, so the
  capacity cuts are exercised;
- midsize, its preset ``zband``.

Tolerances (fp32, sums in another order): the encoder output (B, Z, Y, X, C)
within 1e-4; occupancy and segmentation logits within 1e-4 and the depth
softmax within 1e-5, absolute and relative; at least 99.9% of voxels take
the same class in ``predict`` with cached pooling indices.  A port
``state_dict`` with the LiDAR encoder goes back through
``import_state_dict`` to the same flax tree with empty reports.

The encoder alone in its other supported settings, zband at tiny: every
stage sparse (``dense_from=4``) and the (B, X, Y, Z, C) dense tail
(``dense_mode='xla3d'``), within 1e-4.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from fusionocc_tpu import config as jcfg
from fusionocc_tpu.data.synthetic import synthetic_batch as j_synthetic_batch
from fusionocc_tpu.models.fusion_occ import FusionOcc as JFusionOcc
from fusionocc_tpu.models.lidar_encoder import SparseEncoder as JSparseEncoder
from fusionocc_tpu.train import torch_import as ti
from fusionocc_tpu_torch import config as tcfg
from fusionocc_tpu_torch.data.synthetic import synthetic_batch
from fusionocc_tpu_torch.models.fusion_occ import (FusionOcc,
                                                   batch_pooling_indices)
from fusionocc_tpu_torch.models.lidar_encoder import SparseEncoder
from fusionocc_tpu_torch.weights import flatten_tree, state_dict_from_flax

from test_torch_slice import _init_fn, random_variables
from torch_threads import one_torch_thread  # noqa: E402,F401

ENC_TOL = dict(rtol=1e-4, atol=1e-4)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
DEPTH_TOL = dict(rtol=1e-5, atol=1e-5)
LIDAR = {'tiny': dict(backend='zfold', zconv='zwin', zwin_block=16,
                      zwin_nwin=4),
         'midsize': {}}


def _config(pkg, preset):
    cfg = getattr(pkg, f'{preset}_model_config')(use_lidar=True)
    return dataclasses.replace(
        cfg, lidar=dataclasses.replace(cfg.lidar, **LIDAR[preset]))


def _snap(points):
    return np.round(np.asarray(points) * 256.0) / 256.0


@pytest.fixture(scope='module', params=['tiny', 'midsize'])
def lidar_pair(request):
    jc, tc = _config(jcfg, request.param), _config(tcfg, request.param)
    jbatch = j_synthetic_batch(jc, 1, 0)
    jbatch = jbatch._replace(points=jax.numpy.asarray(_snap(jbatch.points)))
    jmodel = JFusionOcc(jc)
    variables = random_variables(_init_fn(jmodel, jbatch), seed=3)

    def run(v, b):
        return jmodel.apply(
            v, b, train=False, capture_intermediates=lambda mdl, _:
            isinstance(mdl, JSparseEncoder))
    jout, inter = jax.jit(run)(variables, jbatch)
    jout = {k: np.asarray(v) for k, v in jout.items()}
    jlidar = np.asarray(inter['intermediates']['lidar_encoder']['__call__'][0])

    model = FusionOcc(tc, device='cpu')
    model.load_state_dict(state_dict_from_flax(
        variables['params'], variables['batch_stats'], tc), strict=True)
    batch = synthetic_batch(tc, 1, 0, device='cpu')
    batch = batch._replace(points=torch.from_numpy(_snap(batch.points)))
    with torch.inference_mode():
        tout = model(batch)
        tlidar = model.lidar_encoder(batch.points, batch.points_mask)
    return jc, tc, variables, jout, jlidar, model, batch, tout, tlidar


def test_lidar_encoder_matches_jax(lidar_pair):
    jc, *_, jlidar, _, _, _, tlidar = lidar_pair
    gx, gy, gz = jc.grid.grid_size
    assert jlidar.shape == (1, gz, gy, gx, jc.lidar.output_channels)
    assert tuple(tlidar.shape) == jlidar.shape
    assert np.abs(jlidar).max() > 0       # the LiDAR feature is not empty
    np.testing.assert_allclose(tlidar.numpy(), jlidar, **ENC_TOL)


def test_lidar_model_outputs_match_jax(lidar_pair):
    *_, jout, _, _, _, tout, _ = lidar_pair
    for key in ('occ_logits', 'depth', 'seg_logits'):
        assert tout[key].shape == jout[key].shape, key
    np.testing.assert_allclose(tout['occ_logits'].numpy(), jout['occ_logits'],
                               **LOGIT_TOL)
    np.testing.assert_allclose(tout['seg_logits'].numpy(), jout['seg_logits'],
                               **LOGIT_TOL)
    np.testing.assert_allclose(tout['depth'].numpy(), jout['depth'],
                               **DEPTH_TOL)


def test_lidar_predict_matches_jax(lidar_pair):
    _, tc, _, jout, _, model, batch, _, _ = lidar_pair
    pred = model.predict(batch, batch_pooling_indices(tc, batch))
    gx, gy, gz = tc.grid.grid_size
    assert pred.shape == (1, gx, gy, gz) and pred.dtype == torch.uint8
    agree = np.mean(pred.numpy() == jout['occ_logits'].argmax(-1))
    assert agree >= 0.999, agree


def test_lidar_state_dict_round_trips_through_importer(lidar_pair):
    jc, _, variables, _, _, model, *_ = lidar_pair
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    assert 'lidar_encoder.encoder_layers.encoder_layer1.2.0.weight' in sd
    zeros = jax.tree.map(np.zeros_like, variables)
    params, stats, report = ti.import_state_dict(
        sd, zeros['params'], zeros['batch_stats'], jc, strict=True)
    for kind in ('missing_rule', 'missing_torch', 'shape_mismatch',
                 'unused_torch'):
        assert report[kind] == [], (kind, report[kind][:5])
    for got, want in ((params, variables['params']),
                      (stats, variables['batch_stats'])):
        got, want = flatten_tree(got), flatten_tree(want)
        assert got.keys() == want.keys()
        for path in want:
            np.testing.assert_array_equal(np.asarray(got[path]), want[path],
                                          err_msg=path)


@pytest.mark.parametrize('overrides', [dict(dense_from=4),
                                       dict(dense_mode='xla3d')])
def test_encoder_variants_match_jax(overrides):
    """The encoder's other supported settings, zband at tiny: every stage
    sparse (``dense_from=4``, conv_out per lane, then densify) and the
    (B, X, Y, Z, C) dense tail (``dense_mode='xla3d'``), within 1e-4 of JAX
    on the same weights."""
    lidar = dict(backend='zfold', zconv='zband', **overrides)
    jc = jcfg.tiny_model_config()
    jlc = dataclasses.replace(jc.lidar, **lidar)
    tc = tcfg.tiny_model_config(
        lidar=dataclasses.replace(tcfg.tiny_model_config().lidar, **lidar))
    jbatch = j_synthetic_batch(jc, 1, 0)
    pts, pmask = _snap(jbatch.points), np.asarray(jbatch.points_mask)
    jenc = JSparseEncoder(jlc, jc.grid)
    args = (jax.numpy.asarray(pts), jax.numpy.asarray(pmask))
    variables = random_variables(
        lambda: jenc.init(jax.random.PRNGKey(0), *args), seed=4)
    want = np.asarray(jax.jit(jenc.apply)(variables, *args))
    sd = state_dict_from_flax({'lidar_encoder': variables['params']},
                              {'lidar_encoder': variables['batch_stats']}, tc)
    enc = SparseEncoder(tc.lidar, tc.grid, device='cpu')
    enc.load_state_dict({k.split('.', 1)[1]: v for k, v in sd.items()},
                        strict=True)
    with torch.inference_mode():
        got = enc(torch.from_numpy(pts), torch.from_numpy(pmask))
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
