"""The port's image-only slice against ``fusionocc_tpu.FusionOcc``.

Both models carry the same random weights: a flax tree is drawn with numpy
from a seed, run by JAX, and carried into the port by
``weights.state_dict_from_flax`` (a strict ``load_state_dict``).  Both see
the same synthetic batch.  On the CPU the port's kernels run as their plain
versions.

Tolerances (fp32): the two frameworks order their sums differently, so
occupancy and segmentation logits agree to 1e-4 (absolute and relative) and
the depth softmax to 1e-5; at least 99.9% of voxels take the same class.

The rule table of ``weights.py`` is held against the JAX importer's
``build_rules`` for every slice leaf, and a port ``state_dict`` goes back
through ``import_state_dict`` to the same flax tree.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from fusionocc_tpu import config as jcfg
from fusionocc_tpu.data.synthetic import synthetic_batch as j_synthetic_batch
from fusionocc_tpu.models.fusion_occ import FusionOcc as JFusionOcc
from fusionocc_tpu.train import torch_import as ti
from fusionocc_tpu_torch import config as tcfg
from fusionocc_tpu_torch.data.synthetic import synthetic_batch
from fusionocc_tpu_torch.models.fusion_occ import (FusionOcc,
                                                   batch_pooling_indices)
from fusionocc_tpu_torch.weights import (flatten_tree, slice_rules,
                                         state_dict_from_flax)
from torch_threads import one_torch_thread  # noqa: E402,F401

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
DEPTH_TOL = dict(rtol=1e-5, atol=1e-5)


def unflatten_tree(flat):
    tree = {}
    for path, leaf in flat.items():
        node = tree
        *parents, last = path.split('/')
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return tree


def random_variables(init_fn, seed):
    """A flax variable tree of init_fn's structure, drawn with numpy:
    kernels N(0, 1/fan_in), biases and tables N(0, 0.1^2), norm scales near
    1, BatchNorm statistics away from the identity."""
    shapes = flatten_tree(jax.eval_shape(init_fn))
    rng = np.random.RandomState(seed)
    flat = {}
    for path, s in sorted(shapes.items()):
        name, shape = path.split('/')[-1], s.shape
        if name == 'var':
            v = rng.uniform(0.5, 1.5, shape)
        elif name == 'scale':
            v = 1.0 + 0.1 * rng.randn(*shape)
        elif name == 'kernel':
            v = rng.randn(*shape) * np.prod(shape[:-1]) ** -0.5
        else:   # bias, mean, relative_position_bias_table
            v = 0.1 * rng.randn(*shape)
        flat[path] = v.astype(np.float32)
    return unflatten_tree(flat)


def _init_fn(model, batch):
    return lambda: model.init({'params': jax.random.PRNGKey(0),
                               'dropout': jax.random.PRNGKey(1)},
                              batch, train=False)


@pytest.fixture(scope='module', params=['tiny', 'midsize'])
def slice_pair(request):
    jc = getattr(jcfg, f'{request.param}_model_config')(use_lidar=False)
    tc = getattr(tcfg, f'{request.param}_model_config')(use_lidar=False)
    jbatch = j_synthetic_batch(jc, 1, 0, num_points=96)
    jmodel = JFusionOcc(jc)
    variables = random_variables(_init_fn(jmodel, jbatch), seed=3)
    jout = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(
        variables, jbatch)
    jout = {k: np.asarray(v) for k, v in jout.items()}

    model = FusionOcc(tc, device='cpu')
    model.load_state_dict(state_dict_from_flax(
        variables['params'], variables['batch_stats'], tc), strict=True)
    batch = synthetic_batch(tc, 1, 0, num_points=96, device='cpu')
    with torch.inference_mode():
        tout = model(batch)
    return jc, tc, variables, jout, model, batch, tout


def test_slice_outputs_match_jax(slice_pair):
    *_, jout, model, batch, tout = slice_pair
    for key in ('occ_logits', 'depth', 'seg_logits'):
        assert tout[key].shape == jout[key].shape, key
        assert tout[key].dtype == torch.float32, key
    np.testing.assert_allclose(tout['occ_logits'].numpy(), jout['occ_logits'],
                               **LOGIT_TOL)
    np.testing.assert_allclose(tout['seg_logits'].numpy(), jout['seg_logits'],
                               **LOGIT_TOL)
    np.testing.assert_allclose(tout['depth'].numpy(), jout['depth'],
                               **DEPTH_TOL)


def test_slice_predict_matches_jax(slice_pair):
    """predict with cached per-frame pooling indices: >= 99.9% of voxels
    take JAX's class."""
    jc, tc, _, jout, model, batch, _ = slice_pair
    pred = model.predict(batch, batch_pooling_indices(tc, batch))
    gx, gy, gz = tc.grid.grid_size
    assert pred.shape == (1, gx, gy, gz) and pred.dtype == torch.uint8
    agree = np.mean(pred.numpy() == jout['occ_logits'].argmax(-1))
    assert agree >= 0.999, agree


def test_state_dict_round_trips_through_importer(slice_pair):
    jc, _, variables, _, model, _, _ = slice_pair
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
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


# flax leaf shape per converter of weights.py
CONV_SHAPES = {'conv2d': (2, 3, 4, 5), 'conv3d': (2, 3, 4, 5, 6),
               'linear': (2, 3), 'spconv3': (27, 3, 4), 'spconv1': (3, 4)}


@pytest.mark.parametrize('preset', ['full', 'tiny', 'midsize'])
def test_rule_table_agrees_with_build_rules(preset):
    """Same flax leaves (the LiDAR encoder's included), same torch keys,
    and the two converters are inverses."""
    jrules = ti.build_rules(getattr(jcfg, f'{preset}_model_config')())
    trules = slice_rules(getattr(tcfg, f'{preset}_model_config')())
    rng = np.random.RandomState(0)
    for kind in ('params', 'batch_stats'):
        assert set(trules[kind]) == set(jrules[kind]), kind
        assert any(p.startswith('lidar_encoder/') for p in trules[kind])
        for path, (tkey, tconv) in trules[kind].items():
            jkey, jconv = jrules[kind][path]
            assert tkey == jkey, path
            shape = CONV_SHAPES.get(tconv.__name__, (2,))
            x = rng.randn(*shape).astype(np.float32)
            np.testing.assert_array_equal(jconv(tconv(x)), x, err_msg=path)


def test_full_size_state_dict_matches_port_module_tree():
    """At full size (the default config: Swin-B 2/2/18/2, the LiDAR encoder,
    production widths) the keys and shapes the converter produces are
    exactly the port model's ``state_dict``."""
    jc = jcfg.full_model_config()
    tc = tcfg.full_model_config()
    # parameter shapes do not depend on the image size: trace a small one
    small = dataclasses.replace(jc, input_size=(64, 128))
    jbatch = j_synthetic_batch(small, 1, 0, num_points=64)
    shapes = jax.eval_shape(_init_fn(JFusionOcc(small), jbatch))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = state_dict_from_flax(zeros['params'], zeros['batch_stats'], tc)
    model = FusionOcc(tc, device='meta')
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    assert 'img_backbone.stages.2.blocks.17.attn.w_msa.qkv.weight' in want
    assert want['lidar_encoder.encoder_layers.encoder_layer3.2.0.weight'] \
        == (64, 3, 3, 3, 48)
    assert len(flatten_tree(zeros['params'])) > 500


def test_bf16_precision_placement_matches_jax():
    """In bf16 both packages keep parameters in fp32, compute convs and
    matmuls in bf16 and softmax, norms and pooling in fp32: same output
    dtypes (logits and depth fp32, seg logits bf16).  Values agree only
    loosely, as bf16 rounds at other places in the two frameworks."""
    jc = jcfg.tiny_model_config(use_lidar=False, compute_dtype='bfloat16')
    tc = tcfg.tiny_model_config(use_lidar=False, compute_dtype='bfloat16')
    jbatch = j_synthetic_batch(jc, 1, 0, num_points=96)
    jmodel = JFusionOcc(jc)
    variables = random_variables(_init_fn(jmodel, jbatch), seed=3)
    jout = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(
        variables, jbatch)
    model = FusionOcc(tc, device='cpu')
    model.load_state_dict(state_dict_from_flax(
        variables['params'], variables['batch_stats'], tc), strict=True)
    with torch.inference_mode():
        tout = model(synthetic_batch(tc, 1, 0, num_points=96, device='cpu'))
    for key, tol in (('occ_logits', 5e-2), ('depth', 5e-3),
                     ('seg_logits', 1e-1)):
        assert str(tout[key].dtype).split('.')[-1] == str(jout[key].dtype)
        np.testing.assert_allclose(tout[key].float().numpy(),
                                   np.asarray(jout[key], np.float32),
                                   atol=tol, rtol=tol, err_msg=key)
    agree = np.mean(tout['occ_logits'].numpy().argmax(-1)
                    == np.asarray(jout['occ_logits']).argmax(-1))
    assert agree >= 0.99, agree
