"""Torch importer: rule coverage + converter round-trips.

Builds a synthetic torch state_dict by inverting the rule table, imports it,
and asserts (a) every flax leaf has a rule, (b) every synthetic torch key is
consumed, (c) values land where expected after layout conversion.
"""
import jax
import numpy as np
import pytest

from fusionocc_tpu.config import tiny_model_config
from fusionocc_tpu.data.synthetic import synthetic_batch
from fusionocc_tpu.models.fusion_occ import FusionOcc
from fusionocc_tpu.train import torch_import as ti
from torch_threads import one_torch_thread  # noqa: E402,F401


@pytest.fixture(scope='module')
def trees():
    cfg = tiny_model_config()
    model = FusionOcc(cfg)
    batch = synthetic_batch(cfg, 1, 0, num_points=256)
    v = jax.jit(lambda b: model.init(
        {'params': jax.random.PRNGKey(0), 'dropout': jax.random.PRNGKey(1)},
        b, train=False))(batch)
    return cfg, v['params'], v['batch_stats']


def _inverse_shape(conv, flax_shape):
    if conv is ti.conv2d:
        kh, kw, i, o = flax_shape
        return (o, i, kh, kw)
    if conv is ti.conv3d:
        kd, kh, kw, i, o = flax_shape
        return (o, i, kd, kh, kw)
    if conv is ti.linear:
        i, o = flax_shape
        return (o, i)
    if conv is ti.spconv:
        if len(flax_shape) == 3:
            _, i, o = flax_shape
            return (o, 3, 3, 3, i)
        i, o = flax_shape
        return (o, 1, 1, 1, i)
    return tuple(flax_shape)


def test_full_coverage_and_round_trip(trees):
    cfg, params, batch_stats = trees
    rules = ti.build_rules(cfg)
    rng = np.random.RandomState(0)

    sd = {}
    for kind, tree in (('params', params), ('batch_stats', batch_stats)):
        flat = ti._flatten(tree)
        for path, leaf in flat.items():
            rule = rules[kind].get(path)
            assert rule is not None, f'no import rule for {kind}:{path}'
            tkey, conv = rule
            if tkey not in sd:
                sd[tkey] = rng.randn(
                    *_inverse_shape(conv, tuple(leaf.shape))).astype(
                        np.float32)

    new_params, new_stats, report = ti.import_state_dict(
        sd, params, batch_stats, cfg)
    assert not report['missing_rule'], report['missing_rule'][:5]
    assert not report['missing_torch'], report['missing_torch'][:5]
    assert not report['shape_mismatch'], report['shape_mismatch'][:5]
    assert not report['unused_torch'], report['unused_torch'][:5]

    # spot-check conversions
    w = sd['final_conv.conv.weight']
    got = ti._flatten(new_params)['final_conv/kernel']
    np.testing.assert_allclose(np.asarray(got),
                               np.transpose(w, (2, 3, 4, 1, 0)))
    q = sd['img_backbone.stages.0.blocks.0.attn.w_msa.qkv.weight']
    got_q = ti._flatten(new_params)['img_backbone/stage0_block0/attn/qkv/kernel']
    np.testing.assert_allclose(np.asarray(got_q), q.T)
    sp = sd['lidar_encoder.encoder_layers.encoder_layer1.0.0.weight']
    got_sp = ti._flatten(new_params)['lidar_encoder/stage0_subm0/kernel']
    np.testing.assert_allclose(
        np.asarray(got_sp),
        np.transpose(sp.reshape(sp.shape[0], 27, sp.shape[-1]), (1, 2, 0)))


def test_imported_model_still_runs(trees):
    cfg, params, batch_stats = trees
    rules = ti.build_rules(cfg)
    rng = np.random.RandomState(1)
    sd = {}
    for kind, tree in (('params', params), ('batch_stats', batch_stats)):
        for path, leaf in ti._flatten(tree).items():
            tkey, conv = rules[kind][path]
            if tkey not in sd:
                sd[tkey] = (0.05 * rng.randn(
                    *_inverse_shape(conv, tuple(leaf.shape)))).astype(
                        np.float32)
            if 'running_var' in tkey or tkey.endswith('.weight') and \
                    'bn' in tkey.split('.')[-2]:
                sd[tkey] = np.abs(sd[tkey]) + 0.5
    new_params, new_stats, _ = ti.import_state_dict(
        sd, params, batch_stats, cfg, strict=False)
    model = FusionOcc(cfg)
    batch = synthetic_batch(cfg, 1, 0, num_points=256)
    out = jax.jit(lambda p, s, b: model.apply(
        {'params': p, 'batch_stats': s}, b, train=False)['occ_logits'])(
            new_params, new_stats, batch)
    assert np.all(np.isfinite(np.asarray(out)))


def test_official_swin_convert_round_trip():
    """convert_official_swin == the reference's swin_convert
    (backbones/swin.py:32-84): construct an official-format state_dict by
    inverse-transforming an mmcv-format one, convert it, and require exact
    recovery (incl. the nn.Unfold channel-order fix on PatchMerging)."""
    rng = np.random.RandomState(3)
    C, O = 8, 16

    mmcv = {
        'patch_embed.projection.weight': rng.randn(C, 3, 4, 4),
        'patch_embed.projection.bias': rng.randn(C),
        'patch_embed.norm.weight': rng.randn(C),
        'stages.0.blocks.0.norm1.weight': rng.randn(C),
        'stages.0.blocks.0.attn.w_msa.qkv.weight': rng.randn(3 * C, C),
        'stages.0.blocks.0.attn.w_msa.qkv.bias': rng.randn(3 * C),
        'stages.0.blocks.0.attn.w_msa.proj.weight': rng.randn(C, C),
        'stages.0.blocks.0.attn.w_msa.relative_position_bias_table':
            rng.randn(49, 2),
        'stages.0.blocks.0.norm2.weight': rng.randn(C),
        'stages.0.blocks.0.ffn.layers.0.0.weight': rng.randn(4 * C, C),
        'stages.0.blocks.0.ffn.layers.0.0.bias': rng.randn(4 * C),
        'stages.0.blocks.0.ffn.layers.1.weight': rng.randn(C, 4 * C),
        'stages.0.downsample.norm.weight': rng.randn(4 * C),
        'stages.0.downsample.norm.bias': rng.randn(4 * C),
        'stages.0.downsample.reduction.weight': rng.randn(O, 4 * C),
        'norm1.weight': rng.randn(O),
    }
    mmcv = {k: v.astype(np.float32) for k, v in mmcv.items()}

    def inv_reduction(y):
        o, i = y.shape
        return y.reshape(o, i // 4, 4).transpose(0, 2, 1)[
            :, (0, 2, 1, 3)].reshape(o, i)

    def inv_norm(y):
        i = y.shape[0]
        return y.reshape(i // 4, 4).T[(0, 2, 1, 3), :].reshape(i)

    official = {}
    for k, v in mmcv.items():
        if k.startswith('stages'):
            if 'attn.w_msa.' in k:
                k = k.replace('attn.w_msa.', 'attn.')
            elif 'ffn.layers.0.0.' in k:
                k = k.replace('ffn.layers.0.0.', 'mlp.fc1.')
            elif 'ffn.layers.1.' in k:
                k = k.replace('ffn.layers.1.', 'mlp.fc2.')
            elif 'downsample.reduction.' in k:
                v = inv_reduction(v)
            elif 'downsample.norm.' in k:
                v = inv_norm(v)
            k = k.replace('stages', 'layers', 1)
        elif 'projection' in k:
            k = k.replace('projection', 'proj')
        official[k] = v
    official['head.fc.weight'] = rng.randn(10, O).astype(np.float32)

    got = ti.convert_official_swin(official)
    assert 'img_backbone.head.fc.weight' not in got
    assert set(got) == {f'img_backbone.{k}' for k in mmcv}
    for k, v in mmcv.items():
        np.testing.assert_allclose(got[f'img_backbone.{k}'], v, rtol=0,
                                   atol=0, err_msg=k)
