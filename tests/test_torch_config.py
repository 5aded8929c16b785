"""The PyTorch port's configuration mirror, import hygiene and GPU entry.

- Every preset of ``fusionocc_tpu_torch.config`` equals the JAX package's,
  field by field, with the same derived sizes.
- The default multi-modal configuration is supported; configurations that
  select an unported path are refused.
- Entry points that make tensors put them on the card unless asked not to.
- Importing the port pulls in no JAX (the GPU machine has none).
- ``chip_smoke.py`` refuses to run without a CUDA device, without a
  traceback and without printing a result.
"""
import dataclasses
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from fusionocc_tpu import config as jcfg
from fusionocc_tpu.configs import get_config
from fusionocc_tpu_torch import config as tcfg
from torch_threads import ONE_THREAD, one_torch_thread  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize('preset', ['full', 'tiny', 'midsize'])
def test_config_fields_match_jax(preset):
    j = getattr(jcfg, f'{preset}_model_config')()
    t = getattr(tcfg, f'{preset}_model_config')()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for sub in ('grid', 'swin', 'lidar', 'vt'):
        assert ([f.name for f in dataclasses.fields(getattr(t, sub))]
                == [f.name for f in dataclasses.fields(getattr(j, sub))])
    for prop in ('num_frame', 'feat_size', 'fusion_channels', 'occ_channels',
                 'bev_channels'):
        assert getattr(t, prop) == getattr(j, prop), prop
    assert t.grid.grid_size == j.grid.grid_size
    assert t.grid.num_depth_bins == j.grid.num_depth_bins
    assert t.swin.num_features == j.swin.num_features
    assert t.lidar.sparse_shape(t.grid) == j.lidar.sparse_shape(j.grid)
    np.testing.assert_array_equal(np.float32(t.grid.lower_bound),
                                  np.asarray(j.grid.lower_bound))
    np.testing.assert_array_equal(np.float32(t.grid.interval),
                                  np.asarray(j.grid.interval))
    assert str(t.dtype).split('.')[-1] == str(j.dtype)


def test_image_only_preset_matches_named_config():
    assert (dataclasses.asdict(tcfg.image_only_model_config())
            == dataclasses.asdict(get_config('fusion_occ_image_only').model))


@pytest.mark.parametrize('overrides,item', [
    (dict(use_lidar=True,
          lidar=dataclasses.replace(tcfg.SparseEncoderConfig(),
                                    backend='coo')), 'item 5'),
    (dict(use_lidar=False, param_dtype='bfloat16'), 'param_dtype'),
])
def test_unported_paths_are_refused(overrides, item):
    from fusionocc_tpu_torch.models.fusion_occ import FusionOcc
    with pytest.raises(NotImplementedError, match=item):
        FusionOcc(tcfg.full_model_config(**overrides))


def test_int8_dense_builds_at_full_size():
    """int8 serving is ported: the full-size config with
    ``swin.int8_dense`` builds, and exactly the backbone's Linears (qkv,
    proj, the ffn's two, the patch-merge reductions) take int8 products."""
    from fusionocc_tpu_torch.models.fusion_occ import FusionOcc
    from fusionocc_tpu_torch.nn.layers import Linear
    cfg = tcfg.full_model_config(swin=dataclasses.replace(
        tcfg.SwinConfig(), int8_dense=True))
    model = FusionOcc(cfg, device='meta')
    int8 = [n for n, m in model.named_modules()
            if isinstance(m, Linear) and m.int8]
    assert len(int8) == 4 * sum(cfg.swin.depths) + len(cfg.swin.depths) - 1
    assert all(n.startswith('img_backbone.') for n in int8)
    assert not any(m.int8 for n, m in model.named_modules()
                   if isinstance(m, Linear) and not n.startswith('img_'))


@pytest.mark.parametrize('field,value', [
    ('backend', 'coo'), ('backend', 'tile'), ('zconv', 'lifted'),
    ('zconv', 'zslice'), ('dense_from', 2), ('stop_after', 'vox')])
def test_unported_lidar_paths_are_refused(field, value):
    lidar = dataclasses.replace(tcfg.SparseEncoderConfig(), **{field: value})
    with pytest.raises(NotImplementedError, match='not ported'):
        tcfg.check_supported(tcfg.full_model_config(lidar=lidar))


@pytest.mark.parametrize('overrides', [
    {}, dict(zconv='zband'), dict(dense_from=4), dict(dense_mode='xla3d'),
    dict(zwin_fuse=True), dict(zwin_merged=True, zwin_block=16)])
def test_default_lidar_config_is_supported(overrides):
    """Supported settings; ``zwin_fuse`` is honoured (every sparse conv of
    the encoder runs fused or none does), the tiling knobs are ignored."""
    from fusionocc_tpu_torch.models.lidar_encoder import SparseEncoder
    lidar = dataclasses.replace(tcfg.SparseEncoderConfig(), **overrides)
    cfg = tcfg.full_model_config(lidar=lidar)
    assert cfg.use_lidar
    tcfg.check_supported(cfg)
    enc = SparseEncoder(lidar, cfg.grid, device='meta')
    fuse = {c.fuse for c in enc.modules() if hasattr(c, 'fuse')}
    assert fuse == {overrides.get('zwin_fuse', False)}


def test_entry_points_default_to_the_card():
    """Without a card and without device='cpu' the entry points raise;
    nothing falls back to the CPU."""
    import torch
    from fusionocc_tpu_torch.data.synthetic import synthetic_batch
    from fusionocc_tpu_torch.models.fusion_occ import FusionOcc
    from fusionocc_tpu_torch.models.lidar_encoder import SparseEncoder
    cfg = tcfg.tiny_model_config(
        lidar=dataclasses.replace(tcfg.tiny_model_config().lidar,
                                  backend='zfold'))
    if torch.cuda.is_available():
        pytest.skip('a card is present: the default is usable here')
    for make in (lambda: synthetic_batch(cfg, 1, 0, num_points=16),
                 lambda: FusionOcc(cfg),
                 lambda: SparseEncoder(cfg.lidar, cfg.grid)):
        with pytest.raises((RuntimeError, AssertionError)):
            make()
    enc = SparseEncoder(cfg.lidar, cfg.grid, device='cpu')
    assert next(enc.parameters()).device.type == 'cpu'


def _run(code_or_args, cwd, env_extra=None):
    env = dict(os.environ)
    env['PYTHONPATH'] = REPO
    env.update(ONE_THREAD)
    env.update(env_extra or {})
    return subprocess.run(code_or_args, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def test_port_imports_no_jax():
    code = (
        'import sys\n'
        'import fusionocc_tpu_torch.models.fusion_occ, '
        'fusionocc_tpu_torch.models.lidar_encoder, '
        'fusionocc_tpu_torch.ops.zwin_conv, fusionocc_tpu_torch.ops.voxelize, '
        'fusionocc_tpu_torch.ops.sparse_conv, fusionocc_tpu_torch.ops.zfold, '
        'fusionocc_tpu_torch.ops.dense_conv, '
        'fusionocc_tpu_torch.weights, fusionocc_tpu_torch.data.synthetic, '
        'fusionocc_tpu_torch.eval.metrics, '
        'fusionocc_tpu_torch.eval.ray_metrics, '
        'fusionocc_tpu_torch.eval.calibration, fusionocc_tpu_torch.configs, '
        'fusionocc_tpu_torch.data.pipeline, fusionocc_tpu_torch.data.dataset, '
        'fusionocc_tpu_torch.data.masks, fusionocc_tpu_torch.native, '
        'fusionocc_tpu_torch.utils.profiling, '
        'fusionocc_tpu_torch.utils.logging, tools.test_torch, '
        'fusionocc_tpu_torch.train.loop, fusionocc_tpu_torch.train.losses, '
        'fusionocc_tpu_torch.train.checkpoint, tools.train_torch, '
        'fusionocc_tpu_torch.parallel.mesh, '
        'fusionocc_tpu_torch.quant, fusionocc_tpu_torch.models.lss_base, '
        'fusionocc_tpu_torch.utils.visualization, tools.export_torch, '
        'tools.visualize_torch, '
        'chip_smoke, tools.profile_torch_zwin_micro, '
        'tools.ab_bev_pool_split, tools.eval_torch_streaming_delta, '
        'tools.profile_torch_predict, fusionocc_tpu_torch.parallel.spatial, '
        'tools.compute_metrics_torch, tools.bench_loader_torch, '
        'tools.burnin_torch, tools.analyze_logs_torch, '
        'tools.analyze_occ_gt_torch, tools.gen_seg_depth_torch, '
        'tools.probe_torch_gloo, fusionocc_tpu_torch.utils.flops, '
        'tools.get_flops_torch, tools.density_sweep_torch, '
        'tools.ab_torch_kernels\n'
        'bad = [m for m in sys.modules if m in ("jax", "flax", "fusionocc_tpu")'
        ' or m.startswith(("jax.", "flax.", "jaxlib", "fusionocc_tpu."))]\n'
        'print("BAD", bad)\n'
        'sys.exit(1 if bad else 0)\n')
    proc = _run([sys.executable, '-c', code], REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize('where', ['repo', 'alone'])
def test_chip_smoke_refuses_without_gpu(where, tmp_path):
    """No CUDA device here: exit non-zero, no traceback, no result line.
    'alone' runs a copy of the script in a directory with nothing else."""
    if where == 'alone':
        shutil.copy(os.path.join(REPO, 'chip_smoke.py'), tmp_path)
        cwd, env = str(tmp_path), {'PYTHONPATH': ''}
    else:
        cwd, env = REPO, {}
    proc = _run([sys.executable, 'chip_smoke.py'], cwd,
                dict(env, CUDA_VISIBLE_DEVICES=''))
    assert proc.returncode != 0
    assert 'Traceback' not in proc.stderr, proc.stderr
    assert '"ok"' not in proc.stdout, proc.stdout
