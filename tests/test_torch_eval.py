"""The port's evaluation metrics, calibration and official-Swin import
against the JAX package's.

Inputs are made with numpy from a seed and go through both packages:

- ``bucketed_confusion_matrix``, the radius and height bucket grids and
  ``OccupancyMetric(grid=...)``: matrices and bucket ids exactly equal,
  mIoUs within 1e-9 (both round to 2 places); ``compute`` raises with more
  than one ``torch.distributed`` process (ROADMAP Queue A item 11);
- ``fscore`` (scipy's ``cKDTree``) against JAX's (scikit-learn's
  ``KDTree``): equal accuracy and completeness, F-score within 1e-12;
- ``render_rays`` and ``RayIoUMetric`` exactly equal on the official ray
  fan and on rays from a point cloud;
- ``fit_temperature``: its search on JAX's objective within 1e-6 relative
  of JAX's fit, the NLL within 1e-6, and its own fit within 1e-3 (the
  float32 objective's resolution at the minimum); ``uncertainty_maps`` and
  ``export_logits`` against JAX's;
- ``convert_official_swin`` on synthesized official keys equals JAX's;
  ``resize_bias_table`` within 1e-5 of JAX's (``jax.image.resize`` cubic),
  where ``F.interpolate(mode='bicubic')`` is not; ``load_official_swin``
  fills a port backbone.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusionocc_tpu.config import GridConfig as JGrid
from fusionocc_tpu.eval import calibration as jcal
from fusionocc_tpu.eval import metrics as jm
from fusionocc_tpu.eval import ray_metrics as jray
from fusionocc_tpu.train import torch_import as ti
from fusionocc_tpu_torch import weights as tw
from fusionocc_tpu_torch.config import GridConfig as TGrid
from fusionocc_tpu_torch.eval import calibration as tcal
from fusionocc_tpu_torch.eval import metrics as tm
from fusionocc_tpu_torch.eval import ray_metrics as tray
from torch_threads import one_torch_thread  # noqa: E402,F401

GRID = dict(x=(-40.0, 40.0, 4.0), y=(-40.0, 40.0, 4.0), z=(-1.0, 5.4, 0.8),
            depth=(1.0, 45.0, 0.5))


def _occ(seed, shape, free=0.7):
    rng = np.random.RandomState(seed)
    occ = rng.randint(0, 17, shape).astype(np.uint8)
    occ[rng.rand(*shape) < free] = 17
    return occ


def _close(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert (np.isnan(got[k]) and np.isnan(want[k])
                or abs(got[k] - want[k]) <= 1e-9), k


@pytest.mark.parametrize('kind', ['radius', 'height'])
def test_bucket_grids_match_jax(kind):
    bins = (jm.OccupancyMetric.RADIUS_BINS if kind == 'radius'
            else jm.OccupancyMetric.HEIGHT_BINS_REL)
    for grid in (GRID, {}):             # coarse, and the full-size default
        want, wl = getattr(jm, f'{kind}_bucket_grid')(JGrid(**grid), bins)
        got, gl = getattr(tm, f'{kind}_bucket_grid')(TGrid(**grid), bins)
        assert gl == wl and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_bucketed_confusion_matrix_matches_jax():
    rng = np.random.RandomState(0)
    shape = (2, 20, 20, 8)
    pred = rng.randint(0, 20, shape)
    gt = rng.randint(-1, 19, shape)
    mask = rng.rand(*shape) > 0.3
    bid = rng.randint(-1, 8, shape)
    want = np.asarray(jm.bucketed_confusion_matrix(
        jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(mask),
        jnp.asarray(bid), 7))
    got = tm.bucketed_confusion_matrix(
        torch.from_numpy(pred), torch.from_numpy(gt), torch.from_numpy(mask),
        torch.from_numpy(bid), 7)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('use_image_mask', [True, False])
def test_bucketed_metric_matches_jax(use_image_mask):
    grid_j, grid_t = JGrid(**GRID), TGrid(**GRID)
    gx, gy, gz = grid_t.grid_size
    jmet = jm.OccupancyMetric(use_image_mask=use_image_mask, grid=grid_j)
    tmet = tm.OccupancyMetric(use_image_mask=use_image_mask, grid=grid_t)
    for seed in range(3):
        rng = np.random.RandomState(seed)
        shape = (2, gx, gy, gz) if seed else (gx, gy, gz)
        pred = rng.randint(0, 18, shape).astype(np.uint8)
        gt = rng.randint(0, 18, shape).astype(np.int32)
        pred[rng.rand(*shape) < 0.5] = gt[rng.rand(*shape) < 0.5][0]
        mask = rng.rand(*shape) > 0.4
        jmet.update(pred, gt, mask_camera=mask)
        tmet.update(torch.from_numpy(pred), torch.from_numpy(gt),
                    mask_camera=torch.from_numpy(mask))
    for name in ('radius', 'height'):
        np.testing.assert_array_equal(tmet.buckets[name]['hist'].numpy(),
                                      jmet.buckets[name]['hist'])
    assert tmet.count == jmet.count == 5
    _close(tmet.compute(), jmet.compute())


def test_metric_refuses_multiple_processes(tmp_path):
    """The refusal is gone: inside a process group (one gloo rank here;
    two in ``tests/test_torch_parallel.py``) ``compute`` sums the matrices
    over the group, buckets included, and gives the one-process result."""
    from fusionocc_tpu_torch.parallel import mesh
    met = tm.OccupancyMetric(grid=TGrid(**GRID))
    rng = np.random.RandomState(0)
    gx, gy, gz = met.buckets['radius']['id'].shape
    gt = torch.from_numpy(rng.randint(0, 18, (gx, gy, gz)).astype(np.int32))
    met.update(gt.to(torch.uint8), gt)
    want = met.compute()
    torch.distributed.init_process_group(
        'gloo', init_method=f'file://{tmp_path}/store', world_size=1, rank=0)
    try:
        mesh.COLLECTIVES.reset()
        got = met.compute()
        assert mesh.COLLECTIVES.calls == {'metric': 3}
    finally:
        torch.distributed.destroy_process_group()
    assert got == want and want['mIoU'] == 100.0


@pytest.mark.parametrize('masked', [False, True])
def test_fscore_matches_jax(masked):
    pytest.importorskip('sklearn')
    shape = (40, 40, 8)
    pred, gt = _occ(1, shape), _occ(2, shape)
    gt[:20] = pred[:20]                  # half the scene predicted well
    mask = (np.random.RandomState(3).rand(*shape) > 0.2) if masked else None
    kw = dict(voxel_size=(0.4, 0.4, 0.4), pc_range=(-8, -8, -1, 8, 8, 2.2))
    want = jm.fscore(pred, gt, mask, **kw)
    got = tm.fscore(pred, gt, mask, **kw)
    assert got['accuracy'] == want['accuracy']
    assert got['completeness'] == want['completeness']
    assert abs(got['fscore'] - want['fscore']) <= 1e-12
    assert 0.2 < got['fscore'] < 1.0
    empty = np.full(shape, 17, np.uint8)
    assert tm.fscore(empty, gt) == jm.fscore(empty, gt)


@pytest.mark.parametrize('rays', ['official_fan', 'points'])
def test_render_rays_and_rayiou_match_jax(rays):
    grid_j, grid_t = JGrid(**GRID), TGrid(**GRID)
    shape = grid_t.grid_size
    gt = _occ(4, shape, free=0.9)
    pred = gt.copy()
    rng = np.random.RandomState(5)
    pred[rng.rand(*shape) < 0.05] = 4                   # false positives
    pred[(rng.rand(*shape) < 0.3) & (gt != 17)] = 17    # misses
    if rays == 'official_fan':
        dirs = tray.generate_lidar_rays()
        np.testing.assert_array_equal(dirs, jray.generate_lidar_rays())
    else:
        pts = rng.randn(3000, 5).astype(np.float32) * 15
        dirs = tray.rays_from_points(pts, max_rays=2048)
        np.testing.assert_array_equal(dirs,
                                      jray.rays_from_points(pts, max_rays=2048))
    for occ in (gt, pred):
        for got, want in zip(
                tray.render_rays(occ, tray.LIDAR_ORIGIN, dirs, grid_t),
                jray.render_rays(occ, jray.LIDAR_ORIGIN, dirs, grid_j)):
            np.testing.assert_array_equal(got, want)
    tmet, jmet = tray.RayIoUMetric(grid_t), jray.RayIoUMetric(grid_j)
    for m in (tmet, jmet):
        m.update(pred, gt, dirs)
        m.update(gt, gt, dirs)
    for a in ('gt_cnt', 'pred_cnt', 'tp_cnt'):
        np.testing.assert_array_equal(getattr(tmet, a), getattr(jmet, a))
    got, want = tmet.compute(), jmet.compute()
    assert got == want and 0 < got['RayIoU'] < 100
    assert tray.ray_iou(pred, gt, dirs, grid_t) == jray.ray_iou(
        pred, gt, dirs, grid_j)


def _calib_inputs(seed=0, n=3000, c=18):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(n, c) * 3.0).astype(np.float32)
    p = np.exp(logits / 2.5)
    p /= p.sum(1, keepdims=True)
    labels = np.array([rng.choice(c, p=row) for row in p])
    return logits, labels, rng.rand(n) > 0.3


@pytest.mark.parametrize('masked', [False, True])
def test_fit_temperature_matches_jax(masked):
    """The search is JAX's step for step: on JAX's own objective it stops
    within 1e-6 (relative) of JAX's ``fit_temperature``.  The port's float32
    NLL agrees with JAX's within 1e-6 at any temperature; near the minimum
    that is below the objective's resolution, so the port's own fit stops
    within 1e-3 of JAX's, at an NLL equal to JAX's within 1e-6."""
    import jax
    logits, labels, mask = _calib_inputs()
    mask = mask if masked else None
    jargs = (jnp.asarray(logits), jnp.asarray(labels),
             None if mask is None else jnp.asarray(mask))
    targs = (torch.from_numpy(logits), torch.from_numpy(labels),
             None if mask is None else torch.from_numpy(mask))
    want = jcal.fit_temperature(logits, labels, mask)
    jnll = jax.jit(lambda t: jcal.nll_at_temperature(*jargs, t))
    same_search = tcal.golden_section(lambda t: float(jnll(t)), 0.05, 10.0)
    assert abs(same_search - want) <= 1e-6 * want, (same_search, want)
    got = tcal.fit_temperature(*targs)
    assert abs(got - want) <= 1e-3 * want, (got, want)
    assert 2.0 < got < 3.0
    for t in (0.5, 1.0, 4.0, want):
        np.testing.assert_allclose(
            float(tcal.nll_at_temperature(*targs, t)), float(jnll(t)),
            rtol=1e-6)
    np.testing.assert_allclose(float(tcal.nll_at_temperature(*targs, got)),
                               float(jnll(want)), rtol=1e-6)


def test_uncertainty_maps_match_jax():
    logits = np.random.RandomState(1).randn(4, 5, 6, 18).astype(np.float32)
    logits[0, 0, 0] = 0.0                       # a flat row: entropy 1
    for t in (1.0, 1.5221):
        want = jcal.uncertainty_maps(jnp.asarray(logits), t)
        got = tcal.uncertainty_maps(torch.from_numpy(logits), t)
        assert got.keys() == want.keys()
        for k in ('probs', 'msp', 'entropy'):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
        assert got['pred'].dtype == torch.uint8
        np.testing.assert_array_equal(got['pred'].numpy(),
                                      np.asarray(want['pred']))


def test_export_logits_matches_jax():
    """The same logits from a JAX-style and a port-style model stub give
    the same export."""
    rng = np.random.RandomState(2)
    logits = rng.randn(1, 4, 4, 2, 18).astype(np.float32)
    sem = rng.randint(0, 18, (1, 4, 4, 2)).astype(np.int32)
    mask = rng.rand(1, 4, 4, 2) > 0.5

    class JModel:
        def apply(self, variables, batch, train):
            return {'occ_logits': jnp.asarray(logits)}

    class TModel(torch.nn.Module):
        def eval_semantics(self):
            import contextlib
            return contextlib.nullcontext()

        def forward(self, batch):
            return {'occ_logits': torch.from_numpy(logits)}

    jb = type('B', (), {'voxel_semantics': sem, 'mask_camera': mask})
    tb = type('B', (), {'voxel_semantics': torch.from_numpy(sem),
                        'mask_camera': torch.from_numpy(mask)})
    want = jcal.export_logits(JModel(), {}, jb)
    got = tcal.export_logits(TModel(), tb)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _official_swin_keys(depths=(2, 2), dims=16, heads=(1, 2), window=7,
                        seed=0):
    """An official (Microsoft) Swin state dict's keys and shapes, random
    values: the stem, every block, the patch mergings, the final norm and
    the classification head."""
    rng = np.random.RandomState(seed)
    sd = {'patch_embed.proj.weight': (dims, 3, 4, 4),
          'patch_embed.proj.bias': (dims,), 'patch_embed.norm.weight': (dims,),
          'patch_embed.norm.bias': (dims,), 'head.weight': (10, dims * 8),
          'head.bias': (10,), 'norm.weight': (dims * 8,),
          'norm.bias': (dims * 8,)}
    for s, (d, h) in enumerate(zip(depths, heads)):
        c = dims * 2 ** s
        for b in range(d):
            p = f'layers.{s}.blocks.{b}.'
            sd.update({
                p + 'norm1.weight': (c,), p + 'norm1.bias': (c,),
                p + 'attn.relative_position_bias_table':
                    ((2 * window - 1) ** 2, h),
                p + 'attn.relative_position_index': (window ** 2,
                                                     window ** 2),
                p + 'attn.qkv.weight': (3 * c, c), p + 'attn.qkv.bias': (3 * c,),
                p + 'attn.proj.weight': (c, c), p + 'attn.proj.bias': (c,),
                p + 'norm2.weight': (c,), p + 'norm2.bias': (c,),
                p + 'mlp.fc1.weight': (4 * c, c), p + 'mlp.fc1.bias': (4 * c,),
                p + 'mlp.fc2.weight': (c, 4 * c), p + 'mlp.fc2.bias': (c,)})
        if s < len(depths) - 1:
            sd.update({f'layers.{s}.downsample.reduction.weight':
                       (2 * c, 4 * c),
                       f'layers.{s}.downsample.norm.weight': (4 * c,),
                       f'layers.{s}.downsample.norm.bias': (4 * c,)})
    return {k: rng.randn(*shape).astype(np.float32)
            for k, shape in sd.items()}


def test_convert_official_swin_matches_jax():
    sd = _official_swin_keys()
    got, want = tw.convert_official_swin(sd), ti.convert_official_swin(sd)
    assert got.keys() == want.keys()
    assert not any(k.startswith('img_backbone.head') for k in got)
    assert 'img_backbone.stages.0.downsample.reduction.weight' in got
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize('window_from,window_to', [(7, 12), (12, 7),
                                                   (7, 4), (12, 23)])
def test_resize_bias_table_matches_jax(window_from, window_to):
    table = np.random.RandomState(window_from).randn(
        (2 * window_from - 1) ** 2, 4).astype(np.float32)
    n = (2 * window_to - 1) ** 2
    want = np.asarray(ti.resize_bias_table(table, n))
    got = tw.resize_bias_table(table, n)
    assert got.shape == want.shape == (n, 4) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    if window_from == 7 and window_to == 12:
        # torch's bicubic (a = -0.75, edge clamped) is another resize
        s1, s2 = 2 * window_from - 1, 2 * window_to - 1
        torch_bicubic = torch.nn.functional.interpolate(
            torch.from_numpy(table.T.reshape(1, 4, s1, s1)), (s2, s2),
            mode='bicubic', align_corners=False)[0].reshape(4, n).T.numpy()
        assert np.abs(torch_bicubic - want).max() > 1e-2


def test_load_official_swin_fills_the_backbone():
    from fusionocc_tpu_torch.config import tiny_model_config
    from fusionocc_tpu_torch.models.fusion_occ import FusionOcc
    cfg = tiny_model_config(use_lidar=False)
    sw = cfg.swin
    model = FusionOcc(cfg, device='cpu')
    sd = _official_swin_keys(sw.depths, sw.embed_dims, sw.num_heads,
                             window=7)
    report = tw.load_official_swin(model, sd)
    # the output norms of the two out indices are the detector's own
    assert report['missing'] == [f'img_backbone.norm{i}.{p}'
                                 for i in sw.out_indices
                                 for p in ('weight', 'bias')]
    assert report['shape_mismatch'] == []
    assert len(report['loaded']) == len(tw.convert_official_swin(sd)) - 2 - sum(
        sw.depths)
    # the classification stem's final norm has no place in the backbone
    assert report['unused'] == ['img_backbone.norm.bias',
                                'img_backbone.norm.weight']
    conv = tw.convert_official_swin(sd)
    own = model.state_dict()
    key = 'img_backbone.stages.1.blocks.0.attn.w_msa.relative_position_bias_table'
    np.testing.assert_array_equal(
        own[key].numpy(),
        tw.resize_bias_table(conv[key], (2 * sw.window_size - 1) ** 2))
    key = 'img_backbone.stages.0.downsample.reduction.weight'
    np.testing.assert_array_equal(own[key].numpy(), conv[key])
    bad = dict(sd, **{'patch_embed.proj.weight': np.zeros((3, 3, 4, 4),
                                                          np.float32)})
    with pytest.raises(ValueError, match='projection'):
        tw.load_official_swin(FusionOcc(dataclasses.replace(cfg),
                                        device='cpu'), bad)
