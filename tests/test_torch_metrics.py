"""The port's occupancy metric against the JAX package's, and the
streaming-delta tool on the CPU.

Random predictions and labels, made with numpy from a seed, with labels
outside the classes (-1, 255) and random camera and LiDAR masks, go
through both packages: the confusion matrices are exactly equal, and the
per-class IoUs and the mIoU agree within 1e-9 (both round to 2 places).
"""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusionocc_tpu.eval import metrics as jm
from fusionocc_tpu_torch.eval import metrics as tm
from torch_threads import one_torch_thread  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (2, 20, 20, 4)


def _draw(seed, ncls=18):
    rng = np.random.RandomState(seed)
    pred = rng.randint(0, ncls, SHAPE).astype(np.uint8)
    gt = rng.randint(0, ncls, SHAPE).astype(np.int32)
    gt[rng.rand(*SHAPE) < 0.05] = 255                   # not a class
    gt[rng.rand(*SHAPE) < 0.05] = -1
    agree = rng.rand(*SHAPE) < 0.4                      # a useful prediction
    pred[agree] = np.clip(gt[agree], 0, ncls - 1)
    return pred, gt, rng.rand(*SHAPE) > 0.3, rng.rand(*SHAPE) > 0.5


def _assert_results_match(got, want):
    assert got.keys() == want.keys()
    for key in want:
        assert (np.isnan(got[key]) and np.isnan(want[key])
                or abs(got[key] - want[key]) <= 1e-9), key


@pytest.mark.parametrize('ncls', [18, 5])
def test_confusion_matrix_matches_jax(ncls):
    pred, gt, mask, _ = _draw(0, ncls)
    pred[0, 0, 0, 0] = 200                      # clipped to the last class
    want = np.asarray(jm.confusion_matrix(jnp.asarray(pred), jnp.asarray(gt),
                                          jnp.asarray(mask), ncls))
    got = tm.confusion_matrix(torch.from_numpy(pred), torch.from_numpy(gt),
                              torch.from_numpy(mask), ncls)
    assert got.dtype == torch.int64 and got.shape == (ncls, ncls)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < mask.sum()
    _assert_results_match(tm.miou_from_hist(got.numpy()),
                          jm.miou_from_hist(want))


@pytest.mark.parametrize('use_image_mask,use_lidar_mask', [
    (True, False), (False, True), (False, False)])
def test_occupancy_metric_matches_jax(use_image_mask, use_lidar_mask):
    """Three updates, the camera mask, the LiDAR mask or neither."""
    want = jm.OccupancyMetric(use_image_mask=use_image_mask,
                              use_lidar_mask=use_lidar_mask)
    got = tm.OccupancyMetric(use_image_mask=use_image_mask,
                             use_lidar_mask=use_lidar_mask)
    for seed in range(3):
        pred, gt, cam, lidar = _draw(seed)
        want.update(pred, gt, mask_camera=cam, mask_lidar=lidar)
        got.update(*(torch.from_numpy(a) for a in (pred, gt, cam, lidar)))
    np.testing.assert_array_equal(got.hist.numpy(), want.hist)
    assert got.count == want.count == 6
    out = got.compute()
    _assert_results_match(out, want.compute())
    assert 0 < out['mIoU'] < 100


def test_free_class_is_left_out_of_the_mean():
    hist = np.diag(np.arange(1, 19)).astype(np.float64)
    hist[17, 0] = 1000.0            # free voxels taken for class 0
    hist[3, :] = 0.0                # class 3 absent: NaN, out of the mean
    out = tm.miou_from_hist(hist)
    assert np.isnan(out['IoU_bus']) and out['IoU_free'] < 2
    # classes 1, 2, 4, ..., 16 at 1 and class 0 at 1/1001; free not counted
    assert out['mIoU'] == pytest.approx(100.0 * (15 + 1 / 1001) / 16,
                                        abs=0.005)
    _assert_results_match(out, jm.miou_from_hist(hist))


def test_streaming_delta_tool_runs_on_the_cpu(tmp_path):
    out = tmp_path / 'delta.json'
    proc = subprocess.run(
        [sys.executable, 'tools/eval_torch_streaming_delta.py', '--device',
         'cpu', '--tiny', '--scenes', '1', '--frames', '3', '--out',
         str(out)], cwd=REPO, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1'))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    res = json.loads(out.read_text())
    assert len(res['agree_by_frame']) == 3
    assert all(0.0 < a < 1.0 for a in res['agree_by_frame'])
    assert 0.0 < res['divergence_miou'] < 100.0
    assert 0.0 < res['rel_logit_mae'] < 1.0
    assert sum(v > 0 for v in res['twopass_voxels_by_class']) > 3
    assert res['config'] == 'tiny' and res['device'] == 'cpu'
