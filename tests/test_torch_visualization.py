"""The port's occupancy rendering against ``fusionocc_tpu``'s.

``occupancy_bev_image`` is bit-equal to JAX's on random class grids
(topmost non-free voxel, palette, north-up flip), the palettes are equal,
and ``occupancy_to_open3d`` returns None here as JAX's does without
Open3D.  ``tools/visualize_torch.py`` turns the port's ``pred_*.npz``
dumps (with ground truth from an infos pkl) into one PNG per sample and a
GIF, and ``tools/train_torch.py --render-interval`` writes the EMA
prediction's BEV render every N steps.
"""
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from fusionocc_tpu.utils import visualization as jvis
from fusionocc_tpu_torch.utils import visualization as tvis
from torch_threads import one_torch_thread  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize('shape,seed,free', [
    ((20, 20, 4), 0, 17), ((200, 200, 16), 1, 17), ((16, 24, 5), 2, 0)])
def test_bev_image_equals_jax(shape, seed, free):
    rng = np.random.RandomState(seed)
    occ = rng.randint(0, 18, shape).astype(np.uint8)
    occ[rng.rand(*shape) < 0.7] = free       # mostly free, as a scene is
    got = tvis.occupancy_bev_image(occ, free_class=free)
    want = jvis.occupancy_bev_image(occ, free_class=free)
    assert got.dtype == np.uint8 and got.shape == (shape[1], shape[0], 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tvis.OCC_COLORS, jvis.OCC_COLORS)


def test_open3d_scene_absent_as_in_jax():
    occ = np.full((4, 4, 2), 17, np.uint8)
    occ[1, 2, 1] = 4
    assert tvis.occupancy_to_open3d(occ) is None
    assert jvis.occupancy_to_open3d(occ) is None


def test_save_figure_with_ground_truth(tmp_path):
    rng = np.random.RandomState(3)
    occ = rng.randint(0, 18, (20, 20, 4)).astype(np.uint8)
    path = tvis.save_occupancy_figure(occ, str(tmp_path / 'f.png'), gt=occ)
    assert os.path.getsize(path) > 0


def test_visualize_tool_writes_figures_and_video(tmp_path):
    sys.path.insert(0, REPO)
    import tools.visualize_torch as vt
    rng = np.random.RandomState(4)
    preds, infos = tmp_path / 'preds', []
    preds.mkdir()
    for i in range(3):
        occ = rng.randint(0, 18, (1, 20, 20, 4)).astype(np.uint8)
        np.savez_compressed(preds / f'pred_{i:06d}.npz', occ_pred=occ)
        gt_dir = tmp_path / f'gt{i}'
        gt_dir.mkdir()
        np.savez_compressed(gt_dir / 'labels.npz', semantics=occ[0])
        infos.append({'timestamp': i, 'occ_path': f'gt{i}'})
    ann = tmp_path / 'infos.pkl'
    with open(ann, 'wb') as f:
        pickle.dump({'data_list': infos}, f)
    out = tmp_path / 'vis'
    vt.main(['--pred-dir', str(preds), '--ann-file', str(ann),
             '--data-root', str(tmp_path), '--out-dir', str(out),
             '--video', str(out / 'occ.gif')])
    names = sorted(os.listdir(out))
    assert names == ['occ.gif'] + [f'occ_{i:06d}.png' for i in range(3)]
    assert all(os.path.getsize(out / n) > 0 for n in names)


def test_train_tool_renders_every_interval(tmp_path, capsys):
    sys.path.insert(0, REPO)
    import tools.train_torch as tr
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tr.main(['--tiny', '--synthetic', '--steps', '2', '--device', 'cpu',
                 '--work-dir', str(tmp_path), '--render-interval', '1'])
    finally:
        torch.set_num_threads(threads)
    images = sorted(os.listdir(tmp_path / 'images'))
    assert images == ['train_bev_pred_0000001.png',
                      'train_bev_pred_0000002.png']
    from PIL import Image
    img = np.asarray(Image.open(tmp_path / 'images' / images[-1]))
    assert img.shape == (20, 20, 3) and img.dtype == np.uint8
