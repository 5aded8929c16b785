"""The port's host data pipeline against the JAX package's.

A tiny nuScenes-shaped tree (``tests/test_ondisk.make_fake_raw_tree``: raw
JPEGs, LiDAR ``.bin`` sweeps, ``labels.npz``, ``.npy`` segmentation maps)
goes through ``tools/create_data.py`` into an infos pkl, and both packages'
``NuScenesOccDataset`` read it:

- every field of a sample equals JAX's: images, segmentation maps, depth
  maps, points, masks and labels exactly, poses within 1e-6; for
  ``train=False`` and for ``train=True`` with one seed at two epochs (the
  augmentations differ between the epochs);
- the loader: threaded equals serial, ``yield_indices``, resampling after
  a failing sample; ``prefetch`` hands a producer's error to the consumer;
  ``stack_batch`` gives the port's ``Batch`` of CPU tensors;
- the native library's four entry points against their numpy versions and
  against JAX's library; the host pose helpers, ``points_to_depthmap`` and
  every ``mask_mode`` against JAX's.
"""
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from fusionocc_tpu import geometry as jgeo
from fusionocc_tpu import native as jnative
from fusionocc_tpu.config import tiny_model_config as j_tiny
from fusionocc_tpu.data import dataset as jds
from fusionocc_tpu.data import masks as jmasks
from fusionocc_tpu.data import pipeline as jpl
from fusionocc_tpu_torch import geometry as tgeo
from fusionocc_tpu_torch import native as tnative
from fusionocc_tpu_torch.config import tiny_model_config as t_tiny
from fusionocc_tpu_torch.data import dataset as tds
from fusionocc_tpu_torch.data import masks as tmasks
from fusionocc_tpu_torch.data import pipeline as tpl
from fusionocc_tpu_torch.models.fusion_occ import Batch
from torch_threads import one_torch_thread  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POSE_TOL = dict(rtol=1e-6, atol=1e-6)
EXACT = ('imgs', 'segs', 'sparse_depth', 'points', 'points_mask',
         'voxel_semantics', 'mask_camera', 'bda', 'intrins', 'post_rots',
         'post_trans')


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    sys.path.insert(0, REPO)
    from test_ondisk import make_fake_raw_tree
    from tools.create_data import build_infos
    root = str(tmp_path_factory.mktemp('nusc_torch'))
    make_fake_raw_tree(root)
    infos, _ = build_infos(root, 'v1.0-mini', None)
    ann = os.path.join(root, 'fusionocc-nuscenes_infos_val.pkl')
    with open(ann, 'wb') as f:
        pickle.dump({'data_list': infos}, f)
    return ann, os.path.join(root, 'img_seg')


def _pair(tree, train, **kw):
    ann, seg = tree
    return (jds.NuScenesOccDataset(ann, j_tiny(**kw), img_seg_dir=seg,
                                   train=train, seed=3),
            tds.NuScenesOccDataset(ann, t_tiny(**kw), img_seg_dir=seg,
                                   train=train, seed=3))


def _assert_sample_equal(got, want):
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        assert g.shape == w.shape and g.dtype == w.dtype, key
        if key in EXACT:
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:                                   # sensor2keyego, ego2global
            np.testing.assert_allclose(g, w, err_msg=key, **POSE_TOL)


@pytest.mark.parametrize('index', [0, 2])
def test_eval_sample_equals_jax(tree, index):
    jd, td = _pair(tree, train=False)
    _assert_sample_equal(td[index], jd[index])
    assert tnative.STATS.built == (jnative.get_lib() is not None)


def test_train_samples_equal_jax_at_two_epochs(tree):
    """One seed, two epochs: equal to JAX's at each, and the epochs'
    augmentations differ."""
    jd, td = _pair(tree, train=True, mask_mode='condition_C')
    seen = []
    for epoch in (0, 1):
        jd.set_epoch(epoch)
        td.set_epoch(epoch)
        got = td[1]
        _assert_sample_equal(got, jd[1])
        seen.append(got['imgs'])
    assert not np.array_equal(*seen)


def test_scene_bounded_adjacency(tree):
    """Sample 0 has no earlier sample: its adjacent frame is itself; sample
    1's adjacent frame is sample 0's pose."""
    _, td = _pair(tree, train=False)
    s0, s1 = td[0], td[1]
    np.testing.assert_array_equal(s0['sensor2keyego'][0],
                                  s0['sensor2keyego'][1])
    assert not np.allclose(s1['sensor2keyego'][0], s1['sensor2keyego'][1])


class FakeDataset:
    """Per-index samples whose content encodes the index."""

    def __init__(self, n=10, fail_once_at=None):
        self.n, self.fail_once_at, self.failed = n, fail_once_at, set()

    def __len__(self):
        return self.n

    def __getitem__(self, j):
        if j == self.fail_once_at and j not in self.failed:
            self.failed.add(j)
            raise OSError(f'corrupt sample {j}')
        sample = {k: None for k in Batch._fields}
        sample['imgs'] = np.full((2, 3), float(j), np.float32)
        sample['points'] = np.full((4,), float(j) * 10, np.float32)
        return sample


def test_loader_threaded_equals_serial_and_jax():
    def collect(mod, **kw):
        return list(mod.data_loader(FakeDataset(), batch_size=2,
                                    shuffle=True, seed=5, **kw))
    serial = collect(tds, num_workers=0)
    threaded = collect(tds, num_workers=4, pipeline_batches=3)
    want = collect(jds, num_workers=0)
    assert len(serial) == len(threaded) == len(want) == 5
    for a, b, w in zip(serial, threaded, want):
        assert isinstance(a.imgs, torch.Tensor) and a.segs is None
        torch.testing.assert_close(a.imgs, b.imgs, rtol=0, atol=0)
        torch.testing.assert_close(a.points, b.points, rtol=0, atol=0)
        np.testing.assert_array_equal(a.imgs.numpy(), w.imgs)


def test_loader_yields_indices():
    out = list(tds.data_loader(FakeDataset(), 2, shuffle=False,
                               num_workers=2, yield_indices=True))
    for k, (batch, idxs) in enumerate(out):
        assert list(idxs) == [2 * k, 2 * k + 1]
        np.testing.assert_array_equal(batch.imgs[:, 0, 0].numpy(),
                                      [2 * k, 2 * k + 1])


@pytest.mark.parametrize('workers', [0, 4])
def test_loader_resamples_a_failing_sample(workers):
    """Sample 3 fails once: it is replaced by the index JAX's loader draws
    for it, and the epoch completes."""
    got = list(tds.data_loader(FakeDataset(fail_once_at=3), 2,
                               shuffle=False, num_workers=workers))
    want = list(jds.data_loader(FakeDataset(fail_once_at=3), 2,
                                shuffle=False, num_workers=workers))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.imgs.numpy(), w.imgs)


def test_prefetch_keeps_order_and_raises_producer_errors():
    assert list(tds.prefetch(iter(range(7)), depth=2)) == list(range(7))

    def broken():
        yield 1
        raise OSError('disk gone')
    with pytest.raises(OSError, match='disk gone'):
        list(tds.prefetch(broken()))


def test_stack_batch_and_to_device():
    rng = np.random.RandomState(0)
    samples = [{'imgs': rng.rand(2, 3).astype(np.float32),
                'points_mask': rng.rand(5) > 0.5} for _ in range(3)]
    b = tpl.stack_batch(samples)
    assert b.imgs.shape == (3, 2, 3) and b.points_mask.dtype == torch.bool
    assert b.bda is None and b.imgs.device.type == 'cpu'
    moved = tpl.to_device(b, 'cpu')
    assert torch.equal(moved.imgs, b.imgs) and moved.bda is None


@pytest.fixture(scope='module')
def cloud():
    rng = np.random.RandomState(0)
    pts = rng.randn(5000, 5).astype(np.float32) * 20
    pts[:, 4] = rng.randint(0, 32, 5000)
    return rng, pts


@pytest.mark.parametrize('entry', ['zbuffer_depth', 'transform_points',
                                   'range_filter_mask', 'project_points'])
def test_native_entry_against_numpy_and_jax(cloud, entry):
    rng, pts = cloud
    if tnative.get_lib() is None:
        pytest.skip('g++ unavailable: the numpy versions run instead')
    T = jgeo.pose_matrix([0.9, 0.1, -0.2, 0.3], [1.0, -2.0, 0.5])
    post_rot = np.array([[0.9, 0.05, 0], [-0.05, 0.9, 0], [0, 0, 1]])
    post_tran = np.array([3.0, -7.0, 0.0])
    args = {'zbuffer_depth': lambda: (
                np.c_[rng.uniform(-5, 70, (5000, 2)),
                      rng.uniform(0, 50, 5000)].astype(np.float32),
                48, 64, (1.0, 45.0)),
            'transform_points': lambda: (pts, T),
            'range_filter_mask': lambda: (pts, (-40, -40, -1, 40, 40, 5.4)),
            'project_points': lambda: (pts, T, post_rot, post_tran)}[entry]()
    before = tnative.STATS.calls.get(entry, 0)
    got = getattr(tnative, entry)(*args)
    assert tnative.STATS.calls[entry] == before + 1
    want, plain = (getattr(jnative, entry)(*args),
                   getattr(tnative, f'{entry}_np')(*args))
    if entry in ('zbuffer_depth', 'range_filter_mask'):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, plain)
        return
    # float64 sums rounded to float32: the library built by another
    # compiler, and numpy's float64 matmul, may round one ulp apart
    np.testing.assert_allclose(got, want, rtol=2.4e-7, atol=0)
    if entry == 'transform_points':
        np.testing.assert_allclose(got, plain, rtol=2.4e-7, atol=0)
    else:           # the numpy version projects in float32
        np.testing.assert_allclose(got, plain, rtol=1e-4, atol=1e-3)


def test_host_pose_helpers_match_jax():
    rng = np.random.RandomState(1)
    for _ in range(3):
        q, t = rng.randn(4), rng.randn(3)
        np.testing.assert_array_equal(tgeo.quat_to_mat(q),
                                      jgeo.quat_to_mat(q))
        np.testing.assert_array_equal(tgeo.pose_matrix(q, t),
                                      jgeo.pose_matrix(q, t))
    s2e = np.stack([[jgeo.pose_matrix(rng.randn(4), rng.randn(3))
                     for _ in range(3)] for _ in range(2)])
    e2g = np.stack([[jgeo.pose_matrix(rng.randn(4), rng.randn(3) * 100)
                     for _ in range(3)] for _ in range(2)])
    np.testing.assert_array_equal(tgeo.sensor2keyego_chain(s2e, e2g),
                                  jgeo.sensor2keyego_chain(s2e, e2g))
    for args in ((12.5, 1.05, True, False), (-3.0, 0.95, False, True)):
        np.testing.assert_array_equal(tgeo.bda_matrix(*args),
                                      jgeo.bda_matrix(*args))


def test_points_to_depthmap_matches_jax():
    import jax.numpy as jnp
    rng = np.random.RandomState(2)
    uvd = np.c_[rng.uniform(-3, 40, (3000, 2)) + 0.5 * (rng.rand(3000, 2)
                                                        < 0.1),
                rng.uniform(0, 12, 3000)].astype(np.float32)
    valid = rng.rand(3000) > 0.2
    want = np.asarray(jgeo.points_to_depthmap(jnp.asarray(uvd),
                                              jnp.asarray(valid), 30, 36,
                                              (1.0, 9.0)))
    got = tgeo.points_to_depthmap(torch.from_numpy(uvd),
                                  torch.from_numpy(valid), 30, 36, (1.0, 9.0))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want > 0).sum() > 100


@pytest.mark.parametrize('mode', jmasks.MASK_MODES)
def test_mask_modes_match_jax(mode):
    rng = np.random.RandomState(4)
    sem = rng.randint(0, 18, (40, 40, 8)).astype(np.int32)
    sem[rng.rand(*sem.shape) < 0.5] = 17
    mask = (rng.rand(*sem.shape) > 0.6).astype(np.uint8)
    got = tmasks.build_training_mask(sem, mask, mode, dist_threshold_c=20.0)
    want = jmasks.build_training_mask(sem, mask, mode, dist_threshold_c=20.0)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert tmasks.MASK_MODES == jmasks.MASK_MODES


def test_image_transforms_match_jax():
    """An augmentation drawn in training, its homography, the PIL
    transform (bilinear and nearest) and the normalisation."""
    rng_j, rng_t = np.random.RandomState(7), np.random.RandomState(7)
    for _ in range(3):
        ja = jpl.sample_image_aug((96, 160), (64, 128), True, rng_j)
        ta = tpl.sample_image_aug((96, 160), (64, 128), True, rng_t)
        assert vars(ta) == vars(ja)
        for got, want in zip(tpl.aug_homography(ta), jpl.aug_homography(ja)):
            np.testing.assert_array_equal(got, want)
        img = np.random.RandomState(0).randint(0, 255, (96, 160, 3),
                                               dtype=np.uint8)
        for nearest in (False, True):
            np.testing.assert_array_equal(
                np.asarray(tpl.transform_image(img, ta, nearest)),
                np.asarray(jpl.transform_image(img, ja, nearest)))
        np.testing.assert_array_equal(tpl.normalize_image(img),
                                      jpl.normalize_image(img))
