"""The port's streaming inference and ``batch_frames`` mode against the JAX
package.

Both packages carry the same weights: a flax tree drawn with numpy
(``test_torch_slice.random_variables``) whose kernels are scaled by sqrt(2)
and whose last predicter layer has centred rows and no bias, the way
``fusion_occ.spread_weights`` spreads the port's own weights, so that the
argmax maps take many classes; ``weights.state_dict_from_flax`` carries it
into the port.  The inputs are a synthetic clip: frame t is the synthetic
batch of seed t (its ego 0.5 m ahead of frame t-1's), with frame t-1's key
images as its adjacent images, and points snapped to multiples of 2^-8 so
that JAX's prefix-sum voxel means are exact.  On the CPU the port's kernels
run as their plain versions.

The multi-modal tiny model (LiDAR encoder on the z-folded path with zband,
the plain form of the zwin kernel, in both packages) holds
``predict_streaming`` against JAX and every mode against the port's own
scan.  JAX compiles the LiDAR encoder slowly on the CPU, so its scan, time
fold and ``batch_frames`` are compiled once each for the image-only tiny
model, and its ``predict_streaming`` for the image-only midsize model.

Tolerances (fp32, sums in another order): logits within 1e-4, absolute and
relative, and at least 99.9% of voxels with the same class; cached features
within 1e-5; ``grid_sample_2d`` within 1e-6.  Inside the port, the scan is
``predict_streaming`` in a loop, so the two agree exactly; the time fold
and ``batch_frames`` run the convolutions at another batch size, so they
agree within the same tolerances.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusionocc_tpu import config as jcfg
from fusionocc_tpu.models.fusion_occ import Batch as JBatch
from fusionocc_tpu.models.fusion_occ import FusionOcc as JFusionOcc
from fusionocc_tpu.models.fusion_occ import StreamingState as JState
from fusionocc_tpu.ops.grid_sample import grid_sample_2d as j_grid_sample_2d
from fusionocc_tpu_torch import config as tcfg
from fusionocc_tpu_torch.data.synthetic import synthetic_batch
from fusionocc_tpu_torch.models.fusion_occ import (
    Batch, FusionOcc, StreamingState, batch_pooling_indices,
    batched_frames_pooling_index, frame_pooling_index, map_batch,
    stack_batches, streaming_fold_pooling_index)
from fusionocc_tpu_torch.ops.grid_sample import grid_sample_2d
from fusionocc_tpu_torch.weights import flatten_tree, state_dict_from_flax

from test_torch_lidar_model import _snap
from test_torch_slice import _init_fn, random_variables, unflatten_tree
from torch_threads import one_torch_thread  # noqa: E402,F401

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
STATE_TOL = dict(rtol=1e-5, atol=1e-5)
LIDAR = dict(backend='zfold', zconv='zband')


def _config(pkg, preset, use_lidar):
    cfg = getattr(pkg, f'{preset}_model_config')(use_lidar=use_lidar)
    return dataclasses.replace(
        cfg, lidar=dataclasses.replace(cfg.lidar, **LIDAR))


def spread_variables(init_fn, seed):
    flat = flatten_tree(random_variables(init_fn, seed))
    for path in flat:
        if path.endswith('/kernel'):
            flat[path] = flat[path] * np.float32(math.sqrt(2.0))
    k = flat['params/predicter_fc2/kernel']
    flat['params/predicter_fc2/kernel'] = k - k.mean(0, keepdims=True)
    flat['params/predicter_fc2/bias'][:] = 0.0
    return unflatten_tree(flat)


def clip(cfg, n):
    frames = []
    for t in range(n):
        b = synthetic_batch(cfg, 1, t, num_points=512, device='cpu')
        b = b._replace(points=torch.from_numpy(_snap(b.points)))
        if frames:
            b = b._replace(imgs=torch.cat(
                [b.imgs[:, :1], frames[-1].imgs[:, :1]], dim=1))
        frames.append(b)
    return frames


def to_jax(tree):
    """A port Batch or StreamingState as the JAX package's, numpy leaves."""
    kind = JBatch if isinstance(tree, Batch) else JState
    return kind(*(None if a is None else jnp.asarray(a.numpy())
                  for a in tree))


class Pair:
    """The same weights in both packages, and a clip."""

    def __init__(self, preset, use_lidar, frames):
        self.jc = _config(jcfg, preset, use_lidar)
        self.tc = _config(tcfg, preset, use_lidar)
        self.frames = frames
        self.jmodel = JFusionOcc(self.jc)
        self.variables = spread_variables(
            _init_fn(self.jmodel, to_jax(self.frames[0])), seed=3)
        self.model = FusionOcc(self.tc, device='cpu')
        self.model.load_state_dict(state_dict_from_flax(
            self.variables['params'], self.variables['batch_stats'],
            self.tc), strict=True)
        self.key_idx = frame_pooling_index(
            self.tc, self.frames[0].sensor2keyego[:, 0],
            self.frames[0].intrins[:, 0], self.frames[0].post_rots[:, 0],
            self.frames[0].post_trans[:, 0], self.frames[0].bda)
        jm = self.jmodel
        self.j_step = jax.jit(lambda v, b, s, r: jm.apply(
            v, b, s, reset=r, method=JFusionOcc.predict_streaming))

    def j_init_state(self):
        return self.jmodel.apply(self.variables, 1,
                                 method=JFusionOcc.init_streaming_state)


@pytest.fixture(scope='module')
def tiny_clip():
    return clip(_config(tcfg, 'tiny', True), 4)


@pytest.fixture(scope='module')
def tiny(tiny_clip):
    return Pair('tiny', True, tiny_clip)


@pytest.fixture(scope='module')
def tiny_cam(tiny_clip):
    return Pair('tiny', False, tiny_clip)


def _agree(a, b):
    return float(np.mean(np.asarray(a) == np.asarray(b)))


def _check_state(got: StreamingState, want: JState):
    np.testing.assert_allclose(got.voxel_feat.numpy(),
                               np.asarray(want.voxel_feat), **STATE_TOL)
    np.testing.assert_allclose(got.ego2global.numpy(),
                               np.asarray(want.ego2global), **STATE_TOL)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))


@pytest.mark.parametrize('align_corners', [True, False])
def test_grid_sample_2d_matches_jax(align_corners):
    rng = np.random.RandomState(0)
    img = rng.randn(2, 3, 5, 7).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, (2, 4, 6, 2)).astype(np.float32)
    grid[0, 0, 0] = (-1.0, 1.0)                 # the corners themselves
    grid[0, 0, 1] = (1.0, -1.0)
    grid[1, 3, 5] = (2.5, -3.0)                 # every tap out of range
    want = np.asarray(j_grid_sample_2d(jnp.asarray(img), jnp.asarray(grid),
                                       align_corners=align_corners))
    got = grid_sample_2d(torch.from_numpy(img), torch.from_numpy(grid),
                         align_corners=align_corners)
    assert got.dtype == torch.float32 and got.shape == (2, 3, 4, 6)
    assert np.abs(want).max() > 0 and not want[1, :, 3, 5].any()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('motion', ['translation', 'yaw'])
def test_shift_bev_matches_jax(tiny, motion):
    gx, gy, gz = tiny.tc.grid.grid_size
    feat = np.random.RandomState(1).randn(2, gz, gy, gx, 3).astype(np.float32)
    dst2src = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    if motion == 'translation':
        dst2src[:, 0, 3], dst2src[:, 1, 3] = (1.3, -0.5), (-0.7, 2.1)
    else:
        for b, deg in enumerate((10.0, -35.0)):
            c, s = math.cos(math.radians(deg)), math.sin(math.radians(deg))
            dst2src[b, :2, :2] = ((c, -s), (s, c))
        dst2src[:, 0, 3] = 0.5
    want = np.asarray(tiny.jmodel.apply(
        {}, jnp.asarray(feat), jnp.asarray(dst2src),
        method=JFusionOcc._shift_bev))
    got = tiny.model._shift_bev(torch.from_numpy(feat),
                                torch.from_numpy(dst2src))
    assert got.shape == feat.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **STATE_TOL)
    assert not np.allclose(want, feat, atol=0.1)        # the warp moved it


def _streaming_against_jax(pair):
    """Frame 0 on an empty cache, frame 1 on frame 0's cache, then frame 1
    again with a reset: outputs and new caches against JAX's."""
    f0, f1 = pair.frames[:2]
    no, yes = torch.zeros(1, dtype=torch.bool), torch.ones(1, dtype=torch.bool)
    state = pair.model.init_streaming_state(1)
    jstate = pair.j_init_state()
    _check_state(state, jstate)
    for batch, reset in ((f0, no), (f1, no), (f1, yes)):
        pred, out, new = pair.model.predict_streaming(batch, state,
                                                      pair.key_idx, reset)
        jpred, jout, jnew = pair.j_step(pair.variables, to_jax(batch),
                                        jstate, jnp.asarray(reset.numpy()))
        np.testing.assert_allclose(out['occ_logits'].numpy(),
                                   np.asarray(jout['occ_logits']),
                                   **LOGIT_TOL)
        np.testing.assert_allclose(out['depth'].numpy(),
                                   np.asarray(jout['depth']), **STATE_TOL)
        assert pred.dtype == torch.uint8
        assert _agree(pred.numpy(), jpred) >= 0.999
        _check_state(new, jnew)
        if reset is no:
            state, jstate = new, jnew
    return out, pred


def test_predict_streaming_matches_jax_tiny(tiny):
    _, pred = _streaming_against_jax(tiny)
    assert len(np.unique(pred.numpy())) > 3        # a varied class map


def test_predict_streaming_matches_jax_midsize():
    _streaming_against_jax(
        Pair('midsize', False, clip(_config(tcfg, 'midsize', False), 2)))


def test_reset_gives_a_fresh_cache_and_the_cache_matters(tiny):
    """With a reset, frame 1 predicts as on an empty cache; without one,
    the warped cache changes the logits."""
    f0, f1 = tiny.frames[:2]
    m, idx = tiny.model, tiny.key_idx
    _, _, s1 = m.predict_streaming(f0, m.init_streaming_state(1), idx)
    _, reset, _ = m.predict_streaming(f1, s1, idx, torch.ones(1, dtype=bool))
    _, fresh, _ = m.predict_streaming(f1, m.init_streaming_state(1), idx)
    _, cached, _ = m.predict_streaming(f1, s1, idx)
    assert torch.equal(reset['occ_logits'], fresh['occ_logits'])
    assert not torch.allclose(cached['occ_logits'], fresh['occ_logits'],
                              atol=1e-3)


def _scan3(pair):
    frames = stack_batches(pair.frames[:3])
    resets = torch.tensor([[False], [False], [True]])
    state = pair.model.init_streaming_state(1)
    return (frames, resets, state) + pair.model.predict_streaming_scan(
        frames, state, resets, pair.key_idx)


def test_streaming_scan_matches_sequential(tiny):
    frames, resets, state, preds, final = _scan3(tiny)
    assert preds.shape == (3, 1) + tiny.tc.grid.grid_size
    assert preds.dtype == torch.uint8
    s = state
    for t in range(3):
        p, _, s = tiny.model.predict_streaming(
            map_batch(lambda a: a[t], frames), s, tiny.key_idx, resets[t])
        assert torch.equal(preds[t], p)
    for got, want in zip(final, s):
        assert torch.equal(got, want)


def test_streaming_scan_matches_jax(tiny_cam):
    frames, resets, _, preds, final = _scan3(tiny_cam)
    jm = tiny_cam.jmodel
    jpreds, jfinal = jax.jit(lambda v, f, st, r: jm.apply(
        v, f, st, resets=r, method=JFusionOcc.predict_streaming_scan))(
        tiny_cam.variables, to_jax(frames), tiny_cam.j_init_state(),
        jnp.asarray(resets.numpy()))
    assert _agree(preds.numpy(), jpreds) >= 0.999
    _check_state(final, jfinal)


@pytest.fixture(scope='module')
def scan4(tiny):
    """The port's scan over the four frames, a reset at frame 2."""
    frames = stack_batches(tiny.frames)
    resets = torch.tensor([[False], [False], [True], [False]])
    state = tiny.model.init_streaming_state(1)
    preds, final = tiny.model.predict_streaming_scan(frames, state, resets,
                                                     tiny.key_idx)
    return frames, resets, state, preds, final


@pytest.mark.parametrize('chunk,cam_chunk', [(2, 0), (4, 0), (4, 2)])
def test_streaming_batch_matches_scan(tiny, scan4, chunk, cam_chunk):
    frames, resets, state, preds, final = scan4
    idx = streaming_fold_pooling_index(tiny.tc, frames, chunk, cam_chunk)
    got, got_final = tiny.model.predict_streaming_batch(
        frames, state, resets, idx, chunk=chunk, cam_chunk=cam_chunk)
    assert got.shape == preds.shape and got.dtype == torch.uint8
    assert _agree(got.numpy(), preds.numpy()) >= 0.999
    for a, b in zip(got_final, final):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **STATE_TOL)
    # without the index each camera microbatch builds its own
    again, _ = tiny.model.predict_streaming_batch(
        frames, state, resets, chunk=chunk, cam_chunk=cam_chunk)
    assert torch.equal(again, got)


def test_cam_chunk_equals_one_camera_pass(tiny, scan4):
    frames, resets, state, *_ = scan4
    m, tc = tiny.model, tiny.tc
    whole = m.predict_streaming_batch(
        frames, state, resets, streaming_fold_pooling_index(tc, frames, 4),
        chunk=4)
    split = m.predict_streaming_batch(
        frames, state, resets,
        streaming_fold_pooling_index(tc, frames, 4, 2), chunk=4, cam_chunk=2)
    assert torch.equal(whole[0], split[0])
    for a, b in zip(whole[1], split[1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **STATE_TOL)


def test_streaming_batch_matches_jax(tiny_cam):
    frames = stack_batches(tiny_cam.frames)
    resets = torch.tensor([[False], [False], [True], [False]])
    got, final = tiny_cam.model.predict_streaming_batch(
        frames, tiny_cam.model.init_streaming_state(1), resets,
        streaming_fold_pooling_index(tiny_cam.tc, frames, 2), chunk=2)
    jm = tiny_cam.jmodel
    jpreds, jfinal = jax.jit(lambda v, f, st, r: jm.apply(
        v, f, st, resets=r, chunk=2,
        method=JFusionOcc.predict_streaming_batch))(
        tiny_cam.variables, to_jax(frames), tiny_cam.j_init_state(),
        jnp.asarray(resets.numpy()))
    assert _agree(got.numpy(), jpreds) >= 0.999
    _check_state(final, jfinal)


def test_batch_frames_matches_per_frame_and_jax(tiny_cam):
    tiny = tiny_cam
    batch = tiny.frames[1]
    m = tiny.model
    with torch.inference_mode():
        per_frame = m(batch, batch_pooling_indices(tiny.tc, batch))
        folded = m(batch, batch_frames=True)
        given = m(batch, batch_frames=True, pool_idx_folded=(
            batched_frames_pooling_index(tiny.tc, batch)))
    jm = tiny.jmodel
    jout = jax.jit(lambda v, b: jm.apply(v, b, train=False,
                                         batch_frames=True))(
        tiny.variables, to_jax(batch))
    for out in (folded, given):
        for key in ('occ_logits', 'seg_logits'):
            for want in (per_frame[key].numpy(), np.asarray(jout[key])):
                assert out[key].shape == want.shape, key
                np.testing.assert_allclose(out[key].numpy(), want,
                                           **LOGIT_TOL, err_msg=key)
        np.testing.assert_allclose(out['depth'].numpy(),
                                   np.asarray(jout['depth']), **STATE_TOL)
        assert _agree(out['occ_logits'].argmax(-1).numpy(),
                      np.asarray(jout['occ_logits']).argmax(-1)) >= 0.999
    assert torch.equal(folded['occ_logits'], given['occ_logits'])
    pred = m.predict(batch, batch_frames=True)
    assert torch.equal(pred, folded['occ_logits'].argmax(-1).to(torch.uint8))


def test_streaming_refuses_what_jax_refuses(tiny):
    """No ego2global, or more than one adjacent frame: both packages
    raise before running anything."""
    f0 = tiny.frames[0]._replace(ego2global=None)
    state = tiny.model.init_streaming_state(1)
    with pytest.raises(ValueError, match='ego2global'):
        tiny.model.predict_streaming(f0, state)
    with pytest.raises(ValueError, match='ego2global'):
        tiny.model.predict_streaming_batch(stack_batches([f0, f0]), state,
                                           chunk=2)
    with pytest.raises(AssertionError):
        tiny.jmodel.apply({}, to_jax(f0), to_jax(state),
                          method=JFusionOcc.predict_streaming)
    two = FusionOcc(dataclasses.replace(tiny.tc, num_adj=2), device='cpu')
    with pytest.raises(ValueError, match='one adjacent frame'):
        two.predict_streaming(tiny.frames[0], two.init_streaming_state(1))
    with pytest.raises(AssertionError, match='one adjacent frame'):
        JFusionOcc(dataclasses.replace(tiny.jc, num_adj=2)).apply(
            {}, to_jax(tiny.frames[0]), to_jax(state),
            method=JFusionOcc.predict_streaming)
