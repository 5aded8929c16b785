"""BEVStereo4D-Occ (``models/bevstereo_occ.py``) against the benchmark's
plain reference (``benchmark/reference/bevstereo_occ.py``), in fp32 on the
CPU at a tiny size (tiny Swin, 8 depth bins, a 20x20x4 grid).

Both sides load the same seeded weights (the reference's
``make_weights``).  Two-pass ``predict``'s logits agree within relative L2
1e-5 over three frames of a drive, and with moved, augmented cameras;
the cost volume, its invalid bias included, agrees within 1e-5 under a
moved camera; the sweep op's CPU path is the plain sweep on
``stereo_grid`` bit for bit, and ``csrc/plane_sweep.cu``'s projection,
sampling, bias and softmax written out in PyTorch reproduce the grid and
the plain sweep; planted faults change the volume; ``CostVolume`` keeps
its positional contract; Swin's stage-0-only pass equals the first output of a full
pass with ``return_stereo_feat``; the model's state dict carries BEVDet's
names; a traced predict shows the stereo spans and no host wait beyond
the pooling index built in the call; ``configs.build_model`` builds the
preset's class, which has no streaming entry point and no ``batch_frames``
fold.
"""
import dataclasses
import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (os.path.join(REPO, 'benchmark'), REPO):
    if p not in sys.path:
        sys.path.insert(0, p)

from fusionocc_tpu_torch import configs  # noqa: E402
from fusionocc_tpu_torch.config import tiny_model_config  # noqa: E402
from fusionocc_tpu_torch.models import bevstereo_occ as bs  # noqa: E402
from fusionocc_tpu_torch.models.fusion_occ import (  # noqa: E402
    Batch, FusionOcc, frame_pooling_index)
from fusionocc_tpu_torch.ops import plane_sweep as ps  # noqa: E402
from fusionocc_tpu_torch.utils import profiling  # noqa: E402
from fusionocc_tpu_torch.weights import (  # noqa: E402
    bevstereo_depth_net_names)
from harness import inputs, program, spec  # noqa: E402
from reference import bevstereo_occ as ref_bs  # noqa: E402
from reference.fusion_occ import Batch as RefBatch  # noqa: E402
from reference.weights import make_weights  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

SEED = 2 ** 31 + 77
INDEX_WAITS = ['frustum.copy', 'frustum.inverse', 'frustum.inverse',
               'pooling_index.constant', 'pooling_index.constant',
               'long_runs']


def tiny_cfg():
    """The preset's structure at the tiny size: no LiDAR, a 32-wide neck
    and depth net, trunk (1, 2, 4), float32."""
    m = tiny_model_config(use_lidar=False, lidar_out_channels=0,
                          bev_num_layer=(1, 2, 4))
    return dataclasses.replace(m, vt=dataclasses.replace(
        m.vt, in_channels=32, mid_channels=32, aspp_mid_channels=8))


@pytest.fixture(scope='module')
def models():
    """(config, the port's model, the reference) with the same weights."""
    m = tiny_cfg()
    rc = program.reference_config({'model': spec.as_json(m), 'optim': {},
                                   'batch_size': 1}).model
    w = make_weights(ref_bs.BEVStereo4DOcc(rc, device='meta'),
                     inputs.generator(SEED, 'weights', 'cpu'), 'cpu')
    port = bs.BEVStereo4DOcc(m, device='cpu')
    ref = ref_bs.BEVStereo4DOcc(rc, device='cpu')
    program.load(port, w)
    program.load(ref, w)
    return m, port, ref


def moved(fields, seed=0):
    """The fields with every camera of every frame turned and shifted a
    little, and an image augmentation (rotation, scale, shift)."""
    g = torch.Generator().manual_seed(seed)
    s2k = fields['sensor2keyego'].clone()
    B, F_, N = s2k.shape[:3]
    a = 0.05 * (torch.rand(B, F_, N, generator=g) - 0.5)
    rot = torch.eye(4).repeat(B, F_, N, 1, 1)
    rot[..., 0, 0], rot[..., 0, 2] = a.cos(), a.sin()
    rot[..., 2, 0], rot[..., 2, 2] = -a.sin(), a.cos()
    rot[..., :3, 3] = 0.2 * (torch.rand(B, F_, N, 3, generator=g) - 0.5)
    post_rots = fields['post_rots'].clone()
    post_rots[..., 0, 0] = post_rots[..., 1, 1] = 0.9
    post_rots[..., 0, 1], post_rots[..., 1, 0] = 0.03, -0.03
    post_trans = fields['post_trans'].clone()
    post_trans[..., 0], post_trans[..., 1] = 3.0, -2.0
    return dict(fields, sensor2keyego=s2k @ rot, post_rots=post_rots,
                post_trans=post_trans)


@pytest.mark.parametrize('cameras', ['rig', 'moved'])
def test_predict_logits_match_the_reference(models, cameras):
    m, port, ref = models
    scene = inputs.make_scene(m, 4, SEED, 'cpu')
    f = inputs.frame_fields(m, scene, 3, [2, 1])
    if cameras == 'moved':
        f = moved(f)
    with torch.inference_mode():
        got = port._outputs(Batch(**f))['occ_logits']
        want = ref(RefBatch(**f))['occ_logits']
        rel = float((got - want).norm() / want.norm())
        assert rel < 1e-5
        pred = port.predict(Batch(**f))
    assert pred.dtype == torch.uint8 and pred.shape == want.shape[:4]
    assert torch.equal(pred, got.argmax(-1).to(torch.uint8))
    assert pred.unique().numel() > 1


@pytest.fixture(scope='module')
def sweep_case(models):
    """Stage-0 features of two frames and the cameras of a moved drive
    at the tiny size: (curr, prev, k2s, (intrins, post_rots, post_trans),
    their ``sweep_geometry``)."""
    m, port, _ = models
    scene = inputs.make_scene(m, 4, SEED, 'cpu')
    f = moved(inputs.frame_fields(m, scene, 3, [2, 1]), seed=1)
    B, N = 1, m.num_cams
    H, W = m.input_size
    g = torch.Generator().manual_seed(3)
    curr = torch.randn(B * N, H // 4, W // 4, m.swin.embed_dims, generator=g)
    prev = torch.randn(B * N, H // 4, W // 4, m.swin.embed_dims, generator=g)
    s2k = f['sensor2keyego']
    k2s = (torch.linalg.inv(s2k[:, 1].double()) @ s2k[:, 0].double()).float()
    args = (f['intrins'][:, 0], f['post_rots'][:, 0], f['post_trans'][:, 0])
    geometry = ps.sweep_geometry(port.img_view_transformer.cv_frustum, k2s,
                                 *args, H, W)
    return curr, prev, k2s, args, geometry


def test_cost_volume_matches_the_reference_under_a_moved_camera(
        models, sweep_case):
    m, port, _ = models
    curr, prev, k2s, args, geometry = sweep_case
    H, W = m.input_size
    vt = port.img_view_transformer
    got = vt.cost_volume(curr, prev, geometry)
    want = ref_bs.cost_volume(m, curr, prev, k2s, *args)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # the bias acts: samples off the previous image and inside it both occur
    grid = ps.stereo_grid(vt.cv_frustum, k2s, *args, H, W)
    invalid = grid.abs().amax(-1) > 1
    assert 0 < int(invalid.sum()) < invalid.numel()
    unbiased = bs.CostVolume(vt.cost_volume.depth_bins,
                             vt.cost_volume.group_size, 0.0)
    assert not torch.allclose(got, unbiased(curr, prev, geometry), rtol=1e-3,
                              atol=1e-3)


def test_the_sweep_op_on_the_cpu_is_the_plain_sweep_on_stereo_grid(
        models, sweep_case):
    """``fusionocc::plane_sweep``'s CPU path equals ``plane_sweep`` on
    ``stereo_grid`` bit for bit, and passes ``opcheck`` (schema, the fake's
    shape, dispatch)."""
    m, port, _ = models
    curr, prev, k2s, args, geometry = sweep_case
    H, W = m.input_size
    vt = port.img_view_transformer
    got = ps.sweep(prev, curr, geometry, 4, 5.0)
    want = ps.plane_sweep(prev, curr,
                          ps.stereo_grid(vt.cv_frustum, k2s, *args, H, W),
                          vt.cost_volume.depth_bins, 4, 5.0)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    op_args = (prev, curr, geometry.frustum, geometry.cams, H, W, 4, 5.0)
    torch.library.opcheck(ps.plane_sweep_op, op_args, test_utils=(
        'test_schema', 'test_faketensor', 'test_aot_dispatch_static'))
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode() as mode:
        fake = ps.plane_sweep_op(*(mode.from_tensor(a) if isinstance(
            a, torch.Tensor) else a for a in op_args))
    assert fake.shape == want.shape and fake.dtype == torch.float32


def fma(a, b, c):
    """a·b + c rounded once to float32 (the fp32 product is exact in
    float64)."""
    return (a.double() * b.double() + c.double()).float()


def kernel_order_grid(geom):
    """``stereo_grid`` point by point in ``csrc/plane_sweep.cu``'s order
    (``project``): the frustum's three axes, the per-camera pieces, each
    product of a piece an fma chain from its first term, float32; (B*N, D,
    H, W) x and y."""
    fr, cams = geom.frustum, geom.cams
    D, H, W, _ = fr.shape
    u = fr[0, 0, :, 0][None, None, None, :]
    v = fr[0, :, 0, 1][None, None, :, None]
    dz = fr[:, 0, 0, 2][None, :, None, None]

    def w(i):
        return cams[:, i][:, None, None, None]

    def dot3(at, a, b, c):
        return fma(w(at + 2), c, fma(w(at + 1), b, w(at) * a))

    p = (u - w(0), v - w(1), dz - w(2))
    q = [dot3(3 + 3 * i, *p) for i in range(3)]
    r = (q[0] * q[2], q[1] * q[2], q[2])
    s = [dot3(12 + 3 * i, *r) + w(21 + i) for i in range(3)]
    t = [dot3(24 + 3 * i, *s) for i in range(3)]
    z = torch.clamp_min(t[2], 1e-6)
    a0, a1 = t[0] / z, t[1] / z
    b0 = fma(w(34), a1, w(33) * a0) + w(0)
    b1 = fma(w(36), a1, w(35) * a0) + w(1)
    behind = s[2] < 1e-3
    px = torch.where(behind, -2.0, b0 / (geom.wi - 1.0) * 2.0 - 1.0)
    py = torch.where(behind, -2.0, b1 / (geom.hi - 1.0) * 2.0 - 1.0)
    return px, py


def kernel_model(prev, curr, geom, group_size, bias):
    """The kernel's algorithm in plain float32 torch: the kernel-order
    grid, grid_sample's unnormalisation, taps, weights and zeros outside
    written out (a coordinate outside (-1, size) samples 0), the cost over
    all channels, the bias where the sample of the last group's first
    channel is exactly 0, the softmax over the planes.  Returns the volume
    and the bias mask."""
    BN, H, W, C = curr.shape
    px, py = kernel_order_grid(geom)
    ix = (px + 1) / 2 * (W - 1)
    iy = (py + 1) / 2 * (H - 1)
    inside = (ix > -1) & (ix < W) & (iy > -1) & (iy < H)
    fx, fy = torch.floor(ix), torch.floor(iy)
    ex, ey, gx, gy = fx + 1 - ix, fy + 1 - iy, ix - fx, iy - fy
    sample = 0
    for dx, dy, wt in ((0, 0, ex * ey), (1, 0, gx * ey), (0, 1, ex * gy),
                       (1, 1, gx * gy)):
        xx, yy = fx.long() + dx, fy.long() + dy
        ok = inside & (xx >= 0) & (xx < W) & (yy >= 0) & (yy < H)
        rows = (torch.arange(BN)[:, None, None, None] * H
                + yy.clamp(0, H - 1)) * W + xx.clamp(0, W - 1)
        tap = prev.reshape(-1, C).float()[rows] * ok[..., None]
        sample = sample + tap * wt[..., None]
    cost = (curr.float()[:, None] - sample).abs().sum(-1)
    zero = sample[..., (C - 1) // group_size * group_size] == 0
    cost = cost + bias * zero
    return torch.softmax(-cost, dim=1), zero


def test_the_kernels_projection_and_sampling_reproduce_the_plain_sweep(
        models, sweep_case):
    """The per-camera geometry with a plain per-point projection in the
    kernel's order gives ``stereo_grid`` within 1e-6 (relative where the
    point is far off the image; equal on a CPU whose einsums
    are fma chains in that order), and the kernel's sampling, bias and
    softmax written out give the plain sweep within 1e-5 (sums in another
    order) with the same bias mask."""
    m, port, _ = models
    curr, prev, k2s, args, geom = sweep_case
    H, W = m.input_size
    vt = port.img_view_transformer
    D, h, w, _ = geom.frustum.shape
    want = ps.stereo_grid(vt.cv_frustum, k2s, *args, H, W).reshape(
        -1, D, h, w, 2)
    got = torch.stack(kernel_order_grid(geom), -1)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    grid = want.reshape(-1, D * h, w, 2)
    plain = ps.plane_sweep(prev, curr, grid, D, 4, 5.0)
    vol, zero = kernel_model(prev, curr, geom, 4, 5.0)
    torch.testing.assert_close(vol, plain, rtol=1e-5, atol=1e-5)
    warp = ps.grid_sample_2d(prev[..., -4:].permute(0, 3, 1, 2), grid)
    assert torch.equal(zero, warp[:, 0].reshape(zero.shape) == 0)
    assert 0 < int(zero.sum()) < zero.numel()


@pytest.mark.parametrize('fault', ['bias dropped', 'prev is curr'])
def test_a_planted_fault_changes_the_volume(models, sweep_case, fault):
    _, port, _ = models
    curr, prev, _, _, geometry = sweep_case
    cv = port.img_view_transformer.cost_volume
    sound = cv(curr, prev, geometry)
    if fault == 'bias dropped':
        broken = bs.CostVolume(cv.depth_bins, cv.group_size, 0.0)(
            curr, prev, geometry)
    else:
        broken = cv(curr, curr, geometry)
    assert (broken - sound).abs().max() > 1e-2


def test_cost_volume_keeps_its_positional_contract(models, sweep_case):
    """``CostVolume.forward(curr, prev, geometry)``: three positional
    arguments, ``curr`` first (the FLOP count and the benchmark's forward
    hooks read ``args[0]``), then ``prev``."""
    import inspect
    _, port, _ = models
    cv = port.img_view_transformer.cost_volume
    assert list(inspect.signature(cv.forward).parameters) == [
        'curr', 'prev', 'geometry']
    curr, prev, _, _, geometry = sweep_case
    seen = []
    hook = cv.register_forward_hook(lambda mod, a, out: seen.append(a))
    try:
        out = cv(curr, prev, geometry)
    finally:
        hook.remove()
    assert len(seen) == 1 and len(seen[0]) == 3
    assert seen[0][0] is curr and seen[0][1] is prev
    assert out.shape == (curr.shape[0], cv.depth_bins) + curr.shape[1:3]


def test_stage0_pass_equals_the_full_pass_first_output(models):
    m, port, _ = models
    x = torch.rand(2, *m.input_size, 3,
                   generator=torch.Generator().manual_seed(5))
    with torch.inference_mode():
        full = port.img_backbone(x)
        alone = port.img_backbone.stereo_feat(x)
    assert m.swin.return_stereo_feat and len(full) == 3
    assert torch.equal(alone, full[0])


def test_state_dict_has_bevdet_names(models):
    m, port, _ = models
    keys = list(port.state_dict())
    vt = [k for k in keys if k.startswith('img_view_transformer.')]
    assert vt == ['img_view_transformer.depth_net.' + n
                  for n in bevstereo_depth_net_names()]
    # the shared modules are named as FusionOcc's
    fo = FusionOcc(m, device='meta')
    assert [k for k in keys if k not in vt] == [
        k for k in fo.state_dict()
        if not k.startswith('img_view_transformer.')]
    assert 'img_view_transformer.depth_net.cost_volumn_net.2.bias' in keys


def test_the_preset_builds_the_stereo_model_at_published_widths():
    cfg = configs.get_config('bevdet_occ_stbase_stereo').model
    other = configs.build_model('fusion_occ_image_only', device='meta')
    assert type(other) is FusionOcc and other.input_frames == 2
    model = configs.build_model('bevdet_occ_stbase_stereo', device='meta')
    assert type(model) is bs.BEVStereo4DOcc and model.input_frames == 3
    assert (cfg.fusion_channels, cfg.occ_channels, cfg.bev_channels) == (
        64, 32, (32, 64, 128))
    dn = model.img_view_transformer.depth_net
    assert dn.reduce_conv[0].weight.shape == (512, 512, 3, 3)
    assert dn.depth_conv[0].downsample.weight.shape == (512, 600, 1, 1)
    assert dn.cost_volumn_net[0].weight.shape == (88, 88, 3, 3)
    assert model.img_view_transformer.cv_frustum.shape == (88, 128, 352, 3)
    assert sum(p.numel() for p in model.parameters()) == 121278120
    with pytest.raises(NotImplementedError):
        bs.BEVStereo4DOcc(dataclasses.replace(cfg, use_lidar=True),
                          device='meta')


def test_traced_predict_has_the_stereo_spans_and_no_new_wait(models):
    m, port, _ = models
    scene = inputs.make_scene(m, 4, SEED, 'cpu')
    b = Batch(**inputs.frame_fields(m, scene, 3, [2, 1]))
    idx = frame_pooling_index(m, b.sensor2keyego[:, 0], b.intrins[:, 0],
                              b.post_rots[:, 0], b.post_trans[:, 0], b.bda)
    with profiling.tracing() as tr:
        port.predict(b, pool_idxs=[idx, None])
    rec = tr.collect()
    names = [s['name'] for s in rec['spans']]
    by_id = {s['id']: s for s in rec['spans']}
    for n in ('camera.stereo_ref', 'camera.stereo', 'camera.stereo.grid',
              'camera.stereo.cost_volume', 'camera.depth_net'):
        assert n in names, n
    assert names.count('camera.stereo.cost_volume') == 2
    assert names.count('camera.stereo_ref') == 1
    for s in rec['spans']:
        if s['name'].startswith('camera.stereo.'):
            assert by_id[s['parent']]['name'] == 'camera.stereo'
        if s['name'] == 'camera.depth_net':
            assert by_id[s['parent']]['name'] == 'camera.view_transformer'
    where = [(w['site'], by_id[w['span']]['name']) for w in rec['waits']]
    assert where == [(w, 'camera.pooling_index') for w in INDEX_WAITS]


def test_streaming_and_frame_folds_are_refused(models):
    """The stereo model is FusionOcc's sibling, not its subclass: it has no
    streaming entry point, its ``predict`` takes no ``batch_frames`` fold,
    and the evaluation tool refuses both modes for its preset."""
    from tools import test_torch
    m, port, _ = models
    assert not isinstance(port, FusionOcc)
    for name in ('predict_streaming', 'predict_streaming_scan',
                 'predict_streaming_batch', 'init_streaming_state'):
        assert not hasattr(port, name), name
    scene = inputs.make_scene(m, 4, SEED, 'cpu')
    b = Batch(**inputs.frame_fields(m, scene, 3, [2, 1]))
    with pytest.raises(TypeError, match='batch_frames'):
        port.predict(b, batch_frames=True)
    for mode in ('--streaming', '--batch-frames'):
        with pytest.raises(SystemExit):
            test_torch.parse_args(['--config', 'bevdet_occ_stbase_stereo',
                                   '--synthetic', mode])
