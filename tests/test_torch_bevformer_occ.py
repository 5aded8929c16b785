"""BEVFormer-Occ (``models/bevformer_occ.py``) against the benchmark's
plain reference (``benchmark/reference/bevformer_occ.py``) on the CPU at a
tiny size (``tiny_bevformer_config``: one Bottleneck a stage but two in the
third, DCN in the last two stages, width 32, 4 heads; 6 cameras at 56x96
over the tiny 20x20x4 grid).

Both sides load the same seeded weights (the cell driver's
``seeded_weights``).  In float32 the sampling (``ms_deform_attn``), DCNv2,
a one-layer encoder's frame and a 3-frame stream with a reset at frame 2
agree within relative L2 1e-5: the port samples through ``grid_sample``
and re-batches spatial cross-attention per camera, the reference writes
the bilinear taps out and sums every camera densely, so only float32's
reassociation separates them.  In bfloat16 the port's logits stay within
0.04 of the float32 reference's (relative L2; 0.012-0.020 measured over
the three frames, the bfloat16 reference's own 0.012-0.021), which the
bfloat16 reference with fp8 products does not meet (0.139-0.208): the
tolerance lies between the configuration's precision and the one below
it, with about twice the room on either side.  The rig's re-batch
equals the dense camera mask; a traced frame shows the model's spans, one
host wait (the re-batch's) where the index is built in the call and none
once it is cached; ``configs.build_model`` builds the published widths.
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
from fusionocc_tpu_torch.config import (OptimConfig,  # noqa: E402
                                        tiny_bevformer_config,
                                        tiny_model_config)
from fusionocc_tpu_torch.models import bevformer_occ as bf  # noqa: E402
from fusionocc_tpu_torch.models.fusion_occ import Batch  # noqa: E402
from fusionocc_tpu_torch.nn.resnet import ModulatedDeformConv2d  # noqa: E402
from fusionocc_tpu_torch.ops.ms_deform_attn import (  # noqa: E402
    ms_deform_attn)
from fusionocc_tpu_torch.utils import profiling  # noqa: E402
from harness import inputs, program, spec  # noqa: E402
from reference import bevformer_occ as ref_bf  # noqa: E402
from reference.fusion_occ import Batch as RefBatch  # noqa: E402
from reference.layers import fp8_products  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

SEED = 2 ** 31 + 91
driver = spec.load_module(spec.driver_path('stream_temporal'),
                          'driver_stream_temporal')
SPANS = {'camera.backbone', 'camera.neck', 'bev.encoder', 'bev.tsa',
         'bev.sca', 'bev.ffn', 'bev.sca.rebatch', 'stream.rotate', 'head'}


def rel(a, b):
    return float((a.detach().float() - b.detach().float()).norm()
                 / b.detach().float().norm())


def conf(dtype='float32', **bev):
    m = tiny_model_config(use_lidar=False, lidar_out_channels=0,
                          input_size=(56, 96), num_cams=6,
                          compute_dtype=dtype)
    return {'model': spec.as_json(m),
            'bevformer': spec.as_json(tiny_bevformer_config(**bev)),
            'optim': spec.as_json(OptimConfig()), 'batch_size': 1}


def port(c):
    cfg = program.port_config(c).model
    bev = spec.build_dataclass(type(tiny_bevformer_config()), c['bevformer'])
    model = bf.BEVFormerOcc(cfg, 'cpu', bev)
    program.load(model, driver.seeded_weights(
        program.reference_config(c).model, driver.reference_bev(c), SEED,
        'cpu'))
    return model


@pytest.fixture(scope='module')
def scene():
    m = program.port_config(conf()).model
    s = inputs.make_scene(m, 3, SEED, 'cpu')
    return [inputs.frame_fields(m, s, t, []) for t in range(3)]


@pytest.fixture(scope='module')
def ref32():
    return driver.reference_model(conf(), SEED, 'cpu')[1]


def reference_chain(ref, fields, resets=(0, 2)):
    out, prev = [], None
    for t, f in enumerate(fields):
        b = RefBatch(**f)
        logits, bev = ref.frame(b, None if t in resets else prev)
        prev = (bev, b.ego2global.float())
        out.append((logits, bev))
    return out


def port_chain(model, fields, resets=(0, 2)):
    state = model.init_streaming_state(1)
    rig = model.rig_index(Batch(**fields[0]))
    out = []
    for t, f in enumerate(fields):
        reset = torch.tensor([t in resets])
        _, o, state = model.predict_streaming(Batch(**f), state, rig, reset)
        out.append((o['occ_logits'], state.prev_bev))
    return out


def test_ms_deform_attn_matches_the_plain_formula():
    g = torch.Generator().manual_seed(0)
    shapes = [(5, 7), (3, 4)]
    value = torch.randn(2, 47, 2, 4, generator=g)
    loc = torch.rand(2, 11, 2, 2, 3, 2, generator=g) * 1.4 - 0.2
    w = torch.rand(2, 11, 2, 2, 3, generator=g)
    got = ms_deform_attn(value, shapes, loc, w)
    want = ref_bf._msda(value, shapes, loc, w)
    assert rel(got, want) < 1e-6


def test_dcnv2_matches_the_plain_formula():
    g = torch.Generator().manual_seed(1)
    ours, theirs = ModulatedDeformConv2d(6, 5), ref_bf.DeformConv2d(6, 5)
    sd = {'weight': torch.randn(5, 6, 3, 3, generator=g),
          'conv_offset.weight': torch.randn(27, 6, 3, 3, generator=g) * 0.4,
          'conv_offset.bias': torch.randn(27, generator=g)}
    ours.load_state_dict(sd)
    theirs.load_state_dict(sd)
    x = torch.randn(2, 6, 7, 9, generator=g)
    assert ours.conv_offset(x)[:, :18].abs().max() > 3   # taps leave the map
    assert rel(ours(x), theirs(x)) < 1e-5


def test_one_encoder_layer_frame_matches_the_reference(scene):
    c = conf(num_layers=1)
    ref = driver.reference_model(c, SEED, 'cpu')[1]
    (want, wbev), = reference_chain(ref, scene[:1])
    (got, gbev), = port_chain(port(c), scene[:1])
    assert rel(got, want) < 1e-5 and rel(gbev, wbev) < 1e-5


def test_a_stream_with_a_reset_matches_the_reference(scene, ref32):
    """Frame 1 runs on frame 0's rotated BEV; frame 2 is reset."""
    want = reference_chain(ref32, scene)
    got = port_chain(port(conf()), scene)
    for (gl, gb), (wl, wb) in zip(got, want):
        assert rel(gl, wl) < 1e-5 and rel(gb, wb) < 1e-5
    assert rel(got[1][0], got[2][0]) > 1e-2      # the history counts


def test_bfloat16_is_within_what_fp8_products_miss(scene, ref32):
    want = [x[0] for x in reference_chain(ref32, scene)]
    got = [x[0] for x in port_chain(port(conf('bfloat16')), scene)]
    ref16 = driver.reference_model(conf(), SEED, 'cpu', 'bfloat16')[1]
    with fp8_products():
        fp8 = [x[0] for x in reference_chain(ref16, scene)]
    err = max(rel(a, b) for a, b in zip(got, want))
    err8 = max(rel(a, b) for a, b in zip(fp8, want))
    assert err < 0.04 < err8, (err, err8)


def test_the_rig_index_is_the_dense_camera_mask(scene):
    model = port(conf())
    b = Batch(**scene[0])
    rig = model.rig_index(b)
    xy, mask = ref_bf.point_sampling(
        model.cfg, ref_bf.BEVFormerConfig(), b.sensor2keyego[:, 0],
        b.intrins[:, 0], b.post_rots[:, 0], b.post_trans[:, 0])
    seen = mask[0].any(-1)                                   # (N, Q)
    Q = seen.shape[1]
    for n in range(seen.shape[0]):
        idx = rig.query_idx[n]
        assert torch.equal(idx[idx < Q], seen[n].nonzero()[:, 0])
        assert torch.allclose(rig.ref_cam[n][idx < Q], xy[0, n][seen[n]],
                              atol=1e-5)
    assert torch.equal(rig.count, seen.sum(0).clamp(min=1).float())


def test_a_traced_frame_shows_the_spans_and_waits_once(scene):
    model = port(conf())
    b = Batch(**scene[0])
    state = model.init_streaming_state(1)
    with profiling.tracing() as tr:
        _, _, state = model.predict_streaming(b, state)
    rec = tr.collect()
    names = {s['name'] for s in rec['spans']}
    assert SPANS <= names, SPANS - names
    by_id = {s['id']: s['name'] for s in rec['spans']}
    assert [(w['site'], by_id[w['span']]) for w in rec['waits']] == [
        ('sca.rebatch', 'bev.sca.rebatch')]
    rig = model.rig_index(b)
    with profiling.tracing() as tr:
        model.predict_streaming(Batch(**scene[1]), state, rig)
    rec = tr.collect()
    assert rec['waits'] == []
    assert 'bev.sca.rebatch' not in {s['name'] for s in rec['spans']}


def test_build_model_builds_the_published_widths():
    model = configs.build_model('bevformer_base_occ', device='meta')
    assert isinstance(model, bf.BEVFormerOcc)
    assert model.shapes == [(116, 200), (58, 100), (29, 50), (15, 25)]
    assert model.img_hw == (928, 1600)
    assert sum(isinstance(m, ModulatedDeformConv2d)
               for m in model.modules()) == 26
    assert len(model.encoder.layers) == 6
    assert model.embeds.bev_queries.shape == (40000, 256)
    cfg = configs.get_config('bevformer_base_occ').model
    shell = ref_bf.BEVFormerOcc(dataclasses.replace(
        program.reference_config({'model': spec.as_json(cfg),
                                  'optim': {}, 'batch_size': 1}).model),
        device='meta')
    assert list(model.state_dict()) == list(shell.state_dict())
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(p.numel() for p in shell.parameters())
