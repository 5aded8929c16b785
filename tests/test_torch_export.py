"""The kernels as ``torch.library`` custom ops and the serving export
(``tools/export_torch.py``), on the CPU at tiny size.

- Each op (``fusionocc::bev_pool``, ``window_attn``, ``zwin_conv``,
  ``zwin_conv_epi``, Swin's glue ``window_in``, with and without the
  previous block's residual, and ``window_out``) passes ``torch.library.opcheck`` (schema, fake
  implementation, dispatch) on CPU inputs of its main-path contract, and
  equals its plain version.
- While ``torch.export`` traces, the index builds take their static
  capacities and ``long_runs`` its static, -1-padded table; the rows they
  add are masked, so the results equal the eager ones.
- The export round trip: ``torch.export`` of the two-pass predict, of the
  streaming step (``StreamingState`` in and out), of the predict with
  ``lidar.zwin_fuse=True`` (K3's fused epilogue traced as its op) and of
  the ``--int8-weights`` predict; the saved and loaded program's output
  equals eager's exactly, and its graph calls each kernel's op as often as
  the eager path launches it, the three index-build ops of each sparse
  stage (``ops/sparse_conv.py``) included.
"""
import collections
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from fusionocc_tpu_torch.data.synthetic import synthetic_batch  # noqa: E402
from fusionocc_tpu_torch.models.fusion_occ import (  # noqa: E402
    FusionOcc, frame_pooling_index, init_weights)
from fusionocc_tpu_torch.ops import bev_pool as bp  # noqa: E402
from fusionocc_tpu_torch.ops import kernels  # noqa: E402
from fusionocc_tpu_torch.ops import swin_glue as sg  # noqa: E402
from fusionocc_tpu_torch.ops import voxelize  # noqa: E402
from fusionocc_tpu_torch.ops import window_attn as wa  # noqa: E402
from fusionocc_tpu_torch.ops import zwin_conv as zw  # noqa: E402
from tools import export_torch as et  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401


def _tiny(**lidar):
    cfg = et.model_config(tiny=True, fp32=False)
    return dataclasses.replace(cfg, lidar=dataclasses.replace(cfg.lidar,
                                                              **lidar))


def _pool_args():
    cfg = _tiny()
    b = synthetic_batch(cfg, 1, 0, num_points=64, device='cpu')
    idx = frame_pooling_index(cfg, b.sensor2keyego[:, 0], b.intrins[:, 0],
                              b.post_rots[:, 0], b.post_trans[:, 0], b.bda)
    rng = np.random.RandomState(0)
    P = idx.ranks_depth.numel()
    rows = int(idx.ranks_feat.max()) + 1
    depth = torch.from_numpy(rng.rand(P).astype(np.float32))
    feat = torch.from_numpy(rng.randn(rows, 8).astype(np.float32))
    gx, gy, gz = cfg.grid.grid_size
    return depth, feat, idx, gx * gy * gz


def _zwin_args(rng, epi=False):
    B, S, f, cin, cout = 2, 12, 2, 4, 4
    feats = torch.from_numpy(rng.randn(B, S, f * cin).astype(np.float32))
    nbr = torch.from_numpy(rng.randint(0, S + 1, (B, S, 27)).astype(np.int32))
    mask = torch.from_numpy(rng.rand(B, S) > 0.2)
    weight = torch.from_numpy(rng.randn(27, cin, cout).astype(np.float32))
    args = (feats, mask, nbr, weight, f, f, 1)
    if epi:
        args += (torch.from_numpy(rng.rand(f * cout).astype(np.float32)),
                 torch.from_numpy(rng.randn(f * cout).astype(np.float32)),
                 torch.from_numpy(rng.rand(B, S, f) > 0.3))
    return args


def _op_cases():
    rng = np.random.RandomState(1)
    depth, feat, idx, nvox = _pool_args()
    q, k, v = (torch.from_numpy(rng.randn(8, 16, 16).astype(np.float32))
               for _ in range(3))
    bias = torch.from_numpy(rng.randn(2, 16, 16).astype(np.float32))
    # Swin's glue on a 6x7 map of 2 images in windows of 4: padded on both
    # axes, shifted by 2
    x, r = (torch.from_numpy(rng.randn(2, 42, 8).astype(np.float32))
            for _ in range(2))
    norm = tuple(torch.from_numpy(rng.randn(8).astype(np.float32))
                 for _ in range(2))
    o = torch.from_numpy(rng.randn(2 * 2 * 2, 16, 8).astype(np.float32))
    geom = (1e-6, 6, 7, 4, 2)
    return {
        'bev_pool': (bp.bev_pool_op,
                     (depth, feat, idx.ranks_depth, idx.ranks_feat,
                      idx.ranks_bev, idx.bounds, idx.long_voxels, nvox,
                      idx.max_short, torch.bfloat16),
                     lambda *_: bp.bev_pool_plain(depth, feat, idx, nvox).to(
                         torch.bfloat16)),
        'window_attn': (wa.window_attn_op, (q, k, v, bias, 2, 2, 4, 2, 2),
                        wa.window_attention_plain),
        'zwin_conv': (zw.zwin_conv_op, _zwin_args(rng), zw.zwin_conv_plain),
        'zwin_conv_epi': (zw.zwin_conv_epi_op, _zwin_args(rng, epi=True),
                          zw.zwin_conv_epi_plain),
        'window_in': (sg.window_in_op, (x, r, *norm, *geom),
                      sg.window_in_plain),
        'window_in_first': (sg.window_in_op, (x, None, *norm, *geom),
                            lambda *a: (x.new_empty(0),
                                        sg.window_in_plain(*a)[1])),
        'window_out': (sg.window_out_op, (o, x, *norm, *geom),
                       sg.window_out_plain),
    }


@pytest.mark.parametrize('name', ['bev_pool', 'window_attn', 'zwin_conv',
                                  'zwin_conv_epi', 'window_in',
                                  'window_in_first', 'window_out'])
def test_kernel_op_registration(name):
    op, args, plain = _op_cases()[name]
    torch.library.opcheck(op, args, test_utils=(
        'test_schema', 'test_faketensor', 'test_aot_dispatch_static'))
    got, want = op(*args), plain(*args)
    if isinstance(want, torch.Tensor):
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_static_widths_while_exporting(monkeypatch):
    """``padded_width`` gives the capacity and ``long_runs`` a table of its
    static length (the eager table, then -1s) while tracing."""
    n = torch.tensor([3, 5])
    assert voxelize.padded_width(n, 16) == 5
    bounds = torch.tensor([0, 20, 21, 61, 61, 100], dtype=torch.int32)
    eager = bp.long_runs(bounds, 16, num_points=100)
    for module in (voxelize, bp):
        monkeypatch.setattr(module, 'exporting', lambda: True)
    assert voxelize.padded_width(n, 16) == 16
    static = bp.long_runs(bounds, 16, num_points=100)
    assert static.shape == (100 // 17,)
    assert static[:len(eager)].tolist() == eager.tolist() == [2, 4, 0]
    assert static[len(eager):].tolist() == [-1] * (5 - len(eager))


def _ops_in(program) -> dict:
    counts = collections.Counter(str(n.target).split('.')[1]
                                 for n in program.graph.nodes
                                 if str(n.target).startswith('fusionocc.'))
    return dict(counts)


@pytest.mark.parametrize('mode', ['two-pass', 'streaming', 'zwin_fuse',
                                  'int8-weights'])
def test_export_round_trip_equals_eager(mode, tmp_path):
    cfg = _tiny(zwin_fuse=mode == 'zwin_fuse')
    model = init_weights(FusionOcc(cfg, device='cpu'),
                         torch.Generator().manual_seed(0))
    if mode == 'int8-weights':
        from fusionocc_tpu_torch.quant import load_int8_weights
        load_int8_weights(model, cfg)
    batch = synthetic_batch(cfg, 1, 0, num_points=512, device='cpu')
    state = model.init_streaming_state(1) if mode == 'streaming' else None
    program = et.export_program(model, batch, state)
    camera = 1 if state is not None else cfg.num_frame
    zwin = sum(map(len, cfg.lidar.encoder_channels[:3]))
    # each sparse stage's index builds: the candidates, the set at the
    # static width, one table group's maps (the tiny tables are small)
    blocks = sum(cfg.swin.depths) * camera
    assert _ops_in(program) == {
        'window_attn': blocks, 'window_in': blocks, 'window_out': blocks,
        'bev_pool': camera,
        'zwin_conv_epi' if cfg.lidar.zwin_fuse else 'zwin_conv': zwin,
        'stride2_count': 3, 'stride2_set': 3, 'stage_maps': 3}
    path = str(tmp_path / 'program.pt2')
    torch.export.save(program, path)
    got = et.run_loaded(path, batch, state)
    want = et.eager(model, batch, state)
    if state is None:
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_export_tool_verifies(tmp_path, capsys):
    info = et.main(['--tiny', '--device', 'cpu', '--streaming', '--verify',
                    '--out', str(tmp_path / 'stream.pt2')])
    assert info['verified'] and info['bytes'] == os.path.getsize(
        tmp_path / 'stream.pt2')
    assert 'verify: roundtrip output matches' in capsys.readouterr().out


def test_exporting_is_false_outside_a_trace():
    assert kernels.exporting() is False
