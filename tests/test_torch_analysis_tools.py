"""The port's FLOP count (``utils/flops.py``), ``tools/get_flops_torch.py``
and ``tools/density_sweep_torch.py``, on the CPU at tiny size.

- Each kernel op's formula, counted by ``FlopCounterMode``, against a
  count made here another way: K2 as torch counts the two einsums of
  attention; K1 as the points whose voxel lies in the grid; K3 (and with
  its fused epilogue) by walking the plain contract (``ops/zwin_conv.py``'s
  docstring) over every active row, found tap, out cell and dz.
- No double count: an op's count is its formula alone (the plain version
  that implements it on the CPU adds nothing), and a forward and backward
  through ``ZwinConv`` counts the formula plus ``zwin_conv_bwd``'s aten
  products once.
- The port's two-pass ``predict`` outside the kernels against the products
  of JAX's ``predict``: 2 per multiply-add of every ``dot_general`` and
  ``conv_general_dilated`` of ``jax.make_jaxpr``, through nested jaxprs
  but not into a ``pallas_call`` (JAX's config on the kernels' paths,
  fused attention and zwin, so that the same work sits in the pallas_calls
  as in the port's ops).  They agree to 1e-6 relative once the products
  that differ by design are taken out, each named and pinned below: three
  JAX-only products (the third the strided lane masks' 0/1 gather-GEMM,
  which the port's index op computes as an OR of lane bits), and the
  port's encoder taken at the static widths of its export path.
- BEVStereo4D-Occ's two-pass ``predict`` counts its two plane sweeps by
  the op's formula, 10·C·BN·D·h·w each, and nothing of them outside.
- The density sweep's kept rows per cut at 1x and 2x equal, exactly, those
  of JAX's ``voxelize_mean``, ``zfold_regroup`` and ``stage_indices_table``
  (the functions ``tools/density_sweep.py:62-80`` calls) on the same cloud.
- Both tools run here with ``--tiny --device cpu`` and print their
  sections.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from fusionocc_tpu import config as jcfg
from fusionocc_tpu.data.synthetic import synthetic_batch as j_synthetic_batch
from fusionocc_tpu.models.fusion_occ import FusionOcc as JFusionOcc
from fusionocc_tpu.ops import sparse_conv as jsc
from fusionocc_tpu.ops import zfold as jzf
from fusionocc_tpu.ops.voxelize import voxelize_mean as j_voxelize_mean
from fusionocc_tpu_torch import configs
from fusionocc_tpu_torch.data.synthetic import synthetic_batch
from fusionocc_tpu_torch.models.fusion_occ import FusionOcc, init_weights
from fusionocc_tpu_torch.ops import voxelize
from fusionocc_tpu_torch.ops import window_attn as wa
from fusionocc_tpu_torch.ops import zwin_conv as zw
from fusionocc_tpu_torch.utils import flops
from tools import density_sweep_torch as ds
from tools import get_flops_torch as gf
from tools.test_torch import tiny_config

from torch_threads import one_torch_thread  # noqa: F401

REL = 1e-6


def counted_ops(run) -> dict:
    """Every op ``run()`` counts, by name."""
    return flops.counted(run)['by_op']


def zwin_args(g, stride: int, epi: bool = False):
    B, s_in, s_out, cin, cout = 2, 30, 20, 8, 4
    f_in, f_out = 4, (2 if stride == 2 else 4)
    feats = torch.randn(B, s_in, f_in * cin, generator=g)
    nbr = torch.randint(0, s_in, (B, s_out, 27), generator=g)
    nbr = torch.where(torch.rand(B, s_out, 27, generator=g) < 0.3, s_in,
                      nbr).to(torch.int32)
    mask = torch.rand(B, s_out, generator=g) > 0.2
    weight = torch.randn(27, cin, cout, generator=g)
    args = (feats, mask, nbr, weight, f_in, f_out, stride)
    if epi:
        args += (torch.rand(f_out * cout, generator=g),
                 torch.randn(f_out * cout, generator=g),
                 torch.rand(B, s_out, f_out, generator=g) > 0.3)
    return args


def contract_macs(feats, mask, nbr, weight, f_in, f_out, stride) -> int:
    """The plain contract walked: out cell zo of an active row reads, per
    tap t found in the map and dz in 0..2, the in cell r = stride*zo + dz
    - 1 when it lies in the tap's super shift t % 3, Cin·Cout
    multiply-adds each."""
    s_in = feats.shape[1]
    macs = 0
    for b, s in mask.nonzero().tolist():
        for t in range(27):
            if int(nbr[b, s, t]) >= s_in:
                continue
            for zo in range(f_out):
                for dz in range(3):
                    r = stride * zo + dz - 1
                    macs += (r // f_in + 1 == t % 3)
    return macs * weight.shape[1] * weight.shape[2]


@pytest.mark.parametrize('stride', [1, 2])
@pytest.mark.parametrize('op', ['zwin_conv', 'zwin_conv_epi'])
def test_zwin_formula_counts_the_contract(op, stride):
    args = zwin_args(torch.Generator().manual_seed(stride), stride,
                     op == 'zwin_conv_epi')
    fn = getattr(zw, f'{op}_op')
    got = counted_ops(lambda: fn(*args))
    assert got == {f'fusionocc.{op}': 2 * contract_macs(*args[:7])}


def test_window_attn_formula_counts_its_two_products():
    g = torch.Generator().manual_seed(0)
    nWh, nWw, w, heads, d = 2, 3, 4, 2, 32
    n, bn = w * w, 2 * nWh * nWw
    q, k, v = (torch.randn(bn, n, heads * d, generator=g) for _ in range(3))
    bias = torch.randn(heads, n, n, generator=g)
    got = counted_ops(lambda: wa.window_attn_op(q, k, v, bias, nWh, nWw, w,
                                                 3, heads))
    qh, kh, vh = (t.reshape(bn, n, heads, d).transpose(1, 2)
                  for t in (q, k, v))
    with FlopCounterMode(display=False) as ref:
        torch.einsum('bhnm,bhmd->bhnd',
                     torch.einsum('bhnd,bhmd->bhnm', qh, kh), vh)
    assert got == {'fusionocc.window_attn': ref.get_total_flops()}


def test_bev_pool_formula_counts_the_points_in_the_grid():
    cfg = tiny_config()
    b = synthetic_batch(cfg, 1, 0, num_points=64, device='cpu')
    from fusionocc_tpu_torch.models.fusion_occ import frame_pooling_index
    from fusionocc_tpu_torch.ops import bev_pool as bp
    idx = frame_pooling_index(cfg, b.sensor2keyego[:, 0], b.intrins[:, 0],
                              b.post_rots[:, 0], b.post_trans[:, 0], b.bda)
    gx, gy, gz = cfg.grid.grid_size
    nvox = gx * gy * gz
    h, w = cfg.feat_size
    C = cfg.vt.feature_channels
    g = torch.Generator().manual_seed(1)
    depth = torch.rand(cfg.num_cams * cfg.grid.num_depth_bins * h * w,
                       generator=g)
    feat = torch.randn(cfg.num_cams * h * w, C, generator=g)
    got = counted_ops(lambda: bp.bev_pool_op(
        depth, feat, idx.ranks_depth, idx.ranks_feat, idx.ranks_bev,
        idx.bounds, idx.long_voxels, nvox, idx.max_short, torch.float32))
    in_grid = int((idx.ranks_bev < nvox).sum())
    assert 0 < in_grid < idx.ranks_bev.numel()
    assert got == {'fusionocc.bev_pool': 2 * in_grid * C}


def test_a_backward_counts_its_aten_products_once():
    """``ZwinConv``'s forward is the formula alone, its backward
    ``zwin_conv_bwd``'s products, counted once each."""
    args = zwin_args(torch.Generator().manual_seed(3), 2)
    feats, mask, nbr, weight = args[:4]
    cot = torch.randn(feats.shape[0], nbr.shape[1], args[5] * weight.shape[2],
                      generator=torch.Generator().manual_seed(4))
    bwd = counted_ops(lambda: zw.zwin_conv_bwd(*args, cot))
    assert bwd and 'fusionocc.zwin_conv' not in bwd

    def step():
        f, wt = feats.clone().requires_grad_(), weight.clone().requires_grad_()
        y = zw.zwin_conv(f, mask, nbr, wt, *args[4:])
        y.backward(cot)
    got = counted_ops(step)
    assert got.pop('fusionocc.zwin_conv') == 2 * contract_macs(*args)
    assert got == bwd


def jax_products(jaxpr, out: dict, path: str = '', mult: int = 1) -> None:
    """2 per multiply-add of every dot_general and conv_general_dilated of
    ``jaxpr``, through nested jaxprs (a scan's body times its length), not
    into a pallas_call; summed by the path of enclosing primitives."""
    for e in jaxpr.eqns:
        name = e.primitive.name
        if name == 'pallas_call':
            continue
        if name == 'dot_general':
            (contract, _), _ = e.params['dimension_numbers']
            lhs = e.invars[0].aval.shape
            n = math.prod(lhs[d] for d in contract)
        elif name == 'conv_general_dilated':
            rhs = e.invars[1].aval.shape
            spec = e.params['dimension_numbers'].rhs_spec
            n = rhs[spec[1]] * math.prod(rhs[d] for d in spec[2:])
        else:
            n = 0
        if n:
            out[path] = out.get(path, 0) + (
                2 * math.prod(e.outvars[0].aval.shape) * n * mult)
        for value in e.params.values():
            for sub in (value if isinstance(value, (tuple, list))
                        else (value,)):
                if isinstance(sub, jax.extend.core.ClosedJaxpr):
                    sub = sub.jaxpr
                if isinstance(sub, jax.extend.core.Jaxpr):
                    jax_products(sub, out, f'{path}/{name}', mult * (
                        e.params['length'] if name == 'scan' else 1))


def test_predict_products_match_jax(monkeypatch):
    tc = tiny_config()
    jc = jcfg.tiny_model_config()
    jc = dataclasses.replace(
        jc, swin=dataclasses.replace(jc.swin, fused_attn=True),
        lidar=dataclasses.replace(jc.lidar, backend='zfold', zconv='zwin'))
    jbatch = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
        j_synthetic_batch(jc, 1, 0))
    jmodel = JFusionOcc(jc)
    variables = jax.eval_shape(lambda b: jmodel.init(
        {'params': jax.random.PRNGKey(0), 'dropout': jax.random.PRNGKey(1)},
        b, train=False), jbatch)
    jaxpr = jax.make_jaxpr(lambda v, b: jmodel.apply(
        v, b, method=JFusionOcc.predict))(variables, jbatch)
    paths = {}
    jax_products(jaxpr.jaxpr, paths)
    # JAX's zwin layers carry a whole-layer XLA fallback under lax.cond,
    # taken only when the window plan overflows (a TPU workaround the
    # CUDA kernel, which gathers rows by index, does not need)
    fallback = sum(n for p, n in paths.items() if '/cond' in p)
    # JAX inverts the 3x3 rotations by a linear solve whose triangular
    # solves are dot_generals; torch's counter has no formula for
    # torch.linalg.inv
    solve = sum(n for p, n in paths.items() if 'custom_linear_solve' in p)
    assert fallback > 0 and 0 < solve < 10 ** 4
    # JAX finds each stride-2 set's lane mask by a 0/1 gather-GEMM over its
    # static capacity, (S, 27 f_in) x (27 f_in, f_out); the port ORs lane
    # bits inside its index op (``fusionocc::stage_maps``): no product
    lc, cells, lane = jc.lidar, jc.lidar.sparse_shape(jc.grid), 0
    for i in range(min(lc.dense_from, len(lc.encoder_channels) - 1)):
        f_in = min(lc.zfold, cells[2])
        cells = jsc.out_shape_strided(cells)
        lane += 2 * lc.zfold_capacity[i + 1] * 27 * f_in * min(lc.zfold,
                                                                cells[2])
    # the rest of the encoder runs over the widest sample in the port and
    # over the static capacity in JAX: count the port at the static widths
    # its export path takes
    monkeypatch.setattr(voxelize, 'exporting', lambda: True)
    model = init_weights(FusionOcc(tc, device='cpu'),
                         torch.Generator().manual_seed(0))
    batch = synthetic_batch(tc, 1, 0, device='cpu')
    port = flops.count_flops(model, batch, 'predict')
    want = sum(paths.values()) - fallback - solve - lane
    assert port['outside'] == pytest.approx(want, rel=REL)
    assert port['kernels']['window_attn'] and port['kernels']['zwin_conv']
    assert port['kernels']['bev_pool'] and not port['kernels'][
        'zwin_conv_epi']


def test_stereo_predict_counts_its_plane_sweeps():
    """Frames 1 and 0 each sweep the tiny stage-0 map (H/4, W/4, C0) of
    every camera over the D planes."""
    cfg = dataclasses.replace(tiny_config(), use_lidar=False,
                              lidar_out_channels=0)
    model = init_weights(
        configs.build_model('bevdet_occ_stbase_stereo', 'cpu', cfg),
        torch.Generator().manual_seed(0))
    batch = synthetic_batch(cfg, 1, 0, device='cpu',
                            frames=model.input_frames)
    got = flops.count_flops(model, batch, 'predict')
    H, W = cfg.input_size
    one = (10 * cfg.swin.embed_dims * cfg.num_cams * cfg.grid.num_depth_bins
           * (H // 4) * (W // 4))
    assert got['kernels']['plane_sweep'] == 2 * one
    assert got['outside'] == got['total'] - sum(got['kernels'].values())


def jax_stage_rows(cfg, points, mask) -> list:
    """Kept rows per cut from JAX's builds: voxels, super rows, each
    stage's stride-2 outputs (``tools/density_sweep.py:62-80``)."""
    lc = cfg.lidar
    shape = lc.sparse_shape(cfg.grid)
    fold = min(lc.zfold, shape[2])
    sp = j_voxelize_mean(jnp.asarray(points), jnp.asarray(mask),
                         cfg.grid.point_cloud_range, lc.voxel_size, shape,
                         lc.voxel_capacity[0])
    rows = [int(sp.mask.sum())]
    zv = jzf.zfold_regroup(sp, shape, lc.zfold_capacity[0], fold)
    rows.append(int(zv.mask.sum()))
    cur, cells = jzf.as_sparse(zv), shape
    for i in range(min(lc.dense_from, len(lc.encoder_channels) - 1)):
        _, strided = jsc.stage_indices_table(
            cur, jzf.super_shape(cells, fold), lc.zfold_capacity[i + 1])
        (oc, okeys, om, _), _ = strided
        rows.append(int(om.sum()))
        cur = type(cur)(jnp.zeros(om.shape + (1,), jnp.float32),
                        jnp.where(om[..., None], oc, 0), okeys, om)
        cells = jsc.out_shape_strided(cells)
        fold = min(lc.zfold, cells[2])
    return rows


@pytest.mark.parametrize('scale', [1.0, 2.0])
def test_density_rows_equal_jax(scale):
    cfg = ds.density_config(tiny_config(), scale)
    b = synthetic_batch(cfg, 1, 0, device='cpu')
    rows = ds.stage_rows(cfg, b.points, b.points_mask)
    assert [name for name, *_ in rows][:2] == ['voxels', 'super rows']
    assert [kept for _, kept, _, _ in rows] == jax_stage_rows(
        cfg, b.points.numpy(), b.points_mask.numpy())
    assert any(before > cap for _, _, before, cap in rows)


def test_tools_run_on_the_cpu(capsys):
    gf.main(['--tiny', '--device', 'cpu'])
    out = capsys.readouterr().out
    for line in ('--- parameters ---', 'total_params: ', 'flops: ',
                 'flops without the kernels: ', '  zwin_conv: ',
                 'bytes accessed: ', '--- memory ---', 'not measured'):
        assert line in out, line
    ds.main(['--tiny', '--device', 'cpu'])
    out = capsys.readouterr().out
    assert out.count('--- density x') == 3
    assert out.count('stage 2 stride-2 outputs: ') == 3
    assert 'zwin bad-block column' in out and 'TRUNCATED!' in out
