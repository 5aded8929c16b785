"""The port's LiDAR ops against the JAX package (CPU, fp32).

Inputs are made with numpy from a seed and handed to both packages.

- ``zwin_conv_plain`` against JAX ``zwin_conv_apply`` (the Pallas kernel in
  interpret mode with block_v=8, n_win=4, as tests/test_zwin.py runs it)
  and ``zband_conv_apply``, SubM and stride 2, on test_zwin.py's fixtures:
  rtol 1e-5, atol 1e-6 (fp32 sums taken in another order).  The same cases
  walk the taps and out cells as csrc/zwin_conv.cu does (for each out cell
  only the band cells it reads, times the cell kernel's tap t - ds + dz),
  and must give the plain version's result within the same tolerance.
- Index builds equal JAX exactly on the valid rows, stage by stage on the
  tiny cloud, which JAX truncates at its capacity (1,882 voxels against
  1,024): voxel keys and coords, ``zfold_regroup`` keys, lane masks and
  features, the SubM and stride-2 neighbour maps (a miss is S_in in both),
  the stride-2 out set and ``strided_lane_mask``.
- ``voxelize_mean`` against a float64 numpy mean (1e-6), on the tiny and
  the full-size cloud; the JAX package's prefix-sum mean is further off
  (ROADMAP Queue C).
- ``expand_weight``, ``z_bands``, ``MaskedBatchNorm`` (eps 1e-3) and the
  dense tail's conv (against both of JAX's formulations) and stride-2 mask
  against JAX (1e-5).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusionocc_tpu import config as jcfg
from fusionocc_tpu.data.synthetic import beam_lidar_cloud
from fusionocc_tpu.data.synthetic import synthetic_batch as j_synthetic_batch
from fusionocc_tpu.nn.layers import MaskedBatchNorm as JMaskedBatchNorm
from fusionocc_tpu.ops import dense_conv as jdc
from fusionocc_tpu.ops import sparse_conv as jsc
from fusionocc_tpu.ops import voxelize as jvox
from fusionocc_tpu.ops import zfold as jzf
from fusionocc_tpu.ops.pallas.zwin_conv import z_bands as j_z_bands
from fusionocc_tpu.ops.pallas.zwin_conv import zwin_conv_apply
from fusionocc_tpu_torch.nn.layers import MaskedBatchNorm
from fusionocc_tpu_torch.ops import dense_conv as tdc
from fusionocc_tpu_torch.ops import sparse_conv as tsc
from fusionocc_tpu_torch.ops import voxelize as tvox
from fusionocc_tpu_torch.ops import zfold as tzf
from fusionocc_tpu_torch.ops import zwin_conv as tzw

from test_sparse_conv import _random_sparse
from torch_threads import one_torch_thread  # noqa: E402,F401

TOL = dict(rtol=1e-5, atol=1e-6)


def _t(x):
    return torch.tensor(np.asarray(x))


# (seed, cell shape, B, V, Cin, Cout, capacity, points, down capacity)
ZWIN_CASES = {
    'subm': (3, (10, 6, 16), 2, 96, 3, 5, 96, 140, None),
    'strided': (4, (12, 10, 16), 2, 128, 3, 4, 128, 170, 64),
    'strided_fout4': (5, (12, 10, 8), 2, 128, 3, 4, 128, 150, 64),
}


def kernel_walk(feats, mask_out, nbr, weight, f_in, f_out, stride):
    """csrc/zwin_conv.cu's loop in PyTorch: per tap t with a band, the band
    lanes of the neighbour rows; per out cell zo, only the band cells it
    reads (stride*zo + dz - 1, dz = 0..2) times the cell kernel's tap
    t - ds + dz."""
    cin, cout = weight.shape[1], weight.shape[2]
    out = torch.zeros(*nbr.shape[:2], f_out * cout)
    for t in range(27):
        ds = t % 3
        zi_lo, nzi = tzw.z_bands(f_in, f_out, stride)[ds]
        if not nzi:
            continue
        band = tsc.gather_rows(feats[:, :, zi_lo * cin:(zi_lo + nzi) * cin],
                               nbr[:, :, t]).float()
        for zo in range(f_out):
            z0 = stride * zo - 1 - (ds - 1) * f_in - zi_lo
            for z in range(max(z0, 0), min(z0 + 2, nzi - 1) + 1):
                out[..., zo * cout:(zo + 1) * cout] += \
                    band[..., z * cin:(z + 1) * cin] @ weight[t - ds + z - z0]
    return torch.where(mask_out[..., None], out.to(feats.dtype), 0)


@pytest.mark.parametrize('case', list(ZWIN_CASES))
def test_zwin_plain_matches_jax(case):
    seed, shape, B, V, cin, cout, cap, pts, down = ZWIN_CASES[case]
    rng = np.random.RandomState(seed)
    sp = _random_sparse(rng, B, V, shape, cin, density_pts=pts)
    zv = jzf.zfold_regroup(sp, shape, capacity=cap, fold=8)
    sshape = jzf.super_shape(shape, 8)
    if down is None:
        nbr, _ = jsc.stage_indices_table(jzf.as_sparse(zv), sshape, None)
        mask, f_out, stride = zv.mask, 8, 1
    else:
        _, ((_, _, mask, nbr), _) = jsc.stage_indices_table(
            jzf.as_sparse(zv), sshape, down)
        f_out = min(8, jsc.out_shape_strided(shape)[2])
        stride = 2
    w = jnp.asarray(rng.randn(27, cin, cout), jnp.float32) * 0.1
    args = (8, f_out, stride)
    ref = np.asarray(jzf.zband_conv_apply(zv.feats, mask, nbr, w, *args))
    pallas = np.asarray(zwin_conv_apply(zv.feats, mask, nbr, w, *args,
                                        block_v=8, n_win=4))
    tf, tm, tn, tw = _t(zv.feats), _t(mask), _t(nbr), _t(w)
    got = tzw.zwin_conv(tf, tm, tn, tw, *args)
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    np.testing.assert_allclose(got.numpy(), pallas, **TOL)
    walked = kernel_walk(tf, tm, tn, tw, *args)
    np.testing.assert_allclose(walked.numpy(), got.numpy(), **TOL)


@pytest.mark.parametrize('f_in,f_out,stride', [(8, 8, 1), (8, 8, 2),
                                               (8, 4, 2), (4, 4, 1),
                                               (8, 2, 2)])
def test_bands_and_lifted_weight_match_jax(f_in, f_out, stride):
    assert tzw.z_bands(f_in, f_out, stride) == j_z_bands(f_in, f_out, stride)
    w = np.random.RandomState(0).randn(27, 2, 3).astype(np.float32)
    np.testing.assert_array_equal(
        tzf.expand_weight(_t(w), f_in, f_out, stride).numpy(),
        np.asarray(jzf.expand_weight(jnp.asarray(w), f_in, f_out, stride)))


def test_tap_order_and_strided_shape_match_jax():
    np.testing.assert_array_equal(tsc.KERNEL_OFFSETS, jsc.KERNEL_OFFSETS)
    for shape in ((1600, 1600, 16), (7, 5, 3), (1, 2, 1)):
        assert tsc.out_shape_strided(shape) == jsc.out_shape_strided(shape)


def _snap(points):
    """Points on multiples of 2^-8: every fp32 partial sum of JAX's prefix
    mean is then exact at tiny size, so both packages agree to rounding."""
    return np.round(np.asarray(points) * 256.0) / 256.0


@pytest.fixture(scope='module')
def tiny_cloud():
    jc = jcfg.tiny_model_config()
    b = j_synthetic_batch(jc, 1, 0)
    return jc, np.asarray(b.points), np.asarray(b.points_mask)


def _valid(x, m):
    return np.asarray(x)[np.asarray(m)]


def _same_nbr(port, jax_map, port_rows, s_in_port, s_in_jax):
    """Neighbour maps equal on the valid rows, misses mapped onto misses."""
    got = _valid(port, port_rows)
    want = np.asarray(jax_map)[:got.shape[0]]
    np.testing.assert_array_equal(
        np.where(got == s_in_port, -1, got),
        np.where(want == s_in_jax, -1, want))


def test_index_builds_match_jax_stage_by_stage(tiny_cloud):
    jc, points, pmask = tiny_cloud
    lc = jc.lidar
    cells = lc.sparse_shape(jc.grid)
    pts = _snap(points)
    pcr = jc.grid.point_cloud_range
    jsp = jvox.voxelize_mean(jnp.asarray(pts), jnp.asarray(pmask), pcr,
                             lc.voxel_size, cells, lc.voxel_capacity[0])
    tsp = tvox.voxelize_mean(_t(pts), _t(pmask), pcr, lc.voxel_size, cells,
                             lc.voxel_capacity[0])
    # JAX truncates this cloud at its capacity; the port keeps the same set
    assert bool(np.asarray(jsp.mask).all())
    assert tsp.keys.shape == (1, lc.voxel_capacity[0])
    for name in ('keys', 'coords'):
        np.testing.assert_array_equal(getattr(tsp, name).numpy(),
                                      np.asarray(getattr(jsp, name)))
    np.testing.assert_allclose(tsp.feats.numpy(), np.asarray(jsp.feats),
                               **TOL)

    fold = min(lc.zfold, cells[2])
    jzv = jzf.zfold_regroup(jsp, cells, lc.zfold_capacity[0], fold)
    tzv = tzf.zfold_regroup(tsp, cells, lc.zfold_capacity[0], fold)
    n = int(tzv.mask.sum())
    assert n == int(np.asarray(jzv.mask).sum()) and tzv.mask.all()
    for name in ('keys', 'coords', 'lane_mask'):
        np.testing.assert_array_equal(
            getattr(tzv, name).numpy(),
            np.asarray(getattr(jzv, name))[:, :n], err_msg=name)
    np.testing.assert_allclose(tzv.feats.numpy(),
                               np.asarray(jzv.feats)[:, :n], **TOL)

    for i in range(len(lc.encoder_channels) - 1):
        sshape = jzf.super_shape(cells, fold)
        cap = lc.zfold_capacity[i + 1]
        jn, ((joc, jok, jom, jsn), jshape) = jsc.stage_indices_table(
            jzf.as_sparse(jzv), sshape, cap)
        tn, ((toc, tok, tom, tsn), tshape) = tsc.stage_indices_table(
            tzf.as_sparse(tzv), sshape, cap)
        assert tshape == jshape
        s_in_t, s_in_j = tzv.keys.shape[1], jzv.keys.shape[1]
        _same_nbr(tn, jn[0], tzv.mask, s_in_t, s_in_j)
        m = int(tom.sum())
        assert m == int(np.asarray(jom).sum()), f'stage {i} out set'
        for got, want in ((tok, jok), (toc, joc)):
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(want)[:, :m])
        _same_nbr(tsn, jsn[0], tom, s_in_t, s_in_j)
        cells = jsc.out_shape_strided(cells)
        f_out = min(lc.zfold, cells[2])
        jlane = jzf.strided_lane_mask(jzv.lane_mask, jom, jsn, fold, f_out)
        tlane = tzf.strided_lane_mask(tzv.lane_mask, tom, tsn, fold, f_out)
        np.testing.assert_array_equal(tlane.numpy(),
                                      np.asarray(jlane)[:, :m])
        jzv = jzf.ZFoldVoxels(jlane.astype(jnp.float32),
                              jnp.where(jom[..., None], joc, 0), jok, jom,
                              jlane, f_out)
        tzv = tzf.ZFoldVoxels(tlane.float(), toc, tok, tom, tlane, f_out)
        fold = f_out


def _float64_mean(points, valid, pcr, voxel_size, shape):
    """{key: mean point} in float64, binned in fp32 as both packages do."""
    pts = points[valid]
    lo = np.asarray(pcr[:3], np.float32)
    coord = np.floor((pts[:, :3] - lo) / np.asarray(voxel_size, np.float32))
    inside = np.all((coord >= 0) & (coord < np.asarray(shape)), axis=1)
    coord, pts = coord[inside].astype(np.int64), pts[inside]
    key = (coord[:, 0] * shape[1] + coord[:, 1]) * shape[2] + coord[:, 2]
    uniq, inv = np.unique(key, return_inverse=True)
    sums = np.zeros((len(uniq), pts.shape[1]))
    np.add.at(sums, inv, pts.astype(np.float64))
    cnts = np.bincount(inv, minlength=len(uniq))
    return uniq, sums / cnts[:, None]


@pytest.mark.parametrize('preset,jax_floor', [('tiny', 1e-5), ('full', 5e-2)])
def test_voxelize_mean_against_float64(preset, jax_floor):
    """The port's segment mean is within 1e-6 of float64; the JAX package's
    prefix-sum mean over the unsnapped cloud is further off: above 1e-5 on
    the tiny cloud, above 5 cm on the full-size one (9.37e-2 m in x on this
    cloud, against 0.05 m voxels)."""
    jc = getattr(jcfg, f'{preset}_model_config')()
    lc = jc.lidar
    cells = lc.sparse_shape(jc.grid)
    pcr = jc.grid.point_cloud_range
    # the synthetic batch's cloud: the first draw of its RandomState(seed)
    points, pmask = beam_lidar_cloud(np.random.RandomState(0),
                                     lc.point_capacity, pcr)
    keys, ref = _float64_mean(points, pmask, pcr, lc.voxel_size, cells)
    cap = lc.voxel_capacity[0]
    keys, ref = keys[:cap], ref[:cap]
    tsp = tvox.voxelize_mean(_t(points[None]), _t(pmask[None]), pcr,
                             lc.voxel_size, cells, cap)
    np.testing.assert_array_equal(tsp.keys[0].numpy(), keys)
    np.testing.assert_allclose(tsp.feats[0].numpy(), ref, rtol=1e-6,
                               atol=1e-6)
    jsp = jvox.voxelize_mean(jnp.asarray(points[None]),
                             jnp.asarray(pmask[None]), pcr, lc.voxel_size,
                             cells, cap)
    port_err = np.abs(tsp.feats[0].numpy() - ref).max()
    jax_err = np.abs(np.asarray(jsp.feats[0])[:len(keys)] - ref).max()
    assert jax_err > jax_floor and jax_err > 10 * port_err, (jax_err,
                                                            port_err)


@pytest.mark.parametrize('layout', ['zfold', 'cells'])
def test_masked_batch_norm_matches_jax(layout):
    rng = np.random.RandomState(7)
    C, F = 3, 4
    shape = (2, 5, F * C) if layout == 'zfold' else (2, 5, 6, C)
    x = rng.randn(*shape).astype(np.float32)
    mask = rng.rand(*shape[:-1], F) > 0.4 if layout == 'zfold' else \
        rng.rand(*shape[:-1]) > 0.4
    stats = {'mean': rng.randn(C), 'var': rng.uniform(0.5, 1.5, C)}
    params = {'scale': 1 + 0.1 * rng.randn(C), 'bias': rng.randn(C)}
    jbn = JMaskedBatchNorm(fold=F if layout == 'zfold' else 0)
    want = jbn.apply(
        {'params': {k: jnp.float32(v) for k, v in params.items()},
         'batch_stats': {k: jnp.float32(v) for k, v in stats.items()}},
        jnp.asarray(x), jnp.asarray(mask))
    bn = MaskedBatchNorm(C)
    with torch.no_grad():
        bn.weight.copy_(_t(params['scale']))
        bn.bias.copy_(_t(params['bias']))
        bn.running_mean.copy_(_t(stats['mean']))
        bn.running_var.copy_(_t(stats['var']))
    with torch.no_grad():
        got = bn(_t(x), _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize('dense_mode,stride', [('zbatch', 1), ('zbatch', 2),
                                               ('xla3d', 1), ('xla3d', 2)])
def test_dense_tail_conv_and_mask_match_jax(dense_mode, stride):
    """The port's one (B, X, Y, Z, C) conv against each of JAX's two
    formulations: 'zbatch' over (B, Z, X, Y, C), 'xla3d' over (B, X, Y, Z,
    C)."""
    rng = np.random.RandomState(stride)
    x = rng.randn(2, 6, 7, 8, 3).astype(np.float32)
    w = (rng.randn(27, 3, 5) * 0.1).astype(np.float32)
    if dense_mode == 'zbatch':
        want = jdc.conv3d_zbatch(jnp.asarray(x.transpose(0, 3, 1, 2, 4)),
                                 jnp.asarray(w), stride)
        want = np.asarray(want).transpose(0, 2, 3, 1, 4)
    else:
        want = np.asarray(jdc.conv3d_ndhwc(jnp.asarray(x), jnp.asarray(w),
                                           stride))
    got = tdc.dense_conv3d(_t(x), _t(w), stride)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    m = rng.rand(2, 6, 7, 8) > 0.8
    np.testing.assert_array_equal(
        tdc.strided_out_mask(_t(m)).numpy(),
        np.asarray(jdc.strided_out_mask(jnp.asarray(m), 0)))


def test_zwin_cuda_wrapper_refuses_cpu_tensors():
    f = torch.zeros(1, 4, 8 * 2)
    with pytest.raises(ValueError, match='CUDA'):
        tzw.zwin_conv_cuda(f, torch.ones(1, 4, dtype=torch.bool),
                           torch.zeros(1, 4, 27, dtype=torch.int32),
                           torch.zeros(27, 2, 3), 8, 8, 1)
