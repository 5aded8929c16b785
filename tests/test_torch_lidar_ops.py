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
- A sparse stage's index builds as custom ops (``fusionocc::stride2_count``,
  ``stride2_set``, ``stage_maps``): through the ops the CPU path gives the
  plain build's integers, the stride-2 set's lane mask among them (equal to
  ``strided_lane_mask`` on the map); the six kernels of
  ``csrc/sparse_index.cu`` walked in numpy as their threads compute (tiles
  of the occupancy count, one row per set cell, an OR of lane bits per
  super z-shift) give the same integers, on one sample, a batch with an
  empty sample and a capacity cut, and a grid of two tiles; each op passes
  ``torch.library.opcheck`` (its fake gives the real shapes); and
  ``torch.export`` traces the encoder with no wait, the three ops once per
  sparse stage.
"""
import collections
import itertools

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
from fusionocc_tpu_torch.config import tiny_model_config
from fusionocc_tpu_torch.data.synthetic import synthetic_batch
from fusionocc_tpu_torch.models.fusion_occ import init_weights
from fusionocc_tpu_torch.models.lidar_encoder import SparseEncoder
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


# (seed, super shape, valid rows per sample, V, stride-2 capacity or None
# for every cell, f_in, f_out)
INDEX_CASES = {
    'one_sample': (0, (24, 20, 4), (300,), 300, 10 ** 6, 8, 8),
    'batch_cut': (1, (30, 14, 2), (0, 250, 140), 256, 90, 8, 4),
    'two_tiles': (2, (130, 72, 4), (500, 380), 512, None, 4, 2),
}


def _index_inputs(case):
    """A stage's input rows: per sample sorted distinct random cells, padded
    to V (sentinel keys, zero coords), a random lane mask on the valid
    rows; then the stride-2 shape and capacity."""
    seed, shape, rows, V, cap, f_in, f_out = INDEX_CASES[case]
    rng = np.random.RandomState(seed)
    n_cells = shape[0] * shape[1] * shape[2]
    keys = np.full((len(rows), V), n_cells, np.int32)
    for b, r in enumerate(rows):
        keys[b, :r] = np.sort(rng.choice(n_cells, r, replace=False))
    mask = np.arange(V) < np.asarray(rows)[:, None]
    coords, keys, mask = tvox.key_set(_t(keys), _t(mask), shape)
    lane = _t((rng.rand(len(rows), V, f_in) < 0.4)
              & np.asarray(mask)[..., None])
    shape_out = tsc.out_shape_strided(shape)
    if cap is None:
        cap = shape_out[0] * shape_out[1] * shape_out[2]
    return shape, shape_out, coords, keys, mask, lane, cap, f_out


def index_walk(shape, coords, keys, mask, lane, capacity, f_out) -> dict:
    """csrc/sparse_index.cu's six kernels in numpy, as their threads
    compute: index_mark (each valid row's cells (d + c) >> 1, c in {0, 1}
    per axis), index_count (tile counts, exclusive tile offsets, n),
    index_prefix (a tile's offset plus its inclusive count), index_set (a
    cell where the count steps to c writes row c - 1; rows past n the
    padding), index_table and index_maps (per row and tap the table's
    column, miss V; per super z-shift the OR of the found rows' lane bits,
    out cell zo on where a cell r = 2 zo + dz - 1 of its field is set at
    shift floor(r / f_in) + 1, lane r mod f_in)."""
    coords, keys = coords.numpy().astype(np.int64), keys.numpy()
    mask, lane = mask.numpy(), lane.numpy()
    B, V = mask.shape
    f_in = lane.shape[-1]
    shape_out = tsc.out_shape_strided(shape)
    sx, sy, sz = shape_out
    n_out = sx * sy * sz
    tile = tsc.INDEX_TILE
    T = -(-n_out // tile)
    occ = np.zeros((B, T * tile), np.int64)
    b, v = np.nonzero(mask)
    for c in itertools.product((0, 1), repeat=3):
        q = (coords[b, v] + np.asarray(c)) >> 1
        ok = ((q >= 0) & (q < np.asarray(shape_out))).all(-1)
        occ[b[ok], (q[ok, 0] * sy + q[ok, 1]) * sz + q[ok, 2]] = 1
    tiles = occ.reshape(B, T, tile)
    sums = tiles.sum(-1)
    offsets = np.cumsum(sums, 1) - sums
    n = np.minimum(sums.sum(1), capacity)
    count = (offsets[..., None] + np.cumsum(tiles, -1)).reshape(B, -1)
    count = count[:, :n_out]
    S = int(n.max())
    out_keys = np.full((B, S), n_out)
    out_coords = np.zeros((B, S, 3), np.int64)
    out_mask = np.zeros((B, S), bool)
    prev = np.concatenate([np.zeros((B, 1), np.int64), count[:, :-1]], 1)
    b, i = np.nonzero((count > prev) & (count <= n[:, None]) & (count <= S))
    r = count[b, i] - 1
    out_keys[b, r] = i
    out_coords[b, r] = np.stack([i // (sy * sz), i % (sy * sz) // sz,
                                 i % sz], -1)
    out_mask[b, r] = True
    table = np.full((B, shape[0] * shape[1] * shape[2] + 4), V)
    b, v = np.nonzero(mask)
    table[b, keys[b, v] + 1] = v

    def maps(rows, valid, stride):
        out = np.empty(rows.shape[:2] + (27,), np.int64)
        for t, tap in enumerate(tsc.KERNEL_OFFSETS):
            q = rows * stride + tap - 1
            ok = valid & ((q >= 0) & (q < np.asarray(shape))).all(-1)
            col = np.where(ok, (q[..., 0] * shape[1] + q[..., 1]) * shape[2]
                           + q[..., 2] + 1, 0)
            out[..., t] = np.where(ok, np.take_along_axis(table, col, 1), V)
        return out
    subm, strided = maps(coords, mask, 1), maps(out_coords, out_mask, 2)
    lane_bits = np.concatenate([(lane * (1 << np.arange(f_in))).sum(-1),
                                np.zeros((B, 1), np.int64)], 1)
    bits = np.zeros((B, S, 3), np.int64)
    for t in range(27):
        bits[..., t % 3] |= np.take_along_axis(lane_bits, strided[..., t], 1)
    out_lane = np.zeros((B, S, f_out), bool)
    for zo, dz in itertools.product(range(f_out), range(3)):
        rr = 2 * zo + dz - 1
        ds, zi = (0, f_in - 1) if rr < 0 else (rr // f_in + 1, rr % f_in)
        out_lane[..., zo] |= ((bits[..., ds] >> zi) & 1) > 0
    return dict(count=count, n=n, coords=out_coords, keys=out_keys,
                mask=out_mask, subm=subm, strided=strided, lane=out_lane)


@pytest.mark.parametrize('case', list(INDEX_CASES))
def test_index_ops_and_kernel_walk_equal_the_plain_build(case):
    shape, shape_out, coords, keys, mask, lane, cap, f_out = \
        _index_inputs(case)
    count, n = tsc.stride2_count_op(coords, mask, *shape_out, cap)
    want_count, want_n = tsc.stride2_count_plain(coords, mask, *shape_out,
                                                 cap)
    assert torch.equal(count, want_count) and torch.equal(n, want_n)
    width = int(n.max())
    oc, ok, om = tsc.stride2_set_op(count, n, *shape_out, width)
    for got, want in zip((oc, ok, om), tsc.stride2_set_plain(
            count, n, *shape_out, width)):
        assert got.dtype == want.dtype and torch.equal(got, want)
    subm, strided, out_lane = tsc.stage_maps_op(keys, coords, mask, oc, om,
                                                lane, *shape, f_out)
    assert torch.equal(out_lane, tzf.strided_lane_mask(
        lane, om, strided, lane.shape[-1], f_out))
    sp = tvox.SparseVoxels(lane.float(), coords, keys, mask)
    built = tsc.stage_indices_table(sp, shape, cap, lane, f_out)
    assert built[1][1] == shape_out
    for got, want in zip((built[0], *built[1][0]),
                         (subm, oc, ok, om, strided, out_lane)):
        assert got.dtype == want.dtype and torch.equal(got, want)
    plain = tsc.stage_indices_table(sp, shape, cap)
    assert len(plain[1][0]) == 4 and torch.equal(plain[1][0][3], strided)
    walked = index_walk(shape, coords, keys, mask, lane, cap, f_out)
    got = dict(count=count, n=n, coords=oc, keys=ok, mask=om, subm=subm,
               strided=strided, lane=out_lane)
    for name, want in walked.items():
        np.testing.assert_array_equal(got[name].numpy(), want, err_msg=name)
    assert int(om.sum()) == int(np.minimum(
        walked['count'][:, -1], cap).sum())


def test_index_cuda_wrappers_refuse_cpu_tensors():
    _, shape_out, coords, keys, mask, lane, cap, f_out = \
        _index_inputs('one_sample')
    with pytest.raises(ValueError, match='CUDA'):
        tsc.stride2_count_cuda(coords, mask, *shape_out, cap)
    count, n = tsc.stride2_count_plain(coords, mask, *shape_out, cap)
    with pytest.raises(ValueError, match='CUDA'):
        tsc.stride2_set_cuda(count, n, *shape_out, int(n.max()))
    with pytest.raises(ValueError, match='CUDA'):
        tsc.stage_maps_cuda(keys, coords, mask, coords, mask, lane, 24, 20,
                            4, f_out)


def _index_op_cases():
    shape, shape_out, coords, keys, mask, lane, cap, f_out = \
        _index_inputs('batch_cut')
    count, n = tsc.stride2_count_plain(coords, mask, *shape_out, cap)
    oc, _, om = tsc.stride2_set_plain(count, n, *shape_out, int(n.max()))
    return {
        'stride2_count': (tsc.stride2_count_op,
                          (coords, mask, *shape_out, cap)),
        'stride2_set': (tsc.stride2_set_op,
                        (count, n, *shape_out, int(n.max()) + 3)),
        'stage_maps': (tsc.stage_maps_op,
                       (keys, coords, mask, oc, om, lane, *shape, f_out)),
        'stage_maps_no_lane': (tsc.stage_maps_op,
                               (keys, coords, mask, oc, om, None, *shape, 0)),
    }


@pytest.mark.parametrize('name', ['stride2_count', 'stride2_set',
                                  'stage_maps', 'stage_maps_no_lane'])
def test_index_op_registration(name):
    op, args = _index_op_cases()[name]
    torch.library.opcheck(op, args, test_utils=(
        'test_schema', 'test_faketensor', 'test_aot_dispatch_static'))


def test_encoder_exports_without_a_wait(monkeypatch):
    cfg = tiny_model_config()
    enc = init_weights(SparseEncoder(cfg.lidar, cfg.grid, device='cpu'),
                       torch.Generator().manual_seed(0))
    b = synthetic_batch(cfg, 1, 0, num_points=512, device='cpu')
    with torch.no_grad():
        want = enc(b.points, b.points_mask)

    def no_wait(site):
        raise AssertionError(f'a wait at {site} while exporting')
    monkeypatch.setattr(tvox.profiling, 'wait', no_wait)
    with torch.no_grad():
        program = torch.export.export(enc, (b.points, b.points_mask),
                                      strict=False)
    monkeypatch.undo()
    ops = collections.Counter(str(n.target).split('.')[1]
                              for n in program.graph.nodes
                              if str(n.target).startswith('fusionocc.'))
    assert dict(ops) == {'stride2_count': 3, 'stride2_set': 3,
                         'stage_maps': 3, 'zwin_conv': 9}
    with torch.no_grad():
        got = program.module()(b.points, b.points_mask)
    assert torch.equal(got, want)
