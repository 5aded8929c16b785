"""The LiDAR encoder's index builds on a batch, against the JAX package's
vmapped builds (CPU).

Three clouds of the tiny config in one batch, padded to one point count:
the synthetic cloud (1,882 voxels, over the voxel capacity of 1,024), 400
points of another seed's cloud, and an empty one.  The capacities of the
super rows and of the stride-2 output sets are cut so that the large sample
overflows each of them.  Stage by stage (voxelization, the z-fold regroup,
each sparse stage's row table and stride-2 output set, the stride-2 lane
mask, the densified tail input) every sample's valid rows equal JAX's: keys,
coords, masks, lane masks and neighbour maps bit for bit (a miss is S_in in
each package), features equal.  The port pads a batch to its largest
sample: its rows past a sample's count are masked, and every build on the
batch equals the same build on each sample alone.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusionocc_tpu import config as jcfg
from fusionocc_tpu.data.synthetic import synthetic_batch as j_synthetic_batch
from fusionocc_tpu.ops import sparse_conv as jsc
from fusionocc_tpu.ops import voxelize as jvox
from fusionocc_tpu.ops import zfold as jzf
from fusionocc_tpu_torch.ops import dense_conv as tdc
from fusionocc_tpu_torch.ops import sparse_conv as tsc
from fusionocc_tpu_torch.ops import voxelize as tvox
from fusionocc_tpu_torch.ops import zfold as tzf

from test_torch_lidar_ops import _same_nbr, _snap, _t
from torch_threads import one_torch_thread  # noqa: E402,F401

ZFOLD_CAPACITY = (400, 260, 80, 30)      # the first sample overflows each

# JAX's builds each as one jitted function, as the JAX model runs them
# inside its jit (op by op they compiled some 400 programs on the CPU)
j_voxelize = jax.jit(jvox.voxelize_mean, static_argnums=(2, 3, 4, 5))
j_regroup = jax.jit(jzf.zfold_regroup, static_argnums=(1, 2, 3))
j_stage = jax.jit(lambda zv, shape, cap: jsc.stage_indices_table(
    jzf.as_sparse(zv), shape, cap), static_argnums=(1, 2))
j_lane_mask = jax.jit(jzf.strided_lane_mask, static_argnums=(3, 4))


@pytest.fixture(scope='module')
def clouds():
    jc = jcfg.tiny_model_config()
    pts, masks = [], []
    for seed, keep in ((0, None), (1, 400), (2, 0)):
        b = j_synthetic_batch(jc, 1, seed)
        p, m = _snap(b.points[0]), np.asarray(b.points_mask[0]).copy()
        if keep is not None:
            m[np.cumsum(m) > keep] = False
        pts.append(p)
        masks.append(m)
    return jc, np.stack(pts).astype(np.float32), np.stack(masks)


def _rows(port, jax_arr, mask):
    """Each sample's valid rows of a port array and JAX's: the port's mask
    says which; JAX's rows past them must be masked too."""
    return ([np.asarray(port)[b][mask[b]] for b in range(len(mask))],
            [np.asarray(jax_arr)[b][:mask[b].sum()] for b in range(len(mask))])


def _same_rows(name, port, jax_arr, mask):
    for b, (got, want) in enumerate(zip(*_rows(port, jax_arr, mask))):
        np.testing.assert_array_equal(got, want, err_msg=f'{name} {b}')


def _same_set(name, tmask, jmask):
    """Masks: the port's is a prefix per sample, padded to the largest
    sample, and it holds JAX's count."""
    tmask, jmask = np.asarray(tmask), np.asarray(jmask)
    n = jmask.sum(axis=1)
    assert tmask.shape[1] == n.max(), name
    np.testing.assert_array_equal(
        tmask, np.arange(tmask.shape[1])[None] < n[:, None], err_msg=name)
    return tmask


def _alone(fn, *args):
    """fn on each sample alone: a list of B outputs."""
    outs = [fn(*(a[b:b + 1] for a in args)) for b in range(args[0].shape[0])]
    return outs


def test_batched_builds_match_jax_and_each_sample(clouds):
    jc, points, pmask = clouds
    lc = jc.lidar
    cells = lc.sparse_shape(jc.grid)
    pcr = jc.grid.point_cloud_range
    cap = lc.voxel_capacity[0]
    jsp = j_voxelize(jnp.asarray(points), jnp.asarray(pmask), pcr,
                     lc.voxel_size, cells, cap)
    tsp = tvox.voxelize_mean(_t(points), _t(pmask), pcr, lc.voxel_size,
                             cells, cap)
    m = _same_set('voxels', tsp.mask, jsp.mask)
    assert m[0].sum() == cap and m[2].sum() == 0 and 0 < m[1].sum() < cap
    for name in ('keys', 'coords', 'feats'):
        _same_rows(name, getattr(tsp, name), getattr(jsp, name), m)
    for b, one in enumerate(_alone(
            lambda p, v: tvox.voxelize_mean(p, v, pcr, lc.voxel_size, cells,
                                            cap), _t(points), _t(pmask))):
        n = int(one.mask.sum())
        for got, want in zip(one, tsp):
            assert torch.equal(got[0, :n], want[b, :n])

    fold = min(lc.zfold, cells[2])
    jzv = j_regroup(jsp, cells, ZFOLD_CAPACITY[0], fold)
    tzv = tzf.zfold_regroup(tsp, cells, ZFOLD_CAPACITY[0], fold)
    m = _same_set('supers', tzv.mask, jzv.mask)
    assert m[0].sum() == ZFOLD_CAPACITY[0]
    for name in ('keys', 'coords', 'lane_mask', 'feats'):
        _same_rows(name, getattr(tzv, name), getattr(jzv, name), m)
    for b, (f, k, c) in enumerate(zip(tzv.feats, tzv.keys, tzv.coords)):
        one = tzf.zfold_regroup(
            tvox.SparseVoxels(*(t[b:b + 1] for t in tsp)), cells,
            ZFOLD_CAPACITY[0], fold)
        n = int(one.mask.sum())
        assert torch.equal(one.feats[0], f[:n]) and torch.equal(
            one.keys[0], k[:n]) and torch.equal(one.coords[0], c[:n])

    for i in range(len(lc.encoder_channels) - 1):
        sshape = jzf.super_shape(cells, fold)
        cap = ZFOLD_CAPACITY[i + 1]
        jn, ((joc, jok, jom, jsn), jshape) = j_stage(jzv, sshape, cap)
        tn, ((toc, tok, tom, tsn), tshape) = tsc.stage_indices_table(
            tzf.as_sparse(tzv), sshape, cap)
        assert tshape == jshape
        s_in_t, s_in_j = tzv.keys.shape[1], jzv.keys.shape[1]
        for b in range(3):
            _same_nbr(tn[b:b + 1], jn[b], tzv.mask[b:b + 1], s_in_t, s_in_j)
        om = _same_set(f'stage {i} out set', tom, jom)
        assert om[0].sum() == cap and om[2].sum() == 0
        _same_rows(f'stage {i} out keys', tok, jok, om)
        _same_rows(f'stage {i} out coords', toc, joc, om)
        for b in range(3):
            _same_nbr(tsn[b:b + 1], jsn[b], tom[b:b + 1], s_in_t, s_in_j)
        cells = jsc.out_shape_strided(cells)
        f_out = min(lc.zfold, cells[2])
        jlane = j_lane_mask(jzv.lane_mask, jom, jsn, fold, f_out)
        tlane = tzf.strided_lane_mask(tzv.lane_mask, tom, tsn, fold, f_out)
        _same_rows(f'stage {i} lane mask', tlane, jlane, om)
        jzv = jzf.ZFoldVoxels(jlane.astype(jnp.float32),
                              jnp.where(jom[..., None], joc, 0), jok, jom,
                              jlane, f_out)
        tzv = tzf.ZFoldVoxels(tlane.float(), toc, tok, tom, tlane, f_out)
        fold = f_out

    # the dense tail's input: one scatter over the batch
    x, mask = tdc.dense_from_zfold(tzv, cells, 1)
    for b in range(3):
        want = np.zeros(cells, bool)
        rows = np.asarray(tzv.mask[b])
        for key, lanes in zip(np.asarray(tzv.keys[b])[rows],
                              np.asarray(tzv.lane_mask[b])[rows]):
            cx, cy, cs = np.unravel_index(key, jzf.super_shape(cells, fold))
            want[cx, cy, cs * fold:(cs + 1) * fold] = lanes
        np.testing.assert_array_equal(mask[b].numpy(), want)
        np.testing.assert_array_equal(x[b, ..., 0].numpy(), want)
