"""The port's inputs, geometry and kernel ops against the JAX package.

Inputs are made with numpy from a seed and handed to both packages.  The
kernel ops' plain versions (what a CPU tensor runs) are held against the
JAX functions, including the Pallas kernels in interpret mode as the JAX
package's own tests run them:

- ``synthetic_batch``: bitwise equal arrays;
- ``make_frustum`` / ``frustum_to_ego`` / ``get_mlp_input``, and the
  one-hot depth input, with linear and log-spaced ('sid') bins;
- ``prepare_pooling_index``: equal ranks and bounds;
- ``bev_pool``: against JAX ``bev_pool``, against ``boundary_segment_sum``
  (Pallas segsum, interpret mode) at P = 4096, and against float64; on the
  tiny and midsize rigs against JAX ``bev_pool``, fp32 and cast to bf16;
  with ``out_dtype`` bf16, equal to the plain version cast; the library
  yardstick (``chip_smoke.embedding_bag_pool``) against the plain version;
- ``window_attention``: against ``fused_window_attention`` (Pallas,
  interpret mode) for the shift cases of test_pallas_window_attn.py and a
  Swin-B-shaped window (w = 12, N = 144, head_dim 32).

The CUDA wrappers refuse CPU tensors, and a build without nvcc raises.
"""
import functools
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusionocc_tpu import config as jcfg
from fusionocc_tpu import geometry as jgeo
from fusionocc_tpu.config import GridConfig as JGrid
from fusionocc_tpu.data.synthetic import synthetic_batch as j_synthetic_batch
from fusionocc_tpu.models.lss import \
    downsample_depth_onehot as j_downsample_depth_onehot
from fusionocc_tpu.ops.bev_pool import bev_pool as j_bev_pool
from fusionocc_tpu.ops.bev_pool import \
    prepare_pooling_index as j_prepare_pooling_index
from fusionocc_tpu.ops.pallas.segsum import BLK, boundary_segment_sum
from fusionocc_tpu.ops.pallas.window_attn import (_full_masks,
                                                  fused_window_attention)
from fusionocc_tpu_torch import config as tcfg
from fusionocc_tpu_torch import geometry as tgeo
from fusionocc_tpu_torch.config import GridConfig as TGrid
from fusionocc_tpu_torch.data.synthetic import synthetic_batch
from fusionocc_tpu_torch.models.lss import downsample_depth_onehot
from fusionocc_tpu_torch.ops import bev_pool as tbp
from fusionocc_tpu_torch.ops import kernels
from fusionocc_tpu_torch.ops import plane_sweep
from fusionocc_tpu_torch.ops import window_attn as twa


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from chip_smoke import embedding_bag_pool  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.mark.parametrize('preset,batch_size,seed', [
    ('tiny', 1, 0), ('midsize', 1, 3), ('tiny', 2, 5)])
def test_synthetic_batch_bitwise_equal(preset, batch_size, seed):
    j = j_synthetic_batch(getattr(jcfg, f'{preset}_model_config')(),
                          batch_size, seed, num_points=256)
    t = synthetic_batch(getattr(tcfg, f'{preset}_model_config')(),
                        batch_size, seed, num_points=256, device='cpu')
    for name, want in j._asdict().items():
        got = getattr(t, name).numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


@functools.lru_cache(maxsize=None)
def _geometry(preset):
    jc = getattr(jcfg, f'{preset}_model_config')()
    b = j_synthetic_batch(jc, 1, 0, num_points=64)
    f = 1   # the adjacent frame: its pose is shifted off the key ego
    return jc, (b.sensor2keyego[:, f], b.intrins[:, f], b.post_rots[:, f],
                b.post_trans[:, f], b.bda, b.sensor2keyego[:, 0])


@pytest.mark.parametrize('preset', ['tiny', 'midsize'])
def test_geometry_matches_jax(preset):
    jc, (s2k, intr, prot, ptr, bda, s2k_key) = _geometry(preset)
    args = (jc.grid.depth, jc.input_size, jc.vt.downsample)
    fr_j = np.asarray(jgeo.make_frustum(*args))
    fr_t = tgeo.make_frustum(*args)
    np.testing.assert_array_equal(fr_t.numpy(), fr_j)
    coor_j = np.asarray(jgeo.frustum_to_ego(fr_j, s2k, intr, prot, ptr, bda))
    coor_t = tgeo.frustum_to_ego(fr_t, _t(s2k), _t(intr), _t(prot), _t(ptr),
                                 _t(bda)).numpy()
    np.testing.assert_allclose(coor_t, coor_j, rtol=1e-6, atol=1e-5)
    mlp_j = np.asarray(jgeo.get_mlp_input(s2k_key, intr, prot, ptr, bda))
    mlp_t = tgeo.get_mlp_input(_t(s2k_key), _t(intr), _t(prot), _t(ptr),
                               _t(bda)).numpy()
    np.testing.assert_array_equal(mlp_t, mlp_j)


@pytest.mark.parametrize('sid', [False, True])
def test_depth_onehot_and_sid_frustum_match_jax(sid):
    """Min-pooled sparse depth to one-hot bins (linear or log-spaced
    'sid' bins), and the sid frustum."""
    jc, _ = _geometry('midsize')
    b = j_synthetic_batch(jc, 1, 2, num_points=64)
    grid, ds = jc.grid, jc.vt.downsample
    j_onehot, j_bins = j_downsample_depth_onehot(b.sparse_depth, ds, grid,
                                                 sid=sid)
    onehot, bins = downsample_depth_onehot(_t(b.sparse_depth), ds,
                                           tcfg.midsize_model_config().grid,
                                           sid=sid)
    np.testing.assert_array_equal(bins.numpy(), np.asarray(j_bins))
    np.testing.assert_array_equal(onehot.numpy(), np.asarray(j_onehot))
    assert int(bins.max()) > 0
    args = (grid.depth, jc.input_size, ds, sid)
    np.testing.assert_allclose(tgeo.make_frustum(*args).numpy(),
                               np.asarray(jgeo.make_frustum(*args)),
                               rtol=1e-6)


@pytest.mark.parametrize('preset', ['tiny', 'midsize', 'full'])
def test_pooling_index_matches_jax(preset):
    """Equal index from equal coordinates; and from each package's own
    geometry, the share of points whose voxel differs (float rounding at a
    voxel face) must be zero, up to the full-size rig (1,486,848 points)."""
    jc, (s2k, intr, prot, ptr, bda, _) = _geometry(preset)
    tc = getattr(tcfg, f'{preset}_model_config')()
    fr = jgeo.make_frustum(jc.grid.depth, jc.input_size, jc.vt.downsample)
    coor = np.asarray(jgeo.frustum_to_ego(fr, s2k, intr, prot, ptr, bda))
    ji = j_prepare_pooling_index(jnp.asarray(coor), jc.grid)
    ti = tbp.prepare_pooling_index(_t(coor), tc.grid)
    for name in ('ranks_depth', 'ranks_feat', 'ranks_bev', 'bounds'):
        got = getattr(ti, name)
        assert got.dtype == torch.int32, name
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(getattr(ji, name)), err_msg=name)
    assert int(ti.bounds[-1]) > 0     # the rig sees the grid

    coor_t = tgeo.frustum_to_ego(tgeo.make_frustum(
        tc.grid.depth, tc.input_size, tc.vt.downsample), _t(s2k), _t(intr),
        _t(prot), _t(ptr), _t(bda))
    own = tbp.prepare_pooling_index(coor_t, tc.grid)
    # voxel of every point, in natural point order
    vox_j = np.empty(coor.size // 3, np.int64)
    vox_j[np.asarray(ji.ranks_depth)] = np.asarray(ji.ranks_bev)
    vox_t = np.empty_like(vox_j)
    vox_t[own.ranks_depth.numpy()] = own.ranks_bev.numpy()
    share = float(np.mean(vox_j != vox_t))
    assert share == 0.0, f'{share:.2e} of points change voxel'


def _random_pool_problem(B, N, D, H, W, C, grid, seed):
    rng = np.random.RandomState(seed)
    lo = np.asarray([grid.x[0], grid.y[0], grid.z[0]]) - 0.5
    hi = np.asarray([grid.x[1], grid.y[1], grid.z[1]]) + 0.5
    coor = rng.uniform(lo, hi, (B, N, D, H, W, 3)).astype(np.float32)
    logits = rng.randn(B, N, D, H, W)
    depth = np.exp(logits) / np.exp(logits).sum(2, keepdims=True)
    feat = rng.randn(B, N, H, W, C).astype(np.float32)
    return coor, depth.astype(np.float32), feat


def _pool_float64(coor, depth, feat, grid):
    """The pooled grid by a float64 scatter-add (independent of both)."""
    B, N, D, H, W, _ = coor.shape
    C = feat.shape[-1]
    gx, gy, gz = grid.grid_size
    v = np.floor((coor - np.float32(grid.lower_bound))
                 / np.float32(grid.interval)).astype(np.int64)
    inside = np.all((v >= 0) & (v < np.asarray([gx, gy, gz])), axis=-1)
    b = np.arange(B).reshape(B, 1, 1, 1, 1)
    rank = ((b * gz + v[..., 2]) * gy + v[..., 1]) * gx + v[..., 0]
    prod = (depth.astype(np.float64)[..., None]
            * feat.astype(np.float64)[:, :, None])
    out = np.zeros((B * gz * gy * gx, C))
    np.add.at(out, rank[inside], prod[inside])
    return out.reshape(B, gz, gy, gx, C)


@pytest.mark.parametrize('B,N,D,H,W,C,seed', [
    (1, 2, 8, 16, 16, 8, 0),      # P = 4096: the JAX path is Pallas segsum
    (2, 2, 5, 3, 7, 4, 1),        # P = 420, two batch entries
])
def test_bev_pool_matches_jax_and_float64(B, N, D, H, W, C, seed):
    kw = dict(x=(-4, 4, 1.0), y=(-4, 4, 1.0), z=(-1, 3, 1.0),
              depth=(1.0, 1.0 + D, 1.0))
    jg, tg = JGrid(**kw), TGrid(**kw)
    coor, depth, feat = _random_pool_problem(B, N, D, H, W, C, tg, seed)
    ref = _pool_float64(coor, depth, feat, tg)

    ti = tbp.prepare_pooling_index(_t(coor), tg)
    got = tbp.bev_pool(_t(depth), _t(feat), ti, tg).numpy()
    # the direct fp32 sum over a voxel's few points
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)

    ji = j_prepare_pooling_index(jnp.asarray(coor), jg)
    want = np.asarray(j_bev_pool(jnp.asarray(depth), jnp.asarray(feat), ji,
                                 jg))
    # JAX differences a running sum over up to P points: its error grows
    # with the prefix, so it is held to float64 more loosely
    np.testing.assert_allclose(want, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    P = coor.size // 3
    if P % BLK == 0:
        d = jnp.asarray(depth.reshape(-1))[ji.ranks_depth]
        f = jnp.asarray(feat.reshape(-1, C))[ji.ranks_feat]
        seg = np.asarray(boundary_segment_sum(
            d, f, ji.ranks_bev, B * tg.size_z * tg.size_y * tg.size_x,
            ji.bounds))
        np.testing.assert_allclose(got.reshape(seg.shape), seg,
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize('preset', ['tiny', 'midsize'])
def test_bev_pool_on_rig_matches_jax(preset):
    """The rig's index, random depth and bf16-representable features: the
    pooled voxels equal JAX's in fp32 and, cast to bf16, within one ulp
    (plus the fp32 tolerance)."""
    jc, (s2k, intr, prot, ptr, bda, _) = _geometry(preset)
    tc = getattr(tcfg, f'{preset}_model_config')()
    fr = jgeo.make_frustum(jc.grid.depth, jc.input_size, jc.vt.downsample)
    coor = np.asarray(jgeo.frustum_to_ego(fr, s2k, intr, prot, ptr, bda))
    B, N, D, h, w, _ = coor.shape
    C = tc.vt.feature_channels
    rng = np.random.RandomState(2)
    depth = rng.rand(B, N, D, h, w).astype(np.float32)
    feat = _t(rng.randn(B, N, h, w, C).astype(np.float32)).bfloat16()
    want = np.asarray(j_bev_pool(
        jnp.asarray(depth), jnp.asarray(feat.float().numpy()),
        j_prepare_pooling_index(jnp.asarray(coor), jc.grid), jc.grid))
    ti = tbp.prepare_pooling_index(_t(coor), tc.grid)
    got = tbp.bev_pool(_t(depth), feat, ti, tc.grid)
    assert got.dtype == torch.float32 and np.abs(want).max() > 0
    # JAX differences a running sum over the sorted points (see above)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    got16 = tbp.bev_pool(_t(depth), feat, ti, tc.grid,
                         out_dtype=torch.bfloat16)
    assert got16.dtype == torch.bfloat16
    want16 = _t(want).bfloat16().float()
    assert bool(((got16.float() - want16).abs()
                 <= 1e-4 + 2 ** -7 * want16.abs()).all())


@pytest.mark.parametrize('feat_dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('out_dtype', [torch.float32, torch.bfloat16])
def test_bev_pool_out_dtype_is_plain_cast_once(feat_dtype, out_dtype):
    kw = dict(x=(-4, 4, 1.0), y=(-4, 4, 1.0), z=(-1, 3, 1.0),
              depth=(1.0, 7.0, 1.0))
    tg = TGrid(**kw)
    coor, depth, feat = _random_pool_problem(1, 2, 6, 5, 7, 8, tg, 4)
    idx = tbp.prepare_pooling_index(_t(coor), tg)
    f = _t(feat).to(feat_dtype)
    got = tbp.bev_pool(_t(depth), f, idx, tg, out_dtype=out_dtype)
    want = tbp.bev_pool_plain(_t(depth).reshape(-1), f.reshape(-1, 8), idx,
                              int(idx.bounds.numel()) - 1).to(out_dtype)
    assert got.dtype == out_dtype
    assert torch.equal(got.reshape(want.shape), want)


@pytest.mark.parametrize('seed', [0, 1])
def test_embedding_bag_yardstick_matches_plain(seed):
    """``embedding_bag`` over the in-grid points computes K1's function:
    the library time in chip_smoke.py times the same work."""
    kw = dict(x=(-2, 2, 1.0), y=(-2, 2, 1.0), z=(0, 2, 1.0),
              depth=(1.0, 9.0, 1.0))
    tg = TGrid(**kw)
    coor, depth, feat = _random_pool_problem(2, 2, 8, 6, 8, 32, tg, seed)
    idx = tbp.prepare_pooling_index(_t(coor), tg)
    n_in = int(idx.bounds[-1])
    nvox = idx.bounds.numel() - 1
    depth_flat, feat_flat = _t(depth).reshape(-1), _t(feat).reshape(-1, 32)
    got = embedding_bag_pool(depth_flat, feat_flat, idx.ranks_depth[:n_in],
                             idx.ranks_feat[:n_in].long(), idx.bounds.long())
    want = tbp.bev_pool_plain(depth_flat, feat_flat, idx, nvox)
    assert got.shape == want.shape == (nvox, 32)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_bev_pool_plain_empty_voxels_and_sentinel():
    """Every voxel is written (zero where empty); out-of-grid points, which
    carry the sentinel rank, are dropped."""
    g = TGrid(x=(0, 2, 1.0), y=(0, 1, 1.0), z=(0, 1, 1.0), depth=(1, 2, 1))
    coor = torch.tensor([[0.5, 0.5, 0.5], [0.2, 0.7, 0.1], [5.0, 0.5, 0.5]]
                        ).reshape(1, 1, 1, 1, 3, 3)
    idx = tbp.prepare_pooling_index(coor, g)
    assert idx.bounds.tolist() == [0, 2, 2]
    assert idx.ranks_bev.tolist() == [0, 0, 2]
    depth = torch.tensor([0.5, 0.25, 1.0]).reshape(1, 1, 1, 1, 3)
    feat = torch.ones(1, 1, 1, 3, 2)
    out = tbp.bev_pool(depth, feat, idx, g)
    assert out.tolist() == [[[[[0.75, 0.75], [0.0, 0.0]]]]]


WA_CASES = [
    # (w, heads, c, shift, nWh, nWw, b): test_pallas_window_attn.py:37-42
    (4, 2, 16, 0, 3, 2, 2),
    (4, 2, 16, 2, 3, 2, 2),
    (4, 2, 16, 2, 1, 1, 3),
    (4, 2, 16, 1, 2, 4, 1),
    # Swin-B window: N = 144, head_dim 32, shift 6
    (12, 2, 64, 6, 2, 3, 1),
]


@pytest.mark.parametrize('w,heads,c,shift,nWh,nWw,b', WA_CASES)
def test_window_attention_matches_pallas(w, heads, c, shift, nWh, nWw, b):
    n, bn = w * w, b * nWh * nWw
    rng = np.random.RandomState(shift * 100 + c)
    q, k, v = (rng.randn(bn, n, c).astype(np.float32) for _ in range(3))
    bias = rng.randn(heads, n, n).astype(np.float32)
    want = np.asarray(fused_window_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias),
        nWh, nWw, w, shift, heads))
    got = twa.window_attention(_t(q), _t(k), _t(v), _t(bias), nWh, nWw, w,
                               shift, heads)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('nWh,nWw,w,shift', [(3, 2, 4, 2), (2, 5, 4, 1),
                                             (1, 1, 4, 2), (2, 3, 12, 6),
                                             (2, 2, 4, 0)])
def test_shift_masks_match_jax(nWh, nWw, w, shift):
    np.testing.assert_array_equal(twa.shift_masks(nWh, nWw, w, shift).numpy(),
                                  _full_masks(nWh, nWw, w, shift))


def test_window_attention_keeps_bf16_dtype():
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(2, 16, 8).astype(np.float32)
                                ).bfloat16() for _ in range(3))
    out = twa.window_attention(q, k, v, torch.zeros(1, 16, 16), 1, 2, 4, 2, 1)
    assert out.dtype == torch.bfloat16


def test_cuda_wrappers_refuse_cpu_tensors():
    q = torch.zeros(1, 144, 32)
    with pytest.raises(ValueError, match='CUDA'):
        twa.window_attention_cuda(q, q, q, torch.zeros(1, 144, 144), 1, 1, 12,
                                  0, 1)
    g = TGrid(x=(0, 2, 1.0), y=(0, 1, 1.0), z=(0, 1, 1.0), depth=(1, 2, 1))
    idx = tbp.prepare_pooling_index(torch.zeros(1, 1, 1, 1, 1, 3), g)
    with pytest.raises(ValueError, match='CUDA'):
        tbp.bev_pool_cuda(torch.ones(1), torch.ones(1, 2), idx, 2)
    feat = torch.zeros(1, 2, 2, 64)
    with pytest.raises(ValueError, match='CUDA'):
        plane_sweep.plane_sweep_cuda(feat, feat, torch.zeros(3, 2, 2, 3),
                                     torch.zeros(1, plane_sweep.CAM_WORDS),
                                     8, 8, 4, 5.0)


def test_build_without_nvcc_raises_naming_the_command(tmp_path, monkeypatch):
    monkeypatch.setattr(kernels.shutil, 'which', lambda name: None)
    monkeypatch.delenv('CUDA_HOME', raising=False)
    monkeypatch.setattr(kernels.os.path, 'isfile', lambda p: False)
    lib = kernels.KernelLibrary(build_dir=tmp_path)
    with pytest.raises(RuntimeError, match='nvcc .*sm_90a'):
        lib.build()
    assert lib.launches == {'bev_pool_fwd': 0, 'window_attn_fwd': 0,
                            'zwin_conv_fwd': 0, 'zwin_conv_null': 0,
                            'zwin_conv_fwd_epi': 0, 'index_mark': 0,
                            'index_count': 0, 'index_prefix': 0,
                            'index_set': 0, 'index_table': 0,
                            'index_maps': 0, 'plane_sweep_fwd': 0,
                            'window_in_fwd': 0, 'window_out_fwd': 0}
