"""The schedules and numerics that the tensor-core bodies of the port's
kernels rely on, emulated in plain torch on the CPU.

The CUDA kernels run only on the card; these tests hold, here, the order of
work they take and the roundings they add against the plain versions:

- K3 (``csrc/zwin_conv.cu``, bf16 body): the Hopper gather-GEMM.  The
  launch plan (``ops/zwin_conv.bf16_plan``): m64 blocks of one out cell and
  64 rows of a tile, or of two (four) cells and 32 (16) rows where that
  keeps more of the cell kernel resident beside 3 stages; Cout split into
  parts (a multiple of 8 each) only where it still does not fit (48 -> 48
  takes two cells a block, 48 -> 64 four, the rest one; none splits).  Per part, per tile, the taps that some active row
  finds, in order; per tap, the band of each found row gathered (the rest
  zero); per dz and consumer warpgroup (the first ceil(blocks / 2) blocks
  and the rest) with a valid (zo, zi) among its cells, per k16 step, one
  product per block, the cells whose in cell zi = stride*zo + dz - 1 - (ds -
  1)*f_in is not valid reading zeros.  In fp32 it must equal
  ``zwin_conv_plain`` within 1e-5, at each distinct geometry of the 9
  full-size launches (SubM 16/32/48, stride-2 16->32, 32->48, 48->64, fold
  8) and at the two edge geometries of ``chip_smoke.py`` (B = 2, Cout 24,
  f_out 4, stride 2; Cin 64, Cout 8, f_in 4), on small random maps with
  misses and ``mask_out`` holes.  Every product it issues is for a found
  tap and a dz with a valid pair in its warpgroup's cells.  The same cases
  check that the valid zo of each (ds, dz) form the contiguous range that
  ``band_pairs`` gives, and that each out cell runs exactly 3 cell GEMMs per
  (dx, dy).
- K2 (``csrc/window_attn.cu``, bf16 body): S in three m64 tiles of query
  rows (the last one padded from 144 to 192 rows, the keys past N at
  -inf), P V as two bf16 products, of P's bf16 high part and of its bf16
  low part (P - high), O normalised by the fp32 row sum and cast to bf16.
  It must stay within the card check's tolerance (atol 1e-3 + rtol 1e-2
  |plain|, one bf16 ulp of the output) of ``window_attention_plain`` at the
  four Swin-B head counts, shift 0 and 6, and at N = 49 and 100 (padded to
  144).  P in bf16 alone does not: at 4 heads, shift 6, it is two ulps off.
- The microbenchmark's maps (``tools/profile_torch_zwin_micro.py``): the
  contiguous and compute-only maps are neighbour maps with the real map's
  misses, and the plain version on them equals JAX's ``zband_conv_apply``.
- K1 (``csrc/bev_pool.cu``): the work table and the order of the sums.  A
  run of at most ``max_short`` points is a short item, summed point by point
  in order by a group of C/8 lanes; a longer run (``long_voxels``, longest
  first) is a warp item: per batch of 32 points, sub-group sg of the 32/G
  sub-groups (G = C/8) adds points sg, sg + 32/G, ..., and the sub-groups'
  sums are added by a xor tree.  On a hand-made index with runs of 0, 1,
  L - 1, L, L + 1 and 480 points and on a random rig, the items cover every
  in-grid point once, each within one voxel's run, every voxel is written
  by exactly one item, and the emulated sums equal ``bev_pool_plain``
  within 1e-5 in fp32 and within one bf16 ulp once cast.

Inputs are made with numpy from a seed.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusionocc_tpu.ops import zfold as jzf
from fusionocc_tpu_torch.config import GridConfig as TGrid
from fusionocc_tpu_torch.ops import bev_pool as tbp
from fusionocc_tpu_torch.ops import window_attn as twa
from fusionocc_tpu_torch.ops import zwin_conv as tzw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from chip_smoke import POOL_BF16_TOL, WA_TOL  # noqa: E402
from tools import profile_torch_zwin_micro as micro  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

ROWS = 32          # the compute-only map's block of rows
TILE = tzw.TILE    # K3's M of a product

# (Cin, Cout, stride) of the full-size encoder's 9 launches, fold 8 in and
# out: SubM at stages 0-2, then each stage's stride-2 conv
FULL_GEOMETRIES = {'subm16': (16, 16, 1), 'subm32': (32, 32, 1),
                   'subm48': (48, 48, 1), 'down16_32': (16, 32, 2),
                   'down32_48': (32, 48, 2), 'down48_64': (48, 64, 2)}
# chip_smoke.py's edge shapes: (B, S_in, S_out, Cin, Cout, f_in, f_out,
# stride), at its row counts scaled down
EDGE_GEOMETRIES = {'edge_b2_cout24_fout4_s2': (2, 30, 20, 16, 24, 8, 4, 2),
                   'edge_cin64_cout8_fin4': (1, 26, 26, 64, 8, 4, 4, 1)}


def random_zwin_inputs(seed, B, s_in, s_out, cin, cout, fold=8):
    """Random feats, a neighbour map with about 30 % misses (= s_in) and a
    mask_out with about 20 % holes, and a (27, Cin, Cout) weight."""
    rng = np.random.RandomState(seed)
    feats = rng.randn(B, s_in, fold * cin).astype(np.float32)
    nbr = rng.randint(0, s_in, size=(B, s_out, 27)).astype(np.int32)
    nbr[rng.rand(B, s_out, 27) < 0.3] = s_in
    mask = rng.rand(B, s_out) > 0.2
    weight = (0.1 * rng.randn(27, cin, cout)).astype(np.float32)
    return feats, nbr, mask, weight


def k3_schedule(feats, mask_out, nbr, weight, f_in, f_out, stride):
    """The bf16 body's order of work, in fp32 (see the module docstring);
    returns the output, the issued products (part, tile, t, warpgroup,
    block, dz), the tiles' feats rows and the block size."""
    B, s_in, l_in = feats.shape
    s_out = nbr.shape[1]
    cin, cout = weight.shape[1], weight.shape[2]
    bands = tzw.z_bands(f_in, f_out, stride)
    zb, parts, _ = tzw.bf16_plan(cin, cout, max(n for _, n in bands))
    rows_t = TILE // zb
    part = cout // parts
    nblk = -(-f_out // zb)
    bpw = -(-nblk // 2)
    rows = B * s_out
    b_of = torch.arange(rows) // s_out
    flat = nbr.reshape(rows, 27).long()
    active = mask_out.reshape(rows)
    src = torch.where((flat < s_in) & active[:, None],
                      b_of[:, None] * s_in + flat, -1)
    tiles = -(-rows // rows_t)
    src = torch.cat([src, src.new_full((tiles * rows_t - rows, 27), -1)])
    table = feats.reshape(B * s_in, l_in).float()
    out = torch.zeros(tiles * rows_t, f_out, cout)
    issued = []
    for p in range(parts):
        co = slice(p * part, (p + 1) * part)
        for tile in range(tiles):
            blk = src[tile * rows_t:(tile + 1) * rows_t]
            acc = torch.zeros(rows_t, f_out, part)
            for t in range(27):
                ds = t % 3
                zi_lo, nzi = bands[ds]
                found = blk[:, t] >= 0
                if not nzi or not bool(found.any()):
                    continue
                stage = torch.zeros(rows_t, nzi, cin)
                stage[found] = table[blk[found, t],
                                     zi_lo * cin:(zi_lo + nzi) * cin
                                     ].reshape(-1, nzi, cin)
                for dz in range(3):
                    for wg in range(2):
                        # the warpgroup's blocks; all of them are issued
                        # when one has a valid (zo, zi) pair
                        mine = [wg * bpw + z for z in range(bpw)
                                if wg * bpw + z < nblk]
                        cells = [zo for j in mine
                                 for zo in range(j * zb, (j + 1) * zb)
                                 if zo < f_out and 0 <= stride * zo + dz - 1
                                 - (ds - 1) * f_in < f_in]
                        if not cells:
                            continue
                        issued += [(p, tile, t, wg, z, dz)
                                   for z in range(4 // zb)]
                        for kk in range(cin // 16):
                            k16 = slice(kk * 16, (kk + 1) * 16)
                            for zo in cells:
                                zi = stride * zo + dz - 1 - (ds - 1) * f_in
                                acc[:, zo] += (stage[:, zi - zi_lo, k16]
                                               @ weight[t - ds + dz, k16, co])
            out[tile * rows_t:(tile + 1) * rows_t, :, co] = acc
    out = out[:rows].reshape(B, s_out, f_out * cout)
    return torch.where(mask_out[..., None], out, 0), issued, src, zb


def k3_geometry(name):
    """(B, S_in, S_out, Cin, Cout, f_in, f_out, stride) of a test case."""
    if name in EDGE_GEOMETRIES:
        return EDGE_GEOMETRIES[name]
    cin, cout, stride = FULL_GEOMETRIES[name]
    return 2, 45, 45 if stride == 1 else 58, cin, cout, 8, 8, stride


@pytest.mark.parametrize('geometry', list(FULL_GEOMETRIES)
                         + list(EDGE_GEOMETRIES))
def test_k3_tensor_core_schedule_matches_plain(geometry):
    B, s_in, s_out, cin, cout, f_in, f_out, stride = k3_geometry(geometry)
    feats, nbr, mask, weight = (torch.from_numpy(x) for x in
                                random_zwin_inputs(11, B, s_in, s_out, cin,
                                                   cout, f_in))
    args = (f_in, f_out, stride)
    want = tzw.zwin_conv_plain(feats, mask, nbr, weight, *args)
    got, issued, src, zb = k3_schedule(feats, mask, nbr, weight, *args)
    assert got.shape == want.shape == (B, s_out, f_out * cout)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)

    # every product is for a tap some row of its tile finds and a dz with
    # a valid (zo, zi) pair in its warpgroup's out cells, and none is
    # issued twice per part
    bands = tzw.z_bands(f_in, f_out, stride)
    rows_t = TILE // zb
    half = -(-f_out // (2 * zb)) * zb       # out cells of warpgroup 0
    for _, tile, t, wg, _, dz in issued:
        assert bool((src[tile * rows_t:(tile + 1) * rows_t, t] >= 0).any())
        pairs = tzw.band_pairs(f_in, f_out, stride, t % 3)
        assert any((zo, dz) in pairs
                   for zo in range(wg * half, min(f_out, (wg + 1) * half)))
        assert bands[t % 3][1] > 0
    assert len(set(issued)) == len(issued)
    plan = tzw.bf16_plan(cin, cout, max(n for _, n in bands))
    assert plan[2] >= tzw.MIN_STAGES and (cout // plan[1]) % 8 == 0
    if geometry in FULL_GEOMETRIES:
        # (zb, Cout parts): the 48-channel layers take blocks of two and
        # four cells, so both keep their whole kernel
        assert plan[:2] == {'subm48': (2, 1), 'down48_64': (4, 1)}.get(
            geometry, (1, 1))

    for ds, (zi_lo, nzi) in enumerate(bands):
        pairs = tzw.band_pairs(f_in, f_out, stride, ds)
        for dz in range(3):
            zos = [zo for zo in range(f_out)
                   if 0 <= stride * zo + dz - 1 - (ds - 1) * f_in < f_in]
            assert zos == [zo for zo, d in pairs if d == dz]
            assert zos == list(range(zos[0], zos[-1] + 1)) if zos else True
    if geometry in FULL_GEOMETRIES:
        for zo in range(f_out):
            gemms = sum(0 <= stride * zo + dz - 1 - (ds - 1) * f_in < f_in
                        for ds in range(3) for dz in range(3))
            assert gemms == 3


def split_p_attention(q, k, v, bias, nWh, nWw, w, shift, heads):
    """The bf16 body's numerics: fp32 scores over three m64 tiles of query
    rows (padded to 192, zero rows) against the keys padded to 144 (zero
    rows, scored -inf), fp32 softmax, P V as the products of P's bf16 high
    and low parts, O normalised and cast; the padding rows dropped."""
    bn, n, c = q.shape
    d = c // heads
    np_, mp = 144, 192
    qh, kh, vh = (t.float().reshape(bn, n, heads, d).transpose(1, 2)
                  for t in (q, k, v))
    qp = torch.zeros(bn, heads, mp, d)
    qp[:, :, :n] = qh
    kp, vp = (torch.zeros(bn, heads, np_, d) for _ in range(2))
    kp[:, :, :n], vp[:, :, :n] = kh, vh
    bp = torch.zeros(heads, mp, np_)
    bp[:, :n, :n] = bias
    s = qp @ kp.transpose(-1, -2) * d ** -0.5 + bp[None]
    if shift:
        nw = nWh * nWw
        m = torch.zeros(nw, mp, np_)
        m[:, :n, :n] = twa.shift_masks(nWh, nWw, w, shift)
        s = (s.view(bn // nw, nw, heads, mp, np_) + m[None, :, None]
             ).view(bn, heads, mp, np_)
    s[..., n:] = -torch.inf
    p = torch.exp2((s - s.amax(-1, keepdim=True)) * 1.4426950408889634)
    hi = p.bfloat16().float()
    lo = (p - hi).bfloat16().float()
    o = (hi @ vp + lo @ vp) / p.sum(-1, keepdim=True)
    return o[:, :, :n].transpose(1, 2).reshape(bn, n, c).bfloat16()


def k2_within_tolerance(heads, shift, w, nWh, nWw, seed):
    n, c, bn = w * w, 32 * heads, nWh * nWw
    rng = np.random.RandomState(seed)
    qkv = torch.from_numpy(rng.randn(bn, n, 3 * c).astype(np.float32)
                           ).bfloat16()
    q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
    bias = torch.from_numpy(rng.randn(heads, n, n).astype(np.float32))
    args = (q, k, v, bias, nWh, nWw, w, shift, heads)
    want = twa.window_attention_plain(*args).float()
    got = split_p_attention(*args).float()
    bound = WA_TOL['atol'] + WA_TOL['rtol'] * want.abs()
    assert bool(((got - want).abs() <= bound).all()), \
        (got - want).abs().max().item()


@pytest.mark.parametrize('shift', [0, 6])
@pytest.mark.parametrize('heads', [4, 8, 16, 32])
def test_k2_split_probabilities_within_card_tolerance(heads, shift):
    k2_within_tolerance(heads, shift, 12, 2, 2, heads + shift)


@pytest.mark.parametrize('w,heads,shift', [(7, 2, 0), (7, 2, 3), (10, 4, 0),
                                           (10, 4, 5)])
def test_k2_padded_windows_within_card_tolerance(w, heads, shift):
    # N = 49 and 100: keys padded to 144, query rows to 192
    k2_within_tolerance(heads, shift, w, 2, 3, w + heads + shift)


@pytest.mark.parametrize('kind', ['contiguous', 'compute_only'])
def test_microbenchmark_maps_are_neighbour_maps(kind):
    s = 64
    feats, nbr, mask, weight = random_zwin_inputs(7, 1, s, s, 32, 32)
    real = torch.from_numpy(nbr)
    made = {'contiguous': micro.contiguous_map,
            'compute_only': micro.compute_only_map}[kind](real, s)
    assert made.dtype == torch.int32 and made.shape == real.shape
    assert bool(((made >= 0) & (made <= s)).all())
    assert torch.equal(made == s, real == s)
    hit = made[made < s]
    if kind == 'compute_only':
        assert int(hit.max()) < ROWS
    else:
        r = torch.arange(s)[None, :, None].expand_as(real)
        t = torch.arange(27)[None, None].expand_as(real)
        want = (r + t - 13).clamp(0, s - 1)
        assert torch.equal(made[real < s].long(), want[real < s])
    got = tzw.zwin_conv_plain(torch.from_numpy(feats), torch.from_numpy(mask),
                              made, torch.from_numpy(weight), 8, 8, 1)
    ref = jzf.zband_conv_apply(jnp.asarray(feats), jnp.asarray(mask),
                               jnp.asarray(made.numpy()), jnp.asarray(weight),
                               8, 8, 1)
    # fp32 sums of up to 27 * 3 * 32 products, taken in another order
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_null_body_wrapper_refuses_fp32_and_cpu_tensors(dtype):
    feats = torch.zeros(1, 4, 8 * 16, dtype=dtype)
    args = (feats, torch.ones(1, 4, dtype=torch.bool),
            torch.zeros(1, 4, 27, dtype=torch.int32),
            torch.zeros(27, 16, 16), 8, 8, 1)
    error = TypeError if dtype == torch.float32 else ValueError
    with pytest.raises(error, match='bf16 only' if error is TypeError
                       else 'CUDA'):
        tzw.zwin_conv_null_cuda(*args)


def handmade_pool_problem(max_short, C, seed):
    """Runs of 0, 1, L - 1, L, L + 1 and 480 points (L = max_short) among
    a few short ones, 40 points out of the grid, random depth and feature
    rows."""
    L = max_short
    runs = [0, 1, L - 1, 3, L, 0, L + 1, 480, 2, 0, 2 * L + 5]
    rng = np.random.RandomState(seed)
    n_in = sum(runs)
    P = n_in + 40
    num_voxels = len(runs)
    bounds = torch.tensor(np.concatenate([[0], np.cumsum(runs)]),
                          dtype=torch.int32)
    ranks_bev = np.concatenate([np.repeat(np.arange(num_voxels), runs),
                                np.full(40, num_voxels)])
    n_rows = 97
    idx = tbp.PoolingIndex(
        torch.from_numpy(rng.permutation(P).astype(np.int32)),
        torch.from_numpy(rng.randint(0, n_rows, P).astype(np.int32)),
        torch.from_numpy(ranks_bev.astype(np.int32)), bounds,
        tbp.long_runs(bounds, L), L)
    depth = torch.from_numpy(rng.rand(P).astype(np.float32))
    feat = torch.from_numpy(rng.randn(n_rows, C).astype(np.float32))
    return depth, feat, idx, num_voxels


def rig_pool_problem(max_short, C, seed):
    """A random frustum of 2 x 2 x 8 x 6 x 8 points over a 4 x 4 x 2 grid
    (B = 2), dense near one corner, so runs from 1 point to some tens."""
    grid = TGrid(x=(-2, 2, 1.0), y=(-2, 2, 1.0), z=(0, 2, 1.0),
                 depth=(1.0, 9.0, 1.0))
    rng = np.random.RandomState(seed)
    B, N, D, H, W = 2, 2, 8, 6, 8
    coor = np.concatenate([
        rng.normal(-1.0, 1.2, (B, N, D, H, W, 2)),
        rng.uniform(-0.3, 2.3, (B, N, D, H, W, 1))], -1).astype(np.float32)
    idx = tbp.prepare_pooling_index(torch.from_numpy(coor), grid)
    idx = idx._replace(long_voxels=tbp.long_runs(idx.bounds, max_short),
                       max_short=max_short)
    depth = torch.from_numpy(rng.rand(B * N * D * H * W).astype(np.float32))
    feat = torch.from_numpy(rng.randn(B * N * H * W, C).astype(np.float32))
    return depth, feat, idx, B * 2 * 4 * 4


POOL_PROBLEMS = {'handmade': handmade_pool_problem, 'rig': rig_pool_problem}


def k1_items(idx, num_voxels):
    """The kernel's work items (voxel, begin, end, kind): a short group for
    every voxel whose run is at most max_short, a warp per long voxel."""
    b = idx.bounds.tolist()
    items = [(v, b[v], b[v + 1], 'short') for v in range(num_voxels)
             if b[v + 1] - b[v] <= idx.max_short]
    return items + [(v, b[v], b[v + 1], 'long')
                    for v in idx.long_voxels.tolist()]


def k1_schedule(depth, feat, idx, num_voxels):
    """The kernel's order of the fp32 sums (see the module docstring)."""
    C = feat.shape[1]
    S = 32 // (C // 8)
    prod = depth[idx.ranks_depth.long(), None] * feat[idx.ranks_feat.long()]
    out = torch.zeros(num_voxels, C)
    for v, begin, end, kind in k1_items(idx, num_voxels):
        if kind == 'short':
            for p in range(begin, end):
                out[v] = out[v] + prod[p]
            continue
        part = torch.zeros(S, C)
        for base in range(begin, end, 32):
            for k in range(32 // S):
                for sg in range(S):
                    if base + sg + k * S < end:
                        part[sg] = part[sg] + prod[base + sg + k * S]
        while part.shape[0] > 1:
            part = part[0::2] + part[1::2]
        out[v] = part[0]
    return out


@pytest.mark.parametrize('problem,max_short,C', [
    ('handmade', 16, 32), ('handmade', 8, 8), ('handmade', 32, 8),
    ('rig', 16, 32), ('rig', 4, 8)])
def test_k1_work_table_covers_points_and_voxels_once(problem, max_short, C):
    depth, feat, idx, num_voxels = POOL_PROBLEMS[problem](max_short, C, 3)
    runs = (idx.bounds[1:] - idx.bounds[:-1]).tolist()
    assert max(runs) > max_short >= min(r for r in runs if r)
    n_in = int(idx.bounds[-1])
    long = idx.long_voxels.tolist()
    assert long == sorted((v for v in range(num_voxels)
                           if runs[v] > max_short),
                          key=lambda v: (-runs[v], v))
    cover = torch.zeros(len(idx.ranks_bev), dtype=torch.int64)
    writes = torch.zeros(num_voxels, dtype=torch.int64)
    for v, begin, end, kind in k1_items(idx, num_voxels):
        assert (end - begin <= max_short) == (kind == 'short')
        # a contiguous stretch of the sorted points, all in voxel v
        assert bool((idx.ranks_bev[begin:end] == v).all())
        cover[begin:end] += 1
        writes[v] += 1
    assert bool((cover[:n_in] == 1).all()) and bool((cover[n_in:] == 0).all())
    assert bool((writes == 1).all())


@pytest.mark.parametrize('problem,max_short,C', [
    ('handmade', 16, 32), ('handmade', 8, 8), ('rig', 16, 32),
    ('rig', 4, 8)])
def test_k1_schedule_matches_plain(problem, max_short, C):
    depth, feat, idx, num_voxels = POOL_PROBLEMS[problem](max_short, C, 5)
    want = tbp.bev_pool_plain(depth, feat, idx, num_voxels)
    got = k1_schedule(depth, feat, idx, num_voxels)
    assert bool(want.abs().amax(1).gt(0).any())
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    # the bf16 epilogue: each sum rounded once, within one ulp of the plain
    # sum rounded once
    got16, want16 = got.bfloat16().float(), want.bfloat16().float()
    bound = POOL_BF16_TOL['atol'] + POOL_BF16_TOL['rtol'] * want16.abs()
    assert bool(((got16 - want16).abs() <= bound).all())
