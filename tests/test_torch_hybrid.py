"""The port's hybrid data x spatial mesh on gloo processes on the CPU.

``parallel.mesh.hybrid_mesh(n_data, n_spatial)`` with
``parallel.hybrid.HybridFusionOcc(cfg, mesh)``, the tiny config, fp32.  Three
spawns (``torch_parallel_ranks.hybrid_checks``), side by side: 4 ranks at
(2, 2), 2 ranks at (1, 2) and 4 ranks at (1, 4), each running every check
of this file in turn.  At 2 spatial ranks
the tiny trunk's Y levels 20, 10 and 5 split 10 + 10, 5 + 5 and 3 + 2: the
last level is uneven at both meshes.

(a) The image-only forward at (2, 2) against JAX's forward under its
    (2, 2) hybrid mesh on the same weights (``tests/test_sharding.py:
    19-45``; 8 virtual CPU devices, ``tests/conftest.py``; compiled with
    ``XLA_ORDERED``) within 5e-3, as that test holds JAX's own sharded
    forward, and against the port's one process within 1e-4.  (JAX
    compiles its LiDAR encoder slowly on the
    CPU, so the JAX side is the image-only model; the multi-modal model's
    mesh is held against the port's one process in (b).)
(b) The multi-modal forward (LiDAR encoder on the z-folded path) at (2, 2)
    and (1, 2): two-pass and ``batch_frames`` logits, depth and seg within
    1e-4 of one process; ``predict`` equal to one process's argmax on at
    least 0.999 of voxels, and the same with the caller's indices of the
    rank's images (``HybridFusionOcc.batch_pooling_indices``); an index
    of every image raises.
(c) The halo rows each layer sends, per rank, against the counts worked
    out by hand for the tiny trunk: one row each way around a 3x3x3 conv
    at stride 1, one row one way around a stride-2 conv and an upsample
    whose blocks need it, none around the 1x1x1 conv and the replicated
    ``pre_process_net``; the halo bytes are those rows times each layer's
    row size (its input's channels, Z and X), nothing more.
(d) The exchange's gradient: a random float64 volume's block through
    ``HybridMesh.exchange`` to the rows a stride-2 output block reads (7
    rows: uneven), the backward of a random cotangent, against autograd
    through the gathered volume in one process.
(e) ``predict_streaming_batch`` (chunk 2) and ``predict_streaming_scan``
    at (2, 2) on a 4-frame clip with a reset at frame 2, against one
    process, as ``tests/test_sharding.py:162-171`` holds JAX's: at least
    0.999 of voxels agree, the carried state within 5e-3, ``valid``
    equal.
(f) One train step at (2, 2) (2 samples, one per data rank), every random
    draw on, against one process at batch 2 by phase 9's noise rule
    (``test_torch_parallel.assert_takes_the_step``), the 4 ranks
    bit-identical after it.
(g) XLA's blocks where the last ones are empty (5 rows over 4 ranks, 6
    cameras over 4 and 5, 50 rows over 11), and a 3x3x3 conv at stride 1
    and 2 and the FPN's upsample, each rank's block of them computed in
    one process with the rows it reads, against the whole volume's.
(i) The hybrid mesh at (1, 4) on a batch of 1, which JAX runs (XLA pads
    the empty blocks): the tiny model's 2 cameras leave ranks 2 and 3
    none, and its last Y level of 5 rows leaves rank 3 none.  The
    image-only forward against JAX's under its (1, 4) mesh within 5e-3 and
    the port's one process within 1e-4; the multi-modal two-pass and
    ``batch_frames`` forwards and ``predict`` against one process as in
    (b); one train step, draws on, against one process by (f)'s rule, the
    4 ranks bit-identical.
(h) ``OccupancyMetric(grid=, mesh=)`` at (2, 2): each rank updates with
    its data rank's samples of one process's predictions and takes its Y
    rows; the matrix summed over the 4 ranks and ``compute()`` (buckets
    included) equal one process's over the batch.
"""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from fusionocc_tpu import config as jcfg
from fusionocc_tpu.models.fusion_occ import FusionOcc as JFusionOcc
from fusionocc_tpu.parallel.mesh import hybrid_mesh as j_hybrid_mesh
from fusionocc_tpu_torch import config as tcfg
from fusionocc_tpu_torch.data.synthetic import synthetic_batch
from fusionocc_tpu_torch.eval.metrics import OccupancyMetric
from fusionocc_tpu_torch.models.fusion_occ import (FusionOcc, init_weights,
                                                   map_batch, spread_weights,
                                                   stack_batches)
from fusionocc_tpu_torch.ops.grid_sample import resize_trilinear
from fusionocc_tpu_torch.parallel import mesh, spatial
from fusionocc_tpu_torch.weights import state_dict_from_flax

import test_torch_parallel as ttp
import torch_parallel_ranks as tpr
from test_torch_lidar_model import _snap
from test_torch_slice import _init_fn
from test_torch_streaming import spread_variables, to_jax
from torch_threads import one_torch_thread  # noqa: E402,F401

# XLA's memory-minimizing scheduler for JAX's sharded forwards.  With the
# default concurrency-optimized one, a device's program runs an all-reduce
# inside a while loop and a collective permute at once, each on a pool
# thread, and XLA's in-process collectives can then deadlock: some devices
# never reach the rendezvous, and after 60 s XLA's watchdog aborts the
# process ("Termination timeout ... only 2 of them arrived on time"),
# which crashed the test worker under the whole suite's load.
XLA_ORDERED = {'xla_cpu_enable_concurrency_optimized_scheduler': False}

JAX_TOL = dict(rtol=5e-3, atol=5e-3)    # tests/test_sharding.py:44
ONE_TOL = dict(rtol=1e-4, atol=1e-4)    # fp32 sums in another order
STATE_TOL = dict(rtol=5e-3, atol=5e-3)  # tests/test_sharding.py:168-169
MIN_AGREE = 0.999
MESHES = {'2x2': (2, 2), '1x2': (1, 2)}
B = 2


def multimodal_config():
    cfg = tcfg.tiny_model_config(use_lidar=True)
    return dataclasses.replace(cfg, lidar=dataclasses.replace(
        cfg.lidar, backend='zfold', zconv='zband'))


def snapped(cfg, seed):
    b = synthetic_batch(cfg, B, seed, num_points=512, device='cpu')
    return b._replace(points=torch.from_numpy(_snap(b.points)))


def image_only_inputs(tmp):
    """JAX's hybrid-mesh forward and the port's one process on the same
    image-only weights; the port's inputs saved for the ranks.  JAX's
    forwards compile with ``XLA_ORDERED``."""
    jc = jcfg.tiny_model_config(use_lidar=False)
    tc = tcfg.tiny_model_config(use_lidar=False)
    batch = snapped(tc, 0)
    jmodel = JFusionOcc(jc)
    variables = spread_variables(_init_fn(jmodel, to_jax(batch)), seed=3)
    model = FusionOcc(tc, device='cpu')
    model.load_state_dict(state_dict_from_flax(
        variables['params'], variables['batch_stats'], tc), strict=True)
    first = map_batch(lambda a: a[:1], batch)
    ref = {}
    for name, (nd, ns), b in (('2x2', (2, 2), batch), ('1x4', (1, 4), first)):
        jmesh = j_hybrid_mesh(nd, ns)
        repl = NamedSharding(jmesh, P())
        dsh = NamedSharding(jmesh, P('data'))
        jbatch = jax.tree_util.tree_map(lambda x: jax.device_put(x, dsh),
                                        to_jax(b))
        sharded = JFusionOcc(jc, mesh=jmesh)
        with torch.inference_mode():
            one = model(b)['occ_logits']
        args = (jax.device_put(variables, repl), jbatch)
        forward = jax.jit(
            lambda v, b: sharded.apply(v, b, train=False)['occ_logits'],
            in_shardings=(repl, dsh)).lower(*args).compile(
                compiler_options=XLA_ORDERED)
        ref[name] = {'jax': np.asarray(forward(*args)), 'one': one}
    paths = {}
    for name, b in (('2x2', batch), ('1x4', first)):
        paths[name] = os.path.join(tmp, f'image_only_{name}.pt')
        torch.save({'model': model.state_dict(), 'config': tc, 'batch': b},
                   paths[name])
    return paths, ref


def multimodal_inputs(tmp):
    """Spread weights, a batch of 2, a 4-frame clip with a reset at frame
    2, and one process's outputs on them."""
    cfg = multimodal_config()
    model = spread_weights(FusionOcc(cfg, device='cpu'),
                           torch.Generator().manual_seed(0))
    batch = snapped(cfg, 0)
    frames = [snapped(cfg, s) for s in range(4)]
    resets = torch.zeros(4, B, dtype=torch.bool)
    resets[2] = True
    with torch.inference_mode():
        one = {'two_pass': model(batch),
               'batch_frames': model(batch, batch_frames=True),
               'predict': model.predict(batch)}
        stacked = stack_batches(frames)
        state = model.init_streaming_state(B)
        one['metric'] = OccupancyMetric(grid=cfg.grid)
        one['metric'].update(one['predict'], batch.voxel_semantics,
                             mask_camera=batch.mask_camera)
        one['stream'] = {
            'batch': model.predict_streaming_batch(stacked, state,
                                                   resets=resets, chunk=2),
            'scan': model.predict_streaming_scan(stacked, state,
                                                 resets=resets)}
    path = os.path.join(tmp, 'multimodal.pt')
    torch.save({'model': model.state_dict(), 'config': cfg, 'batch': batch,
                'frames': frames, 'resets': resets,
                'pred': one['predict']}, path)
    first = map_batch(lambda a: a[:1], batch)
    with torch.inference_mode():
        one['1x4'] = {'two_pass': model(first),
                      'batch_frames': model(first, batch_frames=True)}
    path14 = os.path.join(tmp, 'multimodal_1x4.pt')
    torch.save({'model': model.state_dict(), 'config': cfg, 'batch': first},
               path14)
    return path, path14, one


def train_inputs(tmp, batch_size: int = B, tag: str = 'train'):
    """(f): the draws config's start and one process's step from it, as it
    is and moved twice (``test_torch_parallel``'s noise rule)."""
    tc = ttp.draws_config(1)
    model = init_weights(FusionOcc(tc.model, device='cpu'),
                         torch.Generator().manual_seed(0))
    saved = {'model': model.state_dict(),
             'batch': synthetic_batch(tc.model, batch_size, 0, device='cpu')}
    path = os.path.join(tmp, f'{tag}.pt')
    torch.save(saved, path)
    imgs = saved['batch'].imgs
    moved = imgs * (1 + ttp.NOISE * torch.randn(
        imgs.shape, generator=torch.Generator().manual_seed(5)))
    paths = [path] + [ttp._perturbed(tmp, f'{tag}_{w}', saved, moved, w)
                      for w in (False, True)]
    return tc, path, [[tpr.train_run(0, 1, tc, p, 1) for p in paths]]


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp('hybrid'))
    img_paths, img_ref = image_only_inputs(tmp)
    mm_path, mm14_path, mm_ref = multimodal_inputs(tmp)
    tc, train_path, train_refs = train_inputs(tmp)
    _, train14_path, train14_refs = train_inputs(tmp, 1, 'train_1x4')
    # the three meshes' groups side by side
    square, row, quad = (f.result() for f in [
        tpr.started(tpr.hybrid_checks, 4, os.path.join(tmp, 'r22'), 2, [
            (img_paths['2x2'], ['forward']),
            (mm_path, ['forward', 'stream', 'halo', 'metric']),
            (None, [('train', tc, train_path, 1)])]),
        tpr.started(tpr.hybrid_checks, 2, os.path.join(tmp, 'r12'), 2, [
            (mm_path, ['forward', 'halo'])]),
        tpr.started(tpr.hybrid_checks, 4, os.path.join(tmp, 'r14'), 4, [
            (img_paths['1x4'], ['forward']), (mm14_path, ['forward']),
            (None, [('train', tc, train14_path, 1)])])])
    return {'img': (img_ref['2x2'], [r[0] for r in square]),
            'img14': (img_ref['1x4'], [r[0] for r in quad]),
            'mm': {'2x2': [r[1] for r in square], '1x2': [r[0] for r in row],
                   '1x4': [r[1] for r in quad]},
            'mm_ref': mm_ref,
            'train': (tc, train_refs, [r[2]['train'] for r in square]),
            'train14': (tc, train14_refs, [r[2]['train'] for r in quad])}


def rows_of(ranks, n_data):
    """Each rank's data-rank samples of a global batch."""
    b = B // n_data
    return [slice(r['coords'][0] * b, (r['coords'][0] + 1) * b)
            for r in ranks]


def test_forward_matches_jax_hybrid_mesh(runs):
    """(a)"""
    ref, ranks = runs['img']
    for r, rows in zip(ranks, rows_of(ranks, 2)):
        got = r['forward']['two_pass']['occ_logits'].numpy()
        np.testing.assert_allclose(got, ref['jax'][rows], **JAX_TOL)
        np.testing.assert_allclose(got, ref['one'][rows].numpy(), **ONE_TOL)


def test_forward_matches_jax_hybrid_mesh_1x4(runs):
    """(i): every rank returns the whole batch's logits."""
    ref, ranks = runs['img14']
    assert [r['coords'] for r in ranks] == [(0, s) for s in range(4)]
    for r in ranks:
        got = r['forward']['two_pass']['occ_logits'].numpy()
        np.testing.assert_allclose(got, ref['jax'], **JAX_TOL)
        np.testing.assert_allclose(got, ref['one'].numpy(), **ONE_TOL)


@pytest.mark.parametrize('mode', ['two_pass', 'batch_frames'])
def test_forward_1x4_matches_one_process(runs, mode):
    """(i): the multi-modal model on a batch of 1; ranks 2 and 3 hold no
    camera, rank 3 no row of the last Y level."""
    ranks, ref = runs['mm']['1x4'], runs['mm_ref']
    want = ref['1x4'][mode]
    for r in ranks:
        for key, w in want.items():
            np.testing.assert_allclose(r['forward'][mode][key].numpy(),
                                       w.numpy(), err_msg=key, **ONE_TOL)
        agree = (r['forward']['predict'] == ref['1x4']['two_pass'][
            'occ_logits'].argmax(-1)).float().mean().item()
        assert agree >= MIN_AGREE, agree
        assert torch.equal(r['forward']['own_index'], r['forward']['predict'])
        assert 'build it with the mesh' in r['forward']['refused']
        assert r['forward']['counts']['calls']['pool'] == 2


def test_train_step_1x4_matches_one_process(runs):
    """(i)"""
    tc, refs, ranks = runs['train14']
    ttp.assert_ranks_identical(ranks)
    ttp.assert_takes_the_step(tc, refs, ranks[0])


@pytest.mark.parametrize('mesh_name', list(MESHES))
@pytest.mark.parametrize('mode', ['two_pass', 'batch_frames'])
def test_forward_matches_one_process(runs, mesh_name, mode):
    """(b)"""
    ranks, ref = runs['mm'][mesh_name], runs['mm_ref']
    for r, rows in zip(ranks, rows_of(ranks, MESHES[mesh_name][0])):
        for key, want in ref[mode].items():
            np.testing.assert_allclose(r['forward'][mode][key].numpy(),
                                       want[rows].numpy(), err_msg=key,
                                       **ONE_TOL)
        agree = (r['forward']['predict'] == ref['two_pass']['occ_logits'][
            rows].argmax(-1)).float().mean().item()
        assert agree >= MIN_AGREE, agree
        assert torch.equal(r['forward']['own_index'], r['forward']['predict'])
        assert 'build it with the mesh' in r['forward']['refused']


def expected_halo_rows(s: int) -> dict:
    """The rows spatial rank ``s`` of 2 sends per forward, by layer, at
    the tiny trunk's Y levels 20 (10 + 10), 10 (5 + 5) and 5 (3 + 2)."""
    both, to_next, to_prev = 1, 1 - s, s

    def layer(stage, block, conv):
        return f'img_bev_encoder_backbone.layers.{stage}.{block}.{conv}.conv'
    rows = {layer(0, 0, c): both for c in ('downsample', 'conv1', 'conv2')}
    # 20 -> 10 at stride 2: rank 1's rows 5-9 read input row 9, rank 0's
    rows.update({layer(1, 0, c): to_next for c in ('downsample', 'conv1')})
    # 10 -> 5: rank 0's rows 0-2 read input row 5, rank 1's
    rows.update({layer(2, 0, c): to_prev for c in ('downsample', 'conv1')})
    for stage, blocks in ((1, 2), (2, 3)):
        for block in range(blocks):
            rows[layer(stage, block, 'conv2')] = both
            if block:
                rows[layer(stage, block, 'conv1')] = both
    # x2 from 10 rows: output rows 0-9 read sources 0-5, rows 10-19
    # sources 4-9; x4 from 5 rows (3 + 2): rows 10-19 read sources 2-4
    rows['img_bev_encoder_neck.up2'] = both
    rows['img_bev_encoder_neck.up4'] = to_next
    rows['final_conv.conv'] = both
    return rows


def row_bytes(cfg, name: str, local_batch: int) -> int:
    """Bytes of one Y row of what layer ``name`` exchanges (fp32): its
    input's channels times the Z and X of the trunk level it reads."""
    gx, _, gz = cfg.grid.grid_size
    if name.startswith('img_bev_encoder_neck.up'):
        level = {'2': 1, '4': 2}[name[-1]]
        channels = cfg.bev_channels[level]
    else:
        model = FusionOcc(cfg, device='meta')
        channels = model.get_submodule(name).in_channels
        level = 0
        if name.startswith('img_bev_encoder_backbone'):
            stage, block, conv = name.split('.')[2:5]
            level = int(stage) - (block == '0' and conv != 'conv2'
                                  and stage != '0')
    return local_batch * channels * -(-gz // 2 ** level) * (gx >> level) * 4


@pytest.mark.parametrize('mesh_name', list(MESHES))
def test_halo_moves_only_the_rows_each_layer_reads(runs, mesh_name):
    """(c)"""
    cfg = multimodal_config()
    local = B // MESHES[mesh_name][0]
    for r in runs['mm'][mesh_name]:
        counts = r['forward']['counts']
        want = expected_halo_rows(r['coords'][1])
        assert counts['rows'] == want
        assert counts['calls']['halo'] == len(want)
        assert counts['calls']['pool'] == cfg.num_frame
        assert counts['bytes']['halo'] == sum(
            n * row_bytes(cfg, name, local) for name, n in want.items())


@pytest.mark.parametrize('mesh_name', list(MESHES))
def test_halo_gradient_against_the_gathered_volume(runs, mesh_name):
    """(d)"""
    ranks = runs['mm'][mesh_name]
    g = torch.Generator().manual_seed(3)
    vol = torch.randn(1, 3, 2, 7, 4, generator=g, dtype=torch.float64)
    need = ranks[0]['halo']['need']
    cots = [torch.randn(1, 3, 2, hi - lo, 4, generator=g,
                        dtype=torch.float64) for lo, hi in need]
    leaf = vol.clone().requires_grad_()
    sum((leaf[:, :, :, lo:hi] * c).sum()
        for (lo, hi), c in zip(need, cots)).backward()
    for r in ranks:
        s = r['coords'][1]
        (lo, hi), (a, b) = need[s], r['halo']['have'][s]
        assert torch.equal(r['halo']['window'], vol[:, :, :, lo:hi])
        torch.testing.assert_close(r['halo']['grad'],
                                   leaf.grad[:, :, :, a:b], rtol=0,
                                   atol=1e-12)


@pytest.mark.parametrize('mode', ['batch', 'scan'])
def test_streaming_matches_one_process(runs, mode):
    """(e)"""
    want_pred, want_state = runs['mm_ref']['stream'][mode]
    for r in runs['mm']['2x2']:
        pred, state = r['stream'][mode]
        d = r['coords'][0]
        agree = (pred == want_pred[:, d:d + 1]).float().mean().item()
        assert agree >= MIN_AGREE, agree
        np.testing.assert_allclose(state.voxel_feat.numpy(),
                                   want_state.voxel_feat[d:d + 1].numpy(),
                                   **STATE_TOL)
        assert torch.equal(state.valid, want_state.valid[d:d + 1])


def test_metric_sums_the_y_rows_over_every_rank(runs):
    """(h)"""
    want = runs['mm_ref']['metric']
    result = want.compute()
    for r in runs['mm']['2x2']:
        np.testing.assert_array_equal(r['metric']['hist'],
                                      want.reduced_hist(want.hist))
        assert r['metric']['result'].keys() == result.keys()
        for k, v in result.items():
            assert r['metric']['result'][k] == v or (
                np.isnan(v) and np.isnan(r['metric']['result'][k])), k


def test_train_step_matches_one_process(runs):
    """(f)"""
    tc, refs, ranks = runs['train']
    ttp.assert_ranks_identical(ranks)
    ttp.assert_takes_the_step(tc, refs, ranks[0])


def test_a_block_without_rows_raises():
    """(g): the shapes that left a rank no block run.  XLA's blocks of 5
    rows over 4 ranks, 6 cameras over 4 and 5 and 50 rows over 11 end in
    empty ones; a conv and the upsample computed block by block, each rank
    reading the rows it needs, equal the whole volume's."""
    assert mesh.split(5, 2) == [(0, 3), (3, 5)]
    assert mesh.split(5, 4) == [(0, 2), (2, 4), (4, 5), (5, 5)]
    assert mesh.split(6, 4) == [(0, 2), (2, 4), (4, 6), (6, 6)]
    assert mesh.split(6, 5) == [(0, 2), (2, 4), (4, 6), (6, 6), (6, 6)]
    assert mesh.split(50, 11)[-1] == (50, 50)
    g = torch.Generator().manual_seed(0)
    for n, ranks in ((5, 4), (10, 4), (50, 11)):
        vol = torch.randn(1, 3, 2, n, 4, generator=g, dtype=torch.float64)
        for stride in (1, 2):
            mod = torch.nn.Conv3d(3, 2, 3, stride, 1).double()
            want = mod(vol)
            got = [spatial.conv(RankView(ranks, s, vol), block(vol, ranks, s),
                                mod, n, 'conv')[0] for s in range(ranks)]
            torch.testing.assert_close(torch.cat(got, 3), want, rtol=0,
                                       atol=1e-12)
        want = resize_trilinear(vol.float(), 2)
        got = [spatial.upsample(RankView(ranks, s, vol),
                                block(vol, ranks, s), n, 2, 'up')
               for s in range(ranks)]
        torch.testing.assert_close(torch.cat(got, 3), want,
                                   rtol=0, atol=1e-6)


def block(vol, ranks: int, s: int):
    """Rank ``s``'s Y rows of ``vol`` (NCDHW)."""
    a, b = mesh.split(vol.shape[3], ranks)[s]
    return vol[:, :, :, a:b]


class RankView:
    """Spatial rank ``s`` of ``n_spatial`` in one process: its exchange
    reads the rows it needs from the whole volume ``vol`` (NCDHW) of the
    level it holds, so a layer's block computation runs without a group."""

    def __init__(self, n_spatial: int, s: int, vol):
        self.n_spatial, self.s, self.vol = n_spatial, s, vol

    def rows(self, n: int):
        return mesh.split(n, self.n_spatial)

    def exchange(self, x, dim, have, need, label):
        assert have == self.rows(self.vol.shape[dim])
        lo, hi = need[self.s]
        return self.vol.narrow(dim, lo, hi - lo)
