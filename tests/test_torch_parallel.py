"""Data-parallel training of the port on two gloo processes on the CPU.

Each case spawns 2 ranks (``torch_parallel_ranks.spawn``: a gloo group
through ``init_distributed('file://...')``), fp32, the tiny multi-modal
config (the LiDAR encoder on the z-folded path).  Two rank processes run
every case of one fixture in turn; (a)'s and (b)'s ranks are two groups,
each on a thread of the test process (``torch_parallel_ranks.started``),
beside JAX's compile and the one process's steps.

(a) 2 ranks x batch 1 against one process at batch 2, with the random
    draws on (ASPP's dropout, the depth-input drop at 0.5, drop path at
    0.2), 2 train steps, ``accumulate_steps`` 1 and 2: the ranks stay
    bit-identical (logs, gradients, parameters, buffers, optimizer state,
    EMA), and each step equals the one process's step from the state the
    ranks held before it: the loss and its terms within ``LOSS_RTOL``; the
    gradients (the ranks' sum) and ``grad_norm`` within ``SPREAD`` times
    the one process's change when its images, or its images and weights,
    move by ``NOISE`` (relative), plus 1e-4 of the norm (``GRAD_RTOL``);
    the updated parameters, EMA and running statistics as the test says
    (``tests/test_torch_train_step.py``'s tolerances).  Each step starts
    from the same state because Adam's first update moves the parameters
    of near-zero gradients by up to 2 lr either way, so two runs'
    trajectories part further than any one step does.
(b) The same 2-rank step, the draws off as ``test_torch_train_step.py``
    switches them off, against JAX's jitted single-device ``train_step``
    at batch 2 (its flax BatchNorm two-pass), held by that file's checks
    and tolerances, the spread from the port's one process at batch 2;
    the gradients within that file's bound of the one process's and no
    farther from JAX's than the one process's (which misses JAX's by more
    than the bound in the BEV trunk at batch 2: see the test).
(c) ``BatchNorm`` (rank 0 one row, rank 1 three) and ``MaskedBatchNorm``
    in both layouts (rank 0 one active cell, rank 1 most) in training: the
    output, input and parameter gradients (summed over the ranks) and the
    running statistics against one process on the concatenation and
    against flax two-pass on it, within 1e-5 (``TOL``).
(d) The three losses with other mask counts on each rank: the ranks'
    losses sum to the global batch's within 1e-6 relative; the mean of the
    per-rank losses is off by more than that.
(e) ``OccupancyMetric`` with buckets, 2 samples per rank: the matrices
    summed over the ranks and ``compute()`` equal one process's over the 4
    samples and JAX's exactly.
(g) ``init_distributed`` refuses a card it cannot have; the hybrid mesh
    refuses a process that is in no group of its size.
"""
import dataclasses
import os

import flax.linen.normalization
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusionocc_tpu.config import GridConfig as JGrid
from fusionocc_tpu.eval import metrics as jm
from fusionocc_tpu.nn.layers import BatchNorm as JBatchNorm
from fusionocc_tpu.nn.layers import MaskedBatchNorm as JMaskedBatchNorm
from fusionocc_tpu_torch import config as tcfg
from fusionocc_tpu_torch.config import GridConfig as TGrid
from fusionocc_tpu_torch.data.synthetic import synthetic_batch
from fusionocc_tpu_torch.models.fusion_occ import (Batch, FusionOcc,
                                                   init_weights)
from fusionocc_tpu_torch.parallel import mesh
from fusionocc_tpu_torch.train import loop, losses

import test_torch_train_step as tts
import torch_parallel_ranks as tpr
from test_torch_train_layers import _jax_train, _stats
from torch_threads import one_torch_thread  # noqa: E402,F401

WORLD = 2
NOISE, SPREAD = 1e-6, 3.0
LOSS_RTOL, GRAD_RTOL = 1e-4, 1e-4
PARAM_RTOL, SIGN_MIN = 1e-5, tts.SIGN_MIN
TOL = dict(rtol=1e-5, atol=1e-5)
SUM_RTOL = 1e-6
GRID = dict(x=(-40.0, 40.0, 4.0), y=(-40.0, 40.0, 4.0), z=(-1.0, 5.4, 0.8),
            depth=(1.0, 45.0, 0.5))


def draws_config(accumulate: int):
    """The tiny multi-modal config with every random draw on."""
    cfg = tcfg.tiny_model_config(use_lidar=True)
    cfg = dataclasses.replace(
        cfg, lidar=dataclasses.replace(cfg.lidar, **tts.LIDAR),
        swin=dataclasses.replace(cfg.swin, drop_path_rate=0.2))
    assert cfg.vt.depth_drop_rate > 0
    return tcfg.TrainConfig(model=cfg, optim=tcfg.OptimConfig(
        **tts.OPTIM, accumulate_steps=accumulate))


def _perturbed(tmp, tag, saved, moved_imgs, weights: bool) -> str:
    """Save ``saved`` with its images moved (and its weights, each by
    NOISE relative) under ``tag``; returns the path."""
    saved = dict(saved, batch=saved['batch']._replace(imgs=moved_imgs))
    if weights:
        g = torch.Generator().manual_seed(6)
        saved['model'] = {k: (v * (1 + NOISE * torch.randn(v.shape,
                                                             generator=g))
                              if v.is_floating_point() else v)
                          for k, v in saved['model'].items()}
    path = os.path.join(tmp, f'{tag}.pt')
    torch.save(saved, path)
    return path


@pytest.fixture(scope='module')
def train_runs(tmp_path_factory):
    """(a): the ranks' 2 steps, and for each the one process's step at batch
    2 from the state the ranks held before it, once as it is and twice
    moved (the images; the images and the weights); (b): the ranks' step
    from JAX's weights with the draws off, JAX's step and the port's one
    process (``test_torch_train_step.port_train_step``)."""
    tmp = str(tmp_path_factory.mktemp('dp_train'))
    jobs, starts = [], {}
    for acc in (1, 2):
        tc = draws_config(acc)
        model = init_weights(FusionOcc(tc.model, device='cpu'),
                             torch.Generator().manual_seed(0))
        starts[acc] = (tc, {'model': model.state_dict(),
                            'batch': synthetic_batch(tc.model, WORLD, 0,
                                                     device='cpu')})
        path = os.path.join(tmp, f'acc{acc}.pt')
        torch.save(starts[acc][1], path)
        jobs.append((tc, path, 2, True))
    # the ranks run beside JAX's compile and the one process's steps
    draws = tpr.started(tpr.train_runs, WORLD, os.path.join(tmp, 'ranks'),
                        jobs)
    jax_step = tts.jax_train_step(WORLD)
    one, (tc, start, batch) = tts.port_train_step(jax_step[0], WORLD)
    path = os.path.join(tmp, 'jax.pt')
    torch.save({'model': start, 'batch': batch}, path)
    no_draws = tpr.started(tpr.train_runs, WORLD,
                           os.path.join(tmp, 'ranks_jax'),
                           [(tc, path, 1, False)])
    moved, refs = {}, {1: [], 2: []}
    for s in range(2):
        for acc in (1, 2):
            tc, saved = starts[acc]
            if s == 0:
                imgs = saved['batch'].imgs
                moved[acc] = imgs * (1 + NOISE * torch.randn(
                    imgs.shape, generator=torch.Generator().manual_seed(5)))
                before = saved
            else:       # from the state the ranks held after step 0
                before = dict(saved, **draws.result()[0][acc - 1]['after'][0])
            paths = [os.path.join(tmp, f'acc{acc}_step{s}.pt')]
            torch.save(before, paths[0])
            paths += [_perturbed(tmp, f'acc{acc}_step{s}_{w}', before,
                                 moved[acc], w) for w in (False, True)]
            refs[acc].append([tpr.train_run(0, 1, tc, p, 1) for p in paths])
    ranks = draws.result()
    cases = {'jax': (jax_step, one, [r[0] for r in no_draws.result()])}
    for acc in (1, 2):
        cases[acc] = (starts[acc][0], refs[acc], [r[acc - 1] for r in ranks])
    return cases


def assert_ranks_identical(ranks):
    first = ranks[0]
    for other in ranks[1:]:
        assert other['logs'] == first['logs']
        for s, after in enumerate(first['after']):
            for table in ('model', 'train'):
                _assert_same(other['after'][s][table], after[table], s)
        for s, grads in enumerate(first['grads']):
            for n, g in grads.items():
                assert torch.equal(other['grads'][s][n], g), (s, n)


def _assert_same(a, b, where):
    if isinstance(b, dict):
        assert a.keys() == b.keys(), where
        for k in b:
            _assert_same(a[k], b[k], (where, k))
    elif torch.is_tensor(b):
        assert torch.equal(a, b), where
    else:
        assert a == b, where


@pytest.mark.parametrize('accumulate', [1, 2])
def test_ranks_end_bit_identical(train_runs, accumulate):
    assert_ranks_identical(train_runs[accumulate][2])
    assert_ranks_identical(train_runs['jax'][2])


@pytest.mark.parametrize('accumulate', [1, 2])
def test_two_ranks_take_the_batch2_step(train_runs, accumulate):
    """(a): each of the 2 steps against one process's step at batch 2
    from the same state, the random draws on.  The loss and its terms
    within LOSS_RTOL; the gradients (the ranks' sum) and grad_norm within
    SPREAD x the one process's change when it is moved, plus GRAD_RTOL of
    the norm; after the step, as ``test_torch_train_step.py`` holds
    Adam's first update: each parameter within 2.1 lr and, where the two
    applied gradients agree in sign above SIGN_MIN, within 1e-6 +
    PARAM_RTOL of itself plus 2 lr times their relative difference (the
    most it moves Adam's update from one state); the EMA within
    ema_momentum x 2.1 lr; the running statistics within 1e-4."""
    tc, refs, ranks = train_runs[accumulate]
    assert_takes_the_step(tc, refs, ranks[0])


def assert_takes_the_step(tc, refs, got):
    """The ranks' steps ``got`` against the one process's ``refs`` (per
    step: the step from the ranks' state, then moved twice), as
    ``test_two_ranks_take_the_batch2_step`` says."""
    schedule = loop.make_lr_schedule(tc.optim)
    for s, (one, *moved) in enumerate(refs):
        want, logs = one['logs'][0], got['logs'][s]
        for key in ('loss', 'depth_loss', 'seg_loss', 'loss_occ'):
            np.testing.assert_allclose(logs[key], want[key], rtol=LOSS_RTOL,
                                       err_msg=f'step {s} {key}')
        ref = one['grads'][0]
        spread = max(float(loop.global_norm([m['grads'][0][n] - g for n, g
                                             in ref.items()]))
                     for m in moved)
        d_norm = abs(logs['grad_norm'] - want['grad_norm'])
        assert d_norm <= SPREAD * spread + GRAD_RTOL * want['grad_norm'], s
        for n, g in ref.items():
            err = float((got['grads'][s][n] - g).norm())
            bound = float(SPREAD * max((m['grads'][0][n] - g).norm()
                                       for m in moved)
                          + GRAD_RTOL * g.norm())
            assert err <= bound, (s, n, err, bound)
        before = got['after'][s - 1]['train'] if s else None
        after, ref_after = got['after'][s], one['after'][0]
        lr = schedule(after['train']['count'] - 1)
        d_norm /= want['grad_norm']
        for k, w in ref_after['model'].items():
            p = after['model'][k]
            if k not in ref:
                np.testing.assert_allclose(p.numpy(), w.numpy(), atol=1e-4,
                                           rtol=1e-4, err_msg=k)
                continue
            g, g1 = got['grads'][s][k], ref[k]
            if before is not None and before['mini_step']:
                acc, m = before['acc'][k], before['mini_step']
                g, g1 = acc + (g - acc) / (m + 1), acc + (g1 - acc) / (m + 1)
            same = ((torch.sign(g) == torch.sign(g1)) & (g.abs() > SIGN_MIN)
                    & (g1.abs() > SIGN_MIN))
            d = (g - g1).abs() / torch.minimum(g.abs(), g1.abs()).clamp_min(
                SIGN_MIN) + d_norm
            diff = (p - w).abs()
            assert bool(((diff <= 1e-6 + PARAM_RTOL * w.abs() + 2 * d * lr)
                         | ~same).all()), (s, k)
            assert float(diff.max()) <= 2.1 * lr, (s, k)
        for k, w in ref_after['train']['ema'].items():
            np.testing.assert_allclose(
                after['train']['ema'][k].numpy(), w.numpy(), rtol=PARAM_RTOL,
                atol=tc.optim.ema_momentum * 2.1 * lr, err_msg=k)


@pytest.mark.parametrize('check', ['logs', 'gradients', 'params', 'stats',
                                   'ema'])
def test_two_ranks_match_jax_batch2_step(train_runs, check):
    """(b): the 2-rank step, draws off, against JAX's step at batch 2, by
    ``test_torch_train_step.py``'s checks.  The gradients: each tensor
    within that file's bound (3x the port's change under the image
    perturbation, plus 1e-4 of its norm) of the one process's, and no
    farther from JAX's than the one process's plus that bound.  At batch
    2 the one process itself misses JAX's gradients by that bound in the
    BEV trunk (ResNet3D, FPN3D) and upstream of it: there the training
    forward sits at ReLU kinks that the image perturbation barely reaches
    (the trunk's gradients move by 7e-4 when its weights move by 1e-6,
    and by up to 3e-2 when they move by 2e-5, the size of the two
    frameworks' difference in the training forward)."""
    jax_step, one, ranks = train_runs['jax']
    got = ranks[0]
    logs = got['logs'][0]
    grads = got['grads'][0]
    after = got['after'][0]
    params = {n: after['model'][n] for n in grads}
    if check == 'logs':
        tts.check_logs(jax_step, logs)
    elif check == 'gradients':
        want = tts.by_name(jax_step[3])
        _, _, one_logs, one_grads, perturbed = one
        spread = float(loop.global_norm([perturbed[n] - g
                                         for n, g in one_grads.items()]))
        jnorm = float(jax_step[2]['grad_norm'])
        tol = SPREAD * spread + GRAD_RTOL * jnorm
        assert abs(logs['grad_norm'] - float(one_logs['grad_norm'])) <= tol
        assert abs(logs['grad_norm'] - jnorm) <= tol + abs(
            float(one_logs['grad_norm']) - jnorm)
        missed = 0
        for name, w in want.items():
            g, g1 = grads[name], one_grads[name]
            bound = float(SPREAD * (perturbed[name] - g1).norm()
                          + GRAD_RTOL * w.norm())
            assert float((g - g1).norm()) <= bound, name
            off = float((g1 - w).norm())
            assert float((g - w).norm()) <= off + bound, name
            missed += off > bound
        print(f'the one process misses JAX by more than the bound at '
              f'{missed} of {len(want)} gradient tensors')
    elif check == 'params':
        tts.check_updated_params(jax_step, params, grads)
    elif check == 'stats':
        tts.check_running_stats(jax_step, after['model'])
    else:
        tts.check_ema(jax_step, after['train']['ema'])


def _bn_cases():
    rng = np.random.RandomState(0)
    C, F = 3, 4
    stats, params = _stats(rng, C)
    common = {'c': C, 'weight': torch.tensor(params['scale']),
              'bias': torch.tensor(params['bias']),
              'running_mean': torch.tensor(stats['mean']),
              'running_var': torch.tensor(stats['var'])}
    cases = {}
    # NCHW, rank 0 one row, rank 1 three
    xs = [(2 * rng.randn(n, C, 5, 6) + 1).astype(np.float32) for n in (1, 3)]
    cases['dense'] = dict(common, x=xs, mask=None)
    for layout, shape in (('zfold', (2, 5)), ('cells', (2, 5, 6))):
        lanes = F if layout == 'zfold' else 1
        xs, masks = [], []
        for r in range(WORLD):
            x = rng.randn(*shape, lanes * C if layout == 'zfold' else C
                          ).astype(np.float32) + 0.5
            m = np.zeros(shape + ((F,) if layout == 'zfold' else ()), bool)
            if r == 0:          # one active cell
                m.reshape(-1)[3] = True
            else:
                m = rng.rand(*m.shape) > 0.2
            xs.append(x)
            masks.append(m)
        cases[layout] = dict(common, x=xs, mask=masks)
    for case in cases.values():
        case['cot'] = [rng.randn(*x.shape).astype(np.float32)
                       for x in case['x']]
        for key in ('x', 'cot', 'mask'):
            if case[key] is not None:
                case[key] = [torch.from_numpy(a) for a in case[key]]
    return cases, stats, params


def _loss_case():
    """Tiny shapes, 2 samples; sample 0's masks nearly empty."""
    cfg = tcfg.tiny_model_config()
    rng = np.random.RandomState(1)
    N, (H, W) = cfg.num_cams, cfg.input_size
    h, w = cfg.feat_size
    D = cfg.grid.num_depth_bins
    depth = rng.rand(WORLD, N, h, w, D).astype(np.float32) + 0.1
    depth /= depth.sum(-1, keepdims=True)
    sparse = np.where(rng.rand(WORLD, N, H, W) < np.array([0.01, 0.5]
                                                          )[:, None, None,
                                                            None],
                      rng.uniform(2, 40, (WORLD, N, H, W)), 0.0)
    segs = rng.randint(0, 18, (WORLD, N, H, W))
    segs[0][rng.rand(N, H, W) < 0.97] = losses.FREE_CLASS
    gx, gy, gz = cfg.grid.grid_size
    mask = rng.rand(WORLD, gx, gy, gz) < np.array([0.02, 0.7]
                                                  )[:, None, None, None]
    return {'cfg': cfg,
            'depth': torch.tensor(depth),
            'sparse_depth': torch.tensor(sparse, dtype=torch.float32),
            'seg_logits': torch.tensor(rng.randn(WORLD, N, h, w, 18),
                                       dtype=torch.float32),
            'segs': torch.tensor(segs, dtype=torch.int32),
            'occ': torch.tensor(rng.randn(WORLD, gx, gy, gz, 18),
                                dtype=torch.float32),
            'sem': torch.tensor(rng.randint(0, 18, (WORLD, gx, gy, gz)),
                                dtype=torch.int32),
            'mask': torch.tensor(mask)}


def _metric_case():
    grid = TGrid(**GRID)
    gx, gy, gz = grid.grid_size
    rng = np.random.RandomState(2)
    shape = (4, gx, gy, gz)
    gt = rng.randint(0, 18, shape).astype(np.int32)
    pred = rng.randint(0, 18, shape).astype(np.uint8)
    agree = rng.rand(*shape) < 0.5
    pred[agree] = gt[agree]
    mask = rng.rand(*shape) > 0.4
    return {'grid': grid, 'pred': torch.from_numpy(pred)[:, None],
            'gt': torch.from_numpy(gt)[:, None],
            'mask': torch.from_numpy(mask)[:, None]}


@pytest.fixture(scope='module')
def small(tmp_path_factory):
    """(c), (d), (e) on two ranks, and the same on one process."""
    tmp = str(tmp_path_factory.mktemp('dp_small'))
    bn, stats, params = _bn_cases()
    cases = {'bn': bn, 'loss': _loss_case(), 'metric': _metric_case()}
    path = os.path.join(tmp, 'cases.pt')
    torch.save(cases, path)
    ranks = tpr.spawn(tpr.small_checks, WORLD, os.path.join(tmp, 'ranks'),
                      path)
    one = {'bn': {k: tpr.batchnorm_run(0, 1, c) for k, c in bn.items()},
           'loss': tpr.loss_run(0, 1, cases['loss']),
           'metric': tpr.metric_run(0, 1, cases['metric'])}
    return cases, stats, params, ranks, one


def _flax_two_pass(case, stats, params):
    x = np.concatenate([a.numpy() for a in case['x']])
    cot = np.concatenate([a.numpy() for a in case['cot']])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen.normalization, '_compute_stats',
                   tts.two_pass_stats)
        if case['mask'] is None:
            to_nhwc = (0, 2, 3, 1)
            y, dx, dp, new = _jax_train(
                JBatchNorm(), {'BatchNorm_0': params},
                {'BatchNorm_0': stats}, (x.transpose(to_nhwc),),
                cot.transpose(to_nhwc))
            back = (0, 3, 1, 2)
            return (y.transpose(back), dx.transpose(back),
                    dp['BatchNorm_0'], new['BatchNorm_0'])
        mask = np.concatenate([m.numpy() for m in case['mask']])
        fold = mask.shape[-1] if mask.ndim == x.ndim else 0
        return _jax_train(JMaskedBatchNorm(fold=fold), params, stats,
                          (x, jnp.asarray(mask)), cot)


@pytest.mark.parametrize('layout', ['dense', 'zfold', 'cells'])
def test_batchnorm_statistics_over_both_ranks(small, layout):
    """(c): uneven rows or active cells; one process on the concatenation
    and flax two-pass on it."""
    cases, stats, params, ranks, one = small
    case = cases['bn'][layout]
    got = {k: [r['bn'][layout][k] for r in ranks] for k in ('y', 'dx')}
    want = one['bn'][layout]
    y, dx, dp, new = _flax_two_pass(case, stats, params)
    for key, flax_ref in (('y', y), ('dx', dx)):
        cat = torch.cat(got[key]).numpy()
        np.testing.assert_allclose(cat, want[key].numpy(), **TOL,
                                   err_msg=key)
        np.testing.assert_allclose(cat, flax_ref, **TOL, err_msg=key)
    for key, flax_ref in (('dweight', dp['scale']), ('dbias', dp['bias']),
                          ('running_mean', new['mean']),
                          ('running_var', new['var'])):
        for r in ranks:
            np.testing.assert_allclose(r['bn'][layout][key].numpy(),
                                       want[key].numpy(), **TOL, err_msg=key)
            np.testing.assert_allclose(r['bn'][layout][key].numpy(),
                                       flax_ref, **TOL, err_msg=key)


@pytest.mark.parametrize('loss', ['depth', 'seg', 'occ_mask', 'occ'])
def test_losses_sum_to_the_global_batch_loss(small, loss):
    """(d): each rank divides its masked sum by the count of both; the
    mean of per-rank losses (each over its own count) differs wherever
    the counts do, and fails the same check."""
    cases, _, _, ranks, one = small
    want = float(one['loss'][loss])
    got = sum(float(r['loss'][loss]) for r in ranks)
    np.testing.assert_allclose(got, want, rtol=SUM_RTOL)
    case = cases['loss']
    alone = [tpr.loss_run(0, 1, {k: (v[r:r + 1] if torch.is_tensor(v) else v)
                                 for k, v in case.items()})[loss]
             for r in range(WORLD)]
    mean = float(sum(alone)) / WORLD
    if loss != 'occ':   # without the mask both samples count every voxel
        assert abs(mean - want) > SUM_RTOL * abs(want) + 1e-3, (mean, want)


def test_metric_sums_over_ranks(small):
    """(e): the matrices and results over 2 ranks equal one process's over
    the 4 samples and JAX's on them, exactly."""
    cases, _, _, ranks, one = small
    case = cases['metric']
    jmet = jm.OccupancyMetric(grid=JGrid(**GRID))
    for p, g, m in zip(case['pred'], case['gt'], case['mask']):
        jmet.update(p.numpy(), g.numpy(), mask_camera=m.numpy())
    want = one['metric']
    for r in ranks:
        got = r['metric']
        for key in ('hist', 'radius', 'height'):
            np.testing.assert_array_equal(got[key], want[key])
        np.testing.assert_array_equal(got['hist'], jmet.reduced_hist())
        for name, b in jmet.buckets.items():
            np.testing.assert_array_equal(got[name], b['hist'])
        jres = jmet.compute()
        assert got['result'].keys() == want['result'].keys() == jres.keys()
        for key, value in want['result'].items():
            for other in (got['result'][key], jres[key]):
                assert (other == value or np.isnan(other)
                        and np.isnan(value)), key


def test_all_reduce_sum_is_torchs_differentiable_all_reduce(small):
    for r in small[3]:
        (y, dx), (y_ref, dx_ref) = r['all_reduce']
        assert torch.equal(y, y_ref)
        assert torch.equal(dx, dx_ref)


def test_shard_batch_takes_each_ranks_rows():
    batch = Batch(*(torch.arange(4 * 3.0).view(4, 3) + i
                    for i in range(9)), mask_camera=torch.rand(4, 2) > 0.5)
    parts = [mesh.shard_batch(batch, r, 2) for r in range(2)]
    for name, t in batch._asdict().items():
        if t is None:
            assert all(getattr(p, name) is None for p in parts)
        else:
            assert torch.equal(torch.cat([getattr(p, name) for p in parts]),
                               t), name
    with pytest.raises(ValueError, match='does not split'):
        mesh.shard_batch(batch, 0, 3)


def test_init_distributed_refuses_a_card_it_cannot_have(monkeypatch):
    """(g): two processes want cuda:<LOCAL_RANK>; without that card (or with
    a named card the machine lacks) it raises and joins no group; with one
    process it is a no-op."""
    for key, value in (('WORLD_SIZE', '2'), ('RANK', '1'),
                       ('LOCAL_RANK', str(torch.cuda.device_count())),
                       ('MASTER_ADDR', 'localhost'), ('MASTER_PORT', '1')):
        monkeypatch.setenv(key, value)
    with pytest.raises(RuntimeError, match='needs cuda:'):
        mesh.init_distributed()
    with pytest.raises(RuntimeError, match='needs cuda:'):
        mesh.init_distributed(device=f'cuda:{torch.cuda.device_count()}')
    assert mesh.data_mesh() is None
    assert mesh.world() == 1 and mesh.rank() == 0
    assert mesh.init_distributed(num_processes=1, device='cpu') == \
        torch.device('cpu')
    assert mesh.data_mesh() is None
    with pytest.raises(ValueError, match='needs a process group of 4'):
        mesh.hybrid_mesh(2, 2)

