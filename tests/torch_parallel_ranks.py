"""Rank workers of the port's data-parallel tests (no JAX here: each rank is
a fresh process that imports the port alone).

``spawn(fn, world, tmp, *args)`` runs ``fn(rank, world, *args)`` on
``world`` CPU processes joined in a gloo group through
``init_distributed('file://<tmp>/store', ...)`` and returns each rank's
result (``torch.save``d under ``tmp``); ``started(fn, world, tmp, *args)``
runs the same spawn on a thread and returns its future, so that groups
(each with its own ``tmp``) run side by side or beside the caller's own
work.  ``train_run`` takes train steps
on a rank's rows of a global batch, or on the whole batch outside a group;
``train_runs`` several in turn.  ``batchnorm_run``, ``loss_run`` and
``metric_run`` apply a layer, the losses and the metric to a rank's part
of inputs given for every rank (the whole of them outside a group), and
``small_checks`` runs the three and compares ``all_reduce_sum`` with
``torch.distributed.nn.functional.all_reduce``.  ``hybrid_checks`` runs
jobs on ``HybridFusionOcc`` under ``hybrid_mesh(world // n_spatial,
n_spatial)``: the forward, ``predict``, ``batch_frames``, the streaming
modes, a halo exchange's gradient and train steps (``train_run`` with
``n_spatial``).
"""
import copy
import os
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.distributed as dist
import torch.distributed.nn.functional
import torch.multiprocessing as mp

from fusionocc_tpu_torch.eval.metrics import OccupancyMetric
from fusionocc_tpu_torch.models.fusion_occ import (
    FusionOcc, batch_pooling_indices, stack_batches)
from fusionocc_tpu_torch.nn import layers
from fusionocc_tpu_torch.parallel import mesh
from fusionocc_tpu_torch.parallel.hybrid import HybridFusionOcc
from fusionocc_tpu_torch.train import losses, loop


def _entry(rank, fn, world, tmp, args):
    torch.set_num_threads(1)
    mesh.init_distributed(f'file://{tmp}/store', world, rank, device='cpu')
    try:
        torch.save(fn(rank, world, *args), os.path.join(tmp, f'rank{rank}.pt'))
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, tmp: str, *args) -> list:
    os.makedirs(tmp, exist_ok=True)
    mp.start_processes(_entry, args=(fn, world, tmp, args), nprocs=world,
                       join=True, start_method='spawn')
    return [torch.load(os.path.join(tmp, f'rank{r}.pt'), weights_only=False)
            for r in range(world)]


def started(fn, world: int, tmp: str, *args):
    """``spawn(fn, world, tmp, *args)`` on a thread of its own: its future
    (``.result()`` the ranks' results, or the spawn's error)."""
    pool = ThreadPoolExecutor(1)
    future = pool.submit(spawn, fn, world, tmp, *args)
    pool.shutdown(wait=False)
    return future


def train_run(rank: int, world: int, tc, path: str, steps: int,
              draws: bool = True, n_spatial: int = 1) -> dict:
    """``steps`` train steps from the weights and the global batch saved at
    ``path`` ({'model': state dict, 'batch': Batch, optionally 'train': a
    train state dict to start from}), on this rank's rows of it (all of it
    with world 1 outside a group); with ``draws`` False the dropout is the
    identity; with ``n_spatial`` > 1 under the hybrid mesh, on this data
    rank's samples.  Returns the logs and gradients of each step and the
    model and train state after each."""
    saved = torch.load(path, weights_only=False)
    hybrid = (mesh.hybrid_mesh(world // n_spatial, n_spatial)
              if n_spatial > 1 else None)
    model = (FusionOcc(tc.model, device='cpu') if hybrid is None
             else HybridFusionOcc(tc.model, hybrid, device='cpu'))
    model.load_state_dict(saved['model'], strict=True)
    batch = (hybrid.shard(saved['batch']) if hybrid is not None
             else mesh.shard_batch(saved['batch'], rank, world))
    state = loop.create_train_state(model, tc)
    if 'train' in saved:
        state.load_state_dict(saved['train'])
    out = {'logs': [], 'grads': [], 'after': []}
    real = layers.dropout
    if not draws:
        layers.dropout = lambda x, rate: x
    try:
        for _ in range(steps):
            logs = loop.train_step(model, tc, state, batch)
            out['logs'].append({k: float(v) for k, v in logs.items()})
            out['grads'].append({n: p.grad.clone()
                                 for n, p in model.named_parameters()})
            out['after'].append(copy.deepcopy(
                {'model': model.state_dict(), 'train': state.state_dict()}))
    finally:
        layers.dropout = real
    return out


def train_runs(rank: int, world: int, jobs) -> list:
    """``train_run`` for each (tc, path, steps, draws) of ``jobs``."""
    return [train_run(rank, world, *job) for job in jobs]


def batchnorm_run(rank: int, world: int, case: dict) -> dict:
    """One training call of a BatchNorm (``case['mask']`` None) or a
    MaskedBatchNorm on rank ``rank``'s input (all of them concatenated with
    world 1), the cotangent's backward, the parameter gradients summed over
    the group as ``train_step`` sums them: output, input and parameter
    gradients, running statistics."""
    pick = (lambda t: t[rank]) if world > 1 else (lambda t: torch.cat(t))
    x = pick(case['x']).clone().requires_grad_()
    if case['mask'] is None:
        bn = layers.BatchNorm(x.shape[1])
        args = ()
    else:
        bn = layers.MaskedBatchNorm(case['c'])
        args = (pick(case['mask']),)
    with torch.no_grad():
        for name in ('weight', 'bias', 'running_mean', 'running_var'):
            getattr(bn, name).copy_(case[name])
    bn.train()
    y = bn(x, *args)
    y.backward(pick(case['cot']))
    mesh.all_reduce_gradients(list(bn.parameters()))
    return {'y': y.detach(), 'dx': x.grad, 'dweight': bn.weight.grad,
            'dbias': bn.bias.grad, 'running_mean': bn.running_mean,
            'running_var': bn.running_var}


def loss_run(rank: int, world: int, case: dict) -> dict:
    """The three losses of the rank's rows of ``case`` (B rows, B / world
    per rank; the occupancy loss with and without the camera mask)."""
    b = case['sem'].shape[0] // world
    cut = {k: v[rank * b:(rank + 1) * b] for k, v in case.items()
           if k != 'cfg'}
    cfg = case['cfg']
    return {
        'depth': losses.depth_loss(cut['depth'], cut['sparse_depth'], cfg),
        'seg': losses.seg_loss(cut['seg_logits'], cut['segs'], cfg),
        'occ_mask': losses.occ_loss(cut['occ'], cut['sem'], cut['mask'],
                                    True),
        'occ': losses.occ_loss(cut['occ'], cut['sem'], None, False)}


def metric_run(rank: int, world: int, case: dict) -> dict:
    """``OccupancyMetric`` (with buckets) updated with the rank's samples,
    one at a time; the matrices it reduces and ``compute()``."""
    met = OccupancyMetric(grid=case['grid'])
    n = len(case['pred'])
    for i in range(rank * n // world, (rank + 1) * n // world):
        met.update(case['pred'][i], case['gt'][i],
                   mask_camera=case['mask'][i])
    return {'hist': met.reduced_hist(met.hist),
            **{name: met.reduced_hist(b['hist'])
               for name, b in met.buckets.items()},
            'result': met.compute()}


def small_checks(rank: int, world: int, path: str) -> dict:
    cases = torch.load(path, weights_only=False)
    out = {'bn': {k: batchnorm_run(rank, world, c)
                  for k, c in cases['bn'].items()},
           'loss': loss_run(rank, world, cases['loss']),
           'metric': metric_run(rank, world, cases['metric'])}
    # all_reduce_sum against torch's differentiable all_reduce
    g = torch.Generator().manual_seed(rank)
    x = torch.randn(4, 3, generator=g)
    cot = torch.randn(4, 3, generator=g)
    got = []
    for fn in (mesh.all_reduce_sum,
               torch.distributed.nn.functional.all_reduce):
        leaf = x.clone().requires_grad_()
        y = fn(leaf)
        (y * cot).sum().backward()
        got.append((y.detach(), leaf.grad))
    out['all_reduce'] = got
    return out


def _counted(fn):
    """``fn()`` and the halo rows and collectives it issued on this rank."""
    mesh.COLLECTIVES.reset()
    out = fn()
    c = mesh.COLLECTIVES
    return out, {'rows': dict(c.rows), 'calls': dict(c.calls),
                 'bytes': dict(c.kind_bytes)}


def halo_run(m) -> dict:
    """A global (1, 3, 2, Y, 4) volume and cotangents drawn alike on every
    rank; this rank's block through ``exchange`` to the rows a stride-2
    conv's output block reads, the backward of sum(window * cotangent):
    the window and the gradient of this rank's block."""
    g = torch.Generator().manual_seed(3)
    n = 7
    vol = torch.randn(1, 3, 2, n, 4, generator=g, dtype=torch.float64)
    have = m.rows(n)
    out = m.rows((n - 1) // 2 + 1)
    need = [(max(2 * a - 1, 0), min(2 * b, n)) for a, b in out]
    cots = [torch.randn(1, 3, 2, hi - lo, 4, generator=g,
                        dtype=torch.float64) for lo, hi in need]
    a, b = have[m.s]
    x = vol[:, :, :, a:b].clone().requires_grad_()
    window = m.exchange(x, 3, have, need, 'probe')
    (window * cots[m.s]).sum().backward()
    return {'window': window.detach(), 'grad': x.grad, 'need': need,
            'have': have}


def hybrid_checks(rank: int, world: int, n_spatial: int, tasks) -> list:
    """Under ``hybrid_mesh(world // n_spatial, n_spatial)``, for each
    (path, jobs) of ``tasks``, on the inputs saved at ``path`` ({'model':
    state dict, 'config': model config, 'batch': the global batch,
    'frames': a clip of global batches, 'resets'}): each job of ``jobs``,
    'forward' (the eval forward two-pass and with ``batch_frames``,
    ``predict`` with its own and with given indices of this rank's images,
    the halo rows and collectives of one forward, and what an index of
    every image raises),
    'stream' (``predict_streaming_batch`` at chunk 2 and
    ``predict_streaming_scan`` on the clip), 'halo' (``halo_run``),
    'metric' (``OccupancyMetric`` with the mesh and buckets on this data
    rank's samples of the saved 'pred') or ('train', tc, path, steps)
    (``train_run``)."""
    m = mesh.hybrid_mesh(world // n_spatial, n_spatial)
    results = []
    for path, jobs in tasks:
        saved = torch.load(path, weights_only=False) if path else {}
        out = {'coords': (m.d, m.s)}
        if 'model' in saved:
            model = HybridFusionOcc(saved['config'], m, device='cpu')
            model.load_state_dict(saved['model'], strict=True)
        for job in jobs:
            if job == 'forward':
                batch = m.shard(saved['batch'])
                with torch.inference_mode():
                    two, counts = _counted(lambda: model(batch))
                    out['forward'] = {
                        'two_pass': two, 'counts': counts,
                        'batch_frames': model(batch, batch_frames=True),
                        'predict': model.predict(batch),
                        'own_index': model.predict(
                            batch, model.batch_pooling_indices(batch))}
                    try:        # an index of every image, not this rank's
                        model(batch, batch_pooling_indices(model.cfg, batch))
                    except ValueError as e:
                        out['forward']['refused'] = str(e)
            elif job == 'stream':
                frames = stack_batches([m.shard(f) for f in saved['frames']])
                b = frames.imgs.shape[1]
                resets = saved['resets'][:, m.d * b:(m.d + 1) * b]
                state = model.init_streaming_state(b)
                out['stream'] = {
                    'batch': model.predict_streaming_batch(
                        frames, state, resets=resets, chunk=2),
                    'scan': model.predict_streaming_scan(frames, state,
                                                         resets=resets)}
            elif job == 'halo':
                out['halo'] = halo_run(m)
            elif job == 'metric':
                batch = m.shard(saved['batch'])
                b = batch.imgs.shape[0]
                met = OccupancyMetric(grid=saved['config'].grid, mesh=m)
                met.update(saved['pred'][m.d * b:(m.d + 1) * b],
                           batch.voxel_semantics,
                           mask_camera=batch.mask_camera)
                out['metric'] = {'hist': met.reduced_hist(met.hist),
                                 'result': met.compute()}
            else:
                _, tc, train_path, steps = job
                out['train'] = train_run(rank, world, tc, train_path, steps,
                                         n_spatial=n_spatial)
        results.append(out)
    return results
