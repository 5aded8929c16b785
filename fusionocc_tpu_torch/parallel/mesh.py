"""Data parallelism over processes: the JAX package's data mesh as
``torch.distributed``.

Port of ``fusionocc_tpu/parallel/mesh.py``.  The JAX package shards the
batch over the mesh's 'data' axis and lets XLA reduce the gradients, the
BatchNorm statistics and the loss normalisers over the global batch.  Here
every process (rank) holds its rows of the global batch (``shard_batch``),
and the port reduces over the default process group itself:

- the BatchNorms in training take their sums and counts over every rank
  (``nn/layers.py``);
- each loss divides the rank's masked sum by the all-reduced count
  (``train/losses.py``);
- a random mask is drawn at the global batch's shape from the step's shared
  generator and each rank keeps its rows (``nn.layers.keep_mask``);
- after the backward, the gradients are summed over ranks in buckets
  (``all_reduce_gradients``), on every call, accumulation steps included.

R ranks of b samples then take the step that one process takes at batch
R·b.  ``data_mesh()`` is None outside a process group; every collective
here is then skipped.  The hybrid data×spatial mesh (cameras and the BEV
grid over ranks) is model parallelism and is not ported (ROADMAP Queue A
item 11b): ``hybrid_mesh`` and ``constrain`` raise.

``COLLECTIVES`` counts the collectives (and their bytes) a run issues;
with ``COLLECTIVES.timed`` set it also synchronises the card around each
one and sums the seconds spent inside, for measurement only.
"""
from __future__ import annotations

import os
import time
from typing import List, Optional

import torch
import torch.distributed as dist

# the gradient buckets' size, DistributedDataParallel's default
BUCKET_BYTES = 25 * 2 ** 20


class CollectiveStats:
    """Collectives issued by this process: calls and bytes by kind ('bn',
    'loss', 'grad', 'metric', ...), and with ``timed`` the seconds inside
    them (the card synchronised before and after each)."""

    def __init__(self):
        self.timed = False
        self.reset()

    def reset(self) -> None:
        self.calls: dict = {}
        self.bytes = 0
        self.seconds = 0.0

    def run(self, kind: str, tensor: torch.Tensor, group) -> None:
        """All-reduce (sum) ``tensor`` in place over ``group``, counted."""
        self.calls[kind] = self.calls.get(kind, 0) + 1
        self.bytes += tensor.numel() * tensor.element_size()
        cuda = tensor.is_cuda and self.timed
        if cuda:
            torch.cuda.synchronize(tensor.device)
        t0 = time.perf_counter()
        dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=group)
        if cuda:
            torch.cuda.synchronize(tensor.device)
        if self.timed:
            self.seconds += time.perf_counter() - t0


COLLECTIVES = CollectiveStats()


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     device=None) -> torch.device:
    """Join the default process group and return this rank's device.

    The world size, rank and address come from the arguments (the JAX
    tool's ``--num-processes``, ``--process-id`` and ``--coordinator
    host:port``, or an ``init_method`` URL such as ``file://...``), else
    from ``torchrun``'s ``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR`` and
    ``MASTER_PORT``, else from ``FUSIONOCC_NUM_PROCESSES``,
    ``FUSIONOCC_PROCESS_ID`` and ``FUSIONOCC_COORDINATOR``.  With one
    process it joins nothing and returns ``device`` (the card by default).

    The device is ``device`` when given, else the card of the local rank
    (``LOCAL_RANK``, 0 without it): one card per local rank.  A CUDA
    device this machine does not have raises.  The backend is ``backend``
    when given, else NCCL on a card and gloo on the CPU.  Nothing switches
    device or backend on its own: a failing initialisation raises.
    """
    world = num_processes or _env_int('WORLD_SIZE', 'FUSIONOCC_NUM_PROCESSES',
                                      'SLURM_NTASKS') or 1
    if world == 1:
        return torch.device(device or 'cuda')
    rank = process_id
    if rank is None:
        rank = _env_int('RANK', 'FUSIONOCC_PROCESS_ID', 'SLURM_PROCID')
    if rank is None:
        raise ValueError(f'{world} processes but no rank: pass process_id '
                         'or set RANK')
    local = _env_int('LOCAL_RANK', 'SLURM_LOCALID') or 0
    dev = torch.device(device) if device is not None else torch.device(
        'cuda', local)
    if dev.type == 'cuda':
        index = local if dev.index is None else dev.index
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if index >= have:
            raise RuntimeError(
                f'rank {rank} (local rank {local}) needs cuda:{index}, but '
                f'this machine has {have} CUDA device(s); pass the device '
                'to use')
        dev = torch.device('cuda', index)
        torch.cuda.set_device(dev)
    backend = backend or ('nccl' if dev.type == 'cuda' else 'gloo')
    if not coordinator and not (os.environ.get('MASTER_ADDR')
                                and os.environ.get('MASTER_PORT')):
        coordinator = os.environ.get('FUSIONOCC_COORDINATOR')
    if coordinator:
        url = coordinator if '://' in coordinator else f'tcp://{coordinator}'
    elif os.environ.get('MASTER_ADDR') and os.environ.get('MASTER_PORT'):
        url = 'env://'      # torchrun's store
    else:
        raise ValueError('no address for the process group: pass '
                         'coordinator (host:port) or set MASTER_ADDR and '
                         'MASTER_PORT')
    dist.init_process_group(
        backend, init_method=url, world_size=world, rank=rank,
        device_id=dev if backend == 'nccl' else None)
    return dev


def data_mesh():
    """The data-parallel group: the default process group, or None when
    this process is in none."""
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


def rank() -> int:
    return dist.get_rank() if data_mesh() is not None else 0


def world() -> int:
    return dist.get_world_size() if data_mesh() is not None else 1


def shard_batch(batch, rank: int, world: int):
    """The rank's rows of every field of a ``Batch`` (or any NamedTuple of
    tensors batched on axis 0): rows ``rank*b:(rank+1)*b`` of B = world·b,
    the block the JAX package's 'data' axis gives that device."""
    fields = {}
    for name, t in batch._asdict().items():
        if t is None:
            fields[name] = None
            continue
        if t.shape[0] % world:
            raise ValueError(f'{name}: batch {t.shape[0]} does not split '
                             f'over {world} ranks')
        b = t.shape[0] // world
        fields[name] = t[rank * b:(rank + 1) * b]
    return type(batch)(**fields)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group; the gradient of each rank's input is the sum of
    the output gradients over the group (what
    ``torch.distributed.nn.functional.all_reduce`` computes, with the
    collectives counted in ``COLLECTIVES``)."""

    @staticmethod
    def forward(ctx, x, group, kind):
        ctx.group, ctx.kind = group, kind
        out = x.clone(memory_format=torch.contiguous_format)
        COLLECTIVES.run(kind, out, group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group, ctx.kind), None, None


def all_reduce_sum(x: torch.Tensor, kind: str = 'sum') -> torch.Tensor:
    """``x`` summed over the data-parallel group (``x`` itself outside
    one), differentiable: the backward sums the gradients over the group
    again, which is the gradient of a sum over ranks."""
    group = data_mesh()
    if group is None:
        return x
    return _AllReduceSum.apply(x, group, kind)


@torch.no_grad()
def all_reduce_gradients(params: List[torch.nn.Parameter]) -> None:
    """Replace every parameter's ``.grad`` by its sum over the group, in
    flat fp32 buckets of ``BUCKET_BYTES`` (a parameter without a gradient
    takes zeros, so every rank issues the same collectives)."""
    group = data_mesh()
    if group is None:
        return
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    bucket: List[torch.Tensor] = []
    size = 0
    for i, p in enumerate(params):
        bucket.append(p.grad)
        size += p.grad.numel() * p.grad.element_size()
        if size >= BUCKET_BYTES or i == len(params) - 1:
            flat = torch.cat([g.reshape(-1) for g in bucket])
            COLLECTIVES.run('grad', flat, group)
            offset = 0
            for g in bucket:
                g.copy_(flat[offset:offset + g.numel()].view_as(g))
                offset += g.numel()
            bucket, size = [], 0


def barrier() -> None:
    if data_mesh() is not None:
        dist.barrier()


def hybrid_mesh(n_data: int, n_spatial: int, devices=None):
    """The (data, spatial) mesh of the JAX package is not ported: cameras
    and the BEV grid over ranks need the pooled volume reduced after the
    frustum pooling and halo exchanges in the 3D convs (ROADMAP Queue A
    item 11b)."""
    raise NotImplementedError('the hybrid data x spatial mesh is not '
                              'ported: ROADMAP Queue A item 11b')


def constrain(x, mesh, spec):
    """Sharding constraints belong to the hybrid mesh (ROADMAP Queue A
    item 11b)."""
    raise NotImplementedError('sharding constraints of the spatial axis are '
                              'not ported: ROADMAP Queue A item 11b')
