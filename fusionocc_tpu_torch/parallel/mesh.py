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
here is then skipped.

``hybrid_mesh(n_data, n_spatial)`` is the JAX package's (data, spatial)
mesh: the ranks of the process group on an (n_data, n_spatial) grid.  JAX
puts two sharding constraints on the model and lets XLA partition it; the
port writes those steps out (``parallel/hybrid.py``), with the halo rows
of each Y-block conv exchanged by ``HybridMesh.exchange``.  Blocks are
XLA's: ceil(n / parts) each, the last ones short.

``COLLECTIVES`` counts the collectives (and their bytes) a run issues, by
kind, and the halo rows each layer sends; with ``COLLECTIVES.timed`` set it
also synchronises the card around each one and sums the seconds spent
inside, for measurement only.
"""
from __future__ import annotations

import contextlib
import contextvars
import os
import time
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# the gradient buckets' size, DistributedDataParallel's default
BUCKET_BYTES = 25 * 2 ** 20


class CollectiveStats:
    """Collectives issued by this process: calls and bytes by kind ('bn',
    'loss', 'grad', 'metric', 'pool', 'halo', 'gather', ...), the halo
    rows sent by layer, and with ``timed`` the seconds inside them (the
    card synchronised before and after each)."""

    def __init__(self):
        self.timed = False
        self.reset()

    def reset(self) -> None:
        self.calls: dict = {}
        self.kind_bytes: dict = {}
        self.kind_seconds: dict = {}
        self.rows: dict = {}

    def call(self, kind: str, nbytes: int, device: torch.device, fn):
        """``fn()`` counted under ``kind`` as moving ``nbytes``."""
        self.calls[kind] = self.calls.get(kind, 0) + 1
        self.kind_bytes[kind] = self.kind_bytes.get(kind, 0) + nbytes
        cuda = device.type == 'cuda' and self.timed
        if cuda:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        out = fn()
        if cuda:
            torch.cuda.synchronize(device)
        if self.timed:
            dt = time.perf_counter() - t0
            self.kind_seconds[kind] = self.kind_seconds.get(kind, 0.0) + dt
        return out

    def run(self, kind: str, tensor: torch.Tensor, group) -> None:
        """All-reduce (sum) ``tensor`` in place over ``group``, counted."""
        self.call(kind, tensor.numel() * tensor.element_size(),
                  tensor.device, lambda: dist.all_reduce(
                      tensor, op=dist.ReduceOp.SUM, group=group))


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


def all_reduce_sum(x: torch.Tensor, kind: str = 'sum', group=None
                   ) -> torch.Tensor:
    """``x`` summed over ``group`` (the data-parallel group by default;
    ``x`` itself outside one), differentiable: the backward sums the
    gradients over the group again, which is the gradient of a sum over
    ranks."""
    if group is None:
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


# -- the hybrid data x spatial mesh ------------------------------------------

# set inside a replicated module (the LiDAR encoder, pre_process_net): the
# group its BatchNorms reduce over; and the block of the global draw that
# this rank's random masks keep (start, total), on their batch axis
_STATS_GROUP = contextvars.ContextVar('stats_group', default=None)
_DRAW_BLOCK = contextvars.ContextVar('draw_block', default=None)


@contextlib.contextmanager
def setting(var: contextvars.ContextVar, value):
    """``var`` set to ``value`` inside the ``with`` block."""
    token = var.set(value)
    try:
        yield
    finally:
        var.reset(token)


def stats_group():
    """The group a BatchNorm in training takes its statistics over: the
    enclosing ``HybridMesh.replicated()``'s data group, else the
    data-parallel group (None outside a process group)."""
    group = _STATS_GROUP.get()
    return data_mesh() if group is None else group


def draw_block(local: int) -> Tuple[int, int]:
    """(start, total) of this rank's ``local`` rows in the global draw:
    the enclosing ``HybridMesh.draws()``'s block, else rows
    ``rank*local:(rank+1)*local`` of ``local*world``."""
    block = _DRAW_BLOCK.get()
    if block is not None:
        return block
    return rank() * local, local * world()


def split(n: int, parts: int) -> List[Tuple[int, int]]:
    """XLA's blocks of an axis of length ``n`` over ``parts`` ranks: rows
    [i*c, (i+1)*c) with c = ceil(n / parts), the last ones short and, where
    (parts - 1) * c >= n, empty (XLA pads them)."""
    c = -(-n // parts)
    return [(min(i * c, n), min((i + 1) * c, n)) for i in range(parts)]


class _RowExchange(torch.autograd.Function):
    """``HybridMesh.exchange``: the forward assembles the rows each rank
    needs from the ranks that hold them; the backward sends each received
    row's gradient back to its owner, which adds it to its own."""

    @staticmethod
    def forward(ctx, x, dim, m, have, need, label):
        ctx.args = (dim, m, have, need, x.shape)
        return m._exchange(x, dim, have, need, label)

    @staticmethod
    def backward(ctx, g):
        dim, m, have, need, shape = ctx.args
        return (m._exchange_back(g, dim, have, need, shape),
                None, None, None, None, None)


class HybridMesh:
    """The (data, spatial) mesh: rank r of the process group sits at (d, s)
    = divmod(r, n_spatial), JAX's ``reshape(n_data, n_spatial)``.  The
    spatial group holds the n_spatial ranks of this rank's row (one data
    rank's samples, split over cameras and Y rows), the data group the
    n_data ranks of its column.  Every rank builds every row and column
    group, in one order, as ``dist.new_group`` wants."""

    def __init__(self, n_data: int, n_spatial: int):
        if data_mesh() is None or dist.get_world_size() != n_data * n_spatial:
            have = dist.get_world_size() if data_mesh() is not None else 1
            raise ValueError(f'hybrid_mesh({n_data}, {n_spatial}) needs a '
                             f'process group of {n_data * n_spatial} ranks, '
                             f'this process is in one of {have} '
                             '(init_distributed first)')
        self.n_data, self.n_spatial = n_data, n_spatial
        self.d, self.s = divmod(dist.get_rank(), n_spatial)
        grid = [[d * n_spatial + s for s in range(n_spatial)]
                for d in range(n_data)]
        rows = [dist.new_group(row) for row in grid]
        cols = [dist.new_group([grid[d][s] for d in range(n_data)])
                for s in range(n_spatial)]
        self.spatial_group, self.data_group = rows[self.d], cols[self.s]
        self.spatial_ranks = grid[self.d]

    # -- blocks ----------------------------------------------------------
    def shard(self, batch):
        """This data rank's samples of a global batch (``shard_batch``)."""
        return shard_batch(batch, self.d, self.n_data)

    def image_block(self, n: int) -> Tuple[int, int]:
        """This rank's block of a data rank's ``n`` camera images."""
        return split(n, self.n_spatial)[self.s]

    def rows(self, n: int) -> List[Tuple[int, int]]:
        """Every spatial rank's block of ``n`` Y rows."""
        return split(n, self.n_spatial)

    def y_block(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's Y rows of ``x`` (axis ``dim``)."""
        a, b = self.rows(x.shape[dim])[self.s]
        return x.narrow(dim, a, b - a)

    # -- contexts --------------------------------------------------------
    def draws(self, start: int, total: int):
        """Random masks inside keep their rows from ``start`` on of a
        global draw of ``total`` rows (``nn.layers.keep_mask``)."""
        return setting(_DRAW_BLOCK, (start, total))

    def replicated(self):
        """Inside, BatchNorms take their statistics over the data group:
        a module every spatial rank runs on the same samples counts each
        sample once."""
        return setting(_STATS_GROUP, self.data_group)

    # -- collectives -----------------------------------------------------
    def sum_spatial(self, x: torch.Tensor, kind: str = 'pool'
                    ) -> torch.Tensor:
        """``x`` summed over the spatial group, differentiable
        (``all_reduce_sum``)."""
        return all_reduce_sum(x, kind, self.spatial_group)

    def gather(self, x: torch.Tensor, dim: int, n: int,
               kind: str = 'gather') -> torch.Tensor:
        """The spatial ranks' blocks of an axis of length ``n`` (axis
        ``dim``), concatenated: every rank gets the whole.  Not
        differentiable (inference)."""
        blocks = split(n, self.n_spatial)
        a, b = blocks[self.s]
        if x.shape[dim] != b - a:
            raise ValueError(f'rank {self.s} holds {x.shape[dim]} of axis '
                             f'{dim}, its block of {n} is {b - a}')
        most = max(hi - lo for lo, hi in blocks)
        pad = list(x.shape)
        pad[dim] = most - x.shape[dim]
        buf = (torch.cat([x, x.new_zeros(pad)], dim) if pad[dim]
               else x).contiguous()
        outs = [torch.empty_like(buf) for _ in blocks]
        COLLECTIVES.call(kind, buf.numel() * buf.element_size(), x.device,
                         lambda: dist.all_gather(outs, buf,
                                                 group=self.spatial_group))
        return torch.cat([o.narrow(dim, 0, hi - lo) for o, (lo, hi)
                          in zip(outs, blocks)], dim)

    def exchange(self, x: torch.Tensor, dim: int,
                 have: Sequence[Tuple[int, int]],
                 need: Sequence[Tuple[int, int]], label: str
                 ) -> torch.Tensor:
        """Rows [lo, hi) = ``need[s]`` of the global tensor whose rows
        ``have[r]`` each spatial rank r holds (axis ``dim``; this rank's
        ``x`` holds ``have[s]``): only the rows a rank lacks move, from the
        ranks that hold them.  Differentiable: the backward returns each
        row's gradient to its owner.  ``COLLECTIVES.rows[label]`` counts
        the rows this rank sends in the forward."""
        return _RowExchange.apply(x, dim, self, tuple(have), tuple(need),
                                  label)

    def _overlaps(self, have, need):
        """(rank, first, last) of the rows this rank receives from each
        rank, and of the rows it sends to each other rank."""
        s = self.s
        lo, hi = need[s]
        take = [(r, max(lo, a), min(hi, b)) for r, (a, b) in enumerate(have)]
        a, b = have[s]
        give = [(t, max(nl, a), min(nh, b)) for t, (nl, nh) in enumerate(need)
                if t != s]
        return ([o for o in take if o[1] < o[2]],
                [o for o in give if o[1] < o[2]])

    def _p2p(self, sends, recvs, device, kind: str):
        """Send each (rank, tensor) and receive each (rank, shape, dtype);
        returns the received tensors on ``device``."""
        ranks, group = self.spatial_ranks, self.spatial_group
        # gloo's point-to-point refuses CUDA tensors (its all-reduce and
        # all-gather take them): under gloo the rows go through the host
        where = (torch.device('cpu') if device.type == 'cuda'
                 and dist.get_backend(group) == 'gloo' else device)
        ops, bufs, nbytes = [], [], 0
        for r, t in sends:
            t = t.to(where).contiguous()
            nbytes += t.numel() * t.element_size()
            ops.append(dist.P2POp(dist.isend, t, ranks[r], group))
        for r, shape, dtype in recvs:
            bufs.append(torch.empty(shape, dtype=dtype, device=where))
            ops.append(dist.P2POp(dist.irecv, bufs[-1], ranks[r], group))

        def run():
            if ops:
                for req in dist.batch_isend_irecv(ops):
                    req.wait()
        COLLECTIVES.call(kind, nbytes, device, run)
        return [b.to(device) for b in bufs]

    def _exchange(self, x, dim, have, need, label):
        a = have[self.s][0]
        take, give = self._overlaps(have, need)
        sends = [(t, x.narrow(dim, lo - a, hi - lo)) for t, lo, hi in give]

        def shape(n):
            return x.shape[:dim] + (n,) + x.shape[dim + 1:]
        got = iter(self._p2p(sends, [(r, shape(hi - lo), x.dtype)
                                     for r, lo, hi in take if r != self.s],
                             x.device, 'halo'))
        rows = sum(hi - lo for _, lo, hi in give)
        COLLECTIVES.rows[label] = COLLECTIVES.rows.get(label, 0) + rows
        parts = [x.narrow(dim, lo - a, hi - lo) if r == self.s else next(got)
                 for r, lo, hi in take]
        if not parts:           # no rows needed here (an empty block)
            return x.narrow(dim, 0, 0)
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim)

    def _exchange_back(self, g, dim, have, need, shape):
        a = have[self.s][0]
        lo0 = need[self.s][0]
        take, give = self._overlaps(have, need)
        sends = [(r, g.narrow(dim, lo - lo0, hi - lo)) for r, lo, hi in take
                 if r != self.s]

        def sized(n):
            return shape[:dim] + (n,) + shape[dim + 1:]
        got = self._p2p(sends, [(t, sized(hi - lo), g.dtype)
                                for t, lo, hi in give], g.device, 'halo_grad')
        out = g.new_zeros(shape)
        for r, lo, hi in take:
            if r == self.s:
                out.narrow(dim, lo - a, hi - lo).add_(
                    g.narrow(dim, lo - lo0, hi - lo))
        for (t, lo, hi), gt in zip(give, got):
            out.narrow(dim, lo - a, hi - lo).add_(gt)
        return out


def hybrid_mesh(n_data: int, n_spatial: int) -> HybridMesh:
    """The (data, spatial) mesh over the default process group, which must
    hold n_data * n_spatial ranks (``init_distributed``): batch over
    'data', cameras and the BEV grid's Y rows over 'spatial'."""
    return HybridMesh(n_data, n_spatial)
