"""Which gloo collectives take CUDA tensors: ``all_reduce``, ``all_gather``
and ``batch_isend_irecv``, each in its own pair of ranks on cuda:0 (a
refused one may abort its ranks, so each runs apart).  It decides what
``parallel/mesh.py`` stages through the host under gloo.

    python3 tools/probe_torch_gloo.py
"""
import socket
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def run(rank, port, name):
    dist.init_process_group('gloo', init_method=f'tcp://localhost:{port}',
                            world_size=2, rank=rank)
    torch.cuda.set_device(0)
    x = torch.full((4,), float(rank + 1), device='cuda:0')
    if name == 'all_reduce':
        dist.all_reduce(x)
    elif name == 'all_gather':
        outs = [torch.empty_like(x) for _ in range(2)]
        dist.all_gather(outs, x)
        x = torch.cat(outs)
    else:
        y = torch.empty_like(x)
        for r in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, x.clone(), 1 - rank),
                dist.P2POp(dist.irecv, y, 1 - rank)]):
            r.wait()
        x = y
    torch.cuda.synchronize()
    if rank == 0:
        print(f'gloo {name} of a CUDA tensor: {x.tolist()}', flush=True)
    dist.destroy_process_group()


if __name__ == '__main__':
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          flush=True)
    for name in ('all_reduce', 'all_gather', 'batch_isend_irecv'):
        with socket.socket() as s:
            s.bind(('localhost', 0))
            port = s.getsockname()[1]
        try:
            mp.spawn(run, args=(port, name), nprocs=2, join=True)
        except Exception as e:     # noqa: BLE001 - a probe reports
            print(f'gloo {name} of a CUDA tensor: refused '
                  f'({type(e).__name__}: {str(e).splitlines()[0][:120]})',
                  flush=True)
