"""Performance instrumentation on the card.

Port of ``fusionocc_tpu/utils/profiling.py`` (the reference's
tools/test.py:600-710: synchronised latency percentiles, allocator memory;
mmdet3d's benchmark hook): latency of a callable by CUDA events, the
caching allocator's memory statistics, a ``torch.profiler`` trace, and the
parameter count by top-level module.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict

import numpy as np
import torch


def measure_latency(fn: Callable, *args, warmup: int = 5, iters: int = 20
                    ) -> Dict[str, float]:
    """Latency statistics (ms) of ``fn(*args)`` on the current CUDA device:
    CUDA events around each call, read after one synchronise."""
    for _ in range(warmup):
        fn(*args)
    events = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    arr = np.asarray([s.elapsed_time(e) for s, e in events])
    return {
        'mean_ms': float(arr.mean()),
        'p50_ms': float(np.percentile(arr, 50)),
        'p90_ms': float(np.percentile(arr, 90)),
        'p99_ms': float(np.percentile(arr, 99)),
        'fps': 1000.0 / float(arr.mean()),
    }


def device_memory_stats(device=None) -> Dict[str, float]:
    """The caching allocator's memory (bytes) on a CUDA device, under JAX's
    key names; {} without CUDA."""
    if not torch.cuda.is_available():
        return {}
    stats = torch.cuda.memory_stats(device)
    out = {'bytes_in_use': stats.get('allocated_bytes.all.current', 0),
           'peak_bytes_in_use': stats.get('allocated_bytes.all.peak', 0),
           'bytes_limit': torch.cuda.get_device_properties(
               device if device is not None
               else torch.cuda.current_device()).total_memory,
           'largest_alloc_size': stats.get('requested_bytes.all.peak', 0)}
    return {k: float(v) for k, v in out.items()}


@contextlib.contextmanager
def profiler_trace(logdir: str = './work_dirs/torch_trace'):
    """A ``torch.profiler`` trace of the CPU and CUDA activity inside the
    block, written as a Chrome trace under ``logdir``; yields the
    profiler."""
    import os
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, 'trace.json'))


def param_memory_report(model: torch.nn.Module) -> Dict[str, float]:
    """Parameter count by top-level module, the total, and its fp32 MiB."""
    out: Dict[str, float] = {}
    total = 0
    for name, p in model.named_parameters():
        root = name.split('.')[0]
        out[root] = out.get(root, 0) + p.numel()
        total += p.numel()
    out['total_params'] = total
    out['total_mb_fp32'] = total * 4 / 2 ** 20
    return out
