"""What a ``--trace 1`` run records, and its reduction to numbers.

Inside the measured window the run instruments a few stretches of units
(frames or steps), one kind of instrument at a time, so none times another:

- ``busy``: ``torch.profiler`` with CUDA activity alone (little cost to
  the host), its Chrome trace reduced to the wall, the union of the
  device's operation intervals (busy seconds) and the device operations
  that took most time;
- ``profile``: ``torch.profiler`` with the host's operations too: the
  device time under each of the port's kernel ops, and the longest idle
  gaps named by the host operation that was running (the host runs slower
  under this profiler, so these gaps are longer than untraced);
- ``clocks``: CUDA events around named modules (forward hooks) and at the
  marks a path offers (``train_step``'s ``mark``);
- ``syncs``: host synchronisations inside named modules, counted under
  ``torch.cuda.set_sync_debug_mode('warn')``.

After the window, ``OpRecorder`` replays the profiled units under a
dispatch mode that evaluates the frozen formulas (``peaks.FORMULAS``) on
the arguments of every call of the port's kernel ops.
"""
from __future__ import annotations

import collections
import json
import warnings
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from . import peaks

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
KERNEL_OPS = tuple(f'fusionocc::{k}' for k in peaks.FORMULAS)


@dataclass
class TraceData:
    """What the readers read: per instrumented stretch its units (frames or
    steps) and what was recorded over them; the window's peak memory; the
    uninstrumented stretch's units and seconds; the reference's FLOPs of
    one unit."""
    profile_units: int = 0
    profile_start: int = 0
    profile_wall_s: float = 0.0
    busy_s: float = 0.0
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)
    op_device_s: Dict[str, float] = field(default_factory=dict)
    op_calls: Dict[str, List[Tuple[int, int, str]]] = field(
        default_factory=dict)
    clock_units: int = 0
    module_ms: Dict[str, List[float]] = field(default_factory=dict)
    mark_ms: Dict[str, List[float]] = field(default_factory=dict)
    sync_units: int = 0
    syncs: Dict[str, int] = field(default_factory=dict)
    window_peak_bytes: int = 0
    plain_units: int = 0
    plain_wall_s: float = 0.0
    ref_flops_per_unit: Optional[float] = None


def union_seconds(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float('-inf')
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def gaps(intervals: List[Tuple[float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, at = [], lo
    for a, b in sorted(intervals):
        if a > at:
            out.append((at, min(a, hi)))
        at = max(at, b)
    if at < hi:
        out.append((at, hi))
    return [(a, b) for a, b in out if b > a]


UNIT_SPAN = 'benchmark.unit'


def _events(path: Path):
    for e in json.loads(path.read_text())['traceEvents']:
        if e.get('ph') == 'X' and 'dur' in e:
            yield e, float(e['ts']), float(e['ts']) + float(e['dur'])


def reduce_busy(path: Path):
    """(wall s, busy s, top device ops) of a trace of CUDA activity alone:
    the wall from the first runtime call to the end of the last (each unit
    ends in a synchronise), busy the union of the device's operation
    intervals in it."""
    dev, host = [], []
    for e, a, b in _events(path):
        cat = e.get('cat', '')
        if cat in DEVICE_CATS:
            dev.append((a, b, e.get('name', '?')))
        elif cat == 'cuda_runtime':
            host.append((a, b))
    if not host:
        raise ValueError(f'no CUDA runtime call in {path}')
    lo, hi = min(a for a, _ in host), max(b for _, b in host)
    dev = [(max(a, lo), min(b, hi), n) for a, b, n in dev if b > lo and a < hi]
    busy = union_seconds([(a, b) for a, b, _ in dev]) / 1e6
    by_name = collections.Counter()
    for a, b, n in dev:
        by_name[n] += (b - a) / 1e6
    return (hi - lo) / 1e6, busy, [[n, s] for n, s in by_name.most_common(10)]


def idle_gaps(path: Path):
    """The ten longest stretches in which the device ran nothing, between
    the start of the first ``UNIT_SPAN`` and the end of the last, each
    named by the host operation running at its middle (the innermost), or
    else the one the host ran last before it ('after ...')."""
    dev, cpu, units = [], [], []
    for e, a, b in _events(path):
        cat = e.get('cat', '')
        if cat in DEVICE_CATS:
            dev.append((a, b))
        elif cat == 'cpu_op':
            cpu.append((a, b, e.get('name', '?')))
        elif e.get('name') == UNIT_SPAN and cat == 'user_annotation':
            units.append((a, b))
    if not units:
        raise ValueError(f'no {UNIT_SPAN} span in {path}')
    lo, hi = min(a for a, _ in units), max(b for _, b in units)
    longest = sorted(gaps(dev, lo, hi), key=lambda g: g[0] - g[1])[:10]
    named = []
    for a, b in longest:
        mid = (a + b) / 2
        over = [(e - s, n) for s, e, n in cpu if s <= mid <= e]
        if over:
            host = min(over)[1]
        else:
            before = [(e, n) for s, e, n in cpu if e <= mid]
            host = 'after ' + max(before)[1] if before else 'no host op'
        named.append([host, (b - a) / 1e6])
    return named


def op_device_seconds(prof) -> Dict[str, float]:
    """Device seconds the profiler attributes to each of the port's kernel
    ops (the kernels launched under the op)."""
    out = {}
    for e in prof.key_averages():
        if e.key in KERNEL_OPS:
            t = getattr(e, 'device_time_total', None)
            if t is None:
                t = e.cuda_time_total
            out[e.key.split('::', 1)[1]] = t / 1e6
    return out


class ModuleClock:
    """CUDA events around every call of ``module``."""

    def __init__(self, module):
        self.events = []
        self.hooks = [module.register_forward_pre_hook(self._pre),
                      module.register_forward_hook(self._post)]

    def _pre(self, mod, args):
        self.events.append([torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True)])
        self.events[-1][0].record()

    def _post(self, mod, args, result):
        self.events[-1][1].record()

    def ms(self) -> List[float]:
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events]

    def remove(self) -> None:
        for h in self.hooks:
            h.remove()


class Marks:
    """CUDA events at the marks a path calls (``mark(name)``), per unit:
    ``start()`` before each unit."""

    def __init__(self):
        self.units: List[List[Tuple[str, torch.cuda.Event]]] = []

    def start(self) -> None:
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        self.units.append([('start', e)])

    def __call__(self, name: str) -> None:
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        self.units[-1].append((name, e))

    def ms(self) -> Dict[str, List[float]]:
        """ms between consecutive marks, keyed 'a-b'."""
        torch.cuda.synchronize()
        out = collections.defaultdict(list)
        for marks in self.units:
            for (na, ea), (nb, eb) in zip(marks, marks[1:]):
                out[f'{na}-{nb}'].append(ea.elapsed_time(eb))
        return dict(out)


class SyncCounter:
    """Host synchronisations made inside each of ``modules`` (name ->
    module), counted from ``set_sync_debug_mode('warn')``'s warnings."""

    def __init__(self, modules: Dict[str, torch.nn.Module]):
        self.inside: List[str] = []
        self.counts = collections.Counter()
        self.hooks = []
        for name, mod in modules.items():
            self.hooks.append(mod.register_forward_pre_hook(
                lambda m, a, name=name: self._enter(name)))
            self.hooks.append(mod.register_forward_hook(
                lambda m, a, r: self._leave()))

    def _enter(self, name: str) -> None:
        self.inside.append(name)

    def _leave(self) -> None:
        self.inside.pop()

    def __enter__(self):
        self._catch = warnings.catch_warnings()
        self._catch.__enter__()
        warnings.simplefilter('always')
        self._show = warnings.showwarning
        warnings.showwarning = self._record
        torch.cuda.set_sync_debug_mode('warn')
        return self

    def _record(self, message, *_):
        if 'called a synchronizing' in str(message) and self.inside:
            self.counts[self.inside[-1]] += 1

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode('default')
        warnings.showwarning = self._show
        self._catch.__exit__(*exc)
        for h in self.hooks:
            h.remove()


class OpRecorder(TorchDispatchMode):
    """Evaluates ``peaks.FORMULAS`` on every call of the port's kernel ops:
    ``calls[op] = [(flops, bytes, dtype name), ...]``."""

    def __init__(self):
        super().__init__()
        self.calls = collections.defaultdict(list)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ns, _, rest = str(func.overloadpacket._qualified_op_name
                          ).partition('::')
        if ns == 'fusionocc' and rest in peaks.FORMULAS:
            if rest.startswith('zwin_conv'):
                f, b, dt = peaks.FORMULAS[rest](*args, out=out)
            else:
                f, b, dt = peaks.FORMULAS[rest](*args, out)
            self.calls[rest].append((f, b, str(dt)))
        return out


def profiler(cpu: bool = True):
    """CUDA activity, with the host's operations when ``cpu``."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    return profile(activities=acts)
