"""Performance instrumentation: the program's spans and host waits, the
caching allocator's memory statistics, and the parameter count by
top-level module.

Spans and waits (``span``, ``wait``) sit at the port's layer boundaries
and at every place where the host reads from the card.  They record only
inside ``tracing()``, which code turns on::

    with profiling.tracing() as tr:
        model.predict_streaming(batch, state, pool_idx)
    records = tr.collect()

Off, ``span`` and ``wait`` return one shared no-op object: no allocation,
no clock read.  On, a span records its name, its id, its parent's id, the
unit it belongs to, its host start and end in ``time.time_ns()`` (the
clock of ``torch.profiler``'s Chrome trace: ``ts`` * 1000 +
``baseTimeNanoseconds``), a pair of CUDA events on the current stream
(where CUDA is available), and it enters
``torch.profiler.record_function(name)``, so a profiler run around it
shows the layer.  An entry span (``entry=True``: ``predict``,
``predict_streaming``, the ``forward``) opens a unit when none is open;
every span inside shares that unit's id.  A wait records its site, the
innermost open span and its host start and end.  While ``torch.export``
traces, tracing does nothing.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

from ..ops.kernels import exporting


class _Noop:
    """What ``span`` and ``wait`` return while tracing is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _Noop()
_ACTIVE: Optional['Tracer'] = None      # the tracer ``tracing()`` turned on


class _Span:
    """One span of an active tracer (``span``)."""
    __slots__ = ('tracer', 'name', 'id', 'parent', 'unit', 'start_ns',
                 'end_ns', 'events', 'annotation', 'opened')

    def __init__(self, tracer: 'Tracer', name: str, entry: bool):
        self.tracer, self.name = tracer, name
        self.opened = entry and tracer.unit is None

    def __enter__(self):
        t = self.tracer
        self.id = t.next_id
        t.next_id += 1
        self.parent = t.stack[-1].id if t.stack else -1
        if self.opened:
            t.unit = t.next_unit
            t.next_unit += 1
        self.unit = -1 if t.unit is None else t.unit
        t.spans.append(self)
        t.stack.append(self)
        self.annotation = torch.profiler.record_function(self.name)
        self.annotation.__enter__()
        self.events = None
        if t.cuda:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        if self.events is not None:
            self.events[1].record()
        self.annotation.__exit__(*exc)
        t = self.tracer
        t.stack.pop()
        if self.opened:
            t.unit = None
        return False


class _Wait:
    """One host read from the card, timed for an active tracer (``wait``)."""
    __slots__ = ('tracer', 'site', 'start_ns')

    def __init__(self, tracer: 'Tracer', site: str):
        self.tracer, self.site = tracer, site

    def __enter__(self):
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        t = self.tracer
        top = t.stack[-1] if t.stack else None
        t.waits.append({'site': self.site,
                        'span': -1 if top is None else top.id,
                        'unit': -1 if t.unit is None else t.unit,
                        'start_ns': self.start_ns, 'end_ns': end})
        return False


class Tracer:
    """The spans and waits recorded while tracing is on, in memory until
    ``collect()``; CUDA events around each span where CUDA is available."""

    def __init__(self):
        self.cuda = torch.cuda.is_available()
        self.spans: List[_Span] = []
        self.waits: List[dict] = []
        self.stack: List[_Span] = []
        self.unit: Optional[int] = None
        self.next_id = self.next_unit = 0

    def collect(self) -> Dict[str, List[dict]]:
        """The closed spans and the waits recorded so far, as plain dicts
        (``spans``: name, id, parent, unit, start_ns, end_ns, device_ms,
        the ms between the span's CUDA events, or None without them;
        ``waits``: site, span, unit, start_ns, end_ns); both lists are
        cleared.  Synchronises the card when there are events to read.
        Ids and units count on across calls."""
        closed = [s for s in self.spans if s not in self.stack]
        if any(s.events is not None for s in closed):
            torch.cuda.synchronize()
        spans = [{'name': s.name, 'id': s.id, 'parent': s.parent,
                  'unit': s.unit, 'start_ns': s.start_ns,
                  'end_ns': s.end_ns,
                  'device_ms': (None if s.events is None
                                else s.events[0].elapsed_time(s.events[1]))}
                 for s in closed]
        waits, self.waits = self.waits, []
        self.spans = [s for s in self.spans if s in self.stack]
        return {'spans': spans, 'waits': waits}


class tracing:
    """Turn the program's spans and waits on inside the block; yields the
    ``Tracer``.  The tracer that was on before (if any) is on again
    after."""

    def __init__(self):
        self.tracer = Tracer()

    def __enter__(self) -> Tracer:
        global _ACTIVE
        self.outer, _ACTIVE = _ACTIVE, self.tracer
        return self.tracer

    def __exit__(self, *exc):
        global _ACTIVE
        _ACTIVE = self.outer
        return False


def span(name: str, entry: bool = False):
    """A span named ``name`` around the block (``entry``: it opens a unit
    when none is open); the shared no-op while tracing is off or
    ``torch.export`` traces."""
    t = _ACTIVE
    if t is None or exporting():
        return NOOP
    return _Span(t, name, entry)


def wait(site: str):
    """Around a place where the host reads from the card: counts the wait
    and its host time under the innermost open span; the shared no-op
    while tracing is off or ``torch.export`` traces."""
    t = _ACTIVE
    if t is None or exporting():
        return NOOP
    return _Wait(t, site)


def chrome_events(records: Dict[str, List[dict]], base_ns: int
                  ) -> List[dict]:
    """``records`` (``Tracer.collect()``'s) as Chrome trace events for a
    trace whose ``baseTimeNanoseconds`` is ``base_ns``: complete events of
    category ``program_span`` and ``program_wait``, ``ts`` and ``dur`` in
    microseconds, on a track of their own (process 0, thread 0)."""
    pid = tid = 0
    out = [{'ph': 'M', 'name': 'thread_name', 'pid': pid, 'tid': tid,
            'args': {'name': 'program spans and waits'}}]
    for cat, key, rows in (('program_span', 'name', records['spans']),
                           ('program_wait', 'site', records['waits'])):
        for r in rows:
            args = {k: v for k, v in r.items()
                    if k not in (key, 'start_ns', 'end_ns')}
            out.append({'ph': 'X', 'cat': cat, 'name': r[key], 'pid': pid,
                        'tid': tid, 'ts': (r['start_ns'] - base_ns) / 1e3,
                        'dur': (r['end_ns'] - r['start_ns']) / 1e3,
                        'args': args})
    return out


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
