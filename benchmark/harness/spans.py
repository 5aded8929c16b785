"""The program's own spans and waits over a stretch of units, on the
device trace's clock, and their reduction per unit.

The port records spans at its layer boundaries and waits where the host
reads from the card (``fusionocc_tpu_torch/utils/profiling.py``), on
``time.time_ns()``, the clock of ``torch.profiler``'s Chrome trace
(``ts`` * 1000 + ``baseTimeNanoseconds``).  ``record`` runs the units
twice with the port's tracing on:

- ``timed``, without a profiler: per unit each span's device ms (its CUDA
  events), host ms and waits (count and host ms, those inside child spans
  included), and each wait site's count and host ms (``span_units``).  A
  profiler slows the host, which lengthens the spans the host paces and
  shortens the waits; so these come from a pass without one;
- ``traced``, under ``trace.profiler(cpu=False)`` (CUDA activity alone):
  per unit the device's idle inside each span's host intervals (the union
  of the device's gaps intersected with the span, children included;
  ``self_idle_ms`` less its children's), the unit's total idle and the
  idle no program span covers (``outside_ms``) (``idle_units``); a unit's
  slice of the timeline runs from its entry span's start to the next
  unit's, the last to the stretch's end.  The trace with the spans and
  waits merged in is written as ``<name>.spans.trace.json`` (Perfetto),
  and ``clock_check`` tells whether the two clocks agree.
"""
from __future__ import annotations

import bisect
import collections
import itertools
import json
from pathlib import Path
from typing import Dict, List, Tuple

from .trace import DEVICE_CATS, gaps

OUTSIDE = 'outside'


def record(step, units: int, out_dir: Path, name: str) -> dict:
    """Run ``step(k)`` for k in 0 .. ``units`` - 1 (one unit each: a cell's
    ``drv.step(profile_start + k, keep=False)``) twice with the port's
    tracing on, each unit ending in a synchronise: without a profiler
    (``timed``), then under the profiler's CUDA activity (``traced``, the
    merged trace written to ``out_dir/<name>.spans.trace.json``).  Returns
    {``timed``: ``span_units``, ``traced``: ``idle_units``, ``clock``:
    ``clock_check``}."""
    import torch

    from fusionocc_tpu_torch.utils import profiling

    from . import trace

    def run():
        for k in range(units):
            step(k)
            torch.cuda.synchronize()
    with profiling.tracing() as tr:
        run()
    timed = span_units(tr.collect())
    with trace.profiler(cpu=False) as prof, profiling.tracing() as tr:
        run()
    records = tr.collect()
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f'{name}.spans.trace.json'
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    if 'baseTimeNanoseconds' not in doc:
        raise ValueError(f'{path} has no baseTimeNanoseconds: the spans '
                         'cannot be put on its clock')
    base = int(doc['baseTimeNanoseconds'])
    events = doc['traceEvents']
    doc['traceEvents'] = events + profiling.chrome_events(records, base)
    path.write_text(json.dumps(doc))
    return {'timed': timed, 'traced': idle_units(events, records, base),
            'clock': clock_check(events, records, base)}


def _us(ns: int, base: int) -> float:
    return (ns - base) / 1e3


class Gaps:
    """Sorted, disjoint intervals and the length of their parts inside any
    [lo, hi] (``measure``), by bisection over their running sum."""

    def __init__(self, iv: List[Tuple[float, float]]):
        self.starts = [a for a, _ in iv]
        self.ends = [b for _, b in iv]
        self.cum = [0.0, *itertools.accumulate(b - a for a, b in iv)]

    def measure(self, lo: float, hi: float) -> float:
        i = bisect.bisect_right(self.ends, lo)      # first ending past lo
        j = bisect.bisect_left(self.starts, hi)     # first starting at hi
        if j <= i:
            return 0.0
        total = self.cum[j] - self.cum[i]
        total -= max(0.0, lo - self.starts[i])
        total -= max(0.0, self.ends[j - 1] - hi)
        return total


def device_gaps(events: List[dict], lo: float, hi: float
                ) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] (trace microseconds) in which the device
    ran no operation."""
    dev = [(float(e['ts']), float(e['ts']) + float(e['dur']))
           for e in events if e.get('ph') == 'X'
           and e.get('cat', '') in DEVICE_CATS]
    return gaps(dev, lo, hi)


def stretch_end(events: List[dict]) -> float:
    """The end of the stretch: the last runtime call's or device
    operation's end (each unit ends in a synchronise)."""
    return max(float(e['ts']) + float(e['dur']) for e in events
               if e.get('ph') == 'X' and e.get('cat', '') in
               DEVICE_CATS + ('cuda_runtime', 'cuda_driver'))


def _units(records: Dict[str, List[dict]]):
    """The entry spans in order of start, the spans by id, and whether a
    wait lies inside a span (``within(wait, span id)``, children
    included)."""
    spans = records['spans']
    by_id = {s['id']: s for s in spans}
    entries = sorted((s for s in spans if s['parent'] == -1
                      and s['unit'] >= 0), key=lambda s: s['start_ns'])

    def within(wait, span_id) -> bool:
        i = wait['span']
        while i != -1 and i in by_id:
            if i == span_id:
                return True
            i = by_id[i]['parent']
        return False
    return entries, by_id, within


def span_units(records: Dict[str, List[dict]]) -> List[dict]:
    """Per unit (in order): ``unit``, ``spans`` {name: calls, device_ms,
    host_ms, waits, wait_ms, summed over the unit's calls of the name;
    waits inside child spans count for the parent too}, ``waits`` {site:
    [count, host ms]}.  ``records``: the tracer's ``collect()``."""
    entries, _, within = _units(records)
    out = []
    for entry in entries:
        unit = entry['unit']
        waits = [w for w in records['waits'] if w['unit'] == unit]
        rows: Dict[str, dict] = {}
        for s in records['spans']:
            if s['unit'] != unit:
                continue
            row = rows.setdefault(s['name'], dict.fromkeys(
                ('calls', 'device_ms', 'host_ms', 'waits', 'wait_ms'), 0))
            row['calls'] += 1
            row['device_ms'] += s['device_ms'] or 0.0
            row['host_ms'] += (s['end_ns'] - s['start_ns']) / 1e6
            mine = [w for w in waits if within(w, s['id'])]
            row['waits'] += len(mine)
            row['wait_ms'] += sum(w['end_ns'] - w['start_ns']
                                  for w in mine) / 1e6
        sites: Dict[str, list] = {}
        for w in waits:
            c = sites.setdefault(w['site'], [0, 0.0])
            c[0] += 1
            c[1] += (w['end_ns'] - w['start_ns']) / 1e6
        out.append({'unit': unit, 'spans': rows, 'waits': sites})
    return out


def idle_units(events: List[dict], records: Dict[str, List[dict]],
               base: int) -> List[dict]:
    """Per unit (in order): ``unit``, ``wall_ms`` (its slice),
    ``idle_ms`` (the device's idle in its slice), ``outside_ms`` (idle in
    the slice outside every span), ``spans`` {name: idle_ms (children
    included), self_idle_ms, summed over the unit's calls of the name}.
    ``events``: the profiler's Chrome trace events; ``records``: the
    tracer's ``collect()`` over the same units; ``base``: the trace's
    ``baseTimeNanoseconds``."""
    entries, by_id, _ = _units(records)
    if not entries:
        return []
    hi = stretch_end(events)
    idle = Gaps(device_gaps(events, _us(entries[0]['start_ns'], base), hi))
    children = collections.defaultdict(list)
    for s in records['spans']:
        if s['parent'] in by_id:
            children[s['parent']].append(s)

    def inclusive(s) -> float:
        return idle.measure(_us(s['start_ns'], base), _us(s['end_ns'], base))

    out = []
    starts = [_us(e['start_ns'], base) for e in entries] + [hi]
    for k, entry in enumerate(entries):
        a, b = starts[k], starts[k + 1]
        total = idle.measure(a, b)
        rows: Dict[str, dict] = {}
        for s in records['spans']:
            if s['unit'] != entry['unit']:
                continue
            inc = inclusive(s)
            row = rows.setdefault(s['name'], {'idle_ms': 0.0,
                                              'self_idle_ms': 0.0})
            row['idle_ms'] += inc / 1e3
            row['self_idle_ms'] += (inc - sum(inclusive(c) for c in
                                              children[s['id']])) / 1e3
        out.append({'unit': entry['unit'], 'wall_ms': (b - a) / 1e3,
                    'idle_ms': total / 1e3,
                    'outside_ms': (total - inclusive(entry)) / 1e3,
                    'spans': rows})
    return out


def clock_check(events: List[dict], records: Dict[str, List[dict]],
                base: int) -> Dict[str, int]:
    """Whether the tracer's clock is the trace's: of the runtime's and the
    driver's kernel launches, how many lie inside an entry span's host
    interval (``launches``, ``in_entry``), and of those whose kernel is K2's
    (``window_attn`` in its name), how many inside ``camera.backbone``
    (``k2_launches``, ``k2_in_backbone``)."""
    def intervals(pick):
        return [(_us(s['start_ns'], base), _us(s['end_ns'], base))
                for s in records['spans'] if pick(s)]
    entry = intervals(lambda s: s['parent'] == -1 and s['unit'] >= 0)
    backbone = intervals(lambda s: s['name'] == 'camera.backbone')
    kernel_of = {e.get('args', {}).get('correlation'): e.get('name', '')
                 for e in events if e.get('cat') == 'kernel'}
    out = dict.fromkeys(('launches', 'in_entry', 'k2_launches',
                         'k2_in_backbone'), 0)
    for e in events:
        if (e.get('cat') not in ('cuda_runtime', 'cuda_driver')
                or 'Launch' not in e.get('name', '')):
            continue
        a, b = float(e['ts']), float(e['ts']) + float(e['dur'])
        out['launches'] += 1
        out['in_entry'] += any(x <= a and b <= y for x, y in entry)
        if 'window_attn' in kernel_of.get(e.get('args', {}).get(
                'correlation'), ''):
            out['k2_launches'] += 1
            out['k2_in_backbone'] += any(x <= a and b <= y
                                         for x, y in backbone)
    return out


def per_unit(data, part: str, span: str, key: str):
    """The mean over the units of ``part`` (``timed`` or ``traced``) of
    ``record``'s result in ``data.spans`` of ``key`` of ``span`` (0 in a
    unit without it); None when no stretch ran or no unit has the span."""
    units = (getattr(data, 'spans', None) or {}).get(part) or []
    if not any(span in u['spans'] for u in units):
        return None
    return sum(u['spans'].get(span, {}).get(key, 0.0)
               for u in units) / len(units)


def table(result: dict) -> str:
    """``record``'s result as lines for a run's notes, per unit: the idle
    and the idle outside every span; per span name (in order of idle) its
    calls, device ms, host ms and waits (``timed``), idle and self idle
    (``traced``); each wait site; the clock check."""
    timed, traced = result.get('timed') or [], result.get('traced') or []
    n, m = max(len(timed), 1), max(len(traced), 1)
    rows: Dict[str, collections.Counter] = collections.defaultdict(
        collections.Counter)
    sites: Dict[str, list] = {}
    for u in timed:
        for name, r in u['spans'].items():
            rows[name].update({k: v / n for k, v in r.items()})
        for site, (k, ms) in u['waits'].items():
            c = sites.setdefault(site, [0, 0.0])
            c[0] += k / n
            c[1] += ms / n
    for u in traced:
        for name, r in u['spans'].items():
            rows[name].update({k: v / m for k, v in r.items()})
    idle = sum(u['idle_ms'] for u in traced) / m
    outside = sum(u['outside_ms'] for u in traced) / m
    lines = [f'spans per unit ({len(timed)} timed, {len(traced)} traced '
             f'units): idle {idle:.3f} ms, {OUTSIDE} every span '
             f'{outside:.3f} ms',
             f'{"span":28s} {"calls":>6s} {"device":>9s} {"host":>9s} '
             f'{"waits":>6s} {"wait":>8s} {"idle":>8s} {"self":>8s}']
    for name, r in sorted(rows.items(), key=lambda kv: -kv[1]['idle_ms']):
        lines.append(f'{name:28s} {r["calls"]:6.1f} {r["device_ms"]:9.3f} '
                     f'{r["host_ms"]:9.3f} {r["waits"]:6.1f} '
                     f'{r["wait_ms"]:8.3f} {r["idle_ms"]:8.3f} '
                     f'{r["self_idle_ms"]:8.3f}')
    for site, (k, ms) in sorted(sites.items()):
        lines.append(f'wait {site:23s} {k:6.1f} per unit, {ms:.3f} ms')
    if 'clock' in result:
        lines.append('clock: ' + json.dumps(result['clock']))
    return '\n'.join(lines)
