"""CPU tests of the spans reduction (``harness/spans.py``) and its readers,
on a synthetic device trace and span list.

    python3 -m pytest benchmark/test_spans.py -q
"""
from __future__ import annotations

import random
import types

import pytest

from harness import spans, spec
from harness.trace import gaps

BASE = 10 ** 18            # the trace's baseTimeNanoseconds


def us(t: float) -> int:
    """Trace microseconds as the tracer's time.time_ns()."""
    return BASE + int(t * 1000)


def span(i, name, parent, unit, a, b, device_ms=None):
    return {'name': name, 'id': i, 'parent': parent, 'unit': unit,
            'start_ns': us(a), 'end_ns': us(b), 'device_ms': device_ms}


def X(cat, a, b, name='k', **args):
    return {'ph': 'X', 'cat': cat, 'name': name, 'ts': a, 'dur': b - a,
            'args': args}


# two units: device busy [10, 30], [50, 60] in the first, [130, 190] in
# the second; the last runtime call ends at 205
EVENTS = [X('kernel', 10, 30, 'window_attn_wgmma_kernel<false>',
            correlation=1),
          X('kernel', 50, 60, 'elementwise', correlation=2),
          X('gpu_memcpy', 130, 190, 'copy', correlation=3),
          X('cuda_runtime', 6, 7, 'cudaLaunchKernel', correlation=1),
          X('cuda_runtime', 46, 47, 'cudaLaunchKernel', correlation=2),
          X('cuda_runtime', 125, 126, 'cudaMemcpyAsync', correlation=3),
          X('cuda_runtime', 200, 205, 'cudaDeviceSynchronize')]
RECORDS = {
    'spans': [span(0, 'predict', -1, 0, 0, 100),
              span(1, 'lidar', 0, 0, 5, 40, 2.5),
              span(2, 'lidar.voxelize', 1, 0, 5, 20, 1.0),
              span(3, 'camera.backbone', 0, 0, 45, 90, 4.0),
              span(4, 'predict', -1, 1, 120, 200),
              span(5, 'camera.backbone', 4, 1, 121, 150, 3.0),
              span(6, 'camera.backbone', 4, 1, 150, 195, 5.0)],
    'waits': [{'site': 'padded_width', 'span': 2, 'unit': 0,
               'start_ns': us(8), 'end_ns': us(18)},
              {'site': 'long_runs', 'span': 4, 'unit': 1,
               'start_ns': us(122), 'end_ns': us(124)}]}


def test_idle_by_span_is_inclusive_and_sums_to_the_total():
    first, second = spans.idle_units(EVENTS, RECORDS, BASE)
    # gaps: [0, 10], [30, 50], [60, 130], [190, 205]
    assert first['wall_ms'] == pytest.approx(0.120)
    assert first['idle_ms'] == pytest.approx(0.090)
    assert first['outside_ms'] == pytest.approx(0.020)     # [100, 120]
    r = first['spans']
    assert r['predict']['idle_ms'] == pytest.approx(0.070)
    assert r['lidar']['idle_ms'] == pytest.approx(0.015)    # children in
    assert r['lidar']['self_idle_ms'] == pytest.approx(0.010)
    assert r['lidar.voxelize']['idle_ms'] == pytest.approx(0.005)
    assert r['camera.backbone']['idle_ms'] == pytest.approx(0.035)
    assert r['predict']['self_idle_ms'] == pytest.approx(0.020)
    for u in (first, second):
        assert sum(x['self_idle_ms'] for x in u['spans'].values()) \
            + u['outside_ms'] == pytest.approx(u['idle_ms'])
    assert second['idle_ms'] == pytest.approx(0.025)
    assert second['outside_ms'] == pytest.approx(0.005)
    b = second['spans']['camera.backbone']          # two calls, summed
    assert b['idle_ms'] == pytest.approx(0.014)      # 9 + 5


def test_device_and_host_ms_sum_over_a_units_calls():
    first, second = spans.span_units(RECORDS)
    assert first['unit'] == 0 and second['unit'] == 1
    b = second['spans']['camera.backbone']
    assert b['calls'] == 2 and b['device_ms'] == pytest.approx(8.0)
    assert b['host_ms'] == pytest.approx(0.074)
    assert first['spans']['lidar']['device_ms'] == pytest.approx(2.5)


def test_waits_count_under_every_enclosing_span():
    first, second = spans.span_units(RECORDS)
    for name in ('lidar.voxelize', 'lidar', 'predict'):
        assert first['spans'][name]['waits'] == 1
        assert first['spans'][name]['wait_ms'] == pytest.approx(0.010)
    assert first['spans']['camera.backbone']['waits'] == 0
    assert first['waits'] == {'padded_width': [1, pytest.approx(0.010)]}
    assert second['spans']['predict']['waits'] == 1
    assert second['spans']['camera.backbone']['waits'] == 0


def test_no_entry_span_gives_no_unit():
    recs = {'spans': [span(0, 'head', -1, -1, 0, 10)], 'waits': []}
    assert spans.idle_units(EVENTS, recs, BASE) == []
    assert spans.span_units(recs) == []


def test_gaps_measure_equals_a_brute_force_sum():
    rng = random.Random(0)
    busy = sorted((a, a + rng.uniform(0, 5))
                  for a in (rng.uniform(0, 100) for _ in range(40)))
    iv = gaps(busy, 0, 100)
    g = spans.Gaps(iv)
    for _ in range(200):
        lo, hi = sorted(rng.uniform(-5, 105) for _ in range(2))
        want = sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in iv)
        assert g.measure(lo, hi) == pytest.approx(want, abs=1e-9)


def test_clock_check_counts_launches_inside_entry_and_backbone_spans():
    out = spans.clock_check(EVENTS, RECORDS, BASE)
    assert out == {'launches': 2, 'in_entry': 2, 'k2_launches': 1,
                   'k2_in_backbone': 0}
    moved = dict(RECORDS, spans=RECORDS['spans'] + [
        span(7, 'camera.backbone', 0, 0, 5, 8)])
    assert spans.clock_check(EVENTS, moved, BASE)['k2_in_backbone'] == 1


def test_table_lists_every_span_and_site():
    res = {'timed': spans.span_units(RECORDS),
           'traced': spans.idle_units(EVENTS, RECORDS, BASE),
           'clock': spans.clock_check(EVENTS, RECORDS, BASE)}
    text = spans.table(res)
    for name in ('predict', 'lidar', 'lidar.voxelize', 'camera.backbone',
                 'wait padded_width', 'wait long_runs', 'clock:',
                 spans.OUTSIDE):
        assert name in text


READERS = {'view_transformer_ms.eval': ('timed', 'camera.view_transformer',
                                        'device_ms'),
           'head_ms.stream': ('timed', 'head', 'device_ms'),
           'lidar_wait_ms.stream': ('timed', 'lidar', 'wait_ms'),
           'index_wait_ms.eval': ('timed', 'camera.pooling_index',
                                  'wait_ms'),
           'lidar_idle_ms.stream': ('traced', 'lidar', 'idle_ms'),
           'backbone_idle_ms.stream': ('traced', 'camera.backbone',
                                       'idle_ms'),
           'backbone_idle_ms.eval': ('traced', 'camera.backbone',
                                     'idle_ms')}


@pytest.mark.parametrize('name', sorted(READERS))
def test_readers_take_the_mean_per_unit_and_none_without_spans(name):
    reader = spec.load_module(spec.reader_path(name), 'r_' + name)
    assert reader.NEEDS_SPANS is True
    part, span_name, key = READERS[name]
    units = [{'spans': {span_name: {key: 4.0}}}, {'spans': {}}]
    data = types.SimpleNamespace(spans={part: units})
    assert reader.read(data, name) == pytest.approx(2.0)
    other = 'traced' if part == 'timed' else 'timed'
    assert reader.read(types.SimpleNamespace(spans={other: units}),
                       name) is None
    assert reader.read(types.SimpleNamespace(), name) is None
    assert reader.read(types.SimpleNamespace(spans={part: [
        {'spans': {}}]}), name) is None
