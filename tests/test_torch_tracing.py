"""The program's spans and waits (``fusionocc_tpu_torch/utils/profiling.py``)
on the CPU at tiny size.

- Off, ``span`` and ``wait`` return the shared no-op and nothing is
  recorded; on, a streamed frame and a two-pass predict give the span tree
  of the port's layers, each child inside its parent, one unit per entry
  call; the outputs are bit-identical either way.
- Waits: five ``padded_width`` reads per LiDAR encoder pass, at any batch
  size; six inside ``camera.pooling_index`` when a frame's index is built
  in the call, none when it is passed in; two in the streaming warp.
- The clock: each span lies within 1 ms of the ``record_function``
  annotation of the same name in a CPU ``torch.profiler`` trace, on the
  trace's ``ts`` * 1000 + ``baseTimeNanoseconds``, and
  ``chrome_events`` puts it there.
- ``torch.export`` of the serving program traces with tracing on, and
  records nothing.
"""
import json
import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from fusionocc_tpu_torch.data.synthetic import synthetic_batch  # noqa: E402
from fusionocc_tpu_torch.models.fusion_occ import (  # noqa: E402
    FusionOcc, batch_pooling_indices, init_weights)
from fusionocc_tpu_torch.utils import profiling  # noqa: E402
from tools import export_torch as et  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

CAMERA = ('camera.backbone', 'camera.neck', 'camera.view_transformer',
          'camera.pre_process')
LIDAR = ('lidar.voxelize', 'lidar.regroup', 'lidar.stage0.index',
         'lidar.stage0.convs', 'lidar.stage1.index', 'lidar.stage1.convs',
         'lidar.stage2.index', 'lidar.stage2.convs', 'lidar.dense_tail')
HEAD = ('head.trunk', 'head.final')
INDEX_WAITS = ['frustum.copy', 'frustum.inverse', 'frustum.inverse',
               'pooling_index.constant', 'pooling_index.constant',
               'long_runs']


@pytest.fixture(scope='module')
def tiny():
    cfg = et.model_config(tiny=True, fp32=False)
    model = init_weights(FusionOcc(cfg, device='cpu'),
                         torch.Generator().manual_seed(0))
    batch = synthetic_batch(cfg, 1, 0, num_points=512, device='cpu')
    return cfg, model, batch, batch_pooling_indices(cfg, batch)


def _stream(model, batch, idxs):
    return model.predict_streaming(batch, model.init_streaming_state(1),
                                   idxs[0])


def _traced(fn):
    with profiling.tracing() as tr:
        out = fn()
    return out, tr.collect()


def _children(records, parent):
    return [s for s in records['spans'] if s['parent'] == parent['id']]


def _check_tree(records):
    """Every child inside its parent, in its parent's unit; returns the
    entry spans."""
    by_id = {s['id']: s for s in records['spans']}
    for s in records['spans']:
        assert s['start_ns'] <= s['end_ns']
        if s['parent'] != -1:
            p = by_id[s['parent']]
            assert p['start_ns'] <= s['start_ns'] <= s['end_ns'] \
                <= p['end_ns'], (s['name'], p['name'])
            assert s['unit'] == p['unit']
    return [s for s in records['spans'] if s['parent'] == -1]


def test_off_span_and_wait_are_the_shared_noop(tiny):
    cfg, model, batch, idxs = tiny
    assert profiling.span('head') is profiling.NOOP
    assert profiling.wait('padded_width') is profiling.NOOP
    with profiling.NOOP as x:
        assert x is profiling.NOOP
    idle = profiling.tracing()
    model.predict(batch, idxs)
    assert idle.tracer.collect() == {'spans': [], 'waits': []}
    with profiling.tracing() as tr:
        pass
    _stream(model, batch, idxs)         # after the block: off again
    assert tr.collect() == {'spans': [], 'waits': []}


def test_span_tree_of_a_streamed_frame(tiny):
    cfg, model, batch, idxs = tiny
    _, rec = _traced(lambda: _stream(model, batch, idxs))
    (entry,) = _check_tree(rec)
    assert entry['name'] == 'predict_streaming' and entry['unit'] >= 0
    # CUDA events only where CUDA is available
    assert (entry['device_ms'] is None) != torch.cuda.is_available()
    top = [s['name'] for s in _children(rec, entry)]
    assert top == [*CAMERA, 'lidar', 'stream.warp', 'head']
    lidar = next(s for s in rec['spans'] if s['name'] == 'lidar')
    assert [s['name'] for s in _children(rec, lidar)] == list(LIDAR)
    head = next(s for s in rec['spans'] if s['name'] == 'head')
    assert [s['name'] for s in _children(rec, head)] == list(HEAD)
    assert {s['unit'] for s in rec['spans']} == {entry['unit']}


@pytest.mark.parametrize('indices', ['passed', 'built'])
def test_span_tree_of_a_two_pass_predict(tiny, indices):
    cfg, model, batch, idxs = tiny
    _, rec = _traced(lambda: model.predict(
        batch, idxs if indices == 'passed' else None))
    (entry,) = _check_tree(rec)
    assert entry['name'] == 'predict'
    camera = list(CAMERA)
    if indices == 'built':
        camera.insert(2, 'camera.pooling_index')
    top = [s['name'] for s in _children(rec, entry)]
    assert top == camera * cfg.num_frame + ['lidar', 'head']


def test_one_unit_per_entry_call(tiny):
    cfg, model, batch, idxs = tiny
    with profiling.tracing() as tr:
        model.predict(batch, idxs)
        model(batch, idxs)                       # the eval forward
        _stream(model, batch, idxs)
        first = tr.collect()
        model.predict(batch, idxs)
        second = tr.collect()
    entries = _check_tree(first) + _check_tree(second)
    assert [s['name'] for s in entries] == [
        'predict', 'forward', 'predict_streaming', 'predict']
    units = [s['unit'] for s in entries]
    assert len(set(units)) == 4             # ids count on across collect()
    frames = {k: v[None].expand(2, *v.shape) for k, v in
              batch._asdict().items() if v is not None}
    stacked = batch._replace(**frames)
    _, rec = _traced(lambda: model.predict_streaming_scan(
        stacked, model.init_streaming_state(1), pool_idx=idxs[0]))
    (scan,) = _check_tree(rec)
    assert [s['name'] for s in _children(rec, scan)] == [
        'predict_streaming'] * 2            # two frames, one unit
    assert {s['unit'] for s in rec['spans']} == {scan['unit']}


@pytest.mark.parametrize('path', ['stream', 'two-pass'])
def test_outputs_are_bit_identical_with_tracing_on_and_off(tiny, path):
    cfg, model, batch, idxs = tiny
    if path == 'stream':
        def fn():
            pred, out, state = _stream(model, batch, idxs)
            return [pred, out['occ_logits'], *state]
    else:
        def fn():
            return [model.predict(batch, [idxs[0], None])]
    off = fn()
    on, rec = _traced(fn)
    assert rec['spans']
    for a, b in zip(off, on):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize('batch_size', [1, 2])
def test_five_padded_width_waits_per_encoder_pass(tiny, batch_size):
    cfg, model, _, _ = tiny
    b = synthetic_batch(cfg, batch_size, 3, num_points=512, device='cpu')
    with torch.inference_mode():
        _, rec = _traced(lambda: model.lidar_encoder(b.points,
                                                     b.points_mask))
    assert [w['site'] for w in rec['waits']] == ['padded_width'] * 5
    by_id = {s['id']: s['name'] for s in rec['spans']}
    assert [by_id[w['span']] for w in rec['waits']] == [
        'lidar.voxelize', 'lidar.regroup', 'lidar.stage0.index',
        'lidar.stage1.index', 'lidar.stage2.index']
    assert all(w['end_ns'] >= w['start_ns'] for w in rec['waits'])


def test_waits_of_a_streamed_frame(tiny):
    cfg, model, batch, idxs = tiny
    _, rec = _traced(lambda: _stream(model, batch, idxs))
    by_id = {s['id']: s['name'] for s in rec['spans']}
    where = [(w['site'], by_id[w['span']]) for w in rec['waits']]
    assert [w for w in where if w[1].startswith('lidar')] == [
        ('padded_width', s) for s in ('lidar.voxelize', 'lidar.regroup',
                                      'lidar.stage0.index',
                                      'lidar.stage1.index',
                                      'lidar.stage2.index')]
    assert [w for w in where if not w[1].startswith('lidar')] == [
        ('warp.constant', 'stream.warp')] * 2


@pytest.mark.parametrize('indices', ['built', 'passed'])
def test_pooling_index_waits_only_when_built_in_the_call(tiny, indices):
    cfg, model, batch, idxs = tiny
    pool = {'built': [idxs[0], None], 'passed': idxs}[indices]
    _, rec = _traced(lambda: model.predict(batch, pool))
    by_id = {s['id']: s['name'] for s in rec['spans']}
    inside = [w['site'] for w in rec['waits']
              if by_id[w['span']] == 'camera.pooling_index']
    assert inside == (INDEX_WAITS if indices == 'built' else [])
    assert sum(s['name'] == 'camera.pooling_index' for s in rec['spans']) \
        == (1 if indices == 'built' else 0)
    assert [w['site'] for w in rec['waits']
            if by_id[w['span']] != 'camera.pooling_index'] == (
                ['padded_width'] * 5)


def test_spans_lie_on_the_profiler_trace_clock(tiny, tmp_path):
    cfg, model, batch, idxs = tiny
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, rec = _traced(lambda: _stream(model, batch, idxs))
    path = tmp_path / 'trace.json'
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    base = int(doc['baseTimeNanoseconds'])
    notes = {}
    for e in doc['traceEvents']:
        if e.get('cat') == 'user_annotation':
            notes.setdefault(e['name'], []).append(e)
    mine = {}
    for e in profiling.chrome_events(rec, base):
        if e.get('cat') == 'program_span':
            mine.setdefault(e['name'], []).append(e)
    assert sorted(mine) == sorted(s['name'] for s in rec['spans'])
    for name, ours in mine.items():
        assert len(notes[name]) == len(ours), name
        for a, b in zip(ours, notes[name]):
            # within 1 ms (1000 us)
            assert abs(a['ts'] - float(b['ts'])) < 1e3, name
            assert abs(a['ts'] + a['dur'] - float(b['ts'])
                       - float(b['dur'])) < 1e3, name
            assert a['args']['unit'] == rec['spans'][0]['unit']
    waits = [e for e in profiling.chrome_events(rec, base)
             if e.get('cat') == 'program_wait']
    assert [e['name'] for e in waits] == [w['site'] for w in rec['waits']]


def test_export_traces_with_tracing_on(tiny):
    cfg, model, batch, idxs = tiny
    with profiling.tracing() as tr:
        program = et.export_program(model, batch)
    assert tr.collect() == {'spans': [], 'waits': []}
    assert not any('profiler' in str(n.target)
                   for n in program.graph.nodes)
    got = program.module()(*et.program_args(batch))
    assert torch.equal(got, model.predict(batch))
