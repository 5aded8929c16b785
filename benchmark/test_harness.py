"""CPU tests of the benchmark: the harness as data, its arithmetic, the
plain reference against the port, and the comparison that decides
``correct`` (a sound run holds, a broken one and the control do not).

    python3 -m pytest benchmark/test_harness.py -q

Tests marked ``card`` need an NVIDIA card and skip without one.
"""
from __future__ import annotations

import dataclasses
import json
import math
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

import run  # noqa: E402
from harness import compare, peaks, spec, trace  # noqa: E402

SEED = 2 ** 31 + 12345          # larger than 32 signed bits hold


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card')


def tiny_conf(use_lidar=True):
    """The port's tiny model (its LiDAR on the z-folded path the presets
    take) as a configuration file would state it."""
    from fusionocc_tpu_torch.config import OptimConfig, tiny_model_config
    m = tiny_model_config(use_lidar=use_lidar)
    m = dataclasses.replace(m, lidar=dataclasses.replace(
        m.lidar, backend='zfold', zconv='zwin'))
    return {'model': spec.as_json(m), 'optim': spec.as_json(OptimConfig()),
            'batch_size': 1}


def tiny_run(workload, seconds=1.5, **kw):
    """A run on the CPU at the tiny size, over a scene of 8 frames."""
    conf = tiny_conf('image_only' not in workload)
    bench = TRAINING if workload == TRAIN_CELL['name'] else BENCHMARK
    w = spec.cell(bench, workload)
    traffic = json.loads(spec.traffic_path(w['traffic']).read_text())
    traffic.update(frames=8, compare_frames=3, batches=4)
    return run.run(workload, SEED, seconds, False, device='cpu', conf=conf,
                   traffic=traffic, bench=bench, **kw)


# --- the harness as data ----------------------------------------------------

BENCHMARK = spec.load_benchmark(ROOT)

# The training cell, out of BENCHMARK.json until a number of its check
# separates a lower precision from sound runs (PERF.md); its driver, mix
# and reference stay under test.
TRAIN_CELL = {'name': 'fusion_occ.train', 'config': 'fusion_occ',
              'traffic': 'train', 'chips': 1, 'why': 'fine-tuning step'}
TRAINING = dict(BENCHMARK, workloads=[TRAIN_CELL], per_layer=[],
                end_to_end=[{'name': 'train_samples_per_s',
                             'unit': 'samples/s', 'better': 'higher',
                             'bound': 0.25, 'source': 'host_clock'}])


def test_benchmark_keys_and_names():
    b = BENCHMARK
    assert set(b) == {'command', 'paths', 'run_seconds', 'configs',
                      'workloads', 'end_to_end', 'per_layer'}
    names = ([c['name'] for c in b['configs']]
             + [w['name'] for w in b['workloads']]
             + [m['name'] for m in b['end_to_end'] + b['per_layer']])
    assert len(names) == len(set(names))
    for n in names + [w['traffic'] for w in b['workloads']]:
        assert spec.NAME.match(n), n
    for m in b['end_to_end'] + b['per_layer']:
        assert spec.UNIT.match(m['unit']), m
        assert m['better'] in ('lower', 'higher')
    for m in b['end_to_end']:
        assert 0.01 <= m['bound'] <= 0.25 and m['source'] in (
            'host_clock', 'device_trace')
    assert any(m['name'] == 'setup_s' for m in b['end_to_end'])
    assert len(json.dumps(b)) < 64 * 1024


def test_every_cell_resolves_to_its_files():
    for w in BENCHMARK['workloads']:
        entry = spec.config_entry(BENCHMARK, w['config'])
        assert (ROOT / entry['file']).is_file()
        assert entry['file'].startswith(tuple(BENCHMARK['paths']))
        traffic = json.loads(spec.traffic_path(w['traffic']).read_text())
        assert spec.driver_path(traffic['driver']).is_file()
        for m in spec.per_layer(BENCHMARK, w['name']):
            assert spec.reader_path(m['name']) is not None, m['name']
        reported = {m['name'] for m in spec.end_to_end(BENCHMARK,
                                                       w['name'])}
        assert 'setup_s' in reported and len(reported) >= 2
        assert set(traffic['reports']) | {'setup_s'} >= reported
        assert spec.per_layer(BENCHMARK, w['name'])


def test_config_files_hold_the_presets():
    """Every number of a configuration file is the port's preset's, bar
    the keys its ``reduced`` lists (none)."""
    from fusionocc_tpu_torch.configs import get_config
    for c in BENCHMARK['configs']:
        conf = json.loads((ROOT / c['file']).read_text())
        assert conf['reduced'] == c['reduced'] == []
        preset = get_config(conf['preset'])
        assert conf['model'] == spec.as_json(preset.model)
        assert conf['optim'] == spec.as_json(preset.optim)
        from harness import program
        assert program.port_config(conf).model == preset.model


def test_a_field_the_file_leaves_out_takes_its_default():
    """A field the program adds later runs at its default and is named;
    a key that is no field is refused."""
    @dataclasses.dataclass(frozen=True)
    class Inner:
        a: int = 1
        new: float = 0.5

    @dataclasses.dataclass(frozen=True)
    class Outer:
        inner: Inner = Inner()
        sizes: tuple = (1, 2)
        added: bool = False

    got = []
    o = spec.build_dataclass(Outer, {'inner': {'a': 3}, 'sizes': [4, 5]},
                             got)
    assert o == Outer(Inner(3, 0.5), (4, 5), False)
    assert got == ['inner.new', 'added']
    with pytest.raises(KeyError):
        spec.build_dataclass(Outer, {'inner': {'a': 3, 'gone': 1}})
    with pytest.raises(KeyError):
        spec.build_dataclass(Outer, {'gone': 1})


def test_every_per_layer_metric_moves_a_metric_its_cells_report():
    for m in BENCHMARK['per_layer']:
        for w in m.get('workloads', [x['name'] for x in
                                     BENCHMARK['workloads']]):
            assert m['moves'] in {e['name'] for e in spec.end_to_end(
                BENCHMARK, w)}, (m['name'], w)


def test_a_made_up_cell_is_found_by_name(tmp_path):
    """A configuration, a mix, a cell and a per-layer metric added as new
    files and entries alone."""
    root = tmp_path / 'repo'
    shutil.copytree(BENCH, root / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__'))
    b = json.loads(json.dumps(BENCHMARK))
    conf = json.loads((ROOT / b['configs'][0]['file']).read_text())
    (root / 'benchmark/configs/made_up.json').write_text(json.dumps(conf))
    (root / 'benchmark/traffic/made_up_mix.json').write_text(json.dumps(
        {'driver': 'stream', 'frames': 8, 'compare_frames': 2,
         'trace_units': 2, 'reports': {'stream_fps': 'frames_per_s'},
         'limits': {'gap_mean': 0.1}}))
    (root / 'benchmark/readers/made_up_share.py').write_text(
        'def read(data, name):\n    return 1.0\n')
    b['configs'].append({'name': 'made_up', 'source': 'https://example.org',
                         'file': 'benchmark/configs/made_up.json',
                         'reduced': [], 'why': 'made up'})
    b['workloads'].append({'name': 'made_up.mix', 'config': 'made_up',
                           'traffic': 'made_up_mix', 'chips': 1,
                           'why': 'made up'})
    b['end_to_end'][0]['workloads'].append('made_up.mix')
    b['per_layer'].append({'name': 'made_up_share.mix', 'unit': '%',
                           'better': 'higher', 'source': 'device_trace',
                           'layer': 'device', 'moves': 'stream_fps',
                           'workloads': ['made_up.mix']})
    (root / 'BENCHMARK.json').write_text(json.dumps(b))
    w = spec.cell(spec.load_benchmark(root), 'made_up.mix')
    assert spec.traffic_path(w['traffic'], root).is_file()
    reader = spec.reader_path('made_up_share.mix', root)
    assert reader == root / 'benchmark/readers/made_up_share.py'
    assert spec.load_module(reader, 'r').read(None, 'x') == 1.0
    assert {m['name'] for m in spec.end_to_end(b, 'made_up.mix')} == {
        'stream_fps', 'setup_s'}


# --- the arithmetic ------------------------------------------------------------

def test_tail_is_over_all_units_and_rates_over_the_window():
    lat = [0.010] * 95 + [0.050] * 5
    assert run.percentile(lat, 95) == pytest.approx(0.010 + 0.04 * 0.05)
    assert run.percentile([0.01, math.inf], 50) == math.inf
    assert run.percentile(list(range(101)), 95) == 95


def test_idle_share_is_a_union_of_intervals():
    iv = [(0, 10), (5, 15), (20, 30), (21, 22)]
    assert trace.union_seconds(iv) == 25
    assert trace.gaps(iv, 0, 40) == [(15, 20), (30, 40)]


def test_trace_reduction(tmp_path):
    ev = [{'ph': 'X', 'cat': 'user_annotation', 'name': trace.UNIT_SPAN,
           'ts': 0, 'dur': 100},
          {'ph': 'X', 'cat': 'user_annotation', 'name': trace.UNIT_SPAN,
           'ts': 100, 'dur': 100},
          {'ph': 'X', 'cat': 'cuda_runtime', 'name': 'cudaLaunchKernel',
           'ts': 5, 'dur': 2},
          {'ph': 'X', 'cat': 'cuda_runtime', 'name': 'cudaDeviceSynchronize',
           'ts': 160, 'dur': 40},
          {'ph': 'X', 'cat': 'kernel', 'name': 'a', 'ts': 10, 'dur': 50},
          {'ph': 'X', 'cat': 'kernel', 'name': 'b', 'ts': 40, 'dur': 40},
          {'ph': 'X', 'cat': 'gpu_memcpy', 'name': 'c', 'ts': 150,
           'dur': 20},
          {'ph': 'X', 'cat': 'cpu_op', 'name': 'aten::nonzero', 'ts': 85,
           'dur': 60},
          {'ph': 'X', 'cat': 'cpu_op', 'name': 'aten::add', 'ts': 2,
           'dur': 3}]
    p = tmp_path / 't.json'
    p.write_text(json.dumps({'traceEvents': ev}))
    wall, busy, ops = trace.reduce_busy(p)
    assert wall == pytest.approx(195e-6) and busy == pytest.approx(90e-6)
    assert ops[0] == ['a', pytest.approx(50e-6)]
    idle = trace.idle_gaps(p)
    assert idle[0] == ['aten::nonzero', pytest.approx(70e-6)]
    assert idle[1] == ['after aten::nonzero', pytest.approx(30e-6)]
    assert idle[2] == ['aten::add', pytest.approx(10e-6)]


def test_roofline_formulas():
    q = torch.zeros(10, 144, 128, dtype=torch.bfloat16)
    bias = torch.zeros(4, 144, 144)
    f, b, dt = peaks.window_attn(q, q, q, bias, 1, 10, 12, 0, 4, q)
    assert f == 4 * 10 * 4 * 144 * 144 * 32
    assert b == 4 * q.numel() * 2 + bias.numel() * 4
    assert peaks.bound_s(989e12, 0, torch.bfloat16) == pytest.approx(1.0)
    assert peaks.bound_s(0, 3.35e12, torch.bfloat16) == pytest.approx(1.0)
    # K3: one found tap of one active row, a SubM conv at fold 1
    feats = torch.zeros(1, 4, 8)
    nbr = torch.full((1, 2, 27), 4, dtype=torch.int32)
    nbr[0, 0, 13] = 1
    mask = torch.tensor([[True, False]])
    w = torch.zeros(27, 8, 16)
    f, _, _ = peaks.zwin_conv(feats, mask, nbr, w, 1, 1, 1,
                              out=torch.zeros(1, 2, 16))
    assert f == 2 * 8 * 16


def test_leaf_gaps_and_kept_leaves():
    ref = {'a': 1.0, 'b': 2.0, 'c': 1e-6}
    keep = compare.kept_leaves(ref)
    assert keep == ['a', 'b']
    assert compare.leaf_gaps({'a': 0.0, 'b': 2.0}, ref, keep) == 1.0
    assert compare.held([('x', 0.1, 0.2)])
    assert not compare.held([('x', math.nan, 0.2)])


# --- what a run may import -----------------------------------------------------

def test_nothing_the_harness_runs_imports_jax():
    code = '''
import sys
sys.path[:0] = [{bench!r}, {root!r}]
import run, calibrate
from harness import compare, inputs, peaks, program, spec, trace
from pathlib import Path
for d in ('drivers', 'readers'):
    for p in sorted(Path({bench!r}, d).glob('*.py')):
        spec.load_module(p, d + '_' + p.stem)
import fusionocc_tpu_torch.models.fusion_occ, fusionocc_tpu_torch.train.loop
print(sorted({{m.split('.', 1)[0] for m in sys.modules}}))
'''.format(bench=str(BENCH), root=str(ROOT))
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, check=True, cwd=ROOT).stdout
    tops = set(json.loads(out.strip().splitlines()[-1].replace("'", '"')))
    assert not tops & {'jax', 'jaxlib', 'flax', 'fusionocc_tpu'}
    assert 'fusionocc_tpu_torch' in tops


def test_the_reference_loads_nothing_of_the_port():
    code = '''
import sys
sys.path[:0] = [{bench!r}]
from reference import (bev_pool, counting, fusion_occ, layers, losses,
                       optim, weights, window_attn, zwin_conv)
print(sorted({{m.split('.', 1)[0] for m in sys.modules}}))
'''.format(bench=str(BENCH))
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, check=True, cwd=BENCH).stdout
    tops = set(json.loads(out.strip().splitlines()[-1].replace("'", '"')))
    assert not tops & {'jax', 'jaxlib', 'flax', 'fusionocc_tpu',
                       'fusionocc_tpu_torch', 'harness'}


def test_run_refuses_without_a_card_or_outside_a_checkout(tmp_path):
    r = subprocess.run([sys.executable, str(BENCH / 'run.py'),
                        '--workload', 'fusion_occ.stream', '--seed', '1',
                        '--seconds', '1'], capture_output=True, text=True,
                       cwd=ROOT, env={'CUDA_VISIBLE_DEVICES': '',
                                      'PATH': '/usr/bin:/bin'})
    assert r.returncode != 0 and r.stdout.strip() == ''
    lone = tmp_path / 'lone'
    (lone / 'benchmark').mkdir(parents=True)
    shutil.copy(ROOT / 'BENCHMARK.json', lone)
    shutil.copytree(BENCH, lone / 'benchmark', dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns('__pycache__'))
    r = subprocess.run([sys.executable, 'benchmark/run.py', '--workload',
                        'fusion_occ.stream', '--seed', '1', '--seconds', '1'],
                       capture_output=True, text=True, cwd=lone)
    assert r.returncode != 0 and r.stdout.strip() == ''


# --- the reference against the port ------------------------------------------

@pytest.mark.parametrize('size', ['tiny', 'midsize'])
def test_reference_logits_match_the_port(size):
    from fusionocc_tpu_torch.config import (midsize_model_config,
                                            tiny_model_config)
    from fusionocc_tpu_torch.models.fusion_occ import Batch

    from harness import inputs, program
    m = (tiny_model_config() if size == 'tiny' else midsize_model_config())
    m = dataclasses.replace(m, lidar=dataclasses.replace(
        m.lidar, backend='zfold', zconv='zwin'))
    conf = {'model': spec.as_json(m), 'optim': tiny_conf()['optim'],
            'batch_size': 1}
    _, port = program.port_model(conf, SEED, 'cpu')
    _, ref = program.reference_model(conf, SEED, 'cpu')
    scene = inputs.make_scene(m, 3, SEED, 'cpu')
    f = inputs.frame_fields(m, scene, 2, [1])
    from reference.fusion_occ import Batch as RefBatch
    with torch.no_grad():
        pl = port(Batch(**f))['occ_logits']
        rl = ref(RefBatch(**f))['occ_logits']
        assert compare.rel_l2(pl, rl) < 1e-5
        state = port.init_streaming_state(1)
        f0 = inputs.frame_fields(m, scene, 1, [])
        f1 = inputs.frame_fields(m, scene, 2, [])
        _, _, state = port.predict_streaming(Batch(**f0), state)
        _, out, _ = port.predict_streaming(Batch(**f1), state)
        prev = ref.camera_voxel(RefBatch(**f0))
        rl = ref.streaming_logits(RefBatch(**f1), prev,
                                  scene['ego2global'][1][None],
                                  torch.ones(1, dtype=torch.bool))
        assert compare.rel_l2(out['occ_logits'], rl) < 1e-5


def test_reference_train_step_matches_the_port():
    res = tiny_run('fusion_occ.train', seconds=0.5)
    c, r = res['compared'], res['_notes']['readings']
    assert max(r['loss_gap_steps']) < 1e-4
    assert r['grad_gap'] < 1e-4 and r['grad_gap_worst'] < 1e-3
    assert c['change_gap']['value'] < 1e-2
    assert c['steps_missing']['value'] == 0


def test_reference_counts_flops_by_the_frozen_formulas():
    from reference import bev_pool, counting
    from reference.config import GridConfig
    grid = GridConfig(x=(0., 2., 1.), y=(0., 2., 1.), z=(0., 1., 1.),
                      depth=(1., 3., 1.))
    coor = torch.tensor([0.5, 0.5, 0.5]).repeat(1, 1, 2, 1, 2, 1)
    coor[0, 0, 1, 0, 1] = torch.tensor([9., 9., 9.])     # leaves the grid
    idx = bev_pool.prepare_pooling_index(coor, grid)
    depth = torch.ones(1, 1, 2, 1, 2, requires_grad=True)
    feat = torch.ones(1, 1, 1, 2, 3, requires_grad=True)
    n = counting.count_flops(lambda: bev_pool.bev_pool(
        depth, feat, idx, grid).sum().backward())
    assert n == 3 * 2 * 3 * 3          # 3 points in, 3 channels, fwd + bwd
    assert depth.grad is not None and feat.grad is not None


# --- correct: a sound run holds, a broken one and the control do not ----------

@pytest.mark.parametrize('workload', ['fusion_occ.stream',
                                      'fusion_occ_image_only.twopass',
                                      'fusion_occ.train'])
def test_a_sound_run_is_correct(workload):
    res = tiny_run(workload)
    assert res['correct'], res['compared']
    assert res['failed'] == 0 and res['attempted'] > 0
    assert list(res)[-2:] == ['compared', '_notes']


def _stream_state_unchanged(monkeypatch):
    from fusionocc_tpu_torch.models.fusion_occ import FusionOcc
    orig = FusionOcc.predict_streaming

    def broken(self, batch, state, *a, **k):
        pred, out, _ = orig(self, batch, state, *a, **k)
        return pred, out, state
    monkeypatch.setattr(FusionOcc, 'predict_streaming', broken)


def _answer_altered(name):
    def plant(monkeypatch):
        from fusionocc_tpu_torch.models.fusion_occ import FusionOcc
        orig = getattr(FusionOcc, name)

        def broken(self, *a, **k):
            out = orig(self, *a, **k)
            pred = out[0] if isinstance(out, tuple) else out
            with torch.inference_mode():
                pred.copy_((pred + 1) % 18)     # every voxel's class
            return out
        monkeypatch.setattr(FusionOcc, name, broken)
    return plant


def _train_state_unchanged(monkeypatch):
    from fusionocc_tpu_torch.train import loop
    monkeypatch.setattr(loop, 'apply_gradients',
                        lambda model, opt, state: torch.zeros(()))


def _train_update_doubled(monkeypatch):
    from fusionocc_tpu_torch.train import loop
    orig = loop.apply_gradients

    def broken(model, opt, state):
        orig(model, opt, state)
        return orig(model, opt, state)
    monkeypatch.setattr(loop, 'apply_gradients', broken)


@pytest.mark.parametrize('workload,fault', [
    ('fusion_occ.stream', _stream_state_unchanged),
    ('fusion_occ.stream', _answer_altered('predict_streaming')),
    ('fusion_occ_image_only.twopass', _answer_altered('predict')),
    ('fusion_occ.train', _train_state_unchanged),
    ('fusion_occ.train', _train_update_doubled),
], ids=['stream-state', 'stream-answer', 'twopass-answer', 'train-state',
        'train-doubled'])
def test_a_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    res = tiny_run(workload)
    assert not res['correct'], res['compared']


@pytest.mark.parametrize('workload', ['fusion_occ.stream',
                                      'fusion_occ_image_only.twopass'])
@pytest.mark.parametrize('control', ['int8', 'fp8'])
def test_the_control_is_not_correct(workload, control):
    """The port with its int8 serving path switched on, and the reference
    one precision below the configuration's in the port's place, each
    fail a number.  (The training step's fp8 control fails none: no
    training number reads it 3x farther than sound runs, see PERF.md.)"""
    import calibrate
    if control == 'int8':
        res = tiny_run(workload, model_edit=calibrate.int8_serving)
        assert not res['correct'], res['compared']
        return
    w = spec.cell(BENCHMARK, workload)
    traffic = json.loads(spec.traffic_path(w['traffic']).read_text())
    traffic.update(frames=8, compare_frames=3, batches=4)
    numbers, _ = calibrate.fp8_control(
        workload, SEED, 'cpu', conf=tiny_conf('image_only' not in workload),
        traffic=traffic)
    assert not compare.held(numbers), numbers


@pytest.mark.card
def test_a_cell_runs_on_the_card(card):
    res = run.run('fusion_occ.stream', SEED, 5.0, False)
    assert res['correct'], res['compared']
    assert res['device']['platform'] == 'gpu'
