"""CPU tests of the two cells that evaluate two-pass ``predict`` beside
``fusion_occ_image_only.twopass``: ``fusion_occ.twopass`` (camera and
LiDAR) and ``bevdet_occ_stbase_stereo.twopass_stereo`` (BEVStereo4D-Occ,
``drivers/twopass_stereo.py``).  A tiny run of each comes out ``correct``;
in the stereo cell the planted faults (the cost volume replaced by zeros,
the older frame's stage-0 feature replaced by the frame's own) and both
controls do not.  The configuration file holds the preset, the stereo
reference loads nothing of the port, and the roofline reader's formula
gives the published shapes' figures.

    python3 -m pytest benchmark/test_stereo_cell.py -q
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

import run  # noqa: E402
from harness import compare, spec, trace  # noqa: E402
from test_harness import SEED, tiny_conf  # noqa: E402

STEREO = 'bevdet_occ_stbase_stereo.twopass_stereo'
BENCHMARK = spec.load_benchmark(ROOT)


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def stereo_conf():
    """The stereo preset's structure at the tiny size: no LiDAR, a 32-wide
    neck and depth net, trunk (1, 2, 4), float32."""
    from fusionocc_tpu_torch.config import OptimConfig, tiny_model_config
    m = tiny_model_config(use_lidar=False, lidar_out_channels=0,
                          bev_num_layer=(1, 2, 4))
    m = dataclasses.replace(m, vt=dataclasses.replace(
        m.vt, in_channels=32, mid_channels=32, aspp_mid_channels=8))
    return {'model': spec.as_json(m), 'optim': spec.as_json(OptimConfig()),
            'batch_size': 1}


def tiny_traffic(workload):
    w = spec.cell(BENCHMARK, workload)
    traffic = json.loads(spec.traffic_path(w['traffic']).read_text())
    traffic.update(frames=6, compare_frames=3)
    return traffic


def tiny_run(workload, seconds=1.0, **kw):
    conf = stereo_conf() if workload == STEREO else tiny_conf(True)
    return run.run(workload, SEED, seconds, False, device='cpu', conf=conf,
                   traffic=tiny_traffic(workload), bench=BENCHMARK, **kw)


def test_the_configuration_file_holds_the_preset():
    from fusionocc_tpu_torch.configs import get_config
    entry = spec.config_entry(BENCHMARK, 'bevdet_occ_stbase_stereo')
    conf = json.loads((ROOT / entry['file']).read_text())
    assert conf['reduced'] == entry['reduced'] == []
    preset = get_config(conf['preset'])
    assert conf['model'] == spec.as_json(preset.model)
    assert conf['optim'] == spec.as_json(preset.optim)
    assert all(len(w['why']) <= 200 for w in BENCHMARK['workloads'])


def test_the_stereo_reference_loads_nothing_of_the_port():
    code = '''
import sys
sys.path[:0] = [{bench!r}]
from reference import bevstereo_occ
print(sorted({{m.split('.', 1)[0] for m in sys.modules}}))
'''.format(bench=str(BENCH))
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, check=True, cwd=BENCH).stdout
    tops = set(json.loads(out.strip().splitlines()[-1].replace("'", '"')))
    assert not tops & {'jax', 'jaxlib', 'flax', 'fusionocc_tpu',
                       'fusionocc_tpu_torch', 'harness'}


def test_the_roofline_reader_reads_the_cell_configuration():
    """One volume at the published shapes: 30.45 GFLOP, 372 MB, bound
    0.454 ms by the FLOPs; two clocked calls of twice that read 50 %."""
    reader = spec.load_module(spec.reader_path('cost_volume_roofline.eval'),
                              'reader_cost_volume_roofline')
    conf = json.loads((ROOT / spec.config_entry(
        BENCHMARK, 'bevdet_occ_stbase_stereo')['file']).read_text())
    flops, nbytes = reader.volume(conf['model'], 1)
    assert flops == 10 * 128 * 6 * 88 * 128 * 352 == 30450647040
    assert nbytes == 371982336
    bound_ms = flops / 67e12 * 1e3
    data = trace.TraceData(clock_units=1,
                           module_ms={'cost_volume': [2 * bound_ms] * 2})
    assert reader.read(data, 'cost_volume_roofline.eval') == \
        pytest.approx(50.0)
    ms = spec.load_module(spec.reader_path('cost_volume_ms.eval'), 'r')
    assert ms.read(data, 'cost_volume_ms.eval') == pytest.approx(
        4 * bound_ms)
    assert reader.read(trace.TraceData(), 'cost_volume_roofline.eval') \
        is None


@pytest.mark.parametrize('workload', ['fusion_occ.twopass', STEREO])
def test_a_sound_run_is_correct(workload):
    res = tiny_run(workload)
    assert res['correct'], res['compared']
    assert res['failed'] == 0 and res['attempted'] > 0


def _cost_volume_zero(monkeypatch):
    from fusionocc_tpu_torch.models.bevstereo_occ import CostVolume
    orig = CostVolume.forward
    monkeypatch.setattr(CostVolume, 'forward', lambda self, c, p, g:
                        torch.zeros_like(orig(self, c, p, g)))


def _older_feature_is_own(monkeypatch):
    from fusionocc_tpu_torch.models.bevstereo_occ import CostVolume
    orig = CostVolume.forward
    monkeypatch.setattr(CostVolume, 'forward',
                        lambda self, c, p, g: orig(self, c, c, g))


@pytest.mark.parametrize('fault', [_cost_volume_zero, _older_feature_is_own],
                         ids=['cost-volume-zero', 'stage0-own'])
def test_a_broken_stereo_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    res = tiny_run(STEREO)
    assert not res['correct'], res['compared']


@pytest.mark.parametrize('control', ['int8', 'fp8'])
def test_the_stereo_controls_are_not_correct(control):
    import calibrate
    if control == 'int8':
        res = tiny_run(STEREO, model_edit=calibrate.int8_serving)
        assert not res['correct'], res['compared']
        return
    import calibrate_stereo
    numbers, _ = calibrate_stereo.fp8_numbers(
        SEED, 'cpu', conf=stereo_conf(), traffic=tiny_traffic(STEREO))
    assert not compare.held(numbers), numbers
