"""CPU tests of the two streamed cells beside ``fusion_occ.stream``:
``bevformer_base_occ.stream_temporal`` (BEVFormer-Occ,
``drivers/stream_temporal.py``) and ``fusion_occ.stream_fused`` (K3's
fused epilogue, ``drivers/stream_fused.py``).  A tiny run of each comes
out ``correct``; planted faults (BEVFormer's state returned unchanged, the
previous BEV rotated the wrong way, spatial cross-attention dividing by 6
cameras whatever sees a query; the fused epilogue without its ReLU) and
BEVFormer's fp8 control do not.  The configuration file holds the preset
and its ``bevformer`` sizes, the reference loads nothing of the port, and
the roofline reader's formula gives the published shapes' figures.

    python3 -m pytest benchmark/test_bevformer_cell.py -q
"""
from __future__ import annotations

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

BEVFORMER = 'bevformer_base_occ.stream_temporal'
FUSED = 'fusion_occ.stream_fused'
BENCHMARK = spec.load_benchmark(ROOT)


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def bevformer_conf():
    """BEVFormer-Occ's block kinds at the tiny size (``tiny_bevformer_config``)
    on 6 cameras at 56x96 (padded to 64x96) over the tiny 20x20x4 grid, in
    bfloat16 as the configuration file states."""
    from fusionocc_tpu_torch.config import (OptimConfig, tiny_bevformer_config,
                                            tiny_model_config)
    m = tiny_model_config(use_lidar=False, lidar_out_channels=0,
                          input_size=(56, 96), num_cams=6,
                          compute_dtype='bfloat16')
    return {'model': spec.as_json(m),
            'bevformer': spec.as_json(tiny_bevformer_config()),
            'optim': spec.as_json(OptimConfig()), 'batch_size': 1}


def tiny_traffic(workload):
    w = spec.cell(BENCHMARK, workload)
    traffic = json.loads(spec.traffic_path(w['traffic']).read_text())
    traffic.update(frames=4, compare_frames=3)
    return traffic


def tiny_run(workload, **kw):
    conf = bevformer_conf() if workload == BEVFORMER else tiny_conf(True)
    return run.run(workload, SEED, 0.5, False, device='cpu', conf=conf,
                   traffic=tiny_traffic(workload), bench=BENCHMARK, **kw)


def test_the_configuration_file_holds_the_preset():
    from fusionocc_tpu_torch.config import BEVFormerConfig
    from fusionocc_tpu_torch.configs import get_config
    entry = spec.config_entry(BENCHMARK, 'bevformer_base_occ')
    conf = json.loads((ROOT / entry['file']).read_text())
    assert conf['reduced'] == entry['reduced'] == []
    preset = get_config(conf['preset'])
    assert conf['model'] == spec.as_json(preset.model)
    assert conf['optim'] == spec.as_json(preset.optim)
    assert conf['bevformer'] == spec.as_json(BEVFormerConfig())
    assert spec.build_dataclass(BEVFormerConfig, conf['bevformer']) == \
        BEVFormerConfig()
    assert all(len(w['why']) <= 200 for w in BENCHMARK['workloads'])


def test_the_bevformer_reference_loads_nothing_of_the_port():
    code = '''
import sys
sys.path[:0] = [{bench!r}]
from reference import bevformer_occ
print(sorted({{m.split('.', 1)[0] for m in sys.modules}}))
'''.format(bench=str(BENCH))
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, check=True, cwd=BENCH).stdout
    tops = set(json.loads(out.strip().splitlines()[-1].replace("'", '"')))
    assert not tops & {'jax', 'jaxlib', 'flax', 'fusionocc_tpu',
                       'fusionocc_tpu_torch', 'harness'}


def test_the_msda_roofline_reader_reads_the_cell_configuration():
    """At the published shapes the rig sees 50,606 (query, camera) pairs;
    a TSA call is 0.8192 GFLOP and 112.64 MB, an SCA call 4.1456 GFLOP and
    276.07 MB (bound 0.0336 and 0.0824 ms, both by the bytes); clocks at
    twice the bounds read 50 %."""
    reader = spec.load_module(spec.reader_path('msda_roofline.stream'),
                              'reader_msda_roofline')
    conf = json.loads((ROOT / spec.config_entry(
        BENCHMARK, 'bevformer_base_occ')['file']).read_text())
    assert reader.seen_pairs(conf) == 50606
    per, dtype = reader.calls(conf)
    assert dtype == torch.bfloat16
    assert per['tsa'] == (10 * 80000 * 8 * 4 * 32, 112640000)
    assert per['sca'] == (10 * 50606 * 8 * 4 * 8 * 32,
                          6 * 30825 * 256 * 2 + 50606 * 8 * 32 * 12
                          + 50606 * 256 * 2)
    tsa_ms, sca_ms = (1e3 * per[k][1] / 3.35e12 for k in ('tsa', 'sca'))
    data = trace.TraceData(clock_units=1, module_ms={
        'msda.tsa.0': [2 * tsa_ms], 'msda.sca.0': [2 * sca_ms],
        'img_backbone': [3.0], 'bev_encoder': [5.0]})
    assert reader.read(data, 'msda_roofline.stream') == pytest.approx(50.0)
    for name, want in (('dcn_backbone_ms.stream', 3.0),
                       ('bev_encoder_ms.stream', 5.0)):
        r = spec.load_module(spec.reader_path(name), 'r_' + name)
        assert r.read(data, name) == want
    assert reader.read(trace.TraceData(), 'msda_roofline.stream') is None


@pytest.mark.parametrize('workload', [BEVFORMER, FUSED])
def test_a_sound_run_is_correct(workload):
    res = tiny_run(workload)
    assert res['correct'], res['compared']
    assert res['failed'] == 0 and res['attempted'] > 0


def _state_unchanged(monkeypatch):
    from fusionocc_tpu_torch.models.bevformer_occ import BEVFormerOcc
    orig = BEVFormerOcc.predict_streaming

    def broken(self, batch, state, *a, **k):
        pred, out, _ = orig(self, batch, state, *a, **k)
        return pred, out, state
    monkeypatch.setattr(BEVFormerOcc, 'predict_streaming', broken)


def _rotation_reversed(monkeypatch):
    from fusionocc_tpu_torch.models import bevformer_occ
    orig = bevformer_occ.rotate_bev
    monkeypatch.setattr(bevformer_occ, 'rotate_bev',
                        lambda bev, a, h, w: orig(bev, -a, h, w))


def _sca_over_all_cameras(monkeypatch):
    from fusionocc_tpu_torch.models.bevformer_occ import BEVFormerOcc
    orig = BEVFormerOcc.rig_index

    def broken(self, batch):
        rig = orig(self, batch)
        return rig._replace(count=torch.full_like(rig.count, 6.0))
    monkeypatch.setattr(BEVFormerOcc, 'rig_index', broken)


@pytest.mark.parametrize('fault', [_state_unchanged, _rotation_reversed,
                                   _sca_over_all_cameras],
                         ids=['state-unchanged', 'rotation-reversed',
                              'sca-over-6'])
def test_a_broken_bevformer_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    res = tiny_run(BEVFORMER)
    assert not res['correct'], res['compared']


def test_the_bevformer_fp8_control_is_not_correct():
    import calibrate_bevformer
    numbers, _ = calibrate_bevformer.fp8_numbers(
        SEED, 'cpu', conf=bevformer_conf(), traffic=tiny_traffic(BEVFORMER))
    assert not compare.held(numbers), numbers


def test_a_fused_epilogue_without_its_relu_is_not_correct(monkeypatch):
    from fusionocc_tpu_torch.models import lidar_encoder
    from fusionocc_tpu_torch.ops.zwin_conv import zwin_conv
    calls = []

    def no_relu(feats, mask_out, nbr, w, f_in, f_out, stride, inv, shift,
                lane_mask):
        calls.append(1)
        y = zwin_conv(feats, mask_out, nbr, w, f_in, f_out, stride)
        m = lane_mask.float().repeat_interleave(inv.numel() // f_out, -1)
        return ((y.float() * inv + shift) * m).to(y.dtype)
    monkeypatch.setattr(lidar_encoder, 'zwin_conv_epi', no_relu)
    res = tiny_run(FUSED)
    assert calls and not res['correct'], res['compared']
