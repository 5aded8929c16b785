"""``tools/test_torch.py`` and ``tools/train_torch.py`` on an on-disk tree,
on the CPU.

The tiny nuScenes-shaped tree of ``tests/test_ondisk.make_fake_raw_tree``
goes through ``tools/create_data.py``.  JAX's ``tools/test.py`` runs on it
once (``--tiny --buckets --rayiou``), beside the module's other tests, for
the keys it prints; the port's
tool, in two-pass, ``--streaming`` and ``--batch-frames`` mode, prints every
one of them, one ``key: value`` line each, and ends with the result as one
JSON line.  ``--config`` applies the preset's protocol (RayIoU, split
rename); ``--save-predictions`` writes one file per sample; ``--int8``
is refused naming ROADMAP item 12; without ``--device cpu`` the tool wants
the card.  ``tools/train_torch.py`` takes two steps from the tree and its
checkpoint loads into the evaluation tool, with and without the EMA.
"""
import json
import os
import pickle
import shutil
import sys

import numpy as np
import pytest
import torch
from torch_threads import ONE_THREAD, one_torch_thread  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    sys.path.insert(0, REPO)
    from test_ondisk import make_fake_raw_tree
    from tools.create_data import build_infos
    root = str(tmp_path_factory.mktemp('nusc_tool'))
    make_fake_raw_tree(root)
    infos, _ = build_infos(root, 'v1.0-mini', None)
    ann = os.path.join(root, 'fusionocc-nuscenes_infos_val.pkl')
    with open(ann, 'wb') as f:
        pickle.dump({'data_list': infos}, f)
    # the calibration presets' split, the same samples
    shutil.copy(ann, ann.replace('_val.pkl', '_val_eval.pkl'))
    return root, ann, os.path.join(root, 'img_seg')


def _lines(out):
    lines = out.strip().splitlines()
    return lines, json.loads(lines[-1])


@pytest.fixture(scope='module', autouse=True)
def jax_tool(tree):
    """JAX's ``tools/test.py`` on the tree, started with the module's first
    test: it runs beside the port's tests until ``jax_keys`` reads it."""
    import subprocess
    root, ann, seg = tree
    logs = [open(os.path.join(root, f'jax_tool.{k}'), 'w+')
            for k in ('out', 'err')]
    proc = subprocess.Popen(
        [sys.executable, os.path.join(REPO, 'tools', 'test.py'),
         '--ann-file', ann, '--img-seg-dir', seg, '--tiny', '--buckets',
         '--rayiou', '--max-samples', '2', '--warmup', '0'],
        stdout=logs[0], stderr=logs[1], text=True, cwd=REPO,
        env=dict(os.environ, JAX_PLATFORMS='cpu', **ONE_THREAD))
    yield proc, logs
    if proc.poll() is None:
        proc.kill()
        proc.wait()
    for f in logs:
        f.close()


@pytest.fixture(scope='module')
def jax_keys(jax_tool):
    """The keys JAX's ``tools/test.py`` prints on the tree."""
    proc, logs = jax_tool
    proc.wait(timeout=600)
    out, err = (f.seek(0) or f.read() for f in logs)
    assert proc.returncode == 0, err[-2000:]
    return list(_lines(out)[1])


def _run_port(argv, capsys):
    import tools.test_torch as tt
    tt.main(argv)
    return _lines(capsys.readouterr().out)


def test_config_protocol_and_saved_predictions(tree, capsys, tmp_path):
    """A calibration preset evaluates its own split; a RayIoU preset adds
    RayIoU; one prediction file per sample."""
    _, ann, seg = tree
    _, res = _run_port(['--tiny', '--device', 'cpu', '--ann-file', ann,
                        '--img-seg-dir', seg, '--config',
                        'fusion_occ_calib_eval', '--max-samples', '2',
                        '--save-predictions', str(tmp_path)], capsys)
    assert res['samples'] == 2 and 'RayIoU' not in res
    files = sorted(os.listdir(tmp_path))
    assert files == ['pred_000000.npz', 'pred_000001.npz']
    pred = np.load(tmp_path / files[0])['occ_pred']
    assert pred.shape == (1, 20, 20, 4) and pred.dtype == np.uint8
    _, res = _run_port(['--tiny', '--device', 'cpu', '--ann-file', ann,
                        '--img-seg-dir', seg, '--config',
                        'fusion_occ_unified_rayiou', '--max-samples', '1'],
                       capsys)
    assert np.isfinite(res['RayIoU'])


def test_refusals(tree):
    """No data source is refused; ``--int8`` and ``--int8-weights`` are
    ported and parse; the default device is the card."""
    import tools.test_torch as tt
    _, ann, _ = tree
    with pytest.raises(SystemExit):
        tt.parse_args(['--tiny'])
    for flag in ('--int8', '--int8-weights'):
        args = tt.parse_args(['--ann-file', ann, flag])
        assert args.int8 or args.int8_weights
    assert tt.resolve_config(tt.parse_args(
        ['--ann-file', ann, '--int8']))[0].swin.int8_dense
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            tt.evaluate(tt.parse_args(['--tiny', '--ann-file', ann]))


def test_train_tool_steps_from_the_tree_and_its_checkpoint_evaluates(
        tree, capsys, tmp_path):
    import tools.train_torch as tr
    root, ann, seg = tree
    tr.main(['--tiny', '--ann-file', ann, '--img-seg-dir', seg, '--steps',
             '2', '--device', 'cpu', '--log-interval', '1', '--work-dir',
             str(tmp_path)])
    out = capsys.readouterr().out
    steps = [ln for ln in out.splitlines() if ln.startswith('step ')]
    assert [ln.split()[1] for ln in steps] == ['1/2', '2/2']
    for ln in steps:
        vals = dict(kv.split('=') for kv in ln.split()[2:])
        assert all(np.isfinite(float(v)) for v in vals.values())
    with open(tmp_path / 'scalars.jsonl') as f:
        recs = [json.loads(line) for line in f]
    assert [r['step'] for r in recs] == [1, 2] and 'train/loss' in recs[0]
    for ema in (True, False):
        lines, res = _run_port(
            ['--tiny', '--device', 'cpu', '--ann-file', ann,
             '--img-seg-dir', seg, '--checkpoint', str(tmp_path),
             '--max-samples', '1'] + ([] if ema else ['--no-ema']), capsys)
        assert lines[0] == f'loaded checkpoint {tmp_path}/step_2 (step 2)'
        assert np.isfinite(res['mIoU'])
    # what each choice loads: the EMA over the parameters, or the live ones
    from fusionocc_tpu_torch.models.fusion_occ import FusionOcc
    from fusionocc_tpu_torch.train import checkpoint as ckpt
    import tools.test_torch as tt
    saved = torch.load(tmp_path / 'step_2' / ckpt.STATE_FILE)
    for ema, want in ((True, saved['train_state']['ema']),
                      (False, saved['model'])):
        model = FusionOcc(tt.tiny_config(), device='cpu')
        assert ckpt.load_for_eval(str(tmp_path / 'step_2'), model, ema) == 2
        for name, p in model.named_parameters():
            assert torch.equal(p, want[name]), name
    name = 'img_backbone.patch_embed.projection.weight'
    assert not torch.equal(saved['train_state']['ema'][name],
                           saved['model'][name])


@pytest.mark.parametrize('mode', ['two-pass', 'streaming', 'batch-frames',
                                  'int8', 'int8-weights'])
def test_port_tool_prints_every_jax_key(tree, capsys, mode, request):
    """Last in the module: JAX's tool ran beside the tests before it."""
    _, ann, seg = tree
    extra = {'two-pass': [], 'streaming': ['--streaming'],
             'batch-frames': ['--batch-frames'], 'int8': ['--int8'],
             'int8-weights': ['--int8-weights']}[mode]
    lines, res = _run_port(['--tiny', '--device', 'cpu', '--ann-file', ann,
                            '--img-seg-dir', seg, '--buckets', '--rayiou',
                            '--warmup', '0'] + extra, capsys)
    assert list(res) == request.getfixturevalue('jax_keys')
    assert lines[:-1][-len(res):] == [f'{k}: {v}' for k, v in res.items()]
    assert res['samples'] == 3
    for key in ('mIoU', 'RayIoU', 'mIoU_radius_0-20m', 'latency_mean_ms',
                'fps'):
        assert np.isfinite(res[key]), key
    assert 0.0 <= res['mIoU'] <= 100.0 and res['total_params'] > 0
