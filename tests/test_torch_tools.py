"""The port's counterparts of the JAX tools that need JAX (item 15 of the
roadmap), and the training tool's defaults.

Each ``tools/<name>_torch.py`` takes its JAX tool's flags and prints its
output; it imports the port alone (``test_torch_config``).  Mirrored from
``tests/test_tools.py``: the offline scorer on a fake ground-truth tree
with perfect predictions (``:26``), the burn-in at tiny size on the CPU
(``:117``) and the ground-truth statistics (``:138``), whose output
equals the JAX tool's line for line.  The log summary and the depth maps
of ``gen_seg_depth`` equal the JAX tools' on the same inputs; the loader
benchmark runs one sample with no worker thread.  ``tools/train_torch.py``
parses to ``tools/train.py``'s defaults, flag by flag.
"""
import argparse
import importlib.util
import json
import os
import pickle
import shutil
import subprocess
import sys

import numpy as np
import pytest
from torch_threads import ONE_THREAD, one_torch_thread  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_tool(name: str, *args: str) -> str:
    """``tools/<name>.py args`` in a fresh process on the CPU: its stdout."""
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, 'tools', f'{name}.py'), *args],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env={**os.environ, 'JAX_PLATFORMS': 'cpu', **ONE_THREAD})
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def load_tool(name: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, 'tools', f'{name}.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def gt_tree(tmp_path, n: int, seed: int, preds=None) -> str:
    """``n`` samples of random 20x20x4 labels (and, with ``preds``, the
    labels themselves as predictions there): the infos pkl's path."""
    rng = np.random.RandomState(seed)
    infos = []
    for i in range(n):
        token = f'tok{i}'
        gt_dir = tmp_path / 'gts' / f'scene-{i:04d}' / token
        gt_dir.mkdir(parents=True)
        sem = rng.randint(0, 18, (20, 20, 4)).astype(np.uint8)
        mask = rng.rand(20, 20, 4) > 0.3
        np.savez(gt_dir / 'labels.npz', semantics=sem,
                 mask_camera=mask.astype(np.uint8),
                 mask_lidar=mask.astype(np.uint8))
        if preds is not None:
            np.savez_compressed(preds / f'pred_{i:06d}.npz', occ_pred=sem)
        infos.append({'token': token, 'timestamp': i,
                      'occ_path': str(gt_dir), 'lidar_path': 'unused.bin',
                      'scene_token': f'sc{i}'})
    ann = tmp_path / 'infos_val.pkl'
    with open(ann, 'wb') as f:
        pickle.dump({'data_list': infos}, f)
    return str(ann)


def test_offline_scorer_round_trip(tmp_path):
    """``tests/test_tools.py:26``: perfect predictions score mIoU 100."""
    preds = tmp_path / 'preds'
    preds.mkdir()
    ann = gt_tree(tmp_path, 2, 0, preds)
    out = run_tool('compute_metrics_torch', '--pred-dir', str(preds),
                   '--ann-file', ann)
    res = json.loads(out.strip().splitlines()[-1])
    assert res['mIoU'] == 100.0
    assert res['samples'] == 2


def test_burnin_tool_smoke(tmp_path, capsys):
    """``tests/test_tools.py:117``: finite losses, a checkpoint mid-run and
    its replay (the unified recipe: accumulation and the backbone's LR
    multiplier)."""
    load_tool('burnin_torch').main([
        '--tiny', '--steps', '4', '--accum', '2', '--ckpt-at', '2',
        '--num-batches', '2', '--out', str(tmp_path), '--device', 'cpu'])
    lines = capsys.readouterr().out.strip().splitlines()
    assert (tmp_path / 'loss_curve.jsonl').exists()
    assert lines[-2].startswith('resume replay max |dloss| over 2 steps')
    res = json.loads(lines[-1])
    assert res['resume_ok'] and np.isfinite(res['loss_last'])


def test_analyze_occ_gt_prints_the_jax_tools_tables(tmp_path):
    """``tests/test_tools.py:138``."""
    ann = gt_tree(tmp_path, 3, 2)
    out = run_tool('analyze_occ_gt_torch', '--ann-file', ann)
    assert 'camera-mask coverage' in out
    assert 'driveable_surface' in out
    assert out == run_tool('analyze_occ_gt', '--ann-file', ann)


def test_analyze_logs_prints_the_jax_tools_summary(tmp_path):
    from fusionocc_tpu_torch.utils.logging import MetricLogger
    log = MetricLogger(str(tmp_path), use_tensorboard=False)
    for i in range(3):
        log.log(i + 1, {'loss': 3.0 - i, 'loss_occ': 2.0 - i / 2,
                        'sec_per_iter': 0.5})
    log.close()
    out = run_tool('analyze_logs_torch', '--work-dir', str(tmp_path))
    assert out.splitlines()[:2] == ['3 records, steps 1..3',
                                    'train/loss: first=3.0000 last=1.0000 '
                                    'min=1.0000 max=3.0000']
    assert out == run_tool('analyze_logs', '--work-dir', str(tmp_path))


def sweep_tree(root) -> str:
    """One sample: two cameras looking along +x and +y and a LiDAR sweep
    around the ego; the infos pkl's path."""
    rng = np.random.RandomState(4)
    pts = np.zeros((400, 5), np.float32)
    pts[:, :3] = rng.uniform(-20, 20, (400, 3)) * [1, 1, 0.1]
    lidar = os.path.join(root, 'samples', 'LIDAR_TOP', '0000.bin')
    os.makedirs(os.path.dirname(lidar))
    pts.tofile(lidar)
    cams = {}
    for cam, yaw in (('CAM_FRONT', 0.0), ('CAM_LEFT', np.pi / 2)):
        # camera z along the ego's heading, x to its right, y down
        c, s = np.cos(yaw / 2), np.sin(yaw / 2)
        q_yaw = np.array([c, 0, 0, s])
        q_opt = np.array([0.5, -0.5, 0.5, -0.5])    # optical from ego axes
        w1, x1, y1, z1 = q_yaw
        w2, x2, y2, z2 = q_opt
        q = [w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
             w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
             w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
             w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2]
        cams[cam] = {'data_path': os.path.join(root, 'samples', cam,
                                               '0000.jpg'),
                     'cam_intrinsic': [[80.0, 0, 80.0], [0, 80.0, 45.0],
                                       [0, 0, 1]],
                     'sensor2ego_rotation': q,
                     'sensor2ego_translation': [0.0, 0.0, 1.5],
                     'ego2global_rotation': [1, 0, 0, 0],
                     'ego2global_translation': [0.0, 0.0, 0.0]}
    info = {'token': 'tok0', 'lidar_path': lidar, 'cams': cams,
            'lidar2ego_rotation': [1, 0, 0, 0],
            'lidar2ego_translation': [0.0, 0.0, 1.8],
            'ego2global_rotation': [1, 0, 0, 0],
            'ego2global_translation': [0.0, 0.0, 0.0]}
    ann = os.path.join(root, 'infos.pkl')
    with open(ann, 'wb') as f:
        pickle.dump({'data_list': [info]}, f)
    return ann


def test_gen_seg_depth_writes_the_jax_tools_depth_maps(tmp_path):
    roots = [str(tmp_path / name) for name in ('port', 'jax')]
    anns = [sweep_tree(roots[0])]
    shutil.copytree(roots[0], roots[1])
    with open(os.path.join(roots[1], 'infos.pkl'), 'rb') as f:
        data = pickle.load(f)
    info = data['data_list'][0]
    info['lidar_path'] = info['lidar_path'].replace(roots[0], roots[1])
    for ci in info['cams'].values():
        ci['data_path'] = ci['data_path'].replace(roots[0], roots[1])
    anns.append(os.path.join(roots[1], 'infos.pkl'))
    with open(anns[1], 'wb') as f:
        pickle.dump(data, f)
    for tool, root, ann in zip(('gen_seg_depth_torch', 'gen_seg_depth'),
                               roots, anns):
        out = run_tool(tool, '--root', root, '--infos', ann, '--what',
                       'depth', '--workers', '1', '--src-h', '90',
                       '--src-w', '160')
        assert out.strip().splitlines()[-1] == 'done'
    filled = 0
    for cam in ('CAM_FRONT', 'CAM_LEFT'):
        got, want = (np.load(os.path.join(r, 'depth_gt', 'samples', cam,
                                          '0000.npy')) for r in roots)
        assert got.shape == (90, 160) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        filled += int((got > 0).sum())
    assert filled > 0


def test_bench_loader_smoke(tmp_path):
    out = run_tool('bench_loader_torch', '--samples', '1', '--workers', '0',
                   '--keep', str(tmp_path / 'tree'))
    res = json.loads(out.strip().splitlines()[-1])
    assert list(res) == ['samples_per_sec_w0'] and res['samples_per_sec_w0'] > 0


def parser_defaults(name: str, monkeypatch, argv) -> dict:
    """Each flag's default as ``tools/<name>.py`` parses it."""
    class Parsed(Exception):
        pass

    def capture(self, args=None, namespace=None):
        raise Parsed(self)
    monkeypatch.setattr(argparse.ArgumentParser, 'parse_args', capture)
    with pytest.raises(Parsed) as got:
        load_tool(name).main(*argv)
    return {a.dest: a.default for a in got.value.args[0]._actions
            if a.dest != 'help'}


def test_train_tool_takes_the_jax_tools_defaults(monkeypatch):
    """Every flag the two tools share has one default, except
    ``--work-dir`` (the port's checkpoints are not the JAX tool's, so they
    go to a directory of their own) and the multi-host flags, whose
    defaults the JAX tool reads from the environment at parse time and
    ``parallel.mesh.init_distributed`` reads when it runs (the same
    variables: ``SLURM_NTASKS``/``FUSIONOCC_NUM_PROCESSES``,
    ``SLURM_PROCID``/``FUSIONOCC_PROCESS_ID``, ``FUSIONOCC_COORDINATOR``)."""
    for var in ('SLURM_NTASKS', 'FUSIONOCC_NUM_PROCESSES', 'SLURM_PROCID',
                'FUSIONOCC_PROCESS_ID', 'FUSIONOCC_COORDINATOR'):
        monkeypatch.delenv(var, raising=False)
    jax_flags = parser_defaults('train', monkeypatch, ())
    port = parser_defaults('train_torch', monkeypatch, ([],))
    shared = sorted(set(jax_flags) & set(port))
    assert {'steps', 'log_interval', 'batch_size', 'ckpt_interval_steps',
            'render_interval'} <= set(shared)
    apart = {'work_dir', 'coordinator', 'num_processes', 'process_id'}
    assert {k: port[k] for k in shared if k not in apart} == \
        {k: jax_flags[k] for k in shared if k not in apart}
    assert (port['steps'], port['log_interval']) == (0, 50)
    assert jax_flags['num_processes'] == 1 and port['num_processes'] is None
