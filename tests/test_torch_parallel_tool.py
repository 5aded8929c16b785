"""Multi-process training through ``tools/train_torch.py`` on the CPU, and
the loader's host sharding.

(f) ``python -m torch.distributed.run --standalone --nproc_per_node 2
    tools/train_torch.py --tiny --synthetic --steps 2 --device cpu`` (2
    gloo ranks, batch 1 each) writes the ``scalars.jsonl`` that one process
    at ``--batch-size 2`` writes: one line per step, from rank 0 alone;
    the loss and its terms within 1e-4 relative at every step, the first
    step's ``grad_norm`` within 1e-4 and later ones within 1e-2 (Adam's
    first update moves the parameters of near-zero gradients by up to 2 lr
    either way, and the camera branch's ReLU at its kink amplifies it:
    ``tests/test_torch_parallel.py`` (a) holds them against that spread).
    ``--resume`` of both runs takes a third step that agrees the same way.
(h) ``data_loader(host_id=r, host_count=2)`` on the tiny tree of
    ``tests/test_ondisk.py``: the two shards are disjoint, cover the
    shuffled order, and equal JAX's ``data_loader`` shards index for index.
"""
import importlib.util
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from fusionocc_tpu import config as jcfg
from fusionocc_tpu.data import dataset as jds
from fusionocc_tpu_torch import config as tcfg
from fusionocc_tpu_torch.data import dataset as tds
from torch_threads import one_torch_thread  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO, 'tools', 'train_torch.py')
LOSS_RTOL, FIRST_NORM_RTOL, NORM_RTOL = 1e-4, 1e-4, 1e-2


def _start(work_dir, *extra, ranks: int = 1, steps: int = 2):
    """The tool's run, started; ``_done`` waits for it."""
    args = [TOOL, '--tiny', '--synthetic', '--steps', str(steps), '--device',
            'cpu', '--log-interval', '1', '--work-dir', str(work_dir),
            *extra]
    if ranks > 1:
        args = ['-m', 'torch.distributed.run', '--standalone',
                '--nproc_per_node', str(ranks), *args]
    env = dict(os.environ, OMP_NUM_THREADS='1')
    return subprocess.Popen([sys.executable, *args], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=REPO,
                            env=env)


def _done(proc):
    """The standard output of a run ``_start`` started; it must succeed."""
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    return out


def _scalars(work_dir):
    with open(os.path.join(work_dir, 'scalars.jsonl')) as f:
        return [json.loads(line) for line in f]


def _assert_same_steps(got, want):
    assert [r['step'] for r in got] == [r['step'] for r in want]
    for g, w in zip(got, want):
        for key in ('loss', 'depth_loss', 'seg_loss', 'loss_occ'):
            np.testing.assert_allclose(g[f'train/{key}'], w[f'train/{key}'],
                                       rtol=LOSS_RTOL, err_msg=key)
        np.testing.assert_allclose(
            g['train/grad_norm'], w['train/grad_norm'],
            rtol=FIRST_NORM_RTOL if w['step'] == 1 else NORM_RTOL)


def test_torchrun_two_ranks_write_the_batch2_scalars(tmp_path):
    """The ranks' run and the one process's run side by side (each pair
    shares nothing but the seed)."""
    ranks, one = tmp_path / 'ranks', tmp_path / 'one'
    runs = [_start(ranks, ranks=2), _start(one, '--batch-size', '2')]
    stdout, _ = map(_done, runs)
    got, want = _scalars(ranks), _scalars(one)
    assert [r['step'] for r in got] == [1, 2]       # rank 0 alone writes
    assert sum(ln.startswith('step ') for ln in stdout.splitlines()) == 2
    _assert_same_steps(got, want)
    # rank 0 alone writes: scalars, the checkpoint, and with tensorboardX
    # the TensorBoard events (the JAX tool's logger)
    tensorboard = importlib.util.find_spec('tensorboardX') is not None
    assert sorted(os.listdir(ranks)) == ['scalars.jsonl', 'step_2'] + (
        ['tb'] if tensorboard else [])
    assert not tensorboard or len(os.listdir(ranks / 'tb')) == 1
    runs = [_start(ranks, '--resume', str(ranks), ranks=2, steps=3),
            _start(one, '--resume', str(one), '--batch-size', '2', steps=3)]
    list(map(_done, runs))
    got, want = _scalars(ranks), _scalars(one)
    assert [r['step'] for r in got] == [1, 2, 3]
    _assert_same_steps(got[2:], want[2:])


@pytest.fixture(scope='module')
def tiny_tree(tmp_path_factory):
    sys.path.insert(0, REPO)
    from test_ondisk import make_fake_raw_tree
    from tools.create_data import build_infos
    root = str(tmp_path_factory.mktemp('nusc_hosts'))
    make_fake_raw_tree(root)
    infos, _ = build_infos(root, 'v1.0-mini', None)
    ann = os.path.join(root, 'fusionocc-nuscenes_infos_train.pkl')
    with open(ann, 'wb') as f:
        pickle.dump({'data_list': infos}, f)
    return ann, os.path.join(root, 'img_seg')


@pytest.mark.parametrize('seed', [0, 3])
def test_loader_host_shards_match_jax(tiny_tree, seed):
    ann, seg = tiny_tree
    shards = {}
    for name, pkg, cfg in (('port', tds, tcfg), ('jax', jds, jcfg)):
        ds = pkg.NuScenesOccDataset(ann, cfg.tiny_model_config(),
                                    img_seg_dir=seg)
        shards[name] = [
            [int(i) for _, idxs in pkg.data_loader(
                ds, 1, shuffle=True, seed=seed, host_id=r, host_count=2,
                num_workers=0, yield_indices=True) for i in idxs]
            for r in range(2)]
        n = len(ds)
    port = shards['port']
    assert port == shards['jax']
    assert not set(port[0]) & set(port[1])
    assert sorted(port[0] + port[1]) == list(range(n))
    # an odd count: the shards differ by one, as JAX's do
    assert n >= 3 and len(port[0]) - len(port[1]) in (0, 1)
