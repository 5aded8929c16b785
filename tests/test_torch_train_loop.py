"""The port's losses, optimizer, checkpoints, training tool and eval mode.

- Losses: ``depth_loss``, ``seg_loss``, ``occ_loss`` and ``total_loss``
  against ``fusionocc_tpu/train/losses.py`` on the same numpy inputs, the
  values and the gradients of the predictions, with and without
  ``mask_camera``; one case has 80,000 voxels, where JAX takes the
  occupancy loss in two chunks under ``lax.map`` and the port in one pass.
  1e-5 relative (fp32 sums in another order).
- ``OptimConfig``, ``EvalConfig`` and ``TrainConfig`` equal JAX's field
  by field; ``check_train_supported`` takes every evaluation protocol of
  the presets (mIoU, RayIoU, hybrid) and refuses an unknown one.
- The optimizer against optax's chain on a small module whose parameters
  sit under ``img_backbone``, ``img_view_transformer`` and another root:
  three steps with clipping active, with ``backbone_lr_mult`` 0.1 (two
  groups, each clipped alone) and with ``accumulate_steps`` 2 (four
  calls); the parameters and the EMA within 1e-6 (updates of about 1e-3,
  Adam's arithmetic in another order); the LR
  schedule at its boundaries equals ``make_lr_schedule``'s (1e-6
  relative).
- On the tiny model: ``accumulate_steps=2`` on one batch equals one step
  (parameters frozen after the first call), as ``tests/test_grad_accum.py``
  checks JAX; the low-LR group holds exactly the parameters of the two
  roots.
- A checkpoint round trip, and a resumed run giving the same next step as
  the uninterrupted one, bit for bit under torch's deterministic algorithms
  (random draws included); ``tools/train_torch.py
  --tiny --synthetic --steps 2 --device cpu`` and its refusal to run with
  neither data source.
- ``predict`` on a model left in train mode equals ``predict`` in eval, and
  leaves the mode as it was; ``eval_step`` predicts with the EMA.
"""
import copy
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fusionocc_tpu import config as jcfg
from fusionocc_tpu.train import losses as jlosses
from fusionocc_tpu.train.loop import make_lr_schedule as j_make_lr_schedule
from fusionocc_tpu.train.loop import make_optimizer as j_make_optimizer
from fusionocc_tpu_torch import config as tcfg
from fusionocc_tpu_torch.data.synthetic import synthetic_batch
from fusionocc_tpu_torch.models.fusion_occ import Batch, FusionOcc, init_weights
from fusionocc_tpu_torch.nn import layers
from fusionocc_tpu_torch.train import checkpoint as ckpt
from fusionocc_tpu_torch.train import losses, loop
from torch_threads import ONE_THREAD, one_torch_thread  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = dict(rtol=1e-5, atol=1e-7)
OPT_TOL = dict(rtol=1e-6, atol=1e-6)


def _t(x, grad=False):
    return torch.tensor(np.asarray(x), requires_grad=grad)


def _loss_inputs(cfg, grid_xyz, seed):
    rng = np.random.RandomState(seed)
    B, N = 1, cfg.num_cams
    H, W = cfg.input_size
    h, w = cfg.feat_size
    D = cfg.grid.num_depth_bins
    logits = rng.randn(B, N, h, w, D)
    depth = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True))
    sparse = np.where(rng.rand(B, N, H, W) < 0.05,
                      rng.uniform(*cfg.grid.depth[:2], (B, N, H, W)), 0.0)
    segs = rng.randint(0, 18, (B, N, H, W))
    return dict(
        depth=depth.astype(np.float32),
        seg_logits=rng.randn(B, N, h, w, 18).astype(np.float32),
        occ_logits=rng.randn(B, *grid_xyz, 18).astype(np.float32),
        sparse_depth=sparse.astype(np.float32), segs=segs.astype(np.int32),
        voxel_semantics=rng.randint(0, 18, (B, *grid_xyz)).astype(np.int32),
        mask_camera=rng.rand(B, *grid_xyz) > 0.3)


@pytest.mark.parametrize('grid_xyz,masked', [((20, 20, 4), True),
                                             ((20, 20, 4), False),
                                             ((100, 100, 8), True)])
def test_losses_match_jax(grid_xyz, masked):
    jc, tc = jcfg.tiny_model_config(), tcfg.tiny_model_config()
    a = _loss_inputs(tc, grid_xyz, seed=sum(grid_xyz))
    mask = a['mask_camera'] if masked else None
    preds = ('depth', 'seg_logits', 'occ_logits')

    def jtotal(d, s, o):
        batch = jcfg_batch(a, mask)
        return jlosses.total_loss({'depth': d, 'seg_logits': s,
                                   'occ_logits': o}, batch, jc)
    (jloss, jlogs), jgrads = jax.value_and_grad(
        jtotal, argnums=(0, 1, 2), has_aux=True)(
            *(jnp.asarray(a[k]) for k in preds))
    out = {k: _t(a[k], True) for k in preds}
    batch = Batch(*[None] * 8, sparse_depth=_t(a['sparse_depth']),
                  segs=_t(a['segs']), voxel_semantics=_t(a['voxel_semantics']),
                  mask_camera=None if mask is None else _t(mask))
    loss, logs = losses.total_loss(out, batch, tc)
    loss.backward()
    for key in ('depth_loss', 'seg_loss', 'loss_occ', 'loss'):
        np.testing.assert_allclose(logs[key].item(), float(jlogs[key]),
                                   **LOSS_TOL, err_msg=key)
    for key, g in zip(preds, jgrads):
        np.testing.assert_allclose(out[key].grad.numpy(), np.asarray(g),
                                   rtol=1e-5, atol=1e-9, err_msg=key)
    # each term alone against its JAX function
    o = losses.occ_loss(_t(a['occ_logits']), _t(a['voxel_semantics']),
                        None if mask is None else _t(mask), tc.use_mask)
    jo = jlosses.occ_loss(jnp.asarray(a['occ_logits']),
                          jnp.asarray(a['voxel_semantics']),
                          None if mask is None else jnp.asarray(mask),
                          jc.use_mask)
    np.testing.assert_allclose(float(o), float(jo), **LOSS_TOL)


def jcfg_batch(a, mask):
    from fusionocc_tpu.models.fusion_occ import Batch as JBatch
    return JBatch(*[None] * 8, sparse_depth=jnp.asarray(a['sparse_depth']),
                  segs=jnp.asarray(a['segs']),
                  voxel_semantics=jnp.asarray(a['voxel_semantics']),
                  mask_camera=None if mask is None else jnp.asarray(mask))


SCHED = dict(lr=2e-3, warmup_iters=5, max_epochs=2, iters_per_epoch=10)


def test_train_configs_match_jax():
    assert (dataclasses.asdict(tcfg.TrainConfig(model=_tiny()))
            == dataclasses.asdict(jcfg.TrainConfig(model=jcfg_tiny())))
    for name in ('OptimConfig', 'EvalConfig', 'TrainConfig'):
        assert ([(f.name, f.default) for f in
                 dataclasses.fields(getattr(tcfg, name))]
                == [(f.name, f.default) for f in
                    dataclasses.fields(getattr(jcfg, name))]), name
    for metric in ('miou', 'rayiou', 'hybrid'):
        tcfg.check_train_supported(tcfg.TrainConfig(
            model=_tiny(), eval=tcfg.EvalConfig(metric=metric)))
    with pytest.raises(ValueError, match='rayiou'):
        tcfg.check_train_supported(tcfg.TrainConfig(
            model=_tiny(), eval=tcfg.EvalConfig(metric='nope')))


def jcfg_tiny():
    cfg = jcfg.tiny_model_config()
    return dataclasses.replace(
        cfg, lidar=dataclasses.replace(cfg.lidar, backend='zfold',
                                       zconv='zband'))


def test_lr_schedule_matches_optax_at_its_boundaries():
    j = j_make_lr_schedule(jcfg.OptimConfig(**SCHED))
    t = loop.make_lr_schedule(tcfg.OptimConfig(**SCHED))
    for count in (0, 1, 4, 5, 6, 12, 19, 20, 21, 200):
        np.testing.assert_allclose(t(count), float(j(count)), rtol=1e-6,
                                   err_msg=str(count))
    assert t(0) == pytest.approx(SCHED['lr'] / 3)


class _Toy(torch.nn.Module):
    """Parameters under the low-LR roots and under another root."""

    def __init__(self, g):
        super().__init__()
        for root in ('img_backbone', 'img_view_transformer', 'head'):
            m = torch.nn.Module()
            m.w = torch.nn.Parameter(torch.randn(3, 4, generator=g))
            m.b = torch.nn.Parameter(torch.randn(4, generator=g))
            self.add_module(root, m)


@pytest.mark.parametrize('overrides', [{}, dict(backbone_lr_mult=0.1),
                                       dict(accumulate_steps=2)])
def test_optimizer_matches_optax(overrides):
    """Gradients big enough that clipping (norm 5) acts; the EMA moves on
    every call."""
    opt = dict(SCHED, **overrides)
    model = _Toy(torch.Generator().manual_seed(0))

    def nest(flat):     # 'root.leaf' -> {root: {leaf}}, as flax trees are
        tree = {}
        for n, v in flat.items():
            root, leaf = n.split('.')
            tree.setdefault(root, {})[leaf] = jnp.asarray(v)
        return tree
    tree = nest({n: p.detach().numpy().copy()       # no shared buffer
                 for n, p in model.named_parameters()})
    tx = j_make_optimizer(jcfg.OptimConfig(**opt))
    jstate = tx.init(tree)
    jema = tree
    state = loop.create_train_state(
        model, tcfg.TrainConfig(model=_tiny(), optim=tcfg.OptimConfig(**opt)))
    rng = np.random.RandomState(1)
    for _ in range(4 if overrides.get('accumulate_steps') else 3):
        grads = {n: (3 * rng.randn(*p.shape)).astype(np.float32)
                 for n, p in model.named_parameters()}
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[n])
        loop.apply_gradients(model, tcfg.OptimConfig(**opt), state)
        upd, jstate = tx.update(nest(grads), jstate, tree)
        tree = optax.apply_updates(tree, upd)
        jema = jax.tree.map(lambda e, p: e * (1 - 0.001) + p * 0.001, jema,
                            tree)
    for n, p in model.named_parameters():
        root, leaf = n.split('.')
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(tree[root][leaf]), **OPT_TOL,
                                   err_msg=n)
        np.testing.assert_allclose(state.ema[n].numpy(),
                                   np.asarray(jema[root][leaf]), **OPT_TOL,
                                   err_msg=n)


def _tiny(**vt):
    cfg = tcfg.tiny_model_config()
    return dataclasses.replace(
        cfg, lidar=dataclasses.replace(cfg.lidar, backend='zfold',
                                       zconv='zband'),
        vt=dataclasses.replace(cfg.vt, **vt))


def _model(cfg, seed=0):
    return init_weights(FusionOcc(cfg, device='cpu'),
                        torch.Generator().manual_seed(seed))


def test_accumulation_matches_single_step(monkeypatch):
    """Two micro-steps on one batch (random draws off) equal one step; the
    parameters stay put after the first."""
    monkeypatch.setattr(layers, 'dropout', lambda x, rate: x)
    cfg = _tiny(depth_drop_rate=0.0)
    batch = synthetic_batch(cfg, 1, 0, num_points=256, device='cpu')
    optim = tcfg.OptimConfig(**SCHED)
    runs = []
    for k in (1, 2):
        tc = tcfg.TrainConfig(model=cfg, optim=dataclasses.replace(
            optim, accumulate_steps=k))
        model = _model(cfg)
        before = copy.deepcopy(model.state_dict())
        state = loop.create_train_state(model, tc)
        loop.train_step(model, tc, state, batch)
        if k == 2:
            for n, p in model.named_parameters():
                assert torch.equal(p, before[n]), n
            loop.train_step(model, tc, state, batch)
        assert state.count == 1 and state.step == k
        runs.append(model)
    for (n, a), b in zip(runs[0].named_parameters(), runs[1].parameters()):
        torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-7, msg=n)


def test_low_lr_group_is_the_two_roots():
    model = _model(_tiny())
    groups = loop.param_groups(model, tcfg.OptimConfig(backbone_lr_mult=0.1))
    low = {n.split('.')[0] for n in groups['low']}
    assert low == set(loop.LOW_LR_ROOTS)
    assert not {n.split('.')[0] for n in groups['base']} & low
    assert len(groups['low']) + len(groups['base']) == len(
        list(model.parameters()))
    assert list(loop.param_groups(model, tcfg.OptimConfig())) == ['base']


@pytest.fixture
def deterministic():
    """torch's deterministic algorithms, so no scatter-add of the backward
    may sum in thread order."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


def test_checkpoint_round_trip_and_resume(tmp_path, deterministic):
    cfg = _tiny()
    tc = tcfg.TrainConfig(model=cfg, optim=tcfg.OptimConfig(**SCHED))
    batch = synthetic_batch(cfg, 1, 0, num_points=256, device='cpu')
    model = _model(cfg)
    state = loop.create_train_state(model, tc)
    loop.train_step(model, tc, state, batch)
    path = ckpt.save_checkpoint(str(tmp_path), model, state)
    assert path.endswith('step_1')
    assert ckpt.latest_checkpoint(str(tmp_path)) == path

    fresh = _model(cfg, seed=1)
    fstate = loop.create_train_state(fresh, tc)
    ckpt.restore_checkpoint(path, fresh, fstate)
    for (n, a), b in zip(model.state_dict().items(),
                         fresh.state_dict().values()):
        assert torch.equal(a, b), n
    for key, a in state.state_dict().items():
        b = fstate.state_dict()[key]
        if isinstance(a, dict):
            assert all(torch.equal(a[n], b[n]) for n in a), key
        else:
            assert a == b, key
    # the next step, random draws included, is the same from both
    logs = loop.train_step(model, tc, state, batch)
    flogs = loop.train_step(fresh, tc, fstate, batch)
    for key in logs:
        assert torch.equal(logs[key], flogs[key]), key
    for (n, a), b in zip(model.named_parameters(), fresh.parameters()):
        assert torch.equal(a, b), n


def test_train_tool_runs_on_cpu(tmp_path):
    cmd = [sys.executable, os.path.join(REPO, 'tools', 'train_torch.py'),
           '--tiny', '--synthetic', '--steps', '2', '--device', 'cpu',
           '--log-interval', '1', '--work-dir', str(tmp_path)]
    env = dict(os.environ, **ONE_THREAD)
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                         cwd=REPO, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith('step ')]
    assert [ln.split()[1] for ln in lines] == ['1/2', '2/2']
    for ln in lines:
        vals = dict(kv.split('=') for kv in ln.split()[2:])
        assert set(vals) >= {'loss', 'depth_loss', 'seg_loss', 'loss_occ',
                             'grad_norm', 'sec_per_iter'}
        assert all(np.isfinite(float(v)) for v in vals.values())
    assert os.path.isfile(tmp_path / 'step_2' / ckpt.STATE_FILE)
    real = subprocess.run(cmd[:2] + ['--tiny'], capture_output=True,
                          text=True, timeout=300, cwd=REPO, env=env)
    assert real.returncode != 0 and '--ann-file' in real.stderr


def test_predict_in_train_mode_equals_eval():
    cfg = _tiny()
    model = _model(cfg)
    batch = synthetic_batch(cfg, 1, 0, num_points=256, device='cpu')
    want = model.predict(batch)
    model.train()
    got = model.predict(batch)
    assert model.training and all(m.training for m in model.modules())
    assert torch.equal(got, want)
    with layers.random_scope(torch.Generator()):
        train_logits = model(batch)['occ_logits']
    assert not torch.equal(train_logits.argmax(-1).to(torch.uint8), want)


def test_eval_step_predicts_with_the_ema():
    """``eval_step`` predicts with the EMA parameters (or the live ones)
    and leaves the live parameters in place."""
    cfg = _tiny()
    tc = tcfg.TrainConfig(model=cfg, optim=tcfg.OptimConfig(lr=0.05))
    batch = synthetic_batch(cfg, 1, 0, num_points=256, device='cpu')
    model = _model(cfg)
    state = loop.create_train_state(model, tc)
    loop.train_step(model, tc, state, batch)
    live = copy.deepcopy(model.state_dict())
    ema_model = copy.deepcopy(model)
    with torch.no_grad():
        for n, p in ema_model.named_parameters():
            p.copy_(state.ema[n])
    assert torch.equal(loop.eval_step(model, state, batch),
                       ema_model.predict(batch))
    assert torch.equal(loop.eval_step(model, state, batch, use_ema=False),
                       model.predict(batch))
    for n, t in model.state_dict().items():
        assert torch.equal(t, live[n]), n
