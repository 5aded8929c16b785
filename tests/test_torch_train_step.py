"""One training step of the port against ``fusionocc_tpu.train.loop``.

The tiny multi-modal config (``backend='zfold'``, ``zconv='zband'``), fp32,
with the stochastic parts switched off on both sides: ``depth_drop_rate=0``
in the config (tiny's Swin has ``drop_path_rate=0``), and ASPP's dropout
monkeypatched to the identity (flax's ``nn.Dropout`` in JAX, the port's
``nn.layers.dropout``).  Both start from the same random flax tree
(``test_torch_slice.random_variables``) carried into the port by
``weights.state_dict_from_flax``, and see the same synthetic batch (points
snapped to 2^-8, as ``test_torch_lidar_model`` does).  JAX's own jitted
``train_step`` runs once per module; its optimizer is chained behind a
transformation that keeps the raw gradients in the optimizer state, so they
can be compared by state-dict name (the same rules carry the gradient tree,
they are transposes and reshapes).  LR 3e-3 (1e-3 at the first step, after
the warmup start factor), so the update is well above the tolerances.

Tolerances (fp32, sums in another order):
- loss and each term: 1e-4 relative; ``grad_norm`` as the gradients;
- every gradient tensor: its L2 difference to JAX's within 3x the port's
  own change when the images move by 1e-6 (relative), plus 1e-4 of its
  norm; at least half of the tensors are held to the 1e-4 alone (in
  training mode the camera branch upstream of the view transformer's first
  BatchNorm moves by a few % under that perturbation: a ReLU there sits at
  its kink);
- the new parameters: 1e-6 absolute plus 1e-5 relative wherever the two
  gradients agree in sign and both exceed 1e-4 (Adam's first step is
  g / (|g| + 1e-8)), within 2.1 lr everywhere; the EMA: 0.001 of that, plus 1e-5 relative;
- the running statistics after the step: 1e-4 absolute and relative.

JAX's BatchNorm takes the variance in one pass (flax's
``use_fast_variance``) and the port in two; the comparison runs JAX's with
``use_fast_variance=False`` (monkeypatched), so the head's gradients, which
sum over many voxels, are compared to 1e-4 rather than to JAX's rounding
of the one-pass variance (about 1e-2 there).
"""
import copy
import dataclasses
import functools

import flax.linen
import flax.linen.normalization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fusionocc_tpu import config as jcfg
from fusionocc_tpu.data.synthetic import synthetic_batch as j_synthetic_batch
from fusionocc_tpu.models.fusion_occ import FusionOcc as JFusionOcc
from fusionocc_tpu.train import loop as jloop
from fusionocc_tpu_torch import config as tcfg
from fusionocc_tpu_torch.data.synthetic import synthetic_batch
from fusionocc_tpu_torch.models.fusion_occ import FusionOcc
from fusionocc_tpu_torch.nn import layers
from fusionocc_tpu_torch.train import loop
from fusionocc_tpu_torch.weights import state_dict_from_flax

from test_torch_slice import _init_fn, random_variables
from torch_threads import one_torch_thread  # noqa: E402,F401

LIDAR = dict(backend='zfold', zconv='zband')
OPTIM = dict(lr=3e-3)
NOISE = 1e-6          # relative perturbation of the images
LOSS_RTOL = 1e-4
GRAD_SPREAD, GRAD_RTOL = 3.0, 1e-4
PARAM_TOL = dict(atol=1e-6, rtol=1e-5)
STATS_TOL = dict(atol=1e-4, rtol=1e-4)
SIGN_MIN = 1e-4       # |g| above which Adam's first update is sign(g)
EMA_ATOL = 2.1e-3     # of the first step's LR: 0.001 of a sign flip's 2.1 lr
FLAX_STATS = flax.linen.normalization._compute_stats


def model_config(pkg):
    cfg = pkg.tiny_model_config(use_lidar=True)
    return dataclasses.replace(
        cfg, lidar=dataclasses.replace(cfg.lidar, **LIDAR),
        vt=dataclasses.replace(cfg.vt, depth_drop_rate=0.0))


def _snap(points):
    return np.round(np.asarray(points) * 256.0) / 256.0


def no_dropout(rate, deterministic=False):
    return lambda y: y


def two_pass_stats(*args, **kwargs):
    """flax's ``_compute_stats`` with ``use_fast_variance=False``."""
    kwargs['use_fast_variance'] = False
    return FLAX_STATS(*args, **kwargs)


def record_grads():
    """An optax transformation that passes the updates on and keeps them
    (the raw gradients when it comes first) as its state."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def jax_train_step(batch_size: int):
    """JAX's train_step on the tiny batch of ``batch_size``: (variables, new
    state, logs, raw gradients), numpy."""
    jc = jcfg.TrainConfig(model=model_config(jcfg),
                          optim=jcfg.OptimConfig(**OPTIM))
    jbatch = j_synthetic_batch(jc.model, batch_size, 0)
    jbatch = jbatch._replace(points=jnp.asarray(_snap(jbatch.points)))
    model = JFusionOcc(jc.model)
    variables = random_variables(_init_fn(model, jbatch), seed=3)
    tx = optax.chain(record_grads(), jloop.make_optimizer(jc.optim))
    params = jax.tree.map(jnp.asarray, variables['params'])
    state = jloop.TrainState(
        jnp.zeros((), jnp.int32), params,
        jax.tree.map(jnp.asarray, variables['batch_stats']),
        tx.init(params), jax.tree.map(jnp.copy, params))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, 'Dropout', no_dropout)
        mp.setattr(flax.linen.normalization, '_compute_stats',
                   two_pass_stats)
        step = jax.jit(functools.partial(jloop.train_step, model, tx, jc))
        new_state, logs = step(state, jbatch, jax.random.PRNGKey(0))
    def to_np(tree):
        return jax.tree.map(np.asarray, tree)
    return (variables, to_np(new_state), to_np(logs),
            to_np(new_state.opt_state[0]))


def port_train_step(variables, batch_size: int):
    """The port's train_step from the same weights on the batch of
    ``batch_size``: (model, state, logs, raw gradients by name, the
    gradients with the images perturbed), and the batch."""
    tc = tcfg.TrainConfig(model=model_config(tcfg),
                          optim=tcfg.OptimConfig(**OPTIM))
    model = FusionOcc(tc.model, device='cpu')
    model.load_state_dict(state_dict_from_flax(
        variables['params'], variables['batch_stats'], tc.model), strict=True)
    batch = synthetic_batch(tc.model, batch_size, 0, device='cpu')
    batch = batch._replace(points=torch.from_numpy(_snap(batch.points)))
    noise = torch.randn(batch.imgs.shape,
                        generator=torch.Generator().manual_seed(5))
    start = copy.deepcopy(model.state_dict())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(layers, 'dropout', lambda x, rate: x)
        twin = copy.deepcopy(model)
        loop.compute_loss(twin, tc, batch._replace(
            imgs=batch.imgs * (1 + NOISE * noise)), None)[0].backward()
        state = loop.create_train_state(model, tc)
        logs = loop.train_step(model, tc, state, batch)
    grads = {n: p.grad for n, p in model.named_parameters()}
    perturbed = {n: p.grad for n, p in twin.named_parameters()}
    return (model, state, logs, grads, perturbed), (tc, start, batch)


@pytest.fixture(scope='module')
def jax_step():
    return jax_train_step(1)


@pytest.fixture(scope='module')
def port_step(jax_step):
    return port_train_step(jax_step[0], 1)[0]


def by_name(tree, stats=None):
    """A flax params tree (and batch_stats) under the port's state-dict
    names, as tensors."""
    return {k: v for k, v in state_dict_from_flax(
        tree, stats or {}, model_config(tcfg)).items()
        if not k.endswith(('relative_position_index', 'num_batches_tracked'))}


def check_logs(jax_step, logs):
    jlogs = jax_step[2]
    assert set(logs) == set(jlogs)
    for key, want in jlogs.items():
        if key != 'grad_norm':      # held in check_gradients
            np.testing.assert_allclose(float(logs[key]), float(want),
                                       rtol=LOSS_RTOL, err_msg=key)


def check_gradients(jax_step, logs, grads, perturbed):
    jgrads = by_name(jax_step[3])
    assert set(grads) == set(jgrads)
    spread = loop.global_norm([perturbed[n] - g for n, g in grads.items()])
    jnorm = float(jax_step[2]['grad_norm'])
    assert abs(float(logs['grad_norm']) - jnorm) <= (
        GRAD_SPREAD * float(spread) + GRAD_RTOL * jnorm)
    for name, want in jgrads.items():
        got = grads[name]
        spread = (perturbed[name] - got).norm()
        err = (got - want).norm()
        bound = GRAD_SPREAD * spread + GRAD_RTOL * want.norm()
        assert err <= bound, (name, float(err), float(bound))
    # most tensors are far from any kink: the bound is then the 1e-4
    tight = [n for n in jgrads if (perturbed[n] - grads[n]).norm()
             <= GRAD_RTOL * jgrads[n].norm()]
    assert len(tight) >= 0.5 * len(jgrads), (len(tight), len(jgrads))


def check_updated_params(jax_step, params, grads):
    jgrads = by_name(jax_step[3])
    want = by_name(jax_step[1].params)
    lr0 = OPTIM['lr'] * tcfg.OptimConfig().warmup_start_factor
    held = total = 0
    for name, got in params.items():
        w = want[name]
        same = ((torch.sign(grads[name]) == torch.sign(jgrads[name]))
                & (jgrads[name].abs() > SIGN_MIN)
                & (grads[name].abs() > SIGN_MIN))
        held += int(same.sum())
        total += same.numel()
        close = (got - w).abs() <= PARAM_TOL['atol'] + PARAM_TOL['rtol'] * \
            w.abs()
        assert bool((close | ~same).all()), name
        assert float((got - w).abs().max()) <= 2.1 * lr0, name
    print(f'updates held to rounding at {held} of {total} entries')
    assert held >= 0.5 * total, (held, total)


def check_running_stats(jax_step, sd):
    want = by_name({}, jax_step[1].batch_stats)
    assert want
    for name, w in want.items():
        np.testing.assert_allclose(sd[name].numpy(), w.numpy(), **STATS_TOL,
                                   err_msg=name)


def check_ema(jax_step, ema):
    want = by_name(jax_step[1].ema_params)
    assert set(ema) == set(want)
    lr0 = OPTIM['lr'] * tcfg.OptimConfig().warmup_start_factor
    for name, w in want.items():
        np.testing.assert_allclose(ema[name].numpy(), w.numpy(),
                                   atol=EMA_ATOL * lr0, rtol=1e-5,
                                   err_msg=name)


def test_losses_and_logs_match_jax(jax_step, port_step):
    check_logs(jax_step, port_step[2])


def test_gradients_match_jax(jax_step, port_step):
    """Every gradient, by name.  In training mode the camera branch's
    gradients upstream of the view transformer's first BatchNorm move by
    up to a few % when the images move by 1e-6 (a ReLU fed by that
    BatchNorm sits at its kink): the port must agree with JAX to within
    3x its own change under that perturbation, plus 1e-4 of the norm."""
    _, _, logs, grads, perturbed = port_step
    check_gradients(jax_step, logs, grads, perturbed)


def test_updated_params_match_jax(jax_step, port_step):
    """Where the two gradients agree in sign and both exceed 1e-4 (the first
    update is g / (|g| + 1e-8), so a gradient difference moves it by less
    than 1e-4 there), the update agrees to rounding; elsewhere it is within
    2.1 lr."""
    model, _, _, grads, _ = port_step
    check_updated_params(jax_step, {n: p.detach() for n, p in
                                    model.named_parameters()}, grads)


def test_running_stats_match_jax(jax_step, port_step):
    """The BatchNorms' running statistics after one step (the adjacent
    frame's batch first, the key frame's last; flax's momenta, biased
    variance)."""
    check_running_stats(jax_step, port_step[0].state_dict())


def test_ema_matches_jax(jax_step, port_step):
    check_ema(jax_step, port_step[1].ema)
