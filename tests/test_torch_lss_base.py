"""The port's base view transformers (``models/lss_base.py``) against
``fusionocc_tpu.models.lss_base`` in fp32 on the CPU.

Both sides carry the same numpy-drawn weights (``random_variables``,
carried by ``weights.lss_base_rules``), see the same inputs and pool with
their own index built from the same camera geometry.  The voxel feature,
the depth softmax and the stereo cost volume agree within 1e-5 (absolute
and relative): ``LSSViewTransformer``, ``LSSViewTransformerBEVDepth``
plain and with the stereo cost volume fed to its ``DepthNet``, and
``stereo_cost_volume`` itself under a moved camera.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusionocc_tpu.config import GridConfig as JGrid
from fusionocc_tpu.geometry import frustum_to_ego as j_frustum_to_ego
from fusionocc_tpu.geometry import make_frustum as j_make_frustum
from fusionocc_tpu.models import lss_base as jl
from fusionocc_tpu.ops.bev_pool import prepare_pooling_index as j_prepare
from fusionocc_tpu_torch.config import GridConfig
from fusionocc_tpu_torch.geometry import frustum_to_ego, make_frustum
from fusionocc_tpu_torch.models import lss_base as tl
from fusionocc_tpu_torch.ops.bev_pool import prepare_pooling_index
from fusionocc_tpu_torch.weights import lss_base_rules, state_dict_from_rules

from test_torch_slice import random_variables
from torch_threads import one_torch_thread  # noqa: E402,F401

TOL = dict(rtol=1e-5, atol=1e-5)
GRID = dict(x=(-4, 4, 1.0), y=(-4, 4, 1.0), z=(-1, 3, 1.0),
            depth=(1.0, 5.0, 1.0))
B, N, H_IMG, W_IMG, DS = 1, 2, 16, 32, 4
CIN, COUT = 12, 8


def _geometry(seed=0):
    """Camera geometry with small random rotations and offsets."""
    rng = np.random.RandomState(seed)
    intr = np.tile(np.array([[20.0, 0, 16], [0, 20.0, 8], [0, 0, 1]],
                            np.float32), (B, N, 1, 1))
    s2e = np.tile(np.eye(4, dtype=np.float32), (B, N, 1, 1))
    for n in range(N):
        a = rng.uniform(-0.3, 0.3)
        s2e[0, n, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                             [-np.sin(a), 0, np.cos(a)]]
        s2e[0, n, :3, 3] = rng.uniform(-0.5, 0.5, 3)
    pr = np.tile(np.eye(3, dtype=np.float32), (B, N, 1, 1))
    pt = rng.uniform(-1, 1, (B, N, 3)).astype(np.float32)
    bda = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
    return s2e, intr, pr, pt, bda


def _indices():
    geo = _geometry()
    jgrid, tgrid = JGrid(**GRID), GridConfig(**GRID)
    jcoor = j_frustum_to_ego(j_make_frustum(jgrid.depth, (H_IMG, W_IMG), DS),
                             *map(jnp.asarray, geo))
    tcoor = frustum_to_ego(make_frustum(tgrid.depth, (H_IMG, W_IMG), DS,
                                        device='cpu'),
                           *map(torch.from_numpy, geo))
    return (jgrid, j_prepare(jcoor, jgrid)), (tgrid,
                                              prepare_pooling_index(tcoor,
                                                                    tgrid))


def _load(module, variables, rules):
    module.load_state_dict(state_dict_from_rules(
        variables['params'], variables.get('batch_stats', {}), rules),
        strict=True)
    return module.eval()


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    h, w = H_IMG // DS, W_IMG // DS
    x = rng.randn(B, N, h, w, CIN).astype(np.float32)
    mlp = rng.randn(B, N, 27).astype(np.float32)
    return x, mlp


def test_lss_view_transformer_matches_jax():
    (jgrid, jidx), (tgrid, tidx) = _indices()
    x, _ = _inputs()
    jmod = jl.LSSViewTransformer(jgrid, out_channels=COUT)
    v = random_variables(lambda: jmod.init(jax.random.PRNGKey(0), x, jidx),
                         seed=1)
    jvox, jdepth = jax.jit(lambda v, x: jmod.apply(v, x, jidx))(v, x)
    tmod = _load(tl.LSSViewTransformer(tgrid, CIN, COUT), v,
                 lss_base_rules('lss'))
    with torch.inference_mode():
        tvox, tdepth = tmod(torch.from_numpy(x), tidx)
    assert tuple(tvox.shape) == jvox.shape == (B, 4, 8, 8, COUT)
    assert np.abs(np.asarray(jvox)).max() > 0
    np.testing.assert_allclose(tvox.numpy(), np.asarray(jvox), **TOL)
    np.testing.assert_allclose(tdepth.numpy(), np.asarray(jdepth), **TOL)


def _cost_volume_inputs(seed=2):
    """Stage-0 features of two frames and a moved camera: (prev, curr,
    frustum at the cost-volume resolution, k2s, intrins, post_rots,
    post_trans), numpy."""
    rng = np.random.RandomState(seed)
    hs, ws, C = H_IMG, W_IMG, 8
    prev = rng.randn(B * N, hs, ws, C).astype(np.float32)
    curr = (prev + 0.3 * rng.randn(*prev.shape)).astype(np.float32)
    s2e, _, pr, pt, _ = _geometry(seed)
    intr = np.tile(np.array([[30.0, 0, 64], [0, 30.0, 32], [0, 0, 1]],
                            np.float32), (B, N, 1, 1))
    k2s = s2e.copy()
    k2s[..., :3, 3] = rng.uniform(-0.2, 0.2, (B, N, 3))
    return prev, curr, k2s, intr, pr, pt


def test_stereo_cost_volume_matches_jax():
    prev, curr, k2s, intr, pr, pt = _cost_volume_inputs()
    depth = GRID['depth']
    want = jl.stereo_cost_volume(
        jnp.asarray(prev), jnp.asarray(curr),
        j_make_frustum(depth, (H_IMG * 4, W_IMG * 4), 4),
        *map(jnp.asarray, (k2s, intr, pr, pt)))
    got = tl.stereo_cost_volume(
        torch.from_numpy(prev), torch.from_numpy(curr),
        make_frustum(depth, (H_IMG * 4, W_IMG * 4), 4, device='cpu'),
        *map(torch.from_numpy, (k2s, intr, pr, pt)))
    assert tuple(got.shape) == want.shape == (B * N, H_IMG, W_IMG, 4)
    want = np.asarray(want)
    assert want.std(axis=-1).max() > 1e-2        # not uniform: the warp moved
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize('stereo', [False, True])
def test_bevdepth_view_transformer_matches_jax(stereo):
    (jgrid, jidx), (tgrid, tidx) = _indices()
    x, mlp = _inputs()
    cv = None
    if stereo:
        prev, curr, k2s, intr, pr, pt = _cost_volume_inputs()
        cv = np.array(jl.stereo_cost_volume(
            jnp.asarray(prev), jnp.asarray(curr),
            j_make_frustum(GRID['depth'], (H_IMG * 4, W_IMG * 4), 4),
            *map(jnp.asarray, (k2s, intr, pr, pt))))
    jmod = jl.LSSViewTransformerBEVDepth(jgrid, out_channels=COUT,
                                         mid_channels=8, aspp_mid_channels=4,
                                         stereo=stereo)
    v = random_variables(lambda: jmod.init(jax.random.PRNGKey(0), x, mlp,
                                           jidx, cost_volume=cv), seed=4)
    jvox, jdepth = jax.jit(lambda v, x, m, c: jmod.apply(
        v, x, m, jidx, cost_volume=c))(v, x, mlp, cv)
    tmod = _load(tl.LSSViewTransformerBEVDepth(tgrid, CIN, COUT, 8, 4,
                                               stereo=stereo), v,
                 lss_base_rules('bevdepth', stereo))
    with torch.inference_mode():
        tvox, tdepth = tmod(torch.from_numpy(x), torch.from_numpy(mlp), tidx,
                            None if cv is None else torch.from_numpy(cv))
    assert tuple(tvox.shape) == jvox.shape == (B, 4, 8, 8, COUT)
    np.testing.assert_allclose(tvox.numpy(), np.asarray(jvox), **TOL)
    np.testing.assert_allclose(tdepth.numpy(), np.asarray(jdepth), **TOL)
    if stereo:      # the cost volume reaches the depth
        with torch.inference_mode():
            _, plain = tmod(torch.from_numpy(x), torch.from_numpy(mlp), tidx)
        assert (plain - tdepth).abs().max() > 1e-3
