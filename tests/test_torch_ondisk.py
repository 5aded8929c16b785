"""The port's evaluation path end to end against JAX's, on an on-disk tree.

The tiny nuScenes-shaped tree (``tests/test_ondisk.make_fake_raw_tree``,
``tools/create_data.py``) is read by both packages' ``NuScenesOccDataset``
(``train=False``) and stacked by their loaders; both tiny multi-modal
models (the LiDAR encoder on the z-folded path in both) carry the same
random weights, drawn with numpy and carried into the port by
``weights.state_dict_from_flax``.  Occupancy logits agree within 1e-4
(absolute and relative; the frameworks sum in another order), the port's
``predict`` takes JAX's class on at least 99.9 % of voxels, and the port's
evaluation loop (``tools/test_torch.evaluate``, two-pass with the cached
key-frame index) predicts what ``predict`` does on the same batches.
"""
import dataclasses
import os
import pickle
import sys

import jax
import numpy as np
import pytest
import torch

from fusionocc_tpu import config as jcfg
from fusionocc_tpu.data import dataset as jds
from fusionocc_tpu.models.fusion_occ import FusionOcc as JFusionOcc
from fusionocc_tpu_torch import config as tcfg
from fusionocc_tpu_torch.data import dataset as tds
from fusionocc_tpu_torch.models.fusion_occ import FusionOcc
from fusionocc_tpu_torch.weights import state_dict_from_flax

from test_torch_slice import _init_fn, random_variables
from torch_threads import one_torch_thread  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


def _zfold(mod):
    cfg = mod.tiny_model_config()
    return dataclasses.replace(cfg, lidar=dataclasses.replace(
        cfg.lidar, backend='zfold', zconv='zband'))


@pytest.fixture(scope='module')
def pair(tmp_path_factory):
    sys.path.insert(0, REPO)
    from test_ondisk import make_fake_raw_tree
    from tools.create_data import build_infos
    root = str(tmp_path_factory.mktemp('nusc_e2e'))
    make_fake_raw_tree(root)
    infos, _ = build_infos(root, 'v1.0-mini', None)
    ann = os.path.join(root, 'fusionocc-nuscenes_infos_val.pkl')
    with open(ann, 'wb') as f:
        pickle.dump({'data_list': infos}, f)
    seg = os.path.join(root, 'img_seg')
    jc, tc = _zfold(jcfg), _zfold(tcfg)
    jbatches = list(jds.data_loader(
        jds.NuScenesOccDataset(ann, jc, img_seg_dir=seg), 1, shuffle=False,
        num_workers=0))
    tbatches = list(tds.data_loader(
        tds.NuScenesOccDataset(ann, tc, img_seg_dir=seg), 1, shuffle=False,
        num_workers=0))
    jmodel = JFusionOcc(jc)
    variables = random_variables(_init_fn(jmodel, jbatches[0]), seed=5)
    apply = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))
    jlogits = [np.asarray(apply(variables, b)['occ_logits'])
               for b in jbatches]
    model = FusionOcc(tc, device='cpu')
    model.load_state_dict(state_dict_from_flax(
        variables['params'], variables['batch_stats'], tc), strict=True)
    return ann, seg, tc, model, tbatches, jbatches, jlogits


def test_loaded_batches_equal_jax(pair):
    *_, tbatches, jbatches, _ = pair
    assert len(tbatches) == len(jbatches) == 3
    for t, j in zip(tbatches, jbatches):
        for name in t._fields:
            if getattr(j, name) is None:
                assert getattr(t, name) is None
                continue
            np.testing.assert_array_equal(getattr(t, name).numpy(),
                                          np.asarray(getattr(j, name)),
                                          err_msg=name)


def test_logits_and_predict_match_jax(pair):
    *_, model, tbatches, _, jlogits = pair
    for batch, want in zip(tbatches, jlogits):
        with torch.inference_mode():
            got = model(batch)['occ_logits'].numpy()
        np.testing.assert_allclose(got, want, **LOGIT_TOL)
        agree = np.mean(model.predict(batch).numpy() == want.argmax(-1))
        assert agree >= 0.999, agree
    # the argmax is not one class everywhere
    assert len(np.unique(jlogits[0].argmax(-1))) > 1


def test_eval_loop_predicts_what_predict_does(pair):
    import tools.test_torch as tt
    ann, seg, _, model, tbatches, _, _ = pair
    seen = []
    args = tt.parse_args(['--tiny', '--device', 'cpu', '--ann-file', ann,
                          '--img-seg-dir', seg])
    res, tm = tt.evaluate(args, model=model,
                          on_batch=lambda h, s, p: seen.append(p))
    assert res['samples'] == 3 and len(tm.predict) == 3
    for pred, batch in zip(seen, tbatches):
        assert torch.equal(pred, model.predict(batch))
