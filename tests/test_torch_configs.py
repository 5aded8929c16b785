"""The port's named presets against the JAX package's.

Every name of JAX's ``CONFIGS`` builds, in the port, a ``TrainConfig`` with
the same field values; the 25 reference config files of ``PARITY.md`` each
have their preset, and the port adds only the presets of its other
architectures (``ARCHITECTURES``, which JAX does not have); ``get_config``'s overrides split between the model, the
optimizer and the run as JAX's do; every preset but the tiny one (whose
LiDAR backend is the COO path) passes ``check_train_supported``.
"""
import dataclasses

import pytest

from fusionocc_tpu import configs as jconfigs
from fusionocc_tpu_torch import config as tcfg
from fusionocc_tpu_torch import configs as tconfigs

from test_configs import REFERENCE_FILE_TO_PRESET
from torch_threads import one_torch_thread  # noqa: E402,F401


@pytest.mark.parametrize('name', sorted(jconfigs.CONFIGS))
def test_preset_matches_jax(name):
    got, want = tconfigs.get_config(name), jconfigs.get_config(name)
    assert isinstance(got, tcfg.TrainConfig)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if got.model.lidar.backend == 'zfold':
        tcfg.check_train_supported(got)


def test_every_reference_config_file_has_a_preset():
    # the port's presets are JAX's and those of its other architectures
    assert sorted(tconfigs.CONFIGS) == sorted(
        list(jconfigs.CONFIGS) + list(tconfigs.ARCHITECTURES))
    assert len(REFERENCE_FILE_TO_PRESET) == 25
    for fname, preset in REFERENCE_FILE_TO_PRESET.items():
        assert preset in tconfigs.CONFIGS, f'{fname} -> {preset} missing'
        assert (dataclasses.asdict(tconfigs.get_config(preset))
                == dataclasses.asdict(jconfigs.get_config(preset))), fname


def test_overrides_split_as_jax():
    kw = dict(lr=1e-4, num_adj=1, batch_size=2, mask_mode='condition_D',
              accumulate_steps=4, seed=7)
    got = tconfigs.get_config('fusion_occ_unified', **kw)
    assert (dataclasses.asdict(got)
            == dataclasses.asdict(jconfigs.get_config('fusion_occ_unified',
                                                      **kw)))
    assert (got.optim.lr, got.batch_size, got.model.mask_mode) == (
        1e-4, 2, 'condition_D')
    with pytest.raises(KeyError):
        tconfigs.get_config('nope')
