"""The port's configuration against the JAX package's: every field of a port
preset equals the field of the same name in ``get_preset(name)``, for the
model, data and schedule parts.  A preset of the port's own (a backbone the
JAX package lacks) is held to the JAX preset it is built on, with the model
fields it names changed (``PORT_ONLY``)."""
import dataclasses

import pytest

from polyphonicformer_tpu.configs import get_preset as _jax_preset
from polyphonicformer_torch.configs import PRESETS, model_preset, preset

# port preset -> (the JAX preset it is built on, the model fields it changes)
PORT_ONLY = {"video_vitdetl": ("video_r50_1x", {"backbone": "vitdet_large",
                                                "compute_dtype": "bfloat16"})}


def get_preset(name):
    """The JAX package's preset ``name``, or for a preset of the port's own,
    its JAX base with the model fields of ``PORT_ONLY`` changed."""
    if name not in PORT_ONLY:
        return _jax_preset(name)
    base, model = PORT_ONLY[name]
    cfg = _jax_preset(base)
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **model))


def _assert_fields_equal(port, ref, path):
    for field in dataclasses.fields(port):
        got, want = getattr(port, field.name), getattr(ref, field.name)
        if dataclasses.is_dataclass(got):
            _assert_fields_equal(got, want, f"{path}.{field.name}")
        else:
            assert got == want, (f"{path}.{field.name}", got, want)


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_preset_matches_jax(name):
    ref = get_preset(name).model
    _assert_fields_equal(model_preset(name), ref, name)
    assert model_preset(name).num_classes == ref.num_classes
    assert model_preset(name).num_queries == ref.num_queries


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_training_fields_match_jax(name):
    """Loss weights, assigners, schedule and data normalisation."""
    ref = get_preset(name)
    port = preset(name)
    _assert_fields_equal(port.data, ref.data, f"{name}.data")
    _assert_fields_equal(port.schedule, ref.schedule, f"{name}.schedule")


def test_training_presets_are_ported():
    assert {"image_r50_2x", "debug_tiny"} <= set(PRESETS)
    cfg = preset("image_r50_2x")
    assert cfg.model.remat_backbone and not cfg.model.with_track
    assert cfg.data.img_size == (1024, 2048)


def test_parallel_config_and_shard_backbone_match_jax():
    """``ParallelConfig`` field for field, ``ExperimentConfig.parallel`` and
    ``ModelConfig.shard_backbone`` with the JAX defaults."""
    from polyphonicformer_tpu.configs import ExperimentConfig as JaxExperimentConfig
    from polyphonicformer_tpu.configs import ParallelConfig as JaxParallelConfig
    from polyphonicformer_torch.configs import ExperimentConfig, ParallelConfig

    assert [f.name for f in dataclasses.fields(ParallelConfig)] == \
        [f.name for f in dataclasses.fields(JaxParallelConfig)]
    _assert_fields_equal(ParallelConfig(), JaxParallelConfig(), "parallel")
    _assert_fields_equal(ParallelConfig(num_data=2, num_model=4),
                         JaxParallelConfig(num_data=2, num_model=4), "parallel")
    _assert_fields_equal(ExperimentConfig().parallel, JaxExperimentConfig().parallel,
                         "experiment.parallel")
    for name in PRESETS:
        _assert_fields_equal(preset(name).parallel, get_preset(name).parallel,
                             f"{name}.parallel")
        assert model_preset(name).shard_backbone is False
    assert model_preset("video_swinl", shard_backbone=True).shard_backbone
