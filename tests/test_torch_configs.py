"""The port's configuration against the JAX package's: every field of a port
preset equals the field of the same name in ``get_preset(name).model``."""
import dataclasses

import pytest

from polyphonicformer_tpu.configs import get_preset
from polyphonicformer_torch.configs import PRESETS, model_preset


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

