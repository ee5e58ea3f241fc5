"""The seeded draw (``benchmark/weights.py``) byte for byte: at the
``debug_tiny_video`` widths and seed 0, the state dict of each backbone the
cells use hashes to the digest taken before the backbones moved into files
of their own (``reference/backbones/``), over every key, shape, dtype and
the tensor's bytes in key order."""
import hashlib

import pytest

from benchmark import weights
from benchmark.reference import config as ref_config

from .tiny import _config

DIGESTS = {
    "resnet50": (590, "705a99870c84e9b40965fa7066379c2811caf52770a6ec2e8c4914a3b4a959c8"),
    "swin_tiny": (502, "722bb5be7a79ed43d7566297a3b91e5eee08988f62d38ccc138eae0a1d469efc"),
    "swin_large": (658, "47b1519d0bc570c4c41ceedd300c69652e2b9d6ee494986045ce817fc362d58f"),
}


@pytest.mark.parametrize("backbone", sorted(DIGESTS))
def test_seeded_draw_is_unchanged(tmp_path, backbone):
    exp = ref_config.load(_config("video_r50_1x", backbone, tmp_path / "cfg.json"))
    sd = weights.state_dict(exp, 0, "cpu")
    h = hashlib.sha256()
    for k, v in sd.items():
        h.update(f"{k} {tuple(v.shape)} {v.dtype}\n".encode())
        h.update(v.contiguous().numpy().tobytes())
    assert (len(sd), h.hexdigest()) == DIGESTS[backbone]
    if backbone.startswith("swin"):
        table = next(v for k, v in sd.items() if k.endswith("relative_position_bias_table"))
        assert float(table.std()) == pytest.approx(0.02, rel=0.1)
