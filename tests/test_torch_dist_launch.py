"""The port's launcher and distributed check on the CPU.

``tools/launch.py --nproc 2 --sim-cpu`` starts two gloo ranks of
``tools/dist_check.py --legs`` meeting through a FileStore in the test's
tmp_path (2 intra-op threads a rank): both exit 0 and print the same
``total_loss=``, the same eval metrics and the same serving and
tensor-parallel train lines.  A rank that fails stops the job: the
launcher returns its exit code while the other rank would sleep for
minutes.  ``init_distributed`` refuses NCCL where a rank has no card of
its own, and a card where there is none.
"""
import os
import re
import subprocess
import sys
import time

import pytest

from polyphonicformer_torch.parallel.mesh import init_distributed
from tests.torch_dist_ranks import REPO

TIMEOUT = 240


def _launch(tmp_path, *args, timeout=TIMEOUT):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    return subprocess.run(
        [sys.executable, "-m", "polyphonicformer_torch.tools.launch", "--nproc", "2",
         "--sim-cpu", "--store-file", str(tmp_path / "store"), "--", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)


def _values(out: str, tag: str) -> list:
    """What follows each ``tag`` up to the next rank tag or line end (the
    two ranks' lines can interleave on the shared pipe)."""
    return re.findall(re.escape(tag) + r"([^\[\n]*)", out)


def test_launch_dist_check_all_legs(tmp_path):
    out = _launch(tmp_path, "polyphonicformer_torch.tools.dist_check", "--legs")
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    text = out.stdout
    assert len(_values(text, "all_reduce ok: 2.0")) == 2, text
    for tag in ("total_loss=", "sharded eval stats ok: ", "data-parallel serving ok: "):
        got = _values(text, tag)
        assert len(got) == 2 and got[0] == got[1], (tag, got)
    got = [v.split(",")[0] for v in _values(text, "tensor-parallel train ok: loss=")]
    assert len(got) == 2 and got[0] == got[1], got  # the loss; the shards differ
    assert len(_values(text, "tensor-parallel swin ok: ")) == 2, text


def test_launcher_stops_the_job_when_a_rank_fails(tmp_path):
    t0 = time.perf_counter()
    out = _launch(tmp_path, "tests.torch_dist_ranks", "fail_or_hang", timeout=120)
    assert out.returncode == 3, out.stdout + out.stderr
    assert time.perf_counter() - t0 < 60


def test_nccl_refused_without_a_card_of_its_own(tmp_path, monkeypatch):
    for k, v in (("RANK", "0"), ("WORLD_SIZE", "1"), ("POLY_STORE_FILE", f"{tmp_path}/store")):
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="NCCL needs a card of its own"):
        init_distributed("cpu", "nccl")


def test_card_refused_where_there_is_none():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        init_distributed("cuda")
