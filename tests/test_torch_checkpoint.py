"""Checkpoints of the port's training (``polyphonicformer_torch/train/
checkpoint.py``, ``train/optim.py::Optimizer.state_dict``) on the CPU.

Tolerance: none.  A restored state equals the saved one bit for bit (the
model's ``state_dict``, AdamW's moments and step counts, ``LambdaLR``'s
position and learning rates, the step); the newest ``max_keep`` checkpoints
are kept by step number; a temporary file left by a killed save is never
picked up; and 2 steps, a save, a restore into a differently initialised
model and 1 more step give the parameters, optimizer state and learning
rate of 3 uninterrupted steps, bit for bit (``debug_tiny``, 64x128,
``synthetic_batch`` batches).
"""
import dataclasses
import os

import pytest
import torch

from polyphonicformer_torch.configs import preset
from polyphonicformer_torch.data.synthetic import synthetic_batch
from polyphonicformer_torch.models import PolyphonicFormer
from polyphonicformer_torch.train.checkpoint import (latest_step, make_manager, restore_state,
                                                     save_state)
from polyphonicformer_torch.train.optim import Optimizer
from polyphonicformer_torch.train.step import TrainState, create_train_state, make_train_step

HW = (64, 128)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs test files on parallel workers,
    where a CPU torch step with a thread per core slows several-fold."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg():
    cfg = preset("debug_tiny")
    # a warmup that is still running at step 3, so the schedule's position matters
    return dataclasses.replace(cfg, schedule=dataclasses.replace(cfg.schedule, lr=5e-4,
                                                                 warmup_iters=5))


def _state(cfg, seed):
    with torch.device("meta"):
        model = PolyphonicFormer(cfg.model)
    return create_train_state(model, cfg, torch.Generator().manual_seed(seed),
                              steps_per_epoch=4, device="cpu")


def _batches(cfg, n):
    return [synthetic_batch(cfg.model, 1, HW, seed=s, device="cpu") for s in range(n)]


def _run(cfg, state, opt, batches):
    step = make_train_step(state.model, cfg, opt)
    for b in batches:
        state, _ = step(state, b)
    return state


def _assert_same(a_state, a_opt, b_state, b_opt):
    assert int(a_state.step) == int(b_state.step)
    sa, sb = a_state.model.state_dict(), b_state.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a_opt.state_dict(), b_opt.state_dict()
    assert oa["scheduler"]["last_epoch"] == ob["scheduler"]["last_epoch"]
    assert a_opt.scheduler.get_last_lr() == b_opt.scheduler.get_last_lr()
    assert [g["lr"] for g in a_opt.adamw.param_groups] == \
        [g["lr"] for g in b_opt.adamw.param_groups]
    for pa, pb in zip(a_opt.params, b_opt.params):
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(a_opt.adamw.state[pa][key], b_opt.adamw.state[pb][key]), key


@pytest.fixture(scope="module")
def trained():
    cfg = _cfg()
    batches = _batches(cfg, 3)
    state, opt = _state(cfg, 0)
    state = _run(cfg, state, opt, batches)
    return cfg, batches, state, opt


def test_round_trip(tmp_path, trained):
    cfg, _, state, opt = trained
    mgr = make_manager(str(tmp_path), 2)
    save_state(mgr, int(state.step), state, opt)
    other, other_opt = _state(cfg, 1)
    restored = restore_state(mgr, other, other_opt)
    _assert_same(state, opt, restored, other_opt)


def test_resume_equals_uninterrupted(tmp_path, trained):
    cfg, batches, state3, opt3 = trained
    state, opt = _state(cfg, 0)
    state = _run(cfg, state, opt, batches[:2])
    mgr = make_manager(str(tmp_path), 2)
    save_state(mgr, 2, state, opt)
    fresh, fresh_opt = _state(cfg, 9)
    fresh = restore_state(mgr, fresh, fresh_opt)
    assert int(fresh.step) == 2
    fresh = _run(cfg, fresh, fresh_opt, batches[2:])
    _assert_same(state3, opt3, fresh, fresh_opt)


def test_keep_last_and_temporary_files(tmp_path):
    """File handling alone, on a one-layer model (a real one's checkpoint
    is ~450 MB)."""
    cfg = _cfg()
    state = TrainState(step=torch.zeros((), dtype=torch.int64), model=torch.nn.Linear(4, 2))
    opt = Optimizer(state.model, cfg.schedule)
    mgr = make_manager(str(tmp_path), 2)
    assert latest_step(mgr) is None
    with pytest.raises(FileNotFoundError):
        restore_state(mgr, state, opt)
    for step in (3, 10, 7):
        save_state(mgr, step, state, opt)
    assert mgr.steps() == [7, 10]  # by step number, not by the order of the saves
    assert sorted(os.listdir(mgr.path)) == ["10.pt", "7.pt"]
    # a save killed before its rename leaves a temporary file behind
    with open(os.path.join(mgr.path, ".12.pt.999.tmp"), "wb") as f:
        f.write(b"partial")
    assert latest_step(mgr) == 10
    restored = restore_state(mgr, state, opt)
    assert int(restored.step) == 10
