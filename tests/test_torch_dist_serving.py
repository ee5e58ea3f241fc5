"""The port's mesh-sharded multi-clip serving on 2 gloo ranks, a clip a
rank, against the JAX package's ``batched_video_step`` on both clips, on
the CPU (the JAX side of ``tests/test_sharded_serving.py``).

``debug_tiny_video`` widths with ``max_per_img=100``, f32, 64x128, 2
frames of the 2 clips of ``tests/test_torch_batched.py`` (colour blocks
and noise, the last ``fc_cls`` bias 0 so things are kept and tracked), the
clips at different frame ids.  Each rank serves its clip with the
broadcast weights and its own tracker state; ``gather_frame_outputs``
brings both clips' maps to each rank in clip order.  Asserted: on every
rank the gathered semantic, panoptic and track maps and each clip's
tracker ids equal JAX's, the depth within test_torch_batched.py's rtol
1e-4, atol 2e-3 of JAX's (the two frameworks' f32 depth differ by up to
2.2e-5 relative on a pixel of these clips, beyond the rtol 2e-5 of
test_sharded_serving.py); every output and tracker field of a clip
bit-equal to the port's one-process ``batched_video_step`` on that clip
alone; both ranks gather the same outputs.
"""
import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from polyphonicformer_tpu.configs import get_preset
from polyphonicformer_tpu.infer import pipeline as jpipe
from polyphonicformer_tpu.models import PolyphonicFormer as JaxModel
from polyphonicformer_torch.configs import model_preset
from polyphonicformer_torch.infer import pipeline
from polyphonicformer_torch.models import build_model
from polyphonicformer_torch.weights import to_jax_variables, to_numpy_state_dict
from tests.test_torch_batched import _clips
from tests.torch_dist_ranks import H, W, start_ranks

TIMEOUT = 200
FRAME_IDS = [[1, 10], [2, 11]]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    torch.set_num_threads(2)
    tmp = tmp_path_factory.mktemp("serving")
    pcfg = model_preset("debug_tiny_video", max_per_img=100)
    port = build_model(pcfg, "cpu", generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        port.roi_head.mask_head[-1].fc_cls.bias.zero_()
    torch.save(port.state_dict(), tmp / "weights.pt")
    clips = _clips()
    torch.save(torch.from_numpy(clips), tmp / "clips.pt")
    ranks = start_ranks(tmp, "serving", 2, TIMEOUT, state_dict=str(tmp / "weights.pt"),
                        clips=str(tmp / "clips.pt"), frame_ids=FRAME_IDS)
    cfg = dataclasses.replace(get_preset("debug_tiny_video").model, max_per_img=100)
    variables = to_jax_variables(to_numpy_state_dict(port), pcfg)
    step = jpipe.make_batched_video_step(JaxModel(cfg), cfg, (H, W))
    states = jpipe.init_batched_tracker_states(cfg, 2)
    jax_frames = []
    for imgs, fids in zip(clips, FRAME_IDS):
        out, states = step(variables, jnp.asarray(imgs), states,
                           jnp.asarray(np.array(fids, np.int32)))
        jax_frames.append({"out": out, "ids": np.asarray(states.ids)})
    pstep = pipeline.make_batched_video_step(port, pcfg, (H, W))
    alone = []  # each clip by itself through the one-process step
    for b in range(2):
        pstates, frames = pipeline.init_batched_tracker_states(pcfg, 1, "cpu"), []
        for imgs, fids in zip(clips, FRAME_IDS):
            out, pstates = pstep(torch.from_numpy(imgs[b:b + 1]), pstates,
                                 torch.tensor(fids[b:b + 1], dtype=torch.int32))
            frames.append((out, pstates))
        alone.append(frames)
    return ranks.wait(), jax_frames, alone


def test_sharded_serving_matches_jax(runs):
    ranks, jax_frames, _ = runs
    tracked = 0
    for t, f in enumerate(jax_frames):
        for r, rank in enumerate(ranks):
            maps = rank[t]["maps"]
            for name in ("semantic", "panoptic", "track_map", "track_overflow"):
                np.testing.assert_array_equal(maps[name], np.asarray(getattr(f["out"], name)),
                                              err_msg=f"frame {t} rank {r} {name}")
            np.testing.assert_allclose(maps["depth"], np.asarray(f["out"].depth), rtol=1e-4,
                                       atol=2e-3, err_msg=f"frame {t} rank {r}")
        ids = np.concatenate([rank[t]["state"]["ids"] for rank in ranks])
        np.testing.assert_array_equal(ids, f["ids"], err_msg=f"frame {t} tracker ids")
        tracked += int((ranks[0][t]["maps"]["track_map"] > 0).reshape(2, -1).any(1).sum())
    assert tracked == 4, "each clip must keep and track a thing in every frame"


def test_sharded_serving_bit_equal_to_each_clip_alone(runs):
    ranks, _, alone = runs
    for b, frames in enumerate(alone):
        for t, (out, state) in enumerate(frames):
            for name in ("semantic", "panoptic", "track_map", "track_overflow", "depth"):
                for r, rank in enumerate(ranks):
                    np.testing.assert_array_equal(rank[t]["maps"][name][b],
                                                  getattr(out, name)[0].numpy(),
                                                  err_msg=f"clip {b} frame {t} rank {r} {name}")
            for name, v in ranks[b][t]["state"].items():
                np.testing.assert_array_equal(v, getattr(state, name).numpy(), err_msg=name)


def test_ranks_gather_the_same_outputs(runs):
    ranks = runs[0]
    for t in range(len(FRAME_IDS)):
        for name, v in ranks[0][t]["maps"].items():
            np.testing.assert_array_equal(ranks[1][t]["maps"][name], v, err_msg=name)
