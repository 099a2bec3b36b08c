"""Train-state checkpoints of the port (``engines/checkpoint.py``).

A tiny bf16 Llama trained two steps: the f32 masters, both AdamW moments,
the optimizer's settings and the step must come back exactly (bit for
bit), with and without ``like=``, and training resumed from the restored
state must take the same next step as the state that was saved (losses
equal exactly: the same arithmetic on the same values).  A file of the
layout written before format 2 (the masters, the optimizer's
``state_dict``, the step) restores the same way.
"""

import os

import numpy as np
import pytest
import torch

from music_analyst_tpu_torch.engines import train as ttrain
from music_analyst_tpu_torch.engines.checkpoint import (
    TRAIN_STATE_FILE,
    restore_train_state,
    save_train_state,
)
from music_analyst_tpu_torch.models import llama as tl

torch.set_num_threads(1)

CFG = dict(vocab_size=96, dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
           hidden_dim=64, rope_theta=1e4, max_seq_len=64)


def _batch():
    rng = np.random.default_rng(0)
    ids = torch.tensor(rng.integers(1, 96, (3, 17)).astype(np.int32))
    return ids, torch.tensor([17, 12, 5])


def _trained(steps=2):
    model = tl.LlamaModel(tl.LlamaConfig(**CFG))
    opt = ttrain.make_optimizer(1e-3, weight_decay=0.05)
    state = ttrain.init_train_state(model, opt, seed=0)
    step = ttrain.make_train_step(model, opt)
    for _ in range(steps):
        state, _ = step(state, *_batch())
    return model, opt, state, step


def _assert_same(a, b):
    assert list(a.params) == list(b.params)
    for name in a.params:
        assert torch.equal(a.params[name], b.params[name]), name
        ma, mb = a.opt_state.state[a.params[name]], b.opt_state.state[
            b.params[name]]
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(ma[key], mb[key]), (name, key)
        assert float(ma["step"]) == float(mb["step"])
    ga, gb = a.opt_state.param_groups[0], b.opt_state.param_groups[0]
    for key in ("lr", "betas", "eps", "weight_decay"):
        assert ga[key] == gb[key], key
    assert int(a.step) == int(b.step)


def test_round_trip(tmp_path):
    model, opt, state, step = _trained()
    path = save_train_state(state, str(tmp_path / "ckpt"))
    assert path == os.path.abspath(tmp_path / "ckpt")
    assert os.listdir(path) == [TRAIN_STATE_FILE]   # no staging left over
    restored = restore_train_state(path, device="cpu")
    _assert_same(state, restored)
    assert int(restored.step) == 2 and restored.step.dtype == torch.int32
    for master in restored.params.values():
        assert master.dtype == torch.float32
    # Training resumes from the restored state exactly as from the saved.
    state, want = step(state, *_batch())
    restored, got = step(restored, *_batch())
    assert float(got) == float(want)
    _assert_same(state, restored)


def test_restore_like_fills_the_given_state(tmp_path):
    _, _, saved, _ = _trained(steps=3)
    save_train_state(saved, str(tmp_path))
    model, opt, other, step = _trained(steps=1)
    params_before = other.params
    restored = restore_train_state(str(tmp_path), like=other)
    assert restored.params is params_before     # like's tensors, in place
    assert restored.opt_state is other.opt_state
    _assert_same(saved, restored)
    # The state shares no tensor with the model.
    assert restored.params["norm.weight"] is not model.norm.weight


def test_restore_like_refuses_another_model(tmp_path):
    _, _, saved, _ = _trained(steps=1)
    save_train_state(saved, str(tmp_path))
    model = tl.LlamaModel(tl.LlamaConfig(**dict(CFG, n_layers=1)))
    other = ttrain.init_train_state(model, ttrain.make_optimizer(), seed=0)
    with pytest.raises(ValueError, match="other parameters"):
        restore_train_state(str(tmp_path), like=other)


def test_save_overwrites_atomically(tmp_path):
    _, _, state, _ = _trained(steps=1)
    save_train_state(state, str(tmp_path))
    _, _, later, _ = _trained(steps=2)
    save_train_state(later, str(tmp_path))
    assert int(restore_train_state(str(tmp_path), device="cpu").step) == 2
    assert os.listdir(tmp_path) == [TRAIN_STATE_FILE]


@pytest.mark.parametrize("into", ["device", "like"])
def test_the_layout_before_format_2_restores(tmp_path, into):
    _, _, state, step = _trained()
    os.makedirs(tmp_path / "ckpt")
    torch.save({"params": state.params,
                "opt_state": state.opt_state.state_dict(),
                "step": int(state.step)}, tmp_path / "ckpt" / TRAIN_STATE_FILE)
    if into == "device":
        restored = restore_train_state(str(tmp_path / "ckpt"), device="cpu")
    else:
        restored = restore_train_state(str(tmp_path / "ckpt"),
                                       like=_trained(steps=1)[2])
    _assert_same(state, restored)
    state, want = step(state, *_batch())
    restored, got = step(restored, *_batch())
    assert float(got) == float(want)
    _assert_same(state, restored)
