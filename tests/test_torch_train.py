"""The port's training engine ≡ JAX's ``engines/train.py``, piece by piece.

A two-layer f32 Llama (vocab 96, dim 32, GQA 4/2), its JAX parameters
carried over by ``params_from_jax``.  Tolerances, each tested on its own:

- loss and gradient against ``jax.value_and_grad``: rtol 1e-5 on the loss,
  and on every gradient leaf ``atol 1e-5 · max|g|`` of that leaf (f32 on
  both sides, sums in another order), unpacked and packed;
- one AdamW update against ``optax.adamw`` on identical parameters and
  gradients: atol 1e-7 (one f32 update of O(lr) = 1e-2) plus rtol 1.2e-7,
  one f32 ulp of the parameter, since each side rounds its own final
  subtraction;
- the loss over three steps against JAX's: rtol 1e-3.  Parameters are not
  compared after a step: Adam's first step is about lr·sign(g), and the
  sign of a gradient that is numerically zero differs between frameworks;
  such a parameter moves the loss by only lr·|g|.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from music_analyst_tpu.engines import train as jtrain
from music_analyst_tpu.models import llama as jl
from music_analyst_tpu_torch.engines import train as ttrain
from music_analyst_tpu_torch.models import llama as tl
from music_analyst_tpu_torch.telemetry import configure, get_telemetry

torch.set_num_threads(1)

CFG = dict(vocab_size=96, dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
           hidden_dim=64, rope_theta=1e4, max_seq_len=64, dtype="float32")
B, S = 4, 25   # token rows of S tokens: S - 1 inputs, S - 1 targets


def _batch(seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, CFG["vocab_size"], (B, S)).astype(np.int32)
    lengths = np.array([S, 18, 9, S], np.int32)
    return ids, lengths


def _packed(seed):
    """Rows of two or three documents, then padding (segment 0)."""
    ids, _ = _batch(seed)
    seg = np.zeros((B, S), np.int32)
    seg[0, :10], seg[0, 10:] = 1, 2
    seg[1, :4], seg[1, 4:15], seg[1, 15:22] = 1, 2, 3
    seg[2, :S] = 1
    seg[3, :12], seg[3, 12:20] = 1, 2
    lengths = (seg > 0).sum(axis=1).astype(np.int32)
    return ids, lengths, seg


def _jax_model(**over):
    return jl.LlamaModel(jl.LlamaConfig(**dict(CFG, **over)))


def _jax_params(seed=0):
    ids = jnp.zeros((1, S - 1), jnp.int32)
    return _jax_model().init(jax.random.key(seed), ids, ids,
                             jnp.ones((1, 1, S - 1, S - 1), bool))["params"]


def _port_model(params, **over):
    model = tl.LlamaModel(tl.LlamaConfig(**dict(CFG, **over)))
    sd = tl.params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    model.load_state_dict({k: torch.tensor(np.asarray(v))
                           for k, v in sd.items()})
    return model


@pytest.mark.parametrize("packed", [False, True])
def test_loss_and_gradients_match_jax(packed):
    params = _jax_params()
    if packed:
        ids, lengths, seg = _packed(1)
    else:
        (ids, lengths), seg = _batch(1), None
    jmodel = _jax_model()
    jseg = None if seg is None else jnp.asarray(seg)
    want, jgrads = jax.value_and_grad(
        lambda p: jtrain.causal_lm_loss(jmodel, p, jnp.asarray(ids),
                                        jnp.asarray(lengths),
                                        segment_ids=jseg))(params)
    model = _port_model(params)
    loss = ttrain.causal_lm_loss(
        model, torch.tensor(ids), torch.tensor(lengths),
        segment_ids=None if seg is None else torch.tensor(seg))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    want_grads = tl.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jgrads))
    got_grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert set(got_grads) == set(want_grads)
    for name, g in got_grads.items():
        w = np.asarray(want_grads[name])
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-5 * float(np.abs(w).max()) + 1e-9,
                                   err_msg=name)


def test_packed_row_loss_equals_the_per_document_rows():
    """Token-weighted: one mean over the union of valid targets."""
    model = _port_model(_jax_params())
    ids, _, seg = _packed(2)
    row, row_seg = ids[1:2], seg[1:2]
    with torch.no_grad():
        packed = ttrain.causal_lm_loss(
            model, torch.tensor(row), torch.tensor([22]),
            segment_ids=torch.tensor(row_seg))
        total, count = 0.0, 0
        for doc in (1, 2, 3):
            tokens = row[0][row_seg[0] == doc]
            single = np.zeros((1, S), np.int32)
            single[0, :len(tokens)] = tokens
            loss = ttrain.causal_lm_loss(model, torch.tensor(single),
                                         torch.tensor([len(tokens)]))
            total += float(loss) * (len(tokens) - 1)
            count += len(tokens) - 1
    np.testing.assert_allclose(float(packed), total / count, rtol=1e-5)


def test_flash_loss_matches_dense_and_jax():
    """The loss forward through the flash path (the kernel's plain version
    here; JAX's Pallas kernel in interpret mode), unpacked and packed."""
    params = _jax_params()
    flash = _port_model(params, attn_impl="flash")
    dense = _port_model(params)
    for ids, lengths, seg in (_batch(3) + (None,), _packed(3)):
        t_seg = None if seg is None else torch.tensor(seg)
        with torch.no_grad():
            got = ttrain.causal_lm_loss(flash, torch.tensor(ids),
                                        torch.tensor(lengths), t_seg)
            ref = ttrain.causal_lm_loss(dense, torch.tensor(ids),
                                        torch.tensor(lengths), t_seg)
        want = jtrain.causal_lm_loss(
            _jax_model(attn_impl="flash"), params, jnp.asarray(ids),
            jnp.asarray(lengths),
            segment_ids=None if seg is None else jnp.asarray(seg))
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_one_adamw_update_matches_optax():
    rng = np.random.default_rng(4)
    params = {"w": rng.standard_normal((6, 5)).astype(np.float32),
              "norm": np.ones(5, np.float32),
              "emb": rng.standard_normal((7, 5)).astype(np.float32)}
    grads = {k: rng.standard_normal(v.shape).astype(np.float32) * 1e-2
             for k, v in params.items()}
    opt = optax.adamw(1e-2, weight_decay=0.1)
    state = opt.init(params)
    updates, _ = opt.update(grads, state, params)
    want = optax.apply_updates(params, updates)
    cfg = ttrain.make_optimizer(1e-2, weight_decay=0.1)
    assert (cfg.b1, cfg.b2, cfg.eps) == (0.9, 0.999, 1e-8)
    tensors = {k: torch.tensor(v) for k, v in params.items()}
    torch_opt = cfg.init(tensors.values())
    assert len(torch_opt.param_groups) == 1
    for k, t in tensors.items():
        t.grad = torch.tensor(grads[k])
    torch_opt.step()
    for k in params:
        np.testing.assert_allclose(tensors[k].numpy(), np.asarray(want[k]),
                                   rtol=1.2e-7, atol=1e-7, err_msg=k)
        m = torch_opt.state[tensors[k]]
        assert m["exp_avg"].dtype == m["exp_avg_sq"].dtype == torch.float32


@pytest.mark.parametrize("packed", [False, True])
def test_loss_trajectory_matches_jax(packed):
    ids, lengths, seg = _packed(5) if packed else _batch(5) + (None,)
    jmodel = _jax_model()
    jopt = jtrain.make_optimizer(1e-2)
    jstate = jtrain.init_train_state(jmodel, jopt,
                                     (jnp.asarray(ids), jnp.asarray(lengths)),
                                     seed=3)
    model = _port_model(jstate.params)
    jstep = jtrain.make_train_step(jmodel, jopt)
    topt = ttrain.make_optimizer(1e-2)
    tstate = ttrain.init_train_state(model, topt, seed=None)
    tstep = ttrain.make_train_step(model, topt)
    jseg = None if seg is None else jnp.asarray(seg)
    tseg = None if seg is None else torch.tensor(seg)
    want, got = [], []
    for _ in range(3):
        jstate, jloss = jstep(jstate, jnp.asarray(ids), jnp.asarray(lengths),
                              jseg)
        tstate, tloss = tstep(tstate, torch.tensor(ids),
                              torch.tensor(lengths), tseg)
        want.append(float(jloss))
        got.append(float(tloss))
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert int(tstate.step) == int(jstate.step) == 3


def test_bf16_model_keeps_f32_masters_and_moments():
    model = tl.LlamaModel(tl.LlamaConfig(**dict(CFG, dtype="bfloat16")))
    opt = ttrain.make_optimizer(1e-4)
    state = ttrain.init_train_state(model, opt, seed=0)
    step = ttrain.make_train_step(model, opt)
    ids, lengths = _batch(6)
    name = "layers.0.feed_forward.gate_proj.weight"
    start = state.params[name].clone()
    state, _ = step(state, torch.tensor(ids), torch.tensor(lengths))
    weights = dict(model.named_parameters())
    assert weights[name].dtype == torch.bfloat16
    for key, master in state.params.items():
        assert master.dtype == torch.float32, key
        moments = state.opt_state.state[master]
        assert moments["exp_avg"].dtype == torch.float32, key
        assert moments["exp_avg_sq"].dtype == torch.float32, key
    # The f32 master took an update smaller than a bf16 ulp in places,
    # which a bf16 weight stepped in place would have lost.
    delta = (state.params[name] - start).abs()
    ulp = start.abs() * 2.0 ** -8
    assert bool(((delta > 0) & (delta < ulp / 2)).any())
    # The next step runs on the masters rounded to bf16.
    ttrain.load_params_(model, state.params)
    assert torch.equal(weights[name].detach(),
                       state.params[name].to(torch.bfloat16))
    assert torch.equal(weights["norm.weight"].detach(),
                       state.params["norm.weight"])


def test_step_loss_falls_and_is_recorded():
    configure(enabled=True)
    model = tl.LlamaModel(tl.LlamaConfig(**CFG))
    opt = ttrain.make_optimizer(1e-2)
    state = ttrain.init_train_state(model, opt, seed=0)
    step = ttrain.make_train_step(model, opt)
    ids, lengths = _batch(7)
    losses = []
    for _ in range(5):
        state, loss = step(state, torch.tensor(ids), torch.tensor(lengths))
        assert loss.dim() == 0 and not loss.requires_grad
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert int(state.step) == 5
    tel = get_telemetry()
    assert tel.counters["train_steps"] == 5
    assert tel.span_aggregates["train_step"][0] == 5


def test_step_phases_wrap_the_step_it_takes():
    """A ``phase`` hook is entered around the step's four phases in order,
    and the step it wraps is the plain one: equal losses, bit for bit,
    and equal masters after two steps."""
    ids, lengths = (torch.tensor(a) for a in _batch(7))
    entered = []

    @contextlib.contextmanager
    def phase(name):
        entered.append(name)
        yield

    runs = []
    for hook in (None, phase):
        model = tl.LlamaModel(tl.LlamaConfig(**CFG))
        opt = ttrain.make_optimizer(1e-2)
        state = ttrain.init_train_state(model, opt, seed=0)
        step = ttrain.make_train_step(model, opt, phase=hook)
        losses = []
        for _ in range(2):
            state, loss = step(state, ids, lengths)
            losses.append(float(loss))
        runs.append((losses, state.params))
    assert entered == ["load_masters", "forward", "backward",
                       "optimizer"] * 2
    assert runs[0][0] == runs[1][0]
    for name, master in runs[0][1].items():
        assert torch.equal(master, runs[1][1][name]), name


def test_prefetch_batches_narrow_and_count_bytes():
    configure(enabled=True)
    ids, lengths, seg = _packed(8)
    out = list(ttrain.prefetch_batches(
        [(ids, lengths), (ids, lengths, seg), (ids, lengths, None)],
        device="cpu", depth=2))
    assert len(out[0]) == 2 and len(out[1]) == 3 and out[2][2] is None
    t_ids, t_len, t_seg = out[1]
    assert t_len.dtype == t_seg.dtype == torch.int16
    assert t_ids.dtype == torch.int32
    np.testing.assert_array_equal(t_seg.numpy(), seg)
    np.testing.assert_array_equal(t_len.numpy(), lengths)
    per = ids.nbytes + 2 * lengths.size
    tel = get_telemetry()
    assert tel.counters["train_pipeline.h2d_bytes"] == (
        3 * per + 2 * seg.size)
    assert tel.counters["train_pipeline.h2d_bytes_saved"] > 0
    # The narrowed batch trains like the int32 one.
    model = _port_model(_jax_params())
    with torch.no_grad():
        a = ttrain.causal_lm_loss(model, t_ids, t_len, t_seg)
        b = ttrain.causal_lm_loss(model, torch.tensor(ids),
                                  torch.tensor(lengths), torch.tensor(seg))
    assert float(a) == float(b)


def test_refusals():
    """What stays refused: a differentiated flash kernel and a mesh with
    an ``sp`` axis (step, state, batches), a MoE model's too (ZeRO-1 as
    well); ``ep`` and MoE on a mesh train since ``tests/
    test_torch_moe_mesh.py``'s slice."""
    from music_analyst_tpu_torch.parallel.mesh import DeviceMesh

    def mesh(*axes):
        return DeviceMesh((torch.device("cpu"),) * 4, axes, 0)

    model = tl.LlamaModel(tl.LlamaConfig(**dict(CFG, attn_impl="flash")))
    opt = ttrain.make_optimizer()
    with pytest.raises(NotImplementedError, match="JAX cannot differentiate"):
        ttrain.make_train_step(model, opt)
    dense = tl.LlamaModel(tl.LlamaConfig(**CFG))
    with pytest.raises(NotImplementedError, match="'sp' axis is not yet ported"):
        ttrain.make_train_step(dense, opt, mesh=mesh(("dp", 2), ("sp", 2)))
    with pytest.raises(NotImplementedError, match="'sp' axis is not yet ported"):
        ttrain.init_train_state(dense, opt, mesh=mesh(("ep", 2), ("sp", 2)))
    moe = tl.LlamaModel(tl.LlamaConfig(**dict(CFG, n_experts=4)))
    with pytest.raises(NotImplementedError, match="'sp' axis is not yet ported"):
        ttrain.init_train_state(moe, opt, mesh=mesh(("ep", 2), ("sp", 2)),
                                zero1=True)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        next(iter(ttrain.prefetch_batches(
            [], mesh=mesh(("sp", 2), ("tp", 2)), device="cpu")))
    assert dataclasses.is_dataclass(ttrain.TrainState)
