"""Port MoE feed-forward ≡ the JAX ``MoESwiGLU``, with weights carried over.

Tiny sizes (E = 4 experts, hidden 16, dim 8, top-2), f32.  Tolerances:
port against JAX within 1e-5 (f32 einsums, sums in another order); sparse
at lossless capacity against dense within 1e-5 (the same products,
gathered instead of combined); int8 sparse against int8 dense within 1e-5
(identical codes per (expert, row), f32 epilogue sums in another order);
int8 against JAX's int8 within 1e-4 (codes equal, a 1-ulp scale
difference moves the result by ~1e-6 relative).  Integer results (top-k
order, capacity) exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_analyst_tpu.models import moe as jmoe
from music_analyst_tpu.ops import quant as jquant
from music_analyst_tpu_torch.models import llama as tl
from music_analyst_tpu_torch.models import moe as tmoe
from music_analyst_tpu_torch.ops import quant as tquant

torch.set_num_threads(1)

E, H, D, K = 4, 16, 8, 2


def _jax_params(x, seed=0):
    module = jmoe.MoESwiGLU(E, H, top_k=K, dtype=jnp.float32)
    return module.init(jax.random.key(seed), jnp.asarray(x))["params"]


def _port(params, **kwargs):
    moe = tmoe.MoESwiGLU(D, E, H, top_k=K, dtype=torch.float32, **kwargs)
    with torch.no_grad():
        for name in ("gate_experts", "up_experts", "down_experts"):
            getattr(moe, name).copy_(torch.tensor(np.asarray(params[name])))
        moe.router.weight.copy_(
            torch.tensor(np.asarray(params["router"]["kernel"]).T))
    return moe


def _jax_out(params, x, **kwargs):
    module = jmoe.MoESwiGLU(E, H, top_k=K, dtype=jnp.float32, **kwargs)
    return np.asarray(module.apply({"params": params}, jnp.asarray(x)))


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("kwargs", [
    {"dispatch": "dense"},
    {"dispatch": "sparse"},
    {"dispatch": "sparse", "capacity_factor": 1.0},
    {"dispatch": "sparse", "capacity_factor": float(E)},
])
def test_logits_match_jax(kwargs):
    x = _x((2, 16, D), 1)
    params = _jax_params(x)
    want = _jax_out(params, x, **kwargs)
    with torch.no_grad():
        got = _port(params, **kwargs)(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_sparse_lossless_capacity_matches_dense():
    x = _x((2, 6, D), 2)
    params = _jax_params(x)
    with torch.no_grad():
        dense = _port(params, dispatch="dense")(torch.tensor(x))
        sparse = _port(params, dispatch="sparse",
                       capacity_factor=float(E))(torch.tensor(x))
    np.testing.assert_allclose(sparse.numpy(), dense.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_capped_divergence_bounded_by_dropped_mass():
    """At capacity factor 1.0 assignments drop; every token either equals
    dense or differs by at most the router mass of its dropped experts
    times their outputs."""
    x = _x((2, 16, D), 3)
    params = _jax_params(x)
    with torch.no_grad():
        dense_moe = _port(params, dispatch="dense")
        sparse_moe = _port(params, dispatch="sparse", capacity_factor=1.0)
        dense = dense_moe(torch.tensor(x)).numpy().reshape(-1, D)
        sparse = sparse_moe(torch.tensor(x)).numpy().reshape(-1, D)
        dropped = int(sparse_moe.last_dropped)
        # Each expert's output for each token, and the router's weights.
        xt = torch.tensor(x).reshape(-1, D)
        logits = sparse_moe.router(xt)
        vals, idx = tmoe.route(logits, K)
        weights = torch.softmax(vals, dim=-1)
        per_expert = torch.stack([
            (torch.nn.functional.silu(xt @ sparse_moe.gate_experts[e])
             * (xt @ sparse_moe.up_experts[e])) @ sparse_moe.down_experts[e]
            for e in range(E)])                               # [E, T, D]
    assert dropped > 0
    diff = np.abs(dense - sparse).max(axis=-1)
    bound = np.array([
        sum(float(weights[t, j]) * float(per_expert[idx[t, j], t].abs().max())
            for j in range(K))
        for t in range(xt.shape[0])])
    assert (diff <= bound + 1e-5).all()
    assert (diff < 1e-5).mean() >= 0.5


def test_sparse_and_dense_share_the_parameter_tree():
    dense = tmoe.MoESwiGLU(D, E, H, dispatch="dense")
    sparse = tmoe.MoESwiGLU(D, E, H, dispatch="sparse")
    shapes = {k: tuple(v.shape) for k, v in dense.state_dict().items()}
    assert shapes == {k: tuple(v.shape)
                      for k, v in sparse.state_dict().items()}
    assert shapes == {"gate_experts": (E, D, H), "up_experts": (E, D, H),
                      "down_experts": (E, H, D), "router.weight": (E, D)}
    assert dense.router.weight.dtype == torch.float32
    assert dense.router.bias is None


@pytest.mark.parametrize("tokens,k,experts,factor", [
    (8, 1, 4, 1.25), (8, 2, 4, 1.25), (5, 2, 4, 1.0), (1, 2, 8, 1.25),
    (4096, 2, 8, 1.25), (7, 3, 4, 1.5),
])
def test_capacity_uses_ceil(tokens, k, experts, factor):
    want = jmoe.moe_capacity(tokens, k, experts, factor)
    assert tmoe.moe_capacity(tokens, k, experts, factor) == want
    fair = -(-tokens * k // experts)
    assert want == max(1, int(np.ceil(fair * factor)))
    # ceil(8/4) * 1.25 = 2.5 must give 3 slots, not 2.
    assert tmoe.moe_capacity(8, 1, 4, 1.25) == 3


def test_bad_dispatch_is_rejected():
    with pytest.raises(ValueError, match="unknown MoE dispatch"):
        tmoe.MoESwiGLU(D, E, H, dispatch="ragged")


def test_int8_sparse_matches_int8_dense():
    x = _x((2, 6, D), 4)
    params = _jax_params(x)
    with torch.no_grad():
        dense = _port(params, dispatch="dense", quant="int8")(torch.tensor(x))
        sparse = _port(params, dispatch="sparse", capacity_factor=float(E),
                       quant="int8")(torch.tensor(x))
    np.testing.assert_allclose(sparse.numpy(), dense.numpy(), rtol=1e-5,
                               atol=1e-5)
    want = _jax_out(params, x, dispatch="sparse", capacity_factor=float(E),
                    quant="int8")
    np.testing.assert_allclose(sparse.numpy(), want, rtol=1e-4, atol=1e-4)


def test_quant_batched_matmul_matches_jax_code_for_code():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 5, 32)).astype(np.float32)
    w = rng.standard_normal((3, 32, 24)).astype(np.float32)
    want = np.asarray(jquant.quant_batched_matmul(jnp.asarray(x),
                                                  jnp.asarray(w)))
    got = tquant.quant_batched_matmul(torch.tensor(x), torch.tensor(w))
    assert got.dtype == torch.float32 and got.shape == (3, 5, 24)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # The codes and scales, per (expert, row) and (expert, channel).
    qx, s_x, qw, s_w = tquant._quantize_batched(torch.tensor(x),
                                                torch.tensor(w))
    assert s_x.shape == (3, 5, 1) and s_w.shape == (3, 1, 24)
    np.testing.assert_array_equal(
        qx.numpy(), np.round(x / s_x.numpy()).astype(np.int8))
    np.testing.assert_array_equal(
        qw.numpy(), np.round(w / s_w.numpy()).astype(np.int8))


def test_topk_order_on_constructed_ties():
    """Equal router logits: both packages take the lower expert index
    first, and the order of the chosen pair is the same."""
    logits = np.array([[[1.0, 3.0, 3.0, 0.5],
                        [2.0, 2.0, 2.0, 2.0],
                        [0.0, 1.0, 0.0, 1.0],
                        [5.0, 4.0, 5.0, 4.0]]], np.float32)
    jvals, jidx = jax.lax.top_k(jnp.asarray(logits), K)
    tvals, tidx = tmoe.route(torch.tensor(logits), K)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tvals.numpy(), np.asarray(jvals))
    np.testing.assert_array_equal(tidx.numpy()[0],
                                  [[1, 2], [0, 1], [1, 3], [0, 2]])


def test_tied_routing_gives_jax_output():
    """A router whose logits tie on every token (zero weights): the
    assignment order, and so which assignments a tight capacity drops,
    must follow JAX's."""
    x = _x((1, 8, D), 6)
    params = jax.tree_util.tree_map(np.asarray, _jax_params(x))
    params["router"]["kernel"] = np.zeros_like(params["router"]["kernel"])
    kwargs = {"dispatch": "sparse", "capacity_factor": 1.0}
    want = _jax_out(params, x, **kwargs)
    with torch.no_grad():
        got = _port(params, **kwargs)(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_load_balancing_loss_matches_jax():
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((2, 5, E)).astype(np.float32)
    idx = np.argsort(-logits, axis=-1)[..., :K]
    want = float(jmoe.MoESwiGLU.load_balancing_loss(
        jnp.asarray(logits), jnp.asarray(idx), E))
    got = float(tmoe.MoESwiGLU.load_balancing_loss(
        torch.tensor(logits), torch.tensor(idx), E))
    assert abs(got - want) < 1e-6


def test_sparse_is_differentiable():
    x = _x((1, 8, D), 8)
    moe = _port(_jax_params(x))
    (moe(torch.tensor(x)) ** 2).sum().backward()
    grads = [p.grad for p in moe.parameters()]
    assert all(g is not None and torch.isfinite(g).all() for g in grads)
    assert any(float(g.abs().sum()) > 0 for g in grads)


@pytest.mark.parametrize("dispatch", ["sparse", "dense"])
def test_moe_llama_logits_match_jax(dispatch):
    """A two-layer MoE Llama, params carried by ``params_from_jax``."""
    import dataclasses

    from music_analyst_tpu.models import layers as jlayers
    from music_analyst_tpu.models import llama as jl

    jcfg = jl.LlamaConfig(
        vocab_size=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
        hidden_dim=48, rope_theta=1e4, max_seq_len=64, dtype="float32",
        n_experts=4, moe_top_k=2, moe_dispatch=dispatch)
    tcfg = tl.LlamaConfig(**dataclasses.asdict(jcfg))
    rng = np.random.default_rng(9)
    ids = rng.integers(0, 64, (2, 12)).astype(np.int32)
    pos = np.broadcast_to(np.arange(12), ids.shape).copy()
    mask = np.asarray(jlayers.causal_mask(12, 12, 0))
    jmodel = jl.LlamaModel(jcfg)
    params = jmodel.init(jax.random.key(0), jnp.asarray(ids),
                         jnp.asarray(pos), jnp.asarray(mask))["params"]
    want, _ = jmodel.apply({"params": params}, jnp.asarray(ids),
                           jnp.asarray(pos), jnp.asarray(mask))
    model = tl.LlamaModel(tcfg)
    sd = tl.params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    model.load_state_dict({k: torch.tensor(np.asarray(v))
                           for k, v in sd.items()})
    shapes = tl.param_shapes(tcfg)
    assert (jax.tree_util.tree_structure(shapes)
            == jax.tree_util.tree_structure(params))
    with torch.no_grad():
        got, _ = model(torch.tensor(ids), torch.tensor(pos),
                       torch.tensor(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_moe_init_draws_lecun_normal_with_flax_fan_in():
    model = tl.LlamaModel(tl.LlamaConfig.tiny(
        n_experts=4, dim=64, hidden_dim=96, n_layers=1, dtype="float32"))
    tl.init_random_(model, seed=0)
    moe = model.layers[0].feed_forward_moe
    # Flax's fan-in of an [E, in, out] stack is E * in.
    for name, fan_in in (("gate_experts", 4 * 64), ("down_experts", 4 * 96),
                         ("router.weight", 64)):
        w = moe.get_parameter(name).detach()
        assert abs(float(w.std()) * fan_in ** 0.5 - 1.0) < 0.1, name
        assert float(w.abs().max()) <= 2 * fan_in ** -0.5 / 0.8796 + 1e-6
