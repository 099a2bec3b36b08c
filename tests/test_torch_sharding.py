"""The port's sharding rules ≡ JAX's placement, shard for shard.

A tiny DistilBERT and a tiny GQA Llama (8 query / 4 KV heads) are built in
JAX (float32, seeded), their parameter trees sharded by JAX's
``shard_params`` on the 8-device CPU mesh as dp2×tp4, tp2 and tp4, and the
full trees handed to the port (``params_from_jax``).  For every rank
``r`` the port's ``shard_params`` (a ``DeviceMesh`` at rank ``r``; no
process group is needed to place weights) must hold exactly JAX device
``r``'s ``addressable_shards`` data, mapped through the same
``params_from_jax`` layout change (transposes and head flattening): bit
for bit.  Each block is a contiguous tensor with storage of its own.
Splits that do not divide (a vocabulary, query or KV heads) raise
``ValueError`` in both packages; ``kv_cache_spec`` replicates in the same
cases.  The tensor-parallel modules are installed where the rules split.
Tolerance: none.
"""

import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

from music_analyst_tpu.models import distilbert as jd
from music_analyst_tpu.models import llama as jl
from music_analyst_tpu.parallel import mesh as jmesh
from music_analyst_tpu.parallel import sharding as jsh
from music_analyst_tpu_torch.models import distilbert as td
from music_analyst_tpu_torch.models import layers as tlayers
from music_analyst_tpu_torch.models import llama as tl
from music_analyst_tpu_torch.parallel import sharding as tsh
from music_analyst_tpu_torch.parallel.mesh import DeviceMesh

torch.set_num_threads(1)

MESHES = {
    "dp2xtp4": (("dp", 2), ("tp", 4)),
    "tp2": (("tp", 2),),
    "tp4": (("tp", 4),),
}


def _jax_mesh(axes):
    n = int(np.prod([s for _, s in axes]))
    return jmesh.build_mesh(jmesh.MeshSpec(axes), devices=jax.devices()[:n])


def _port_mesh(axes, rank):
    n = int(np.prod([s for _, s in axes]))
    return DeviceMesh((torch.device("cpu"),) * n, axes, rank)


@pytest.fixture(scope="module")
def models():
    jb = jd.DistilBertClassifier(
        config=dataclasses.replace(jd.DistilBertConfig.tiny(),
                                   dtype="float32"), max_len=64, seed=5)
    jg = jl.LlamaZeroShotClassifier(
        config=dataclasses.replace(jl.LlamaConfig.tiny(), dtype="float32"),
        max_prompt_len=64, seed=11)
    out = {}
    for name, params, port_mod, make in (
        ("distilbert", jb.params, td,
         lambda: td.DistilBertForSentiment(td.DistilBertConfig.tiny(
             dtype="float32"))),
        ("llama", jg.params, tl,
         lambda: tl.LlamaModel(tl.LlamaConfig.tiny(dtype="float32"))),
    ):
        tree = jax.tree_util.tree_map(np.asarray, params)
        model = make()
        model.load_state_dict({k: torch.as_tensor(v) for k, v in
                               port_mod.params_from_jax(tree).items()})
        out[name] = (params, port_mod, model)
    return out


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("family", ["distilbert", "llama"])
def test_rank_shards_equal_jax_device_shards(models, family, mesh_name):
    params, port_mod, full = models[family]
    axes = MESHES[mesh_name]
    jm = _jax_mesh(axes)
    placed = jsh.shard_params(params, jm)
    for rank, device in enumerate(jm.devices.flatten()):
        assert device == jax.devices()[rank]
        shard_tree = jax.tree_util.tree_map(
            lambda a: np.asarray([s.data for s in a.addressable_shards
                                  if s.device == device][0]), placed)
        want = port_mod.params_from_jax(shard_tree)
        model = tsh.shard_params(copy.deepcopy(full),
                                 _port_mesh(axes, rank))
        got = model.state_dict()
        assert set(got) == set(want)
        for name, value in got.items():
            assert value.is_contiguous(), name
            assert (value.untyped_storage().nbytes()
                    == value.numel() * value.element_size()), name
            np.testing.assert_array_equal(value.numpy(), want[name],
                                          err_msg=f"rank {rank} {name}")


def test_tensor_parallel_modules_installed(models):
    _, _, full = models["llama"]
    model = tsh.shard_params(copy.deepcopy(full),
                             _port_mesh(MESHES["tp4"], 1))
    att = model.layers[0].attention
    assert (att.n_heads, att.n_kv_heads) == (2, 1)
    assert isinstance(att.o_proj, tlayers.RowParallelLinear)
    assert isinstance(model.layers[0].feed_forward.down_proj,
                      tlayers.RowParallelLinear)
    assert isinstance(model.layers[0].feed_forward.up_proj, torch.nn.Linear)
    assert isinstance(model.tok_embeddings, tlayers.VocabParallelEmbedding)
    assert model.tok_embeddings.start == 128
    assert isinstance(model.lm_head, tlayers.VocabParallelHead)
    _, _, bert = models["distilbert"]
    bert = tsh.shard_params(copy.deepcopy(bert),
                            _port_mesh(MESHES["dp2xtp4"], 5))
    layer = bert.encoder.layers[0]
    assert isinstance(layer.ffn.lin2, tlayers.RowParallelLinear)
    assert layer.ffn.lin2.bias.shape == (64,)      # replicated, added once
    assert layer.attention.n_heads == 1
    # A dp-only mesh shards nothing and keeps the modules.
    plain = tsh.shard_params(copy.deepcopy(full),
                             _port_mesh((("dp", 8),), 3))
    assert plain.tp_layout == {}
    assert type(plain.layers[0].attention.o_proj) is torch.nn.Linear


_UNEVEN = {
    # (family, config overrides, mesh): the split that cannot divide
    "vocab": ("distilbert", dict(vocab_size=1022), (("tp", 4),)),
    "query_heads": ("llama", dict(n_heads=6, n_kv_heads=6, dim=96),
                    (("tp", 4),)),
    "kv_heads": ("llama", dict(n_kv_heads=2), (("tp", 4),)),
}


@pytest.mark.parametrize("case", sorted(_UNEVEN))
def test_uneven_splits_raise_like_jax(case):
    family, overrides, axes = _UNEVEN[case]
    if family == "distilbert":
        jcfg = dataclasses.replace(jd.DistilBertConfig.tiny(), **overrides)
        jparams = jd.DistilBertClassifier(config=jcfg, max_len=64).params
        model = td.DistilBertForSentiment(td.DistilBertConfig.tiny(**overrides))
    else:
        jcfg = dataclasses.replace(jl.LlamaConfig.tiny(), **overrides)
        jparams = jax.eval_shape(
            lambda: jl.LlamaModel(jcfg).init(
                jax.random.key(0), np.zeros((1, 8), np.int32),
                np.zeros((1, 8), np.int32), jl.causal_mask(8, 8, 0)))["params"]
        jparams = jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, s.dtype), jparams)
        with torch.device("meta"):
            model = tl.LlamaModel(tl.LlamaConfig.tiny(**overrides))
    with pytest.raises(ValueError, match="divisible"):
        jsh.shard_params(jparams, _jax_mesh(axes))
    with pytest.raises(ValueError, match="divisible"):
        tsh.shard_params(model, _port_mesh(axes, 0))


@pytest.mark.parametrize("axes,heads", [
    ((("dp", 2), ("tp", 4)), 4), ((("dp", 2), ("tp", 4)), 3),
    ((("dp", 8),), 4), ((("tp", 2),), 4), ((("tp", 4),), 2),
])
def test_kv_cache_spec_matches_jax(axes, heads):
    jkv, jlen = jsh.kv_cache_spec(_jax_mesh(axes), heads)
    kv, lengths = tsh.kv_cache_spec(_port_mesh(axes, 0), heads)
    assert kv == tuple(jkv) and lengths == tuple(jlen) == ()
    tp = dict(axes).get("tp", 1)
    assert tsh.local_kv_heads(_port_mesh(axes, 0), heads) == (
        heads // tp if kv else heads)


@pytest.mark.parametrize("port_name,jax_path", [
    ("layers.0.attention.q_proj.weight", "layer_0/attention/q_proj/kernel"),
    ("layers.0.attention.o_proj.weight", "layer_0/attention/o_proj/kernel"),
    ("layers.0.feed_forward.down_proj.weight",
     "layer_0/feed_forward/down_proj/kernel"),
    ("encoder.layers.0.ffn.lin1.bias", "encoder/layer_0/ffn/lin1/bias"),
    ("encoder.layers.0.ffn.lin2.bias", "encoder/layer_0/ffn/lin2/bias"),
    ("lm_head.weight", "lm_head/kernel"),
    ("norm.weight", "norm/scale"),
    ("layers.0.feed_forward_moe.down_experts",
     "layer_0/feed_forward_moe/down_experts"),
])
def test_rules_name_the_same_mesh_axes_as_jax(port_name, jax_path):
    """Each port rule splits over the same axes as JAX's (the dimension
    order differs by the layout change)."""
    got = tsh.spec_for_path(port_name)
    want = jsh.spec_for_path(jax_path)
    assert sorted(a for a in got if a) == sorted(a for a in want if a)
    assert tsh.prune_spec(got, ("dp",)) == tuple(
        None for _ in got) and tuple(jsh.prune_spec(want, ("dp",))) == tuple(
        None for _ in want)
    assert tsh.partition_specs(torch.nn.Linear(2, 2)) == {
        "weight": (), "bias": ()}


def _wq_llama():
    return tl.LlamaModel(tl.LlamaConfig.tiny(weight_quant="int8"))


@pytest.mark.parametrize("case", [
    "llama_weight_quant", "llama_quant", "llama_moe", "shard_wq_model",
    "train_step_mesh", "train_state_mesh", "train_state_zero1", "serve_tp2",
])
def test_what_stays_unported_under_a_mesh_is_refused(case, capsys):
    """weight_quant / quant / MoE under a mesh, training on a mesh
    (mesh=, zero1=) and ``serve --tp 2`` raise "not yet ported"."""
    from music_analyst_tpu_torch.cli.main import main as port_main
    from music_analyst_tpu_torch.engines import train as ttrain

    mesh = _port_mesh(MESHES["tp2"], 0)
    with pytest.raises((NotImplementedError, SystemExit)) as exc:
        if case == "llama_weight_quant":
            tl.LlamaZeroShotClassifier(
                config=tl.LlamaConfig.tiny(weight_quant="int8"), mesh=mesh)
        elif case == "llama_quant":
            tl.LlamaZeroShotClassifier(
                config=tl.LlamaConfig.tiny(quant="int8"), mesh=mesh)
        elif case == "llama_moe":
            tl.LlamaZeroShotClassifier(
                config=tl.LlamaConfig.tiny(n_experts=4), mesh=mesh)
        elif case == "shard_wq_model":
            tsh.shard_params(_wq_llama(), mesh)
        elif case == "train_step_mesh":
            ttrain.make_train_step(tl.LlamaModel(tl.LlamaConfig.tiny()),
                                   ttrain.make_optimizer(), mesh=mesh)
        elif case == "train_state_mesh":
            ttrain.init_train_state(tl.LlamaModel(tl.LlamaConfig.tiny()),
                                    ttrain.make_optimizer(), mesh=mesh)
        elif case == "train_state_zero1":
            ttrain.init_train_state(tl.LlamaModel(tl.LlamaConfig.tiny()),
                                    ttrain.make_optimizer(), zero1=True)
        else:
            port_main(["serve", "--stdio", "--device", "cpu", "--mock",
                       "--tp", "2"])
    if exc.type is SystemExit:
        assert "not yet ported" in capsys.readouterr().err
    else:
        assert "not yet ported" in str(exc.value)
