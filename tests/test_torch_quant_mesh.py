"""Quantized projections under a mesh ≡ JAX's, and int8 KV pages under tp.

JAX runs in this process on its 8-device CPU mesh; the port runs as gloo
ranks (``tests/torch_ranks.py``), one launch per world size shared by its
cases through module fixtures.  Weights are JAX's, carried over by
``params_from_jax`` (a saved ``.npz``; stored ``QuantizedParam`` kernels
as ``.q`` / ``.scale``), float32 on both sides.

* Placement: every rank's block of every quantized leaf (codes and
  scales, int8 and packed int4) is JAX device ``r``'s
  ``addressable_shards`` block (JAX's ``_quantized_specs``), bit for bit;
  a packed axis that does not split raises in both packages.
* Layers: row- and column-parallel ``WqLinear`` (int8, int4) and
  ``QuantLinear`` at tp 2 and 4 against the unsharded layer — int8
  ``torch.equal`` (its int32 sums are exact), int4 within 1e-6 of the
  output scale (its f32 group sums add in another order), a group cut by
  a rank boundary included (K 256, group 128, tp 4); a row-parallel
  layer that takes its scales from the rank's own rows only must fail.
* Models: weight-quantized (int8, int4) and ``quant`` int8 tiny GQA
  Llama (8 / 4 heads) at tp 2 (paged and slot runtimes, score mode,
  whole-sequence logits) and tp 4 (paged): greedy text byte-identical to
  JAX's tp run, labels equal, logits within ``ATOL``; the tiny DistilBERT
  on dp2×tp4 (int8, ``quant`` int8) and dp4×tp2 (int4, whose 4 heads pack
  into 2 byte rows that tp 4 cannot split): labels equal to JAX's sharded
  labels, logits within 1e-4.
* int8 KV pages at tp 2: both ranks hold one scale plane, the maximum
  over every rank's heads (before the fix each rank took its own heads'),
  and the greedy text is JAX's tp 2 text.
* Entry points: ``run_server`` on 2 ranks (the code under ``serve --tp
  2``) with the weight-quantized Llama and the ``quant`` DistilBERT
  answers as JAX's server over its tp 2 / dp1×tp2 mesh; a residency
  loading a checkpoint on 2 ranks from a cold quantized cache stores one
  entry, and its ``reload`` through the dispatch stream reads it warm to
  the same codes on every rank.  Then the CLI as processes:
  ``sentiment --devices 2 --weight-quant int8`` (labels equal one
  device's and, as ``tests/test_torch_cli_devices.py`` holds the bf16
  model, JAX's ``--devices 2``), and ``serve --stdio --tp 2`` with
  ``--weight-quant int8`` and with ``--model distilbert-tiny-int8``
  (replies equal ``--tp 1``'s).
"""

import copy
import dataclasses
import io
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_analyst_tpu.cli.main import main as jax_main
from music_analyst_tpu.models import distilbert as jd
from music_analyst_tpu.models import llama as jl
from music_analyst_tpu.parallel import sharding as jsh
from music_analyst_tpu.parallel.mesh import MeshSpec, build_mesh
from music_analyst_tpu.serving import server as js
from music_analyst_tpu_torch.cli.main import main as port_main
from music_analyst_tpu_torch.models import distilbert as td
from music_analyst_tpu_torch.models import llama as tl
from music_analyst_tpu_torch.parallel import sharding as tsh
from music_analyst_tpu_torch.parallel.mesh import DeviceMesh
from tests.test_distilbert_checkpoint import _hf_state_dict
from tests.torch_ranks import launch_ranks

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-4
GEN_PROMPTS = [
    "golden sunshine on the river",
    "rain",
    "shadows fall across the empty street tonight",
    "la la la la",
    "winter wind and summer fire",
    "the long road home winds past the silver lake",
]
TEXTS = [
    "love and sunshine all day",
    "tears and pain in the lonely night",
    "",
    "la la la " * 40,
    "cry me a river of joy",
]
LLAMA_CFG = dict(vocab_size=512, dim=128, n_layers=2, n_heads=8,
                 n_kv_heads=4, hidden_dim=256, rope_theta=1e4,
                 max_seq_len=128, dtype="float32")
PAGED = dict(max_new_tokens=8, n_slots=4, prefill_chunk=16)
TP4 = dict(max_new_tokens=6, n_slots=2, prefill_chunk=16)
SCHEMES = {"wq_int8": dict(weight_quant="int8"),
           "wq_int4": dict(weight_quant="int4"),
           "quant_int8": dict(quant="int8")}
# Token ids of the whole-sequence logits check.
LOGIT_IDS = [[5 + (7 * i + 3 * j) % 250 for j in range(12)] for i in range(2)]


def _mesh(axes):
    n = int(np.prod([s for _, s in axes]))
    return build_mesh(MeshSpec(axes), devices=jax.devices()[:n])


def _port_mesh(axes, rank):
    n = int(np.prod([s for _, s in axes]))
    return DeviceMesh((torch.device("cpu"),) * n, axes, rank)


def _save(tree, port_mod, path):
    state = port_mod.params_from_jax(jax.tree_util.tree_map(np.asarray, tree))
    np.savez(path, **state)
    return str(path)


def _run(script, n, args, workdir, timeout=300):
    outs = launch_ranks(script, n, [str(a) for a in args], workdir,
                        timeout=timeout)
    return [json.loads(o.strip().splitlines()[-1]) for o in outs]


def _llama_cfg(scheme):
    return dataclasses.replace(jl.LlamaConfig(**LLAMA_CFG), **SCHEMES[scheme])


def _bert_cfg(scheme):
    return dataclasses.replace(jd.DistilBertConfig.tiny(), dtype="float32",
                               **SCHEMES[scheme])


# ------------------------------------------------------------- placement


def _port_model(family, scheme, jparams):
    """The port's model holding JAX's (quantized) tree, unsharded."""
    if family == "llama":
        model = tl.LlamaModel(tl.LlamaConfig(**LLAMA_CFG, **SCHEMES[scheme]))
        state = tl.params_from_jax(jparams)
    else:
        model = td.DistilBertForSentiment(td.DistilBertConfig.tiny(
            dtype="float32", **SCHEMES[scheme]))
        state = td.params_from_jax(jparams)
    model.load_state_dict({k: torch.as_tensor(np.asarray(v))
                           for k, v in state.items()})
    return model, (tl if family == "llama" else td)


@pytest.fixture(scope="module")
def quantized_trees():
    trees = {}
    for scheme in ("wq_int8", "wq_int4"):
        jb = jd.DistilBertClassifier(config=_bert_cfg(scheme), max_len=64,
                                     seed=5)
        jg = jl.LlamaZeroShotClassifier(config=_llama_cfg(scheme),
                                        max_prompt_len=64, seed=11)
        trees[("distilbert", scheme)] = jb.params
        trees[("llama", scheme)] = jg.params
    return trees


PLACEMENT_MESHES = {"tp2": (("tp", 2),), "tp4": (("tp", 4),),
                    "dp2xtp4": (("dp", 2), ("tp", 4))}


@pytest.mark.parametrize("mesh_name", sorted(PLACEMENT_MESHES))
@pytest.mark.parametrize("scheme", ["wq_int8", "wq_int4"])
@pytest.mark.parametrize("family", ["distilbert", "llama"])
def test_quantized_blocks_equal_jax_device_shards(quantized_trees, family,
                                                  scheme, mesh_name):
    params = quantized_trees[(family, scheme)]
    axes = PLACEMENT_MESHES[mesh_name]
    full, port_mod = _port_model(
        family, scheme, jax.tree_util.tree_map(np.asarray, params))
    jm = _mesh(axes)
    if family == "distilbert" and scheme == "wq_int4" and mesh_name != "tp2":
        # o_proj's 4 heads pack into 2 byte rows: tp 4 cannot split them.
        with pytest.raises(ValueError, match="divisible"):
            jsh.shard_params(params, jm)
        with pytest.raises(ValueError, match="divisible"):
            tsh.shard_params(copy.deepcopy(full), _port_mesh(axes, 0))
        return
    placed = jsh.shard_params(params, jm)
    quantized = 0
    for rank, device in enumerate(jm.devices.flatten()):
        shard_tree = jax.tree_util.tree_map(
            lambda a: np.asarray([s.data for s in a.addressable_shards
                                  if s.device == device][0]), placed)
        want = port_mod.params_from_jax(shard_tree)
        model = tsh.shard_params(copy.deepcopy(full), _port_mesh(axes, rank))
        got = model.state_dict()
        assert set(got) == set(want)
        for name, value in got.items():
            if name.endswith((".q", ".scale")):
                quantized += 1
            np.testing.assert_array_equal(value.numpy(), want[name],
                                          err_msg=f"rank {rank} {name}")
        # Each rank's codes keep the kernel-major layout.
        o_proj = (model.layers[0].attention.o_proj if family == "llama"
                  else model.encoder.layers[0].attention.o_proj)
        assert o_proj.q.permute(2, 0, 1).is_contiguous()
    assert quantized > 0


def test_packed_int4_axis_that_does_not_split_raises_like_jax(
        quantized_trees):
    """tp 8 over the tiny Llama's o_proj: 8 heads pack into 4 byte rows."""
    params = quantized_trees[("llama", "wq_int4")]
    full, _ = _port_model("llama", "wq_int4",
                          jax.tree_util.tree_map(np.asarray, params))
    axes = (("tp", 8),)
    with pytest.raises(ValueError, match="divisible"):
        jsh.shard_params(params, _mesh(axes))
    with pytest.raises(ValueError, match="divisible"):
        tsh.shard_params(full, _port_mesh(axes, 0))


# ------------------------------------------------- layers, models, pages

_LLAMA_CHILD = r"""
import json, sys
import numpy as np, torch
from torch import nn
rank, n, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
spec = json.loads(sys.argv[4])
torch.set_num_threads(1)
from music_analyst_tpu_torch.parallel import mesh as M, multihost as mh
from music_analyst_tpu_torch.parallel.sharding import shard_params
from music_analyst_tpu_torch.models import layers as L, llama as tl
from music_analyst_tpu_torch.ops import quant as Q
mh.initialize(f"localhost:{port}", n, rank, timeout_s=120)
mesh = M.build_mesh(M.MeshSpec((("tp", n),)), device="cpu")
out = {"layers": {}}

# Layers: K = 256 contracted into 64 features (group 128) under the row
# rule (lin2's input split; its bias replicates and is added once), 64
# into 256 under the column rule (lin1's output and bias split).
gen = torch.Generator().manual_seed(3)
weight = torch.randn(64, 256, generator=gen) / 16
x = torch.randn(5, 256, generator=gen)
x[2] *= 40                       # one token's scale far from the rest
xt = torch.randn(5, 64, generator=gen)
for kind in ("int8", "int4", "quant"):
    for role, name, w, inp in (("row", "lin2", weight, x),
                               ("column", "lin1", weight.t().contiguous(),
                                xt)):
        def make():
            holder = nn.Module()
            holder.ffn = nn.Module()
            if kind == "quant":
                layer = L.QuantLinear(w.shape[1], w.shape[0], bias=True,
                                      dtype=torch.float32)
                with torch.no_grad():
                    layer.weight.copy_(w)
            else:
                layer = L.WqLinear(w.shape[1], w.shape[0], kind, bias=True,
                                   dtype=torch.float32)
                layer.quantize_from_(w)
            with torch.no_grad():
                layer.bias.copy_(torch.arange(w.shape[0]) / 10.0)
            setattr(holder.ffn, name, layer)
            return holder
        with torch.no_grad():
            want = getattr(make().ffn, name)(inp)
        layer = getattr(shard_params(make(), mesh).ffn, name)
        if layer.rows is not None:       # this rank's contraction rows
            width = 256 // n
            inp = inp[:, layer.rows.start:layer.rows.start + width]
        with torch.no_grad():
            got = layer(inp)
            kept = Q.row_absmax
            Q.row_absmax = lambda amax, rows: amax   # rank-local scales
            try:
                broken = layer(inp)
            finally:
                Q.row_absmax = kept
        if layer.tp_role is None:        # the rank's block of the features
            got = M.all_gather(got, mesh, "tp", dim=-1)
            broken = M.all_gather(broken, mesh, "tp", dim=-1)
        scale = float(want.abs().max())
        out["layers"][f"{kind}-{role}"] = dict(
            role=layer.tp_role, equal=bool(torch.equal(got, want)),
            rel=float((got - want).abs().max()) / scale,
            broken_rel=float((broken - want).abs().max()) / scale)

# Models: JAX's weights on this rank's tp mesh.
ids = torch.tensor(spec["logit_ids"])
S = ids.shape[1]
for scheme, weights in spec["weights"].items():
    cfg = tl.LlamaConfig(**spec["cfg"], **spec["schemes"][scheme])
    clf = tl.LlamaZeroShotClassifier(
        config=cfg, max_prompt_len=64, state_dict=dict(np.load(weights)),
        mesh=mesh)
    res = {}
    if n == 2:
        res["paged"] = clf.generate_batch_continuous(spec["prompts"],
                                                     **spec["paged"])
        res["slots"] = clf.generate_batch_continuous(
            spec["prompts"], page_size=0, **spec["paged"])
        res["score"] = clf.classify_batch(spec["prompts"])
        with torch.no_grad():
            logits, _ = clf.model(ids, torch.arange(S).expand(2, S),
                                  L.causal_mask(S, S))
        res["logits"] = logits.tolist()
    else:
        res["paged"] = clf.generate_batch_continuous(spec["prompts"],
                                                     **spec["tp4"])
    out[scheme] = res

if n == 2:
    # int8 KV pages on the float model.
    clf = tl.LlamaZeroShotClassifier(
        config=tl.LlamaConfig(**spec["cfg"]), max_prompt_len=64,
        state_dict=dict(np.load(spec["float_weights"])), mesh=mesh)
    texts = clf.generate_batch_continuous(spec["prompts"], kv_quant="int8",
                                          **spec["paged"])
    (sched,) = clf._slot_schedulers.values()
    out["pages"] = dict(
        texts=texts,
        planes=[[c.key_scale.tolist(), c.value_scale.tolist()]
                for c in sched.caches],
        top_codes=[[p.abs().amax(dim=(-2, -1)).tolist()
                    for p in (c.keys, c.values)] for c in sched.caches])
print(json.dumps(out))
mh.shutdown()
"""


@pytest.fixture(scope="module")
def llama_weights(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("llama")
    out = {}
    for scheme in SCHEMES:
        clf = jl.LlamaZeroShotClassifier(config=_llama_cfg(scheme),
                                         max_prompt_len=64, seed=11)
        out[scheme] = _save(clf.params, tl, tmp / f"{scheme}.npz")
    plain = jl.LlamaZeroShotClassifier(config=jl.LlamaConfig(**LLAMA_CFG),
                                       max_prompt_len=64, seed=11)
    out["float"] = _save(plain.params, tl, tmp / "float.npz")
    return out


def _llama_ranks(n, weights, workdir):
    spec = dict(cfg=LLAMA_CFG, schemes=SCHEMES, prompts=GEN_PROMPTS,
                paged=PAGED, tp4=TP4, logit_ids=LOGIT_IDS,
                weights={s: weights[s] for s in SCHEMES},
                float_weights=weights["float"])
    return _run(_LLAMA_CHILD, n, [json.dumps(spec)], workdir)


@pytest.fixture(scope="module")
def tp2(llama_weights, tmp_path_factory):
    ranks = _llama_ranks(2, llama_weights, tmp_path_factory.mktemp("tp2"))
    _same_on_every_rank(ranks, ("layers", *SCHEMES))
    return ranks


def _same_on_every_rank(ranks, keys):
    """Every rank gathers the same result (the broken layers aside: each
    rank's own scales give each rank its own wrong result)."""
    def kept(rank):
        out = {key: rank[key] for key in keys}
        out["layers"] = {case: {k: v for k, v in row.items()
                                if k != "broken_rel"}
                         for case, row in rank["layers"].items()}
        return out

    for r in ranks[1:]:
        assert kept(r) == kept(ranks[0])


@pytest.fixture(scope="module")
def tp4(llama_weights, tmp_path_factory):
    ranks = _llama_ranks(4, llama_weights, tmp_path_factory.mktemp("tp4"))
    _same_on_every_rank(ranks, ("layers", *SCHEMES))
    return ranks[0]


@pytest.mark.parametrize("case", [f"{k}-{r}" for k in ("int8", "int4",
                                                       "quant")
                                  for r in ("row", "column")])
@pytest.mark.parametrize("width", [2, 4])
def test_tp_layer_equals_unsharded(tp2, tp4, width, case):
    """int8 products (stored or dynamic) bit for bit, int4 within 1e-6;
    the row-parallel layer with rank-local scales fails."""
    got = (tp2[0] if width == 2 else tp4)["layers"][case]
    kind, role = case.split("-")
    assert got["role"] == ("row" if role == "row" else None)
    if kind == "int4":
        assert got["rel"] <= 1e-6
    else:
        assert got["equal"]
    if role == "row":
        assert got["broken_rel"] > 1e-3
    else:
        assert got["broken_rel"] == got["rel"]


@pytest.fixture(scope="module")
def jax_tp2():
    return {scheme: jl.LlamaZeroShotClassifier(
        config=_llama_cfg(scheme), max_prompt_len=64, seed=11,
        mesh=_mesh((("tp", 2),))) for scheme in SCHEMES}


@pytest.mark.parametrize("route", ["paged", "slots", "score"])
@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_quantized_llama_tp2_equals_jax(tp2, jax_tp2, scheme, route):
    clf = jax_tp2[scheme]
    if route == "paged":
        want = clf.generate_batch_continuous(GEN_PROMPTS, **PAGED)
    elif route == "slots":
        want = clf.generate_batch_continuous(GEN_PROMPTS, page_size=0,
                                             **PAGED)
    else:
        want = clf.classify_batch(GEN_PROMPTS)
    assert tp2[0][scheme][route] == want


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_quantized_llama_tp2_logits_equal_jax(tp2, jax_tp2, scheme):
    clf = jax_tp2[scheme]
    ids = jnp.asarray(LOGIT_IDS, dtype=jnp.int32)
    S = ids.shape[1]
    pos = jnp.broadcast_to(jnp.arange(S), ids.shape)
    want, _ = clf.model.apply({"params": clf.params}, ids, pos,
                              jl.causal_mask(S, S, 0))
    np.testing.assert_allclose(np.asarray(tp2[0][scheme]["logits"]),
                               np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_quantized_llama_tp4_text_equals_jax(tp4, scheme):
    jax_tp4 = jl.LlamaZeroShotClassifier(
        config=_llama_cfg(scheme), max_prompt_len=64, seed=11,
        mesh=_mesh((("tp", 4),)))
    assert tp4[scheme]["paged"] == jax_tp4.generate_batch_continuous(
        GEN_PROMPTS, **TP4)


def test_int8_page_scales_are_one_plane_over_every_rank_heads(
        llama_weights, tp2):
    """At tp 2 a page row's scale is the maximum over all KV heads, as
    JAX's one global quantize takes it: both ranks hold the same planes;
    in every written row the largest code over both ranks' heads is 127
    (the scale is that row's maximum, not a larger one); and the planes
    are tp 1's up to the last bit of the f32 K/V projections, which sum
    in another order when their output rows are split."""
    one = tl.LlamaZeroShotClassifier(
        config=tl.LlamaConfig(**LLAMA_CFG), max_prompt_len=64,
        state_dict=dict(np.load(llama_weights["float"])), device="cpu")
    one.generate_batch_continuous(GEN_PROMPTS, kv_quant="int8", **PAGED)
    (sched,) = one._slot_schedulers.values()
    want = np.asarray([[c.key_scale.numpy(), c.value_scale.numpy()]
                       for c in sched.caches])
    r0, r1 = tp2[0]["pages"], tp2[1]["pages"]
    assert r0["planes"] == r1["planes"]
    planes = np.asarray(r0["planes"])
    top = np.maximum(np.asarray(r0["top_codes"]), np.asarray(r1["top_codes"]))
    written = planes > np.float32(1e-8) / np.float32(127)
    assert written.sum() > 100
    assert (top[written] == 127).all()
    assert (top[~written] == 0).all()
    np.testing.assert_allclose(planes, want, rtol=1e-6, atol=0)


def test_int8_pages_tp2_text_equals_jax(tp2):
    jax_clf = jl.LlamaZeroShotClassifier(
        config=jl.LlamaConfig(**LLAMA_CFG), max_prompt_len=64, seed=11,
        mesh=_mesh((("tp", 2),)))
    want = jax_clf.generate_batch_continuous(GEN_PROMPTS, kv_quant="int8",
                                             **PAGED)
    assert tp2[0]["pages"]["texts"] == want
    assert tp2[1]["pages"]["texts"] == want


# ------------------------------------------------------------ DistilBERT

BERT_MESHES = {"wq_int8": (("dp", 2), ("tp", 4)),
               "quant_int8": (("dp", 2), ("tp", 4)),
               "wq_int4": (("dp", 4), ("tp", 2))}

_BERT_CHILD = r"""
import json, sys
import numpy as np, torch
rank, n, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
spec = json.loads(sys.argv[4])
torch.set_num_threads(1)
from music_analyst_tpu_torch.parallel import mesh as M, multihost as mh
from music_analyst_tpu_torch.models import distilbert as td
mh.initialize(f"localhost:{port}", n, rank, timeout_s=120)
out = {}
for scheme, axes in spec["meshes"].items():
    mesh = M.build_mesh(M.MeshSpec(tuple(map(tuple, axes))), device="cpu")
    clf = td.DistilBertClassifier(
        config=td.DistilBertConfig.tiny(dtype="float32",
                                        **spec["schemes"][scheme]),
        max_len=64, state_dict=dict(np.load(spec["weights"][scheme])),
        mesh=mesh)
    out[scheme] = dict(labels=clf.classify_batch(spec["texts"]),
                       logits=clf.classify_logits(spec["texts"]).tolist())
print(json.dumps(out))
mh.shutdown()
"""


@pytest.fixture(scope="module")
def bert(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bert")
    weights = {}
    for scheme in BERT_MESHES:
        plain = jd.DistilBertClassifier(config=_bert_cfg(scheme), max_len=64,
                                        seed=6)
        weights[scheme] = _save(plain.params, td, tmp / f"{scheme}.npz")
    spec = dict(meshes=BERT_MESHES, schemes=SCHEMES, weights=weights,
                texts=TEXTS)
    ranks = _run(_BERT_CHILD, 8, [json.dumps(spec)], tmp / "ranks")
    for r in ranks[1:]:
        assert r == ranks[0]
    return ranks[0]


@pytest.mark.parametrize("scheme", sorted(BERT_MESHES))
def test_quantized_distilbert_on_ranks_equals_jax_mesh(bert, scheme):
    sharded = jd.DistilBertClassifier(config=_bert_cfg(scheme), max_len=64,
                                      seed=6, mesh=_mesh(BERT_MESHES[scheme]))
    assert bert[scheme]["labels"] == sharded.classify_batch(TEXTS)
    ids, lengths = sharded.tokenizer.encode_batch(TEXTS, 64)
    want = sharded.model.apply({"params": sharded.params}, jnp.asarray(ids),
                               jnp.asarray(lengths))
    np.testing.assert_allclose(np.asarray(bert[scheme]["logits"]),
                               np.asarray(want), atol=ATOL)


# --------------------------------------------------------- entry points

SERVE_FLAGS = dict(slots=4, prefill_chunk=16, max_new_tokens=8, max_batch=4,
                   max_wait_ms=2.0)
LLAMA_LINES = ([json.dumps({"id": f"g{i}", "op": "generate", "text": p,
                            "max_new_tokens": 8})
                for i, p in enumerate(GEN_PROMPTS)]
               + [json.dumps({"id": f"s{i}", "text": t})
                  for i, t in enumerate(TEXTS[:3])])
BERT_LINES = [json.dumps({"id": f"s{i}", "text": t})
              for i, t in enumerate(TEXTS)]

_SERVE_CHILD = r"""
import contextlib, io, json, os, sys
import numpy as np, torch
rank, n, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
spec = json.loads(sys.argv[4])
torch.set_num_threads(1)
from music_analyst_tpu_torch.engines import checkpoint as C
from music_analyst_tpu_torch.models import distilbert as td, llama as tl
from music_analyst_tpu_torch.parallel import mesh as M, multihost as mh
from music_analyst_tpu_torch.serving import server as ts, tp_dispatch as TD
from music_analyst_tpu_torch.serving.residency import ModelResidency
mh.initialize(f"localhost:{port}", n, rank, timeout_s=120)
mesh = M.build_mesh(M.MeshSpec((("tp", n),)), device="cpu")
out = {}

def serve(clf, lines, kw):
    if rank:
        return {"follower": ts.run_follower(backend=clf, tp=n, device="cpu")}
    sys.stdin = io.StringIO("".join(line + "\n" for line in lines))
    replies, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(replies), contextlib.redirect_stderr(err):
        code = ts.run_server(backend=clf, stdio=True, tp=n, device="cpu",
                             use_response_cache=False, **kw)
    return {"code": code,
            "replies": [json.loads(l) for l in replies.getvalue().splitlines()]}

llama = tl.LlamaZeroShotClassifier(
    config=tl.LlamaConfig(**spec["cfg"], weight_quant="int8"),
    max_prompt_len=64, state_dict=dict(np.load(spec["llama"])), mesh=mesh)
out["llama"] = serve(llama, spec["llama_lines"], spec["serve"])
bert = td.DistilBertClassifier(
    config=td.DistilBertConfig.tiny(dtype="float32", quant="int8"),
    max_len=64, state_dict=dict(np.load(spec["bert"])), mesh=mesh)
out["bert"] = serve(bert, spec["bert_lines"], dict(max_batch=4,
                                                   max_wait_ms=2.0))

# A residency over a checkpoint on a cold quantized cache, then its
# reload through the dispatch stream (every rank reloads).
os.environ["MUSICAAL_DISTILBERT_CKPT"] = spec["ckpt"]
os.environ["MUSICAAL_WQ_CACHE"] = spec["cache"]
res = ModelResidency(model="distilbert-tiny", weight_quant="int8",
                     device="cpu", mesh=mesh)

def codes():
    lin = res.acquire().model.encoder.layers[0].ffn.lin2
    return dict(q=lin.q.tolist(), scale=lin.scale.tolist(),
                dtype=str(lin.q.dtype), role=lin.tp_role,
                cache=C.last_load_stats()["cache"])

if rank:
    res.acquire()
    cold = codes()
    TD.follow({"residency": res}, device="cpu")
else:
    stream = TD.DispatchStream({"residency": res})
    serving = stream.remote(res, TD.RESIDENCY_METHODS)
    serving.acquire()
    cold = codes()
    before = serving.classify_batch(spec["texts"])
    serving.reload()
    after = serving.classify_batch(spec["texts"])
    stream.close()
    out["labels"] = [before, after]
out["codes"] = [cold, codes()]
out["entries"] = sorted(os.listdir(spec["cache"]))
print(json.dumps(out))
mh.shutdown()
"""


@pytest.fixture(scope="module")
def bert_ckpt(tmp_path_factory):
    sd = _hf_state_dict(jd.DistilBertConfig.tiny(), seed=6)
    sd["classifier.weight"] = sd["classifier.weight"] * 3000
    path = tmp_path_factory.mktemp("ckpt") / "distilbert.pt"
    torch.save(sd, path)
    return str(path)


@pytest.fixture(scope="module")
def served(llama_weights, bert_ckpt, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("served")
    jb = jd.DistilBertClassifier(config=_bert_cfg("quant_int8"), max_len=64,
                                 seed=6)
    spec = dict(cfg=LLAMA_CFG, llama=llama_weights["wq_int8"],
                bert=_save(jb.params, td, tmp / "bert.npz"),
                llama_lines=LLAMA_LINES, bert_lines=BERT_LINES,
                serve=SERVE_FLAGS, ckpt=bert_ckpt, texts=TEXTS,
                cache=str(tmp / "wq_cache"))
    ranks = _run(_SERVE_CHILD, 2, [json.dumps(spec)], tmp / "ranks")
    for key in ("llama", "bert"):
        assert ranks[1][key] == {"follower": 0}
        assert ranks[0][key]["code"] == 0
    return ranks


def _jax_served(clf, lines, tp, monkeypatch, capsys, **kw):
    capsys.readouterr()
    monkeypatch.setattr(sys, "stdin", io.StringIO(
        "".join(line + "\n" for line in lines)))
    assert js.run_server(backend=clf, tp=tp, stdio=True, quiet=True,
                         use_response_cache=False, **kw) == 0
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()]


def test_served_weight_quant_llama_equals_jax(served, jax_tp2, monkeypatch,
                                              capsys):
    want = _jax_served(jax_tp2["wq_int8"], LLAMA_LINES, 2, monkeypatch,
                       capsys, **SERVE_FLAGS)
    assert served[0]["llama"]["replies"] == want
    assert len(want) == len(LLAMA_LINES) and all(r["ok"] for r in want)


def test_served_quant_distilbert_equals_jax(served, monkeypatch, capsys):
    """JAX's ``serve_mesh(2)`` (a ``tp`` axis alone) cannot host its
    DistilBERT, which shards the batch over ``dp``; the reference runs on
    dp1×tp2, the same two weight shards."""
    jax_clf = jd.DistilBertClassifier(config=_bert_cfg("quant_int8"),
                                      max_len=64, seed=6,
                                      mesh=_mesh((("dp", 1), ("tp", 2))))
    want = _jax_served(jax_clf, BERT_LINES, 2, monkeypatch, capsys,
                       max_batch=4, max_wait_ms=2.0)
    assert served[0]["bert"]["replies"] == want


def test_reload_under_tp_keeps_the_codes_from_one_cache_entry(served):
    r0, r1 = served
    assert len(r0["entries"]) == 1 and r0["entries"] == r1["entries"]
    before, after = r0["labels"]
    assert before == after and len(before) == len(TEXTS)
    for rank in (r0, r1):
        cold, warm = rank["codes"]
        assert cold["cache"] in ("miss", "hit") and warm["cache"] == "hit"
        assert cold["dtype"] == warm["dtype"] == "torch.int8"
        assert cold["role"] == warm["role"] == "row"
        assert (cold["q"], cold["scale"]) == (warm["q"], warm["scale"])
    # Each rank holds its own block of lin2's contraction rows.
    assert r0["codes"][0]["q"] != r1["codes"][0]["q"]


def _port_cli(args, env=None, timeout=240):
    run_env = dict(os.environ, OMP_NUM_THREADS="1", **(env or {}))
    return subprocess.run(
        [sys.executable, "-m", "music_analyst_tpu_torch", *args],
        cwd=ROOT, env=run_env, capture_output=True, text=True,
        timeout=timeout)


def _labels(out):
    lines = (out / "sentiment_details.csv").read_text().splitlines()
    return [line.rsplit(",", 1)[0] for line in lines]


def test_sentiment_devices_2_weight_quant_equals_one_device_and_jax(
        fixture_csv, bert_ckpt, tmp_path, monkeypatch):
    flags = ["--model", "distilbert-tiny", "--weight-quant", "int8"]
    run = _port_cli(["sentiment", str(fixture_csv), "--device", "cpu",
                     "--devices", "2", "--output-dir", str(tmp_path / "d2"),
                     *flags], env={"MUSICAAL_DISTILBERT_CKPT": bert_ckpt,
                                   "MUSICAAL_WQ_CACHE": "off"})
    assert run.returncode == 0, run.stderr[-2000:]
    assert "mesh: 2 ranks over gloo" in run.stderr
    monkeypatch.setenv("MUSICAAL_DISTILBERT_CKPT", bert_ckpt)
    monkeypatch.setenv("MUSICAAL_WQ_CACHE", "off")
    port_main(["sentiment", str(fixture_csv), "--device", "cpu",
               "--output-dir", str(tmp_path / "d1"), *flags])
    jax_main(["sentiment", str(fixture_csv), "--devices", "2",
              "--output-dir", str(tmp_path / "jax"), *flags])
    jax_main(["sentiment", str(fixture_csv), "--output-dir",
              str(tmp_path / "jax1"), *flags])
    labels = _labels(tmp_path / "d2")
    assert labels == _labels(tmp_path / "d1")
    assert _labels(tmp_path / "jax") == _labels(tmp_path / "jax1")
    assert ((tmp_path / "d2" / "sentiment_totals.json").read_bytes()
            == (tmp_path / "d1" / "sentiment_totals.json").read_bytes())
    # The bf16 models of the two packages round differently: across
    # packages the rows agree wherever the one-device runs do (all but at
    # most one near-boundary row).
    same = [i for i, (a, b) in enumerate(zip(_labels(tmp_path / "d1"),
                                             _labels(tmp_path / "jax1")))
            if a == b]
    assert len(same) >= len(labels) - 1
    assert ([labels[i] for i in same]
            == [_labels(tmp_path / "jax")[i] for i in same])


def _serve_cli(flags, lines, timeout=240):
    proc = subprocess.run(
        [sys.executable, "-m", "music_analyst_tpu_torch", "serve", "--stdio",
         "--device", "cpu", "--no-response-cache", "--no-telemetry", *flags],
        input="".join(line + "\n" for line in lines), capture_output=True,
        text=True, timeout=timeout, cwd=ROOT,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc, [json.loads(line) for line in proc.stdout.splitlines()]


@pytest.mark.parametrize("flags,lines", [
    (["--model", "llama3-tiny", "--weight-quant", "int8", "--slots", "4",
      "--prefill-chunk", "16", "--max-new-tokens", "8"],
     LLAMA_LINES[:4] + LLAMA_LINES[-2:]),
    (["--model", "distilbert-tiny-int8"], BERT_LINES),
], ids=["llama3-tiny-wq-int8", "distilbert-tiny-int8"])
def test_cli_serve_tp2_quantized_equals_tp1(flags, lines):
    _, want = _serve_cli(flags, lines)
    proc, got = _serve_cli(flags + ["--tp", "2"], lines)
    assert "mesh: 2 ranks over gloo" in proc.stderr
    assert got == want
    assert len(got) == len(lines) and all(r["ok"] for r in got)
