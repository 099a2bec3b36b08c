"""The port's classifiers on a mesh of ranks ≡ JAX's on its device mesh.

The counterpart of ``tests/test_sharded_inference.py`` at its configs.
JAX runs in this process on the 8-device CPU mesh; the port runs as gloo
ranks (``tests/torch_ranks.py``), one launch per world size shared by its
cases through module fixtures, with JAX's weights handed over by
``params_from_jax`` (a saved ``.npz``):

* 8 ranks — tiny DistilBERT (float32) on dp8 and on dp2×tp4, flat and
  packed: labels equal JAX's sharded labels and logits within 1e-4 of
  JAX's (f32 on both sides; the tp all-reduces sum in another order);
* 2 ranks — tiny GQA Llama (8 / 4 heads, float32) at tp2: greedy text
  byte-identical to JAX's tp2 run on the paged and the slot runtimes
  and on the static path, score-mode labels equal; and a vocab-parallel
  argmax tie that must resolve to the lowest index, as on one rank;
* 4 ranks — the same Llama at tp4 (one KV head per rank), paged.

Every rank must return the same result (each gathers the full output).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from music_analyst_tpu.models import distilbert as jd
from music_analyst_tpu.models import llama as jl
from music_analyst_tpu.parallel.mesh import MeshSpec, build_mesh
from music_analyst_tpu_torch.models import distilbert as td
from music_analyst_tpu_torch.models import llama as tl
from tests.torch_ranks import launch_ranks

ATOL = 1e-4
TEXTS = [
    "love and sunshine all day",
    "tears and pain in the lonely night",
    "",
    "la la la " * 40,
    "cry me a river of joy",
]
GEN_PROMPTS = [
    "golden sunshine on the river",
    "rain",
    "shadows fall across the empty street tonight",
    "la la la la",
    "winter wind and summer fire",
    "the long road home winds past the silver lake",
]
LLAMA_CFG = dict(vocab_size=512, dim=128, n_layers=2, n_heads=8,
                 n_kv_heads=4, hidden_dim=256, rope_theta=1e4,
                 max_seq_len=128, dtype="float32")
PAGED = dict(max_new_tokens=8, n_slots=4, prefill_chunk=16)
TP4 = dict(max_new_tokens=6, n_slots=2, prefill_chunk=16)


def _mesh(axes):
    n = int(np.prod([s for _, s in axes]))
    return build_mesh(MeshSpec(axes), devices=jax.devices()[:n])


def _save(tree, port_mod, path):
    state = port_mod.params_from_jax(jax.tree_util.tree_map(np.asarray, tree))
    np.savez(path, **state)
    return path


def _run(script, n, args, workdir):
    outs = launch_ranks(script, n, args, workdir)
    results = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    assert all(r == results[0] for r in results[1:])
    return results[0]


_BERT_CHILD = r"""
import json, sys
import numpy as np, torch
rank, n, port, weights, texts = (int(sys.argv[1]), int(sys.argv[2]),
                                 sys.argv[3], sys.argv[4], json.loads(sys.argv[5]))
torch.set_num_threads(1)
from music_analyst_tpu_torch.parallel import mesh as M, multihost as mh
from music_analyst_tpu_torch.models import distilbert as td
mh.initialize(f"localhost:{port}", n, rank, timeout_s=120)
state = dict(np.load(weights))
out = {}
for name, axes in (("dp8", (("dp", 8),)), ("dp2xtp4", (("dp", 2), ("tp", 4)))):
    mesh = M.build_mesh(M.MeshSpec(axes), device="cpu")
    for packed in (False, True):
        clf = td.DistilBertClassifier(
            config=td.DistilBertConfig.tiny(dtype="float32"), max_len=64,
            state_dict=state, mesh=mesh, packed=packed)
        logits = (clf.forward_logits_packed(texts) if packed
                  else clf.classify_logits(texts))
        out[f"{name}-{'packed' if packed else 'flat'}"] = dict(
            labels=clf.classify_batch(texts), logits=logits.tolist())
print(json.dumps(out))
mh.shutdown()
"""


@pytest.fixture(scope="module")
def bert(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bert")
    cfg = dataclasses.replace(jd.DistilBertConfig.tiny(), dtype="float32")
    plain = jd.DistilBertClassifier(config=cfg, max_len=64, seed=6)
    weights = _save(plain.params, td, tmp / "bert.npz")
    port = _run(_BERT_CHILD, 8, [weights, json.dumps(TEXTS)], tmp / "ranks")
    return plain, cfg, port


@pytest.mark.parametrize("case", ["dp8-flat", "dp2xtp4-flat",
                                  "dp8-packed", "dp2xtp4-packed"])
def test_distilbert_on_ranks_matches_jax_mesh(bert, case):
    plain, cfg, port = bert
    mesh_name, layout = case.split("-")
    axes = {"dp8": (("dp", 8),), "dp2xtp4": (("dp", 2), ("tp", 4))}[mesh_name]
    sharded = jd.DistilBertClassifier(config=cfg, max_len=64, seed=6,
                                      mesh=_mesh(axes),
                                      packed=layout == "packed")
    want_labels = sharded.classify_batch(TEXTS)
    assert want_labels == plain.classify_batch(TEXTS)
    assert port[case]["labels"] == want_labels
    ids, lengths = plain.tokenizer.encode_batch(TEXTS, 64)
    want = plain.model.apply({"params": plain.params}, jnp.asarray(ids),
                             jnp.asarray(lengths))
    np.testing.assert_allclose(np.asarray(port[case]["logits"]),
                               np.asarray(want), atol=ATOL)


_LLAMA_CHILD = r"""
import json, sys
import numpy as np, torch
rank, n, port, weights, cfg, prompts = (
    int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
    json.loads(sys.argv[5]), json.loads(sys.argv[6]))
paged, tp4 = json.loads(sys.argv[7]), json.loads(sys.argv[8])
torch.set_num_threads(1)
from music_analyst_tpu_torch.parallel import mesh as M, multihost as mh
from music_analyst_tpu_torch.models import llama as tl, layers as L
mh.initialize(f"localhost:{port}", n, rank, timeout_s=120)
mesh = M.build_mesh(M.MeshSpec((("tp", n),)), device="cpu")
clf = tl.LlamaZeroShotClassifier(
    config=tl.LlamaConfig(**cfg), max_prompt_len=64,
    state_dict=dict(np.load(weights)), mesh=mesh)
out = dict(kv_heads=clf.kv_heads,
           pool_heads=clf.paged_runtime().init_caches()[0].keys.shape[2])
if n == 2:
    out["paged"] = clf.generate_batch_continuous(prompts, **paged)
    out["slots"] = clf.generate_batch_continuous(prompts, page_size=0, **paged)
    out["static"] = clf.generate_batch(prompts, max_new_tokens=8)
    out["score"] = clf.classify_batch(prompts)
    # A tie across the two vocabulary blocks: row 5 (rank 0) and row 256
    # (rank 1's first) score equal; the gathered argmax is the lowest.
    w = torch.zeros(256, 4)
    w[5 if rank == 0 else 0] = 1.0
    head = L.VocabParallelHead(torch.nn.Linear(4, 256, bias=False), mesh)
    head.weight = torch.nn.Parameter(w)
    logits = head(torch.ones(1, 4))
    out["tie"] = [int(logits.argmax(-1)), list(logits.shape)]
else:
    out["paged"] = clf.generate_batch_continuous(prompts, **tp4)
print(json.dumps(out))
mh.shutdown()
"""


@pytest.fixture(scope="module")
def llama_weights(tmp_path_factory):
    cfg = jl.LlamaConfig(**LLAMA_CFG)
    plain = jl.LlamaZeroShotClassifier(config=cfg, max_prompt_len=64,
                                       seed=11)
    path = _save(plain.params, tl, tmp_path_factory.mktemp("llama") / "w.npz")
    return plain, cfg, path


def _llama_ranks(n, path, workdir):
    return _run(_LLAMA_CHILD, n, [path, json.dumps(LLAMA_CFG),
                                  json.dumps(GEN_PROMPTS), json.dumps(PAGED),
                                  json.dumps(TP4)], workdir)


@pytest.fixture(scope="module")
def tp2(llama_weights, tmp_path_factory):
    plain, cfg, path = llama_weights
    jax_tp2 = jl.LlamaZeroShotClassifier(config=cfg, max_prompt_len=64,
                                         seed=11, mesh=_mesh((("tp", 2),)))
    return jax_tp2, _llama_ranks(2, path, tmp_path_factory.mktemp("tp2"))


@pytest.mark.parametrize("route", ["paged", "slots", "static", "score"])
def test_llama_tp2_text_equals_jax(tp2, route):
    jax_tp2, port = tp2
    if route == "paged":
        want = jax_tp2.generate_batch_continuous(GEN_PROMPTS, **PAGED)
    elif route == "slots":
        want = jax_tp2.generate_batch_continuous(GEN_PROMPTS, page_size=0,
                                                 **PAGED)
    elif route == "static":
        want = jax_tp2.generate_batch(GEN_PROMPTS, max_new_tokens=8)
    else:
        want = jax_tp2.classify_batch(GEN_PROMPTS)
    assert port[route] == want
    assert (port["kv_heads"], port["pool_heads"]) == (2, 2)


def test_vocab_parallel_argmax_tie_takes_lowest_index(tp2):
    _, port = tp2
    assert port["tie"] == [5, [1, 512]]


def test_llama_tp4_text_equals_jax(llama_weights, tmp_path_factory):
    plain, cfg, path = llama_weights
    port = _llama_ranks(4, path, tmp_path_factory.mktemp("tp4"))
    want = plain.generate_batch_continuous(GEN_PROMPTS, **TP4)
    jax_tp4 = jl.LlamaZeroShotClassifier(config=cfg, max_prompt_len=64,
                                         seed=11, mesh=_mesh((("tp", 4),)))
    assert jax_tp4.generate_batch_continuous(GEN_PROMPTS, **TP4) == want
    assert port["paged"] == want
    assert (port["kv_heads"], port["pool_heads"]) == (1, 1)
