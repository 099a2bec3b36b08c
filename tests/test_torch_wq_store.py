"""Streaming quantize-on-load and the quantized-checkpoint cache: the
port ≡ the JAX package, and the two share cache entries.

Checkpoints are crafted: tiny HF DistilBERT and Llama state dicts saved
with ``torch.save`` (the JAX tests' own helpers).  Checks: a cold load
misses and stores, a warm one hits with the same leaves; host staging
peaks at about one unit, below the float tree; the streamed tree equals
an eager quantize of the same tensors and JAX's streamed tree byte for
byte; a truncated ``.npy`` is evicted and the load streams again; a stale
schema misses; another scheme is another key; an entry written by either
package loads in the other to the same codes; the classifiers load
checkpoints through the stream.  Tolerance: none (codes and scales
exact).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from music_analyst_tpu.engines import wq_cache as jcache
from music_analyst_tpu.engines.checkpoint import (
    last_load_stats as jax_stats,
    load_quantized_params as jax_load,
)
from music_analyst_tpu.models import distilbert as jd
from music_analyst_tpu.models import llama as jl
from music_analyst_tpu_torch.engines import wq_cache
from music_analyst_tpu_torch.engines.checkpoint import (
    last_load_stats,
    load_quantized_params,
)
from music_analyst_tpu_torch.models import distilbert as td
from music_analyst_tpu_torch.models import llama as tl
from music_analyst_tpu_torch.ops.quant import (
    WQ_DEFAULT_GROUP,
    QuantizedParam,
    iter_tree,
    quantize_tree,
)
from test_distilbert_checkpoint import _hf_state_dict  # noqa: E402
from test_llama_checkpoint import _hf_state_dict as _llama_state_dict  # noqa: E402

CFG = td.DistilBertConfig.tiny()


@pytest.fixture()
def ckpt(tmp_path):
    path = tmp_path / "pytorch_model.bin"
    torch.save(_hf_state_dict(jd.DistilBertConfig.tiny()), path)
    return str(path)


def _load(path, scheme="int8", cache_dir=None, key=True):
    shapes = td.param_shapes(CFG)
    cache_key = (wq_cache.wq_key(path, "distilbert", scheme, WQ_DEFAULT_GROUP)
                 if cache_dir and key else None)
    return load_quantized_params(
        shapes, lambda: td.iter_hf_param_units(shapes, path, mmap=True),
        scheme, cache_dir=cache_dir, cache_key=cache_key)


def _jax_shapes():
    import jax
    import jax.numpy as jnp

    model = jd.DistilBertForSentiment(jd.DistilBertConfig.tiny())
    return jax.eval_shape(model.init, jax.random.key(0),
                          jnp.zeros((1, 64), jnp.int32),
                          jnp.ones((1,), jnp.int32))["params"]


def _jax_load(path, scheme="int8", cache_dir=None):
    shapes = _jax_shapes()
    key = jcache.wq_key(path, "distilbert", scheme, WQ_DEFAULT_GROUP)
    return jax_load(shapes, lambda: jd.iter_hf_param_units(shapes, path),
                    scheme, cache_dir=cache_dir, cache_key=key)


def _leaves(tree):
    """``{path: numpy}`` with quantized kernels split into codes/scales."""
    out = {}
    for path, leaf in iter_tree(tree):
        if hasattr(leaf, "scheme"):
            out[path + "/q"] = np.asarray(
                leaf.q.cpu() if isinstance(leaf.q, torch.Tensor) else leaf.q)
            out[path + "/scale"] = np.asarray(
                leaf.scale.cpu() if isinstance(leaf.scale, torch.Tensor)
                else leaf.scale)
        else:
            out[path] = np.asarray(
                leaf.cpu() if isinstance(leaf, torch.Tensor) else leaf)
    return out


def _assert_same(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert sorted(la) == sorted(lb)
    for path in la:
        assert la[path].dtype == lb[path].dtype, path
        assert np.array_equal(la[path], lb[path]), path


@pytest.mark.parametrize("scheme", ["int8", "int4"])
def test_cold_then_warm_is_cache_hit(ckpt, tmp_path, scheme):
    cache_dir = str(tmp_path / "cache")
    os.makedirs(cache_dir)
    cold = _load(ckpt, scheme, cache_dir)
    st = last_load_stats()
    assert st["cache"] == "miss" and st["cache_stored"]
    assert st["scheme"] == scheme
    warm = _load(ckpt, scheme, cache_dir)
    assert last_load_stats()["cache"] == "hit"
    _assert_same(cold, warm)
    qp = warm["encoder"]["layer_0"]["attention"]["o_proj"]["kernel"]
    assert isinstance(qp, QuantizedParam) and qp.n_contract == 2


def test_peak_staging_is_one_unit(ckpt):
    _load(ckpt)
    st = last_load_stats()
    total_float = sum(int(np.prod(leaf.shape)) * 4
                      for _, leaf in iter_tree(td.param_shapes(CFG)))
    unit_bytes = {}
    for name, leaves in td.iter_hf_param_units(td.param_shapes(CFG), ckpt):
        unit_bytes[name] = sum(a.nbytes for _, a in leaves)
    assert st["units"] == CFG.n_layers + 2
    assert st["cache"] == "off"
    # At most the units in flight (prefetch depth 2 + the one being
    # quantized), and below the whole float tree.
    assert 0 < st["peak_host_staging_bytes"] <= 3 * max(unit_bytes.values())
    assert st["peak_host_staging_bytes"] < total_float


@pytest.mark.parametrize("scheme", ["int8", "int4"])
def test_loaded_tree_matches_eager_quantize_and_jax(ckpt, scheme):
    streamed = _load(ckpt, scheme)
    eager = {}
    for _, leaves in td.iter_hf_param_units(td.param_shapes(CFG), ckpt):
        for path, arr in leaves:
            parts = path.split("/")
            node = eager
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = arr
    _assert_same(streamed, quantize_tree(eager, scheme))
    _assert_same(streamed, _jax_load(ckpt, scheme))


def test_truncated_npy_entry_evicted_and_reloaded(ckpt, tmp_path):
    cache_dir = str(tmp_path / "cache")
    os.makedirs(cache_dir)
    _load(ckpt, cache_dir=cache_dir)
    key = wq_cache.wq_key(ckpt, "distilbert", "int8", WQ_DEFAULT_GROUP)
    entry = os.path.join(cache_dir, key)
    victim = next(os.path.join(entry, n) for n in sorted(os.listdir(entry))
                  if n.endswith(".q.npy"))
    with open(victim, "r+b") as fh:
        fh.truncate(16)
    before = wq_cache.cache_stats()["corrupt"]
    _load(ckpt, cache_dir=cache_dir)
    assert last_load_stats()["cache"] == "miss"
    assert wq_cache.cache_stats()["corrupt"] == before + 1
    _load(ckpt, cache_dir=cache_dir)
    assert last_load_stats()["cache"] == "hit"


def test_stale_schema_misses_and_scheme_changes_key(ckpt, tmp_path):
    cache_dir = str(tmp_path / "cache")
    os.makedirs(cache_dir)
    _load(ckpt, cache_dir=cache_dir)
    key = wq_cache.wq_key(ckpt, "distilbert", "int8", WQ_DEFAULT_GROUP)
    meta = os.path.join(cache_dir, key, "meta.json")
    with open(meta, encoding="utf-8") as fh:
        doc = json.load(fh)
    doc["schema"] = -1
    with open(meta, "w", encoding="utf-8") as fh:
        json.dump(doc, fh)
    _load(ckpt, cache_dir=cache_dir)
    assert last_load_stats()["cache"] == "miss"
    # Keys equal JAX's; another scheme (or group) is another key; a byte
    # flip of the checkpoint changes it.
    for scheme, group in (("int8", 128), ("int4", 128), ("int4", 64)):
        assert (wq_cache.wq_key(ckpt, "llama", scheme, group)
                == jcache.wq_key(ckpt, "llama", scheme, group))
    k4 = wq_cache.wq_key(ckpt, "distilbert", "int4", WQ_DEFAULT_GROUP)
    assert k4 != key
    _load(ckpt, "int4", cache_dir=cache_dir)
    assert last_load_stats()["cache"] == "miss"
    with open(ckpt, "r+b") as fh:
        fh.seek(100)
        b = fh.read(1)
        fh.seek(100)
        fh.write(bytes([b[0] ^ 1]))
    assert wq_cache.wq_key(ckpt, "distilbert", "int8", WQ_DEFAULT_GROUP) != key


@pytest.mark.parametrize("scheme", ["int8", "int4"])
def test_entries_are_interchangeable_with_jax(ckpt, tmp_path, scheme):
    # JAX writes, the port reads.
    jdir = str(tmp_path / "jax_wrote")
    os.makedirs(jdir)
    jtree = _jax_load(ckpt, scheme, cache_dir=jdir)
    assert jax_stats()["cache_stored"]
    from_jax = _load(ckpt, scheme, cache_dir=jdir)
    assert last_load_stats()["cache"] == "hit"
    _assert_same(from_jax, jtree)
    # The port writes, JAX reads.
    pdir = str(tmp_path / "port_wrote")
    os.makedirs(pdir)
    ptree = _load(ckpt, scheme, cache_dir=pdir)
    assert last_load_stats()["cache_stored"]
    back = _jax_load(ckpt, scheme, cache_dir=pdir)
    assert jax_stats()["cache"] == "hit"
    _assert_same(back, ptree)


def test_cache_dir_resolution(monkeypatch, tmp_path):
    assert wq_cache.resolve_cache_dir(str(tmp_path)) == str(tmp_path)
    assert wq_cache.resolve_cache_dir(str(tmp_path), use_cache=False) is None
    for off in ("0", "off", "False", "no"):
        monkeypatch.setenv("MUSICAAL_WQ_CACHE", off)
        assert wq_cache.resolve_cache_dir() is None
    monkeypatch.setenv("MUSICAAL_WQ_CACHE", str(tmp_path / "env"))
    assert wq_cache.resolve_cache_dir() == str(tmp_path / "env")
    monkeypatch.delenv("MUSICAAL_WQ_CACHE")
    monkeypatch.setenv("HOME", str(tmp_path))
    assert wq_cache.resolve_cache_dir() == str(tmp_path / ".cache"
                                               / "musicaal_wq")
    assert wq_cache.resolve_cache_dir() == jcache.resolve_cache_dir()


@pytest.mark.parametrize("scheme", ["int8", "int4"])
def test_distilbert_classifier_streams_a_checkpoint(ckpt, tmp_path, scheme):
    texts = [f"song {i}: love and rain over the lonely city " * (1 + i % 3)
             for i in range(24)]
    jclf = jd.DistilBertClassifier(
        config=dataclasses.replace(jd.DistilBertConfig.tiny(),
                                   weight_quant=scheme),
        checkpoint_path=ckpt, max_len=64, wq_cache_dir=str(tmp_path / "j"))
    tclf = td.DistilBertClassifier(
        config=dataclasses.replace(CFG, weight_quant=scheme),
        checkpoint_path=ckpt, max_len=64, device="cpu",
        wq_cache_dir=str(tmp_path / "t"))
    assert tclf.pretrained and last_load_stats()["scheme"] == scheme
    layer = tclf.model.encoder.layers[1].attention.q_proj
    want = jclf.params["encoder"]["layer_1"]["attention"]["q_proj"]["kernel"]
    assert np.array_equal(layer.q.numpy(), np.asarray(want.q))
    assert np.array_equal(layer.scale.numpy(), np.asarray(want.scale))
    assert tclf.classify_batch(texts) == jclf.classify_batch(texts)


@pytest.mark.parametrize("scheme", ["int8", "int4"])
def test_llama_classifier_streams_a_checkpoint(tmp_path, scheme):
    cfg = jl.LlamaConfig.tiny()
    path = tmp_path / "pytorch_model.bin"
    torch.save(_llama_state_dict(cfg), path)
    jclf = jl.LlamaZeroShotClassifier(
        config=dataclasses.replace(cfg, weight_quant=scheme),
        checkpoint_path=str(path), max_prompt_len=64,
        wq_cache_dir=str(tmp_path / "j"))
    tclf = tl.LlamaZeroShotClassifier(
        config=tl.LlamaConfig.tiny(weight_quant=scheme),
        checkpoint_path=str(path), max_prompt_len=64, device="cpu",
        wq_cache_dir=str(tmp_path / "t"))
    st = last_load_stats()
    assert st["units"] == cfg.n_layers + 3 and st["cache"] == "miss"
    for name, mod in (("lm_head", tclf.model.lm_head),
                      ("layer_1", tclf.model.layers[1].feed_forward.down_proj)):
        node = jclf.params[name]
        want = node["kernel"] if name == "lm_head" else (
            node["feed_forward"]["down_proj"]["kernel"])
        assert np.array_equal(mod.q.numpy(), np.asarray(want.q))
        assert np.array_equal(mod.scale.numpy(), np.asarray(want.scale))
    # The warm load reads the port's own entry.
    tl.LlamaZeroShotClassifier(
        config=tl.LlamaConfig.tiny(weight_quant=scheme),
        checkpoint_path=str(path), max_prompt_len=64, device="cpu",
        wq_cache_dir=str(tmp_path / "t"))
    assert last_load_stats()["cache"] == "hit"
