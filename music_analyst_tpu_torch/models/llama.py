"""Llama-3-style decoder LM and the zero-shot sentiment backend (PyTorch).

Counterpart of ``music_analyst_tpu/models/llama.py``: pre-norm GQA decoder
blocks (RMSNorm, RoPE with contiguous halves, SwiGLU), an explicit KV cache,
and :class:`LlamaZeroShotClassifier`, which asks the model the reference's
Ollama prompt (``PROMPT_TEMPLATE``, lyrics cut at 4,000 characters) and
either scores the three label continuations (``decode_mode="score"``) or
generates greedy text and normalises its first word
(``decode_mode="generate"``; with ``continuous_slots`` through the paged
continuous scheduler, ``serving/decode_loop.py``, whose decode attention
is the paged CUDA kernel).

Numerics follow Flax: the model computes in ``config.dtype`` (bf16) with
f32 RMSNorm statistics and scales, and an f32 ``lm_head`` on f32
activations.  Storing the bf16 weights in bf16 is the same arithmetic as
Flax's f32 parameters cast to bf16 at use.  KV caches are bf16 whatever
the model dtype, as in the JAX package.  The f32 ``lm_head`` assumes TF32
is off for matmuls (PyTorch's default).

Weights: ``load_hf_torch_checkpoint`` (an HF ``LlamaForCausalLM`` state
dict, float weights), ``params_from_jax`` (a JAX parameter tree, for the
parity tests; stored ``QuantizedParam`` kernels included), else seeded
random weights drawn on the target device with the Flax initializers'
distributions.  Quantized inference: ``-int8`` (dynamic int8
projections) and ``weight_quant`` int8 / int4 (stored projection and
``lm_head`` kernels, ``models/layers.py:WqLinear``).  Under
``weight_quant`` random weights are drawn and quantized one kernel at a
time, and a checkpoint streams through quantize-on-load and the
quantized-checkpoint cache, so the float tree never exists whole.

``n_experts > 0`` replaces each block's SwiGLU with the routed experts of
``models/moe.py`` (``feed_forward_moe``).  ``attn_impl="flash"`` runs the
flash kernel on the no-cache path (the training loss and evaluation
forwards, ``engines/train.py``): attention there is causal with ``lengths``
and packed-document ``segment_ids``, and the mask array is not read.  The
kernel is forward only, as in JAX; the cache paths attend as before.

``mesh=`` (a ``parallel/mesh.DeviceMesh`` over ranks) runs the model with
tensor parallelism over its ``tp`` axis (other axes replicate, as the
JAX classifier's unsharded inputs do): each rank holds ``n_heads / tp``
query and ``n_kv_heads / tp`` KV heads, its block of the MLP hidden axis
and of the vocabulary (``parallel/sharding.py``); ``o_proj`` and
``down_proj`` all-reduce, the embedding all-reduces its masked lookup
and the f32 ``lm_head`` all-gathers the logits, so every rank sees the
same full logits and takes the same greedy tokens and scheduling
decisions.  KV caches and page pools hold the rank's own KV heads.
Random weights draw each full tensor from the one generator and keep the
rank's block, so every rank's weights are the unsharded model's.  Not
yet ported under a mesh: ``quant``, ``weight_quant`` and MoE.
"""

from __future__ import annotations

import dataclasses
import math
import os
import warnings
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from music_analyst_tpu_torch.device import DeviceLike, resolve_device
from music_analyst_tpu_torch.engines.sentiment import ClassifierBackend
from music_analyst_tpu_torch.models.layers import (
    KVCache,
    MultiHeadAttention,
    RMSNorm,
    SwiGLU,
    WqLinear,
    causal_mask,
    padding_mask,
    param_slots,
    use_float_slots_,
)
from music_analyst_tpu_torch.models.moe import MoESwiGLU
from music_analyst_tpu_torch.models.tokenization import (
    ByteTokenizer,
    resolve_llama_tokenizer,
)
from music_analyst_tpu_torch.models.tree import as_tensor, f32, put_kernel
from music_analyst_tpu_torch.ops.quant import WQ_DEFAULT_GROUP
from music_analyst_tpu_torch.parallel.mesh import DeviceMesh
from music_analyst_tpu_torch.parallel.sharding import (
    local_kv_heads,
    shard_params,
    shard_state_dict,
)
from music_analyst_tpu_torch.runtime.wire import count_h2d_bytes
from music_analyst_tpu_torch.utils.labels import SUPPORTED_LABELS, normalise_label
from music_analyst_tpu_torch.utils.shapes import round_pow2

# Reference prompt, scripts/sentiment_classifier.py:32-36.
PROMPT_TEMPLATE = (
    "You are an expert music analyst. Classify the overall sentiment of the "
    "following song lyrics as one of the following labels: Positive, "
    "Neutral, or Negative. Respond using only the label name with no "
    "explanations.\n\nLyrics:\n{lyrics}\n"
)
LYRICS_TRUNCATION = 4000

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128_256
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    hidden_dim: int = 14_336
    rope_theta: float = 500_000.0
    max_seq_len: int = 8192
    dtype: str = "bfloat16"
    # > 0 replaces the dense SwiGLU with a routed mixture of experts
    # (models/moe.py): top-k, "sparse" (capacity-bounded) or "dense"
    # (all-experts oracle) dispatch, buffer slots per expert scaled by the
    # capacity factor.
    n_experts: int = 0
    moe_top_k: int = 2
    moe_dispatch: str = "sparse"
    moe_capacity_factor: float = 1.25
    # "flash" runs the flash kernel on the no-cache path (forward only).
    attn_impl: str = "dense"
    # "int8" = dynamic-quant attention/MLP projections (ops/quant.py).
    quant: str = "none"
    # "int8"/"int4" = stored weight-quantized projection + lm_head kernels.
    weight_quant: str = "none"

    def __post_init__(self):
        if self.weight_quant not in ("none", "int8", "int4"):
            raise ValueError(
                f"weight_quant must be none/int8/int4, got "
                f"{self.weight_quant!r}"
            )
        if self.weight_quant != "none" and self.quant != "none":
            raise ValueError(
                "weight_quant and dynamic quant are mutually exclusive — "
                "the stored-weight path already runs the int8 matmul"
            )
        if self.weight_quant != "none" and self.n_experts > 0:
            raise ValueError(
                "weight_quant does not cover the MoE expert stacks yet; "
                "use the dynamic quant='int8' path for MoE configs"
            )
        if self.dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}")

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @classmethod
    def llama3_8b(cls) -> "LlamaConfig":
        return cls()

    @classmethod
    def tiny(cls, **overrides) -> "LlamaConfig":
        """Byte-vocab smoke config: same topology, laptop-sized."""
        return cls(**{**dict(
            vocab_size=512, dim=128, n_layers=2, n_heads=8, n_kv_heads=4,
            hidden_dim=256, rope_theta=10_000.0, max_seq_len=2048,
        ), **overrides})


PRESETS = {
    "llama3": LlamaConfig.llama3_8b,
    "llama3-8b": LlamaConfig.llama3_8b,
    "llama3-tiny": LlamaConfig.tiny,
    "llama-tiny": LlamaConfig.tiny,
}


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig) -> None:
        super().__init__()
        dtype = cfg.torch_dtype
        self.flash = cfg.attn_impl == "flash"
        self.moe = cfg.n_experts > 0
        self.attention = MultiHeadAttention(
            cfg.dim, cfg.n_heads, attn_impl=cfg.attn_impl, use_bias=False,
            dtype=dtype, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
            use_rope=True, rope_theta=cfg.rope_theta,
            max_positions=cfg.max_seq_len, quant=cfg.quant,
            weight_quant=cfg.weight_quant, flash_causal=True,
        )
        self.attention_norm = RMSNorm(cfg.dim)
        self.ffn_norm = RMSNorm(cfg.dim)
        if self.moe:
            # quant composes: the expert products, where the MoE FLOPs
            # are, run the per-expert int8 product.
            self.feed_forward_moe = MoESwiGLU(
                cfg.dim, cfg.n_experts, cfg.hidden_dim, top_k=cfg.moe_top_k,
                dtype=dtype, dispatch=cfg.moe_dispatch,
                capacity_factor=cfg.moe_capacity_factor, quant=cfg.quant)
        else:
            self.feed_forward = SwiGLU(cfg.dim, cfg.hidden_dim, dtype=dtype,
                                       quant=cfg.quant,
                                       weight_quant=cfg.weight_quant)

    def forward(self, x, mask, positions, cache=None, lengths=None,
                segment_ids=None):
        if segment_ids is not None and (cache is not None or not self.flash):
            # Refuse rather than attend across documents: the dense impl
            # takes packing as `causal & same-segment` in the mask array,
            # and the cache paths have no packed documents.
            raise ValueError(
                "segment_ids is consumed by the flash prefill path only; "
                "fold the segment mask into `mask` for the dense impl"
            )
        h = self.attention_norm(x)
        new_cache = None
        if cache is not None:
            attn_out, new_cache = self.attention(
                h, mask=mask, positions=positions, cache=cache)
        else:
            # Flash: causal + lengths (+ segment ids) describe the masking,
            # so the (causal & padding) mask array stays out.
            attn_out = self.attention(
                h, mask=None if self.flash else mask, positions=positions,
                lengths=lengths if self.flash else None,
                segment_ids=segment_ids)
        x = x + attn_out
        h = self.ffn_norm(x)
        ffn = self.feed_forward_moe if self.moe else self.feed_forward
        x = x + ffn(h)
        return x, new_cache


class LlamaModel(nn.Module):
    """Token ids ``[B, S]`` → f32 logits; ``mask`` is a bool array
    broadcastable to ``[B, H, S, KV]``.  With ``caches`` (one per layer:
    ``KVCache`` or ``PagedAttnView``) returns the advanced caches too.
    ``last_position [B]`` keeps one position per row before the vocab
    projection (``[B, 1, V]``): prefill callers read only the last prompt
    logits, and ``[B, S, V]`` in f32 is the largest tensor of the model.

    With ``attn_impl="flash"`` and no caches, ``mask`` is not applied:
    attention is causal, keys are masked by ``lengths [B]`` and, for packed
    documents, by ``segment_ids [B, S]`` (pair them with positions that
    restart at each document).  ``segment_ids`` is refused elsewhere."""

    def __init__(self, cfg: LlamaConfig) -> None:
        super().__init__()
        self.config = cfg
        self.tok_embeddings = nn.Embedding(cfg.vocab_size, cfg.dim,
                                           dtype=cfg.torch_dtype)
        self.layers = nn.ModuleList(LlamaBlock(cfg) for _ in range(cfg.n_layers))
        self.norm = RMSNorm(cfg.dim)
        if cfg.weight_quant != "none":
            self.lm_head = WqLinear(cfg.dim, cfg.vocab_size, cfg.weight_quant,
                                    bias=False, dtype=torch.float32,
                                    group_size=_wq_group_size())
        else:
            self.lm_head = nn.Linear(cfg.dim, cfg.vocab_size, bias=False,
                                     dtype=torch.float32)

    def forward(self, token_ids, positions, mask, caches=None,
                last_position=None, lengths=None, segment_ids=None):
        x = self.tok_embeddings(token_ids.long())
        new_caches = []
        for i, layer in enumerate(self.layers):
            x, new_cache = layer(x, mask, positions,
                                 caches[i] if caches is not None else None,
                                 lengths=lengths, segment_ids=segment_ids)
            if new_cache is not None:
                new_caches.append(new_cache)
        x = self.norm(x)
        if last_position is not None:
            idx = last_position.long()[:, None, None].expand(-1, 1, x.shape[-1])
            x = torch.gather(x, 1, idx)
        logits = self.lm_head(x.float())
        return logits, (new_caches if caches is not None else None)


def init_caches(cfg: LlamaConfig, batch: int, max_len: int,
                dtype: torch.dtype = torch.bfloat16, device=None,
                n_kv_heads: Optional[int] = None) -> List[KVCache]:
    """Zeroed per-layer caches; ``n_kv_heads`` is a rank's own head count
    under tensor parallelism (default: the config's)."""
    return [
        KVCache.zeros(batch, max_len, n_kv_heads or cfg.n_kv_heads,
                      cfg.head_dim, dtype, device=device)
        for _ in range(cfg.n_layers)
    ]


@torch.no_grad()
def init_random_(model: LlamaModel, seed: int) -> None:
    """Seeded random weights with the Flax initializers' distributions,
    drawn on the parameters' own device from one generator: embeddings
    N(0, 1/dim); projections, the MoE router and expert stacks
    ``lecun_normal`` (normal truncated at two standard deviations, std
    sqrt(1/fan_in) / 0.8796, with Flax's fan-in: ``in`` of an ``nn.Linear``
    weight, ``E * in`` of an ``[E, in, out]`` stack); RMSNorm scales 1.
    Each tensor is drawn in f32 and then stored in its parameter's dtype,
    or quantized into a ``WqLinear``'s codes, one at a time, so no f32
    (nor, under ``weight_quant``, float) copy of the whole model exists.
    A tensor-parallel model (``model.tp_layout``) draws each sharded
    tensor whole and keeps its block, so the weights are the unsharded
    model's on every rank."""
    device = model.norm.weight.device
    gen = torch.Generator(device=device).manual_seed(seed)
    layout = getattr(model, "tp_layout", {})
    for name, shape, owner in param_slots(model):
        if name.endswith("norm.weight"):
            model.get_parameter(name).fill_(1.0)
            continue
        piece = layout.get(name)
        if piece is not None:
            shape = piece.full_shape
        value = torch.empty(shape, dtype=torch.float32, device=device)
        if name == "tok_embeddings.weight":
            value.normal_(0.0, shape[1] ** -0.5, generator=gen)
        else:
            nn.init.trunc_normal_(value, 0.0, 1.0, -2.0, 2.0, generator=gen)
            # nn.Linear weights are [out, in]; expert stacks [E, in, out].
            fan_in = shape[1] if len(shape) == 2 else math.prod(shape[:-1])
            value.mul_(math.sqrt(1.0 / fan_in) / 0.87962566103423978)
        if piece is not None:
            value = piece.take(value)
        if isinstance(owner, WqLinear):
            owner.quantize_from_(value)
        else:
            model.get_parameter(name).copy_(value)
        del value


def params_from_jax(tree: Mapping) -> Dict[str, object]:
    """Map the JAX ``LlamaModel`` parameter tree onto this model's
    ``state_dict``: Flax ``[in, out]`` kernels transpose to torch
    ``[out, in]``; ``q/k/v_proj`` kernels ``[dim, H, Dh]`` and ``o_proj``
    ``[H, Dh, dim]`` flatten their head axes; stored quantized kernels
    keep their Flax layout as ``.q`` / ``.scale`` (``WqLinear``)."""
    out: Dict[str, object] = {
        "tok_embeddings.weight": f32(tree["tok_embeddings"]["embedding"]),
        "norm.weight": f32(tree["norm"]["scale"]),
    }
    put_kernel(out, "lm_head", tree["lm_head"]["kernel"])
    n_layers = sum(1 for k in tree if k.startswith("layer_"))
    for i in range(n_layers):
        src = tree[f"layer_{i}"]
        dst = f"layers.{i}"
        att = src["attention"]
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            put_kernel(out, f"{dst}.attention.{proj}", att[proj]["kernel"],
                       n_contract=2 if proj == "o_proj" else 1)
        out[f"{dst}.attention_norm.weight"] = f32(src["attention_norm"]["scale"])
        out[f"{dst}.ffn_norm.weight"] = f32(src["ffn_norm"]["scale"])
        if "feed_forward_moe" in src:
            moe = src["feed_forward_moe"]
            for stack in ("gate_experts", "up_experts", "down_experts"):
                out[f"{dst}.feed_forward_moe.{stack}"] = f32(moe[stack])
            put_kernel(out, f"{dst}.feed_forward_moe.router",
                       moe["router"]["kernel"])
            continue
        for lin in ("gate_proj", "up_proj", "down_proj"):
            put_kernel(out, f"{dst}.feed_forward.{lin}",
                       src["feed_forward"][lin]["kernel"])
    return out


def param_shapes(cfg: LlamaConfig) -> Dict:
    """The Flax parameter tree's structure, with ``meta`` tensors of each
    leaf's float shape (the port's ``jax.eval_shape`` of ``model.init``)."""
    def leaf(*shape):
        return torch.empty(shape, device="meta")

    D, H, Hkv, Dh = cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    F, E = cfg.hidden_dim, cfg.n_experts

    def ffn():
        if E > 0:
            return {"feed_forward_moe": {
                "gate_experts": leaf(E, D, F), "up_experts": leaf(E, D, F),
                "down_experts": leaf(E, F, D),
                "router": {"kernel": leaf(D, E)}}}
        return {"feed_forward": {"gate_proj": {"kernel": leaf(D, F)},
                                 "up_proj": {"kernel": leaf(D, F)},
                                 "down_proj": {"kernel": leaf(F, D)}}}

    tree: Dict = {"tok_embeddings": {"embedding": leaf(cfg.vocab_size, D)}}
    for i in range(cfg.n_layers):
        tree[f"layer_{i}"] = {
            "attention": {"q_proj": {"kernel": leaf(D, H, Dh)},
                          "k_proj": {"kernel": leaf(D, Hkv, Dh)},
                          "v_proj": {"kernel": leaf(D, Hkv, Dh)},
                          "o_proj": {"kernel": leaf(H, Dh, D)}},
            "attention_norm": {"scale": leaf(D)},
            "ffn_norm": {"scale": leaf(D)},
            **ffn(),
        }
    tree["norm"] = {"scale": leaf(D)}
    tree["lm_head"] = {"kernel": leaf(D, cfg.vocab_size)}
    return tree


def load_torch_state_dict(path: str, mmap: bool = False) -> dict:
    """Merge a ``pytorch_model.bin``-style file or a directory of shards
    (``pytorch_model*.bin`` / ``*.pt``) into one raw state dict.  With
    ``mmap`` the tensors stay memory-mapped (pages are read as a unit
    touches them); formats torch cannot map load eagerly."""
    if os.path.isdir(path):
        names = sorted(os.listdir(path))
        shards = [n for n in names
                  if n.startswith("pytorch_model") and n.endswith(".bin")]
        if not shards:
            shards = [n for n in names
                      if n.endswith((".bin", ".pt"))
                      and n not in ("training_args.bin", "optimizer.pt",
                                    "scheduler.pt", "rng_state.pth")]
        shards = [os.path.join(path, n) for n in shards]
        if not shards:
            raise FileNotFoundError(f"no *.bin/*.pt weight shards under {path}")
    else:
        shards = [path]
    sd = {}
    for shard in shards:
        try:
            loaded = None
            if mmap:
                try:
                    loaded = torch.load(shard, map_location="cpu",
                                        weights_only=True, mmap=True)
                except (RuntimeError, ValueError):
                    loaded = None
            if loaded is None:
                loaded = torch.load(shard, map_location="cpu",
                                    weights_only=True)
        except Exception as exc:
            raise RuntimeError(f"failed to load shard {shard}") from exc
        if isinstance(loaded, dict):
            sd.update(loaded)
    if not sd:
        raise ValueError(f"no tensors found in {path} — not a torch state_dict?")
    return sd


def iter_hf_param_units(params, path: str, mmap: bool = False):
    """Yield an HF ``LlamaForCausalLM`` checkpoint as per-unit leaf lists
    in Flax paths and layouts: ``(unit_name, [(tree_path, np.ndarray),
    ...])`` for the embeddings, each decoder layer, the final norm and the
    ``lm_head`` (tied to the embeddings when the checkpoint has none).
    Linear kernels ``[out, in]`` transpose to ``[in, out]``; attention
    projections reshape to the head layout.  ``params`` supplies shapes
    only (:func:`param_shapes`)."""
    sd = load_torch_state_dict(path, mmap=mmap)
    sd = {(k[len("model."):] if k.startswith("model.") else k): v
          for k, v in sd.items()}

    def t(name):
        return np.asarray(sd[name].to(torch.float32).numpy())

    dim = params["tok_embeddings"]["embedding"].shape[1]
    embed = t("embed_tokens.weight")
    want = tuple(params["tok_embeddings"]["embedding"].shape)
    if embed.shape != want:
        raise ValueError(
            f"checkpoint embed_tokens is {embed.shape} but the model config "
            f"expects {want} — config (vocab_size/dim) doesn't match the "
            "checkpoint"
        )
    yield "tok_embeddings", [("tok_embeddings/embedding", embed)]
    n_layers = sum(1 for k in params if k.startswith("layer_"))
    for i in range(n_layers):
        hf = f"layers.{i}"
        attn = params[f"layer_{i}"]["attention"]
        n_heads = attn["q_proj"]["kernel"].shape[1]
        n_kv = attn["k_proj"]["kernel"].shape[1]
        head_dim = attn["q_proj"]["kernel"].shape[2]
        pre = f"layer_{i}"
        yield pre, [
            (f"{pre}/attention/q_proj/kernel",
             t(f"{hf}.self_attn.q_proj.weight").T.reshape(
                 dim, n_heads, head_dim)),
            (f"{pre}/attention/k_proj/kernel",
             t(f"{hf}.self_attn.k_proj.weight").T.reshape(
                 dim, n_kv, head_dim)),
            (f"{pre}/attention/v_proj/kernel",
             t(f"{hf}.self_attn.v_proj.weight").T.reshape(
                 dim, n_kv, head_dim)),
            (f"{pre}/attention/o_proj/kernel",
             t(f"{hf}.self_attn.o_proj.weight").T.reshape(
                 n_heads, head_dim, dim)),
            (f"{pre}/attention_norm/scale", t(f"{hf}.input_layernorm.weight")),
            (f"{pre}/ffn_norm/scale",
             t(f"{hf}.post_attention_layernorm.weight")),
            (f"{pre}/feed_forward/gate_proj/kernel",
             t(f"{hf}.mlp.gate_proj.weight").T),
            (f"{pre}/feed_forward/up_proj/kernel",
             t(f"{hf}.mlp.up_proj.weight").T),
            (f"{pre}/feed_forward/down_proj/kernel",
             t(f"{hf}.mlp.down_proj.weight").T),
        ]
    yield "norm", [("norm/scale", t("norm.weight"))]
    if "lm_head.weight" in sd:
        lm = t("lm_head.weight").T
    else:  # tied embeddings (Llama-3.2 style)
        lm = t("embed_tokens.weight").T
    yield "lm_head", [("lm_head/kernel", lm)]


def _wq_group_size() -> int:
    """One group-size definition for the Llama family, so the cache key,
    the loader and the random-init quantizer agree."""
    return WQ_DEFAULT_GROUP


_HF_RENAMES = (
    ("embed_tokens.", "tok_embeddings."),
    (".self_attn.", ".attention."),
    (".input_layernorm.", ".attention_norm."),
    (".post_attention_layernorm.", ".ffn_norm."),
    (".mlp.", ".feed_forward."),
)


@torch.no_grad()
def load_hf_torch_checkpoint(model: LlamaModel, path: str) -> None:
    """Load an HF ``LlamaForCausalLM`` torch state dict (float weights)
    into ``model``.  HF's ``[out, in]`` layout is this module's, and HF's
    ``rotate_half`` RoPE is :func:`apply_rope`'s, so only names change.  A
    checkpoint without ``lm_head.weight`` ties it to the embeddings.
    Every parameter must be filled and every tensor consumed."""
    sd = load_torch_state_dict(path)
    mapped = {}
    for key, value in sd.items():
        if key.endswith("rotary_emb.inv_freq"):
            continue
        new = key[len("model."):] if key.startswith("model.") else key
        for old, rep in _HF_RENAMES:
            new = new.replace(old, rep)
        mapped[new] = value
    if "lm_head.weight" not in mapped and "tok_embeddings.weight" in mapped:
        mapped["lm_head.weight"] = mapped["tok_embeddings.weight"]
    params = dict(model.named_parameters())
    layout = getattr(model, "tp_layout", {})
    embed = mapped.get("tok_embeddings.weight")
    want = tuple(params["tok_embeddings.weight"].shape)
    if "tok_embeddings.weight" in layout:
        want = layout["tok_embeddings.weight"].full_shape
    if embed is not None and tuple(embed.shape) != want:
        raise ValueError(
            f"checkpoint embed_tokens is {tuple(embed.shape)} but the model "
            f"config expects {want} — config (vocab_size/dim) doesn't match "
            "the checkpoint"
        )
    leftovers = set(mapped) - set(params)
    missing = set(params) - set(mapped)
    if leftovers or missing:
        raise ValueError(
            "checkpoint does not match the Llama mapping: unconsumed "
            f"{sorted(leftovers)[:8]}, missing {sorted(missing)[:8]}"
        )
    for name, param in params.items():
        value = mapped[name]
        if not value.is_floating_point():
            raise TypeError(f"{name}: float weights only, got {value.dtype}")
        if name in layout:
            value = layout[name].take(value)
        param.copy_(value.to(torch.float32))


class LlamaZeroShotClassifier(ClassifierBackend):
    """Zero-shot sentiment over the decoder LM on one device, or tensor
    parallel over a mesh of ranks (``mesh=``)."""

    name = "llama"

    def __init__(
        self,
        config: Optional[LlamaConfig] = None,
        checkpoint_path: Optional[str] = None,
        max_prompt_len: int = 1024,
        mesh=None,
        seed: int = 0,
        decode_mode: str = "score",
        continuous_slots: Optional[int] = None,
        device: DeviceLike = "cuda",
        state_dict: Optional[Mapping[str, np.ndarray]] = None,
        wq_cache_dir: Optional[str] = None,
    ) -> None:
        if decode_mode not in ("score", "generate"):
            raise ValueError(
                f"decode_mode must be 'score' or 'generate', got "
                f"{decode_mode!r}"
            )
        if mesh is not None and not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh must be a DeviceMesh, got "
                            f"{type(mesh).__name__}")
        cfg = config or LlamaConfig.tiny()
        if mesh is not None and (cfg.quant != "none"
                                 or cfg.weight_quant != "none"
                                 or cfg.n_experts > 0):
            raise NotImplementedError(
                "quant, weight_quant and MoE (n_experts > 0) under a mesh "
                "are not yet ported to music_analyst_tpu_torch")
        self.mesh = mesh
        if mesh is not None:
            device = mesh.device
        self.decode_mode = decode_mode
        # > 0 routes batch generation through the continuous paged
        # scheduler at that slot count; $MUSICAAL_CONTINUOUS_SLOTS is the
        # fallback, as in the JAX package.
        if continuous_slots is None:
            env = os.environ.get("MUSICAAL_CONTINUOUS_SLOTS", "").strip()
            if env:
                try:
                    continuous_slots = int(env)
                except ValueError:
                    raise ValueError(
                        f"MUSICAAL_CONTINUOUS_SLOTS must be an integer, "
                        f"got {env!r}"
                    ) from None
        self.continuous_slots = int(continuous_slots or 0)
        self._slot_schedulers: dict = {}
        self.device = resolve_device(device)
        self.config = config or LlamaConfig.tiny()
        self.max_prompt_len = max_prompt_len
        self.tokenizer = resolve_llama_tokenizer(self.config.vocab_size)
        if self.tokenizer.vocab_size > self.config.vocab_size:
            message = (
                f"tokenizer vocab ({self.tokenizer.vocab_size}) exceeds "
                f"model vocab ({self.config.vocab_size})"
            )
            if checkpoint_path:
                raise ValueError(message)
            warnings.warn(message + "; out-of-range ids will fail",
                          stacklevel=2)
        with torch.device("meta"):
            model = LlamaModel(self.config)
        if mesh is not None:
            shard_params(model, mesh)
        # The KV heads this rank's caches hold.
        self.kv_heads = local_kv_heads(mesh, self.config.n_kv_heads)
        self.pretrained = False
        wq = self.config.weight_quant
        if checkpoint_path and wq != "none" and state_dict is None:
            # Streaming quantize-on-load: checkpoint tensors go through
            # quantize → H2D one layer at a time, and a warm quantized-cache
            # entry skips torch.load entirely.
            from music_analyst_tpu_torch.engines import wq_cache
            from music_analyst_tpu_torch.engines.checkpoint import (
                load_quantized_params,
            )

            shapes = param_shapes(self.config)
            cache_dir = wq_cache.resolve_cache_dir(wq_cache_dir)
            cache_key = (
                wq_cache.wq_key(checkpoint_path, "llama", wq,
                                _wq_group_size())
                if cache_dir else None
            )
            state_dict = params_from_jax(load_quantized_params(
                shapes,
                lambda: iter_hf_param_units(shapes, checkpoint_path,
                                            mmap=True),
                wq, group_size=_wq_group_size(), device=self.device,
                cache_dir=cache_dir, cache_key=cache_key,
            ))
            self.pretrained = True
        if state_dict is not None:
            use_float_slots_(model, state_dict)
        model = model.to_empty(device=self.device)
        if state_dict is not None:
            state_dict = {k: as_tensor(v) for k, v in state_dict.items()}
            with torch.no_grad():
                model.load_state_dict(
                    shard_state_dict(state_dict, model.tp_layout)
                    if mesh is not None else state_dict)
        elif checkpoint_path:
            load_hf_torch_checkpoint(model, checkpoint_path)
            self.pretrained = True
        else:
            init_random_(model, seed)
        self.model = model.eval().requires_grad_(False)
        if self.pretrained and isinstance(self.tokenizer, ByteTokenizer):
            warnings.warn(
                "real checkpoint loaded but no matching tokenizer found "
                "— byte-level ids won't line up with the checkpoint's "
                "BPE vocabulary; set MUSICAAL_LLAMA_TOKENIZER to the "
                "checkpoint's tokenizer directory for meaningful labels",
                stacklevel=2,
            )
        # Label continuations, padded to one length 8 (scored as a batch).
        bos_id = getattr(self.tokenizer, "bos_id", None)
        label_rows, label_lens = [], []
        for label in SUPPORTED_LABELS:
            row, n = self.tokenizer.encode(label, 16)
            skip = 1 if (n > 0 and bos_id is not None and row[0] == bos_id) else 0
            label_rows.append(row[skip:skip + 8])
            label_lens.append(min(n - skip, 8))
        self._label_ids = np.stack(label_rows)
        self._label_lens = np.array(label_lens, dtype=np.int32)

    @classmethod
    def from_pretrained_or_random(cls, model: str, **kwargs):
        """Resolve ``--model llama3[-8b|-tiny][-int8]`` / ``llama-tiny``
        (``-int8``: dynamic int8 projections; ``weight_quant``: stored
        int8 / int4 kernels).  The
        checkpoint comes from ``checkpoint_path`` or ``$MUSICAAL_LLAMA_CKPT``;
        the 8B presets refuse to run without one (random 8B weights are
        for ``chip_smoke.py``, which builds the classifier directly)."""
        quant = "none"
        if model.endswith("-int8"):
            model, quant = model[: -len("-int8")], "int8"
        preset = PRESETS.get(model)
        if preset is None:
            raise ValueError(
                f"unknown llama preset {model!r}; options: {sorted(PRESETS)}"
            )
        config = kwargs.pop("config", None) or preset()
        if quant != "none":
            config = dataclasses.replace(config, quant=quant)
        weight_quant = kwargs.pop("weight_quant", "none") or "none"
        if weight_quant != "none":
            config = dataclasses.replace(config, weight_quant=weight_quant)
        ckpt = kwargs.pop("checkpoint_path", None) or os.environ.get(
            "MUSICAAL_LLAMA_CKPT"
        )
        if model in ("llama3", "llama3-8b") and not ckpt:
            raise RuntimeError(
                "llama3-8b needs a checkpoint (set MUSICAAL_LLAMA_CKPT); use "
                "--model llama3-tiny for smoke runs or --mock for the "
                "keyword kernel"
            )
        return cls(config=config, checkpoint_path=ckpt, **kwargs)

    # ------------------------------------------------------------ prompts

    def _trim_prompt_pad(self, ids, lens):
        """Cut tokenizer padding to the smallest power of two (floor 64)
        that covers the batch's longest prompt, capped at
        ``max_prompt_len``; padding is masked either way."""
        longest = int(lens.max()) if len(lens) else 1
        width = min(round_pow2(longest, 64), self.max_prompt_len)
        return ids[:, :width], lens

    def _prompts(self, texts: Sequence[str]) -> List[str]:
        return [PROMPT_TEMPLATE.format(lyrics=t.strip()[:LYRICS_TRUNCATION])
                for t in texts]

    def _encode_prompts(self, texts: Sequence[str]):
        ids, lens = self.tokenizer.encode_batch(self._prompts(texts),
                                                self.max_prompt_len)
        return self._trim_prompt_pad(ids, lens)

    def _tensor(self, array, dtype=torch.int64) -> torch.Tensor:
        return torch.as_tensor(np.asarray(array), dtype=dtype,
                               device=self.device)

    # -------------------------------------------------------------- score

    @torch.no_grad()
    def score_labels(self, prompt_ids: torch.Tensor,
                     prompt_lens: torch.Tensor) -> torch.Tensor:
        """Length-normalised log-likelihood ``[B, 3]`` of each label
        continuation after each prompt: one prompt prefill, then one
        teacher-forced pass per label over the prompt's cache."""
        cfg = self.config
        B, S = prompt_ids.shape
        label_ids = self._tensor(self._label_ids)
        label_lens = self._tensor(self._label_lens)
        L = label_ids.shape[1]
        dev = prompt_ids.device
        lens = prompt_lens.long()
        positions = torch.arange(S, device=dev).expand(B, S)
        pad = padding_mask(lens, S)
        pad = torch.cat([pad, torch.zeros(B, 1, 1, L, dtype=torch.bool,
                                          device=dev)], dim=-1)
        mask = causal_mask(S, S + L, 0, device=dev) & pad
        caches = init_caches(cfg, B, S + L, device=dev,
                             n_kv_heads=self.kv_heads)
        logits, caches = self.model(prompt_ids, positions, mask, caches,
                                    last_position=lens - 1)
        caches = [KVCache(c.keys, c.values, S) for c in caches]
        first_logp = torch.log_softmax(logits[:, 0], dim=-1)
        kv_pos = torch.arange(S + L, device=dev)[None, None, None, :]
        prompt_part = kv_pos < lens[:, None, None, None]
        label_part = (kv_pos >= S) & (
            kv_pos - S <= torch.arange(L, device=dev)[None, None, :, None])
        mask2 = prompt_part | label_part
        pos = lens[:, None] + torch.arange(L, device=dev)[None, :]
        idx = torch.arange(L - 1, device=dev)[None, :]
        scores = []
        for j in range(label_ids.shape[0]):
            lab = label_ids[j][None, :].expand(B, L)
            # The label pass writes cache rows S..S+L in place before it
            # attends to them, so each label starts from the prompt's cache.
            logits2, _ = self.model(lab, pos, mask2, caches)
            logp_all = torch.log_softmax(logits2, dim=-1)
            first_lp = first_logp.gather(1, lab[:, :1])[:, 0]
            rest_lp = logp_all[:, :-1].gather(2, lab[:, 1:, None])[:, :, 0]
            rest_lp = torch.where(idx < label_lens[j] - 1, rest_lp,
                                  torch.zeros_like(rest_lp))
            total = first_lp + rest_lp.sum(dim=1)
            scores.append(total / label_lens[j].clamp(min=1).float())
        return torch.stack(scores, dim=1)

    def classify_batch(self, texts: Sequence[str]) -> List[str]:
        if self.decode_mode == "generate":
            return self.classify_batch_by_generation(texts)
        if not len(texts):
            return []
        ids, lens = self._encode_prompts(texts)
        count_h2d_bytes([ids, lens])
        scores = self.score_labels(self._tensor(ids), self._tensor(lens))
        best = scores.argmax(dim=1).cpu().numpy()
        return ["Neutral" if not text.strip() else SUPPORTED_LABELS[int(i)]
                for text, i in zip(texts, best)]

    # ----------------------------------------------------------- generate

    @torch.no_grad()
    def generate(self, prompt: str, max_new_tokens: int = 16) -> str:
        """Greedy generation of one prompt, one step per token (the
        reference-semantics path and the differential oracle)."""
        ids, lens = self.tokenizer.encode_batch([prompt], self.max_prompt_len)
        S = self.max_prompt_len
        n = int(lens[0])
        dev = self.device
        caches = init_caches(self.config, 1, S + max_new_tokens, device=dev,
                             n_kv_heads=self.kv_heads)
        pad = torch.cat([padding_mask(self._tensor(lens), S),
                         torch.zeros(1, 1, 1, max_new_tokens,
                                     dtype=torch.bool, device=dev)], dim=-1)
        mask = causal_mask(S, S + max_new_tokens, 0, device=dev) & pad
        logits, caches = self.model(
            self._tensor(ids), torch.arange(S, device=dev)[None, :], mask,
            caches, last_position=self._tensor(lens) - 1)
        caches = [KVCache(c.keys, c.values, n) for c in caches]
        token = logits[:, 0].argmax(dim=-1)
        eos = getattr(self.tokenizer, "eos_id", ByteTokenizer.EOS)
        kv_pos = torch.arange(S + max_new_tokens, device=dev)[None, None, None, :]
        out_tokens: List[int] = []
        position = n
        for _ in range(max_new_tokens):
            out_tokens.append(int(token[0]))
            if out_tokens[-1] == eos:
                break
            pos = torch.full((1, 1), position, dtype=torch.long, device=dev)
            logits, caches = self.model(token[:, None], pos,
                                        kv_pos <= position, caches)
            token = logits[:, -1].argmax(dim=-1)
            position += 1
        return self.tokenizer.decode(out_tokens)

    @torch.no_grad()
    def _generate_tokens(self, prompts: Sequence[str], max_new_tokens: int = 16,
                        early_exit: bool = True) -> np.ndarray:
        """Static batched greedy decode: ``[B, max_new_tokens]`` token ids,
        EOS after a row's end.  Row ``b``'s decode token ``t`` sits in cache
        slot ``S + t`` at position ``len_b + t``.  ``early_exit`` stops
        once every row has emitted EOS, checked every 8 steps; the skipped
        steps would have emitted EOS, so the output is the same."""
        ids, lens = self.tokenizer.encode_batch(prompts, self.max_prompt_len)
        ids, lens = self._trim_prompt_pad(ids, lens)
        dev = self.device
        B, S = ids.shape
        total = S + max_new_tokens
        lens_t = self._tensor(lens)
        pad = torch.cat([padding_mask(lens_t, S),
                         torch.zeros(B, 1, 1, max_new_tokens,
                                     dtype=torch.bool, device=dev)], dim=-1)
        mask = causal_mask(S, total, 0, device=dev) & pad
        caches = init_caches(self.config, B, total, device=dev,
                             n_kv_heads=self.kv_heads)
        logits, caches = self.model(
            self._tensor(ids), torch.arange(S, device=dev).expand(B, S), mask,
            caches, last_position=lens_t - 1)
        caches = [KVCache(c.keys, c.values, S) for c in caches]
        eos = int(self.tokenizer.eos_id)
        token = logits[:, 0].argmax(dim=-1)
        done = token == eos
        kv_pos = torch.arange(total, device=dev)[None, None, None, :]
        prompt_part = kv_pos < lens_t[:, None, None, None]
        out = torch.full((max_new_tokens, B), eos, dtype=torch.long, device=dev)
        seg = min(8, max_new_tokens)
        for t in range(max_new_tokens):
            if early_exit and t % seg == 0 and bool(done.all()):
                break
            decode_part = (kv_pos >= S) & (kv_pos - S <= t)
            lg, caches = self.model(token[:, None], (lens_t + t)[:, None],
                                    prompt_part | decode_part, caches)
            nxt = lg[:, -1].argmax(dim=-1)
            done = done | (token == eos)
            out[t] = token
            token = torch.where(done, torch.full_like(nxt, eos), nxt)
        return out.T.cpu().numpy()

    def _decode_rows(self, tokens: np.ndarray) -> List[str]:
        eos = self.tokenizer.eos_id
        outs = []
        for row in tokens:
            ids_out = []
            for t in row:
                if t == eos:
                    break
                ids_out.append(int(t))
            outs.append(self.tokenizer.decode(ids_out))
        return outs

    def generate_batch(self, prompts: Sequence[str], max_new_tokens: int = 16,
                       early_exit: bool = True) -> List[str]:
        """Greedy generation for a whole static batch."""
        if not prompts:
            return []
        return self._decode_rows(
            self._generate_tokens(prompts, max_new_tokens, early_exit))

    # --------------------------------------------------------- continuous

    def slot_runtime(
        self,
        n_slots: int = 8,
        prefill_chunk: int = 64,
        max_new_tokens: int = 16,
        prompt_region: Optional[int] = None,
        decode_span: int = 4,
    ):
        """The monolithic slot runtime for this model (``ops/kv_slots.py``,
        ``page_size=0``).  Its presence is the capability probe the
        server uses (``hasattr(backend, "slot_runtime")``) to decide
        whether it can host the ``generate`` op."""
        from music_analyst_tpu_torch.ops.kv_slots import (
            SlotDecodeRuntime,
            SlotPlan,
        )

        chunk = max(1, min(int(prefill_chunk), self.max_prompt_len))
        if prompt_region is None:
            prompt_region = self.max_prompt_len
        region = min(int(prompt_region), self.max_prompt_len)
        region = max(chunk, chunk * ((region + chunk - 1) // chunk))
        plan = SlotPlan(
            n_slots=int(n_slots), prefill_chunk=chunk, prompt_region=region,
            max_new=int(max_new_tokens), decode_span=int(decode_span),
        )
        eos_id = getattr(self.tokenizer, "eos_id", ByteTokenizer.EOS)
        return SlotDecodeRuntime(self.model, self.config, plan, eos_id,
                                 mesh=self.mesh)

    def paged_runtime(
        self,
        n_slots: int = 8,
        prefill_chunk: int = 64,
        max_new_tokens: int = 16,
        prompt_region: Optional[int] = None,
        decode_span: int = 4,
        page_size: int = 16,
        kv_pages: int = 0,
        kv_quant: str = "none",
    ):
        """The paged decode runtime for this model (``ops/kv_pages.py``):
        the region is rounded to a multiple of the chunk and the page, and
        ``kv_pages=0`` sizes the pool to one full sequence per slot."""
        from music_analyst_tpu_torch.ops.kv_pages import (
            PagedDecodeRuntime,
            PagePlan,
        )

        chunk = max(1, min(int(prefill_chunk), self.max_prompt_len))
        if prompt_region is None:
            prompt_region = self.max_prompt_len
        region = min(int(prompt_region), self.max_prompt_len)
        region = max(chunk, chunk * ((region + chunk - 1) // chunk))
        page = min(round_pow2(max(1, int(page_size)), 1), region)
        unit = math.lcm(chunk, page)
        region = unit * ((region + unit - 1) // unit)
        pages_per_slot = region // page + -(-int(max_new_tokens) // page)
        n_pages = int(kv_pages) or int(n_slots) * pages_per_slot
        n_pages = max(n_pages, int(n_slots), pages_per_slot)
        plan = PagePlan(
            n_slots=int(n_slots), prefill_chunk=chunk, prompt_region=region,
            max_new=int(max_new_tokens), decode_span=int(decode_span),
            page_size=page, n_pages=n_pages,
        )
        eos_id = getattr(self.tokenizer, "eos_id", ByteTokenizer.EOS)
        return PagedDecodeRuntime(self.model, self.config, plan, eos_id,
                                  kv_quant=kv_quant, mesh=self.mesh)

    def generate_batch_continuous(
        self,
        prompts: Sequence[str],
        max_new_tokens: int = 16,
        n_slots: Optional[int] = None,
        prefill_chunk: int = 64,
        decode_span: int = 4,
        budgets: Optional[Sequence[int]] = None,
        page_size: Optional[int] = None,
        kv_pages: Optional[int] = None,
        kv_quant: Optional[str] = None,
        prefix_cache: bool = True,
        speculate_k: Optional[int] = None,
    ) -> List[str]:
        """Greedy generation through the continuous scheduler,
        synchronously: admit → chunked prefill → decode slots.  The KV
        cache is paged with prefix sharing by default; ``page_size=0``
        selects the monolithic slot cache (``ops/kv_slots.py``), and
        ``speculate_k > 0`` draft-and-verify speculative decoding.  The
        prompt region is the static path's padded width, so the KV
        geometry (and on the CPU every greedy token) matches
        :meth:`generate_batch` on every route.  One scheduler per
        geometry is kept for reuse."""
        from music_analyst_tpu_torch.serving.decode_loop import (
            ContinuousScheduler,
        )

        if not prompts:
            return []
        n_slots = int(n_slots or self.continuous_slots or 8)
        budgets = ([int(b) for b in budgets] if budgets is not None
                   else [int(max_new_tokens)] * len(prompts))
        if len(budgets) != len(prompts):
            raise ValueError("budgets must match prompts 1:1")
        _, lens = self.tokenizer.encode_batch(prompts, self.max_prompt_len)
        longest = int(lens.max()) if len(lens) else 1
        region = min(round_pow2(longest, 64), self.max_prompt_len)
        chunk = min(int(prefill_chunk), region)
        cap = max(1, max(budgets))
        key = (n_slots, chunk, region, cap, int(decode_span), page_size,
               kv_pages, kv_quant, bool(prefix_cache), speculate_k)
        sched = self._slot_schedulers.get(key)
        if sched is None:
            sched = ContinuousScheduler(
                self, n_slots=n_slots, prefill_chunk=chunk,
                prompt_region=region, max_new_tokens=cap,
                decode_span=int(decode_span),
                max_queue=max(len(prompts), 64), page_size=page_size,
                kv_pages=kv_pages, kv_quant=kv_quant,
                prefix_cache=prefix_cache, speculate_k=speculate_k,
            )
            self._slot_schedulers[key] = sched
        reqs = [sched.submit(i, prompt, max_new_tokens=budget)
                for i, (prompt, budget) in enumerate(zip(prompts, budgets))]
        sched.run_until_idle()
        outs = []
        for req in reqs:
            resp = req.response or {}
            if not resp.get("ok"):
                raise RuntimeError(
                    f"continuous generation failed for prompt {req.id}: "
                    f"{resp.get('error', 'unknown error')}"
                )
            outs.append(resp["text"])
        return outs

    def classify_by_generation(self, text: str) -> str:
        """Reference semantics: generate text, normalise its first word."""
        return normalise_label(self.generate(self._prompts([text])[0]))

    def classify_batch_by_generation(self, texts: Sequence[str]) -> List[str]:
        """Reference generation semantics at batch speed: greedy decode of
        16 tokens (continuous when ``continuous_slots`` is set), then the
        shared label normaliser; empty lyrics are ``Neutral``."""
        prompts = self._prompts(texts)
        if self.continuous_slots:
            generations = self.generate_batch_continuous(
                prompts, max_new_tokens=16, n_slots=self.continuous_slots)
        else:
            generations = self.generate_batch(prompts, max_new_tokens=16)
        return ["Neutral" if not text.strip() else normalise_label(gen)
                for text, gen in zip(texts, generations)]
