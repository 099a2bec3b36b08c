"""DistilBERT-sst2-style encoder classifier (PyTorch).

Counterpart of ``music_analyst_tpu/models/distilbert.py``: a 6-layer post-LN
transformer encoder with learned positions and a CLS head, in the layout of
``distilbert-base-uncased-finetuned-sst-2-english`` so real checkpoints load
(``load_hf_torch_checkpoint``), with seeded random init otherwise.
``params_from_jax`` carries a JAX classifier's parameters over (stored
``QuantizedParam`` kernels included), which is how the parity tests give
both packages the same weights.

Quantized inference (JAX ``quant`` / ``weight_quant``): ``-int8`` runs the
projections and the MLP through the dynamic int8 path; ``weight_quant``
("int8" / "int4") stores them quantized (``models/layers.py:WqLinear``).
Random weights are drawn as for the float model and then quantized; a
checkpoint streams layer by layer through quantize-on-load and the
quantized-checkpoint cache (``engines/checkpoint.py``,
``engines/wq_cache.py``), so its float tree never exists whole.

The port's default attention is ``attn_impl="flash"``: every encoder
layer's attention runs the hand-written CUDA kernel
(``ops/flash_attention.py``), flat batches masked by ``lengths`` and packed
batches by ``lengths`` plus segment ids.  ``"dense"`` materialises the
logits (the JAX package's default) and is kept for comparison.

``mesh=`` (a ``parallel/mesh.DeviceMesh`` over ranks) runs the classifier
as JAX's does on a mesh: weights shard by ``parallel/sharding.py``'s rules
(tp: heads, the FFN hidden axis, the vocabulary), batch rows split over
``dp`` after JAX's padding (rows to a multiple of dp, with length 1), each
rank tokenizes and classifies its own rows (all of them on the packed and
length-bucket paths, which plan the whole batch), and the labels and
confidences are all-gathered back in row order on every rank.  ``quant``
and ``weight_quant`` shard too: the model is built, loaded and quantized
whole, then each rank keeps its block of the codes and scales.

Label contract: the sst2 head is 2-class; ``max softmax prob <
neutral_threshold`` → ``Neutral``, else argmax → ``Positive``/``Negative``.
"""

from __future__ import annotations

import bisect
import dataclasses
import os
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from music_analyst_tpu_torch.device import DeviceLike, resolve_device
from music_analyst_tpu_torch.engines.sentiment import ClassifierBackend
from music_analyst_tpu_torch.models.layers import (
    GeluMLP,
    LayerNorm,
    MultiHeadAttention,
    WqLinear,
    padding_mask,
    param_slots,
    segment_mask,
    use_float_slots_,
)
from music_analyst_tpu_torch.models.tokenization import resolve_bert_tokenizer
from music_analyst_tpu_torch.models.tree import as_tensor, f32, put_kernel
from music_analyst_tpu_torch.parallel.mesh import (
    DeviceMesh,
    all_gather,
    shard_bounds,
)
from music_analyst_tpu_torch.parallel.sharding import shard_params
from music_analyst_tpu_torch.profiling.collectives import record_collective
from music_analyst_tpu_torch.runtime.wire import (
    count_h2d_bytes,
    narrow_lengths,
    to_device,
)
from music_analyst_tpu_torch.utils.shapes import round_pow2

# HF DistilBERT hardcodes nn.LayerNorm(eps=1e-12).
LN_EPS = 1e-12

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class DistilBertConfig:
    vocab_size: int = 30522
    dim: int = 768
    n_layers: int = 6
    n_heads: int = 12
    hidden_dim: int = 3072
    max_positions: int = 512
    n_classes: int = 2
    dtype: str = "bfloat16"
    # "flash" = the CUDA flash-attention kernel (lengths + segment masks);
    # "dense" = materialised logits with a mask array.
    attn_impl: str = "flash"
    # "int8" = dynamic-quant projections/MLP (ops/quant.py).
    quant: str = "none"
    # "int8"/"int4" = stored weight-quantized projection/MLP kernels;
    # embeddings, norms and the classifier heads stay float.
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
        if self.attn_impl not in ("dense", "flash"):
            raise ValueError(
                f"attn_impl must be dense/flash, got {self.attn_impl!r}"
            )
        if self.dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}")

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @classmethod
    def tiny(cls, **overrides) -> "DistilBertConfig":
        return cls(**{**dict(vocab_size=1024, dim=64, n_layers=2, n_heads=4,
                             hidden_dim=128, max_positions=128), **overrides})


class TransformerBlock(nn.Module):
    """Post-LN block: x → LN(x + attn(x)) → LN(· + mlp(·))."""

    def __init__(self, cfg: DistilBertConfig) -> None:
        super().__init__()
        dtype = cfg.torch_dtype
        self.flash = cfg.attn_impl == "flash"
        # HF DistilBERT q/k/v/out projections carry biases.
        self.attention = MultiHeadAttention(
            cfg.dim, cfg.n_heads, attn_impl=cfg.attn_impl, use_bias=True,
            dtype=dtype, quant=cfg.quant, weight_quant=cfg.weight_quant,
        )
        self.sa_layer_norm = LayerNorm(cfg.dim, LN_EPS)
        self.ffn = GeluMLP(cfg.dim, cfg.hidden_dim, dtype=dtype,
                           quant=cfg.quant, weight_quant=cfg.weight_quant)
        self.output_layer_norm = LayerNorm(cfg.dim, LN_EPS)

    def forward(self, x, mask, lengths=None, segment_ids=None):
        attn_out = self.attention(
            x, mask=None if self.flash else mask, lengths=lengths,
            segment_ids=segment_ids if self.flash else None,
        )
        x = self.sa_layer_norm(x + attn_out)
        return self.output_layer_norm(x + self.ffn(x))


class DistilBertEncoder(nn.Module):
    def __init__(self, cfg: DistilBertConfig) -> None:
        super().__init__()
        self.config = cfg
        dtype = cfg.torch_dtype
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.dim, dtype=dtype)
        self.position_embeddings = nn.Embedding(
            cfg.max_positions, cfg.dim, dtype=dtype
        )
        self.embed_layer_norm = LayerNorm(cfg.dim, LN_EPS)
        self.layers = nn.ModuleList(
            TransformerBlock(cfg) for _ in range(cfg.n_layers)
        )

    def forward(self, token_ids, lengths, positions=None, segment_ids=None):
        """Encode ``[B, S]`` ids.

        Flat mode (``positions``/``segment_ids`` omitted): positions
        ``0..S-1``, key padding from ``lengths``.  Packed mode: rows carry
        several lyrics; ``segment_ids`` ``[B, S]`` (0 = padding) restricts
        attention to same-segment pairs and ``positions`` restart at every
        segment start.  With ``attn_impl == "flash"`` masking comes from
        ``lengths`` plus ``segment_ids`` inside the kernel; the mask array
        is built only for the dense path.
        """
        flash = self.config.attn_impl == "flash"
        seq = token_ids.shape[1]
        if positions is None:
            positions = torch.arange(seq, device=token_ids.device)[None, :]
        x = self.embed_layer_norm(
            self.word_embeddings(token_ids)
            + self.position_embeddings(positions)
        )
        if flash:
            mask = None
        elif segment_ids is not None:
            mask = segment_mask(segment_ids)
        else:
            mask = padding_mask(lengths, seq)
        for layer in self.layers:
            x = layer(x, mask, lengths, segment_ids=segment_ids)
        return x


class DistilBertForSentiment(nn.Module):
    """Encoder + CLS head → class logits (f32).

    Flat mode returns ``[B, n_classes]`` from each row's position-0 CLS.
    Packed mode (``cls_index`` ``[B, K]``, each lyric's CLS offset) returns
    ``[B, K, n_classes]``; unused slots give logits the caller drops.
    """

    def __init__(self, cfg: DistilBertConfig) -> None:
        super().__init__()
        self.config = cfg
        self.encoder = DistilBertEncoder(cfg)
        self.pre_classifier = nn.Linear(cfg.dim, cfg.dim, dtype=cfg.torch_dtype)
        self.classifier = nn.Linear(cfg.dim, cfg.n_classes, dtype=torch.float32)

    def forward(self, token_ids, lengths, positions=None, segment_ids=None,
                cls_index=None):
        x = self.encoder(token_ids, lengths, positions=positions,
                         segment_ids=segment_ids)
        if cls_index is None:
            cls = x[:, 0]
        else:
            idx = cls_index.long()[:, :, None].expand(-1, -1, x.shape[-1])
            cls = torch.gather(x, 1, idx)                     # [B, K, D]
        h = F.relu(self.pre_classifier(cls))
        return self.classifier(h.float())


def init_random_(model: DistilBertForSentiment, seed: int) -> None:
    """Seeded random init, drawn in f32 on the CPU from one generator:
    normal(0, 1/sqrt(fan_in)) linear weights, normal(0, 1/sqrt(rows))
    embeddings, zero biases, unit LayerNorm scales.  A weight-quantized
    projection draws the same values and stores them quantized."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, shape, owner in param_slots(model):
            if isinstance(owner, LayerNorm):
                value = (torch.ones if name.endswith("weight")
                         else torch.zeros)(shape)
            elif name.endswith("bias"):
                value = torch.zeros(shape)
            else:
                linear = isinstance(owner, (nn.Linear, WqLinear))
                fan = shape[1] if linear else shape[0]
                value = torch.randn(shape, generator=gen) * fan ** -0.5
            if isinstance(owner, WqLinear) and name.endswith("weight"):
                owner.quantize_from_(value)
            else:
                model.get_parameter(name).copy_(value)


def params_from_jax(tree: Mapping) -> Dict[str, object]:
    """Map the JAX classifier's parameter tree onto this model's
    ``state_dict`` names and layouts.

    Flax ``Dense`` kernels are ``[in, out]`` (torch ``[out, in]``);
    ``DenseGeneral`` ``q/k/v_proj`` kernels are ``[dim, H, Dh]`` with bias
    ``[H, Dh]`` and ``o_proj`` is ``[H, Dh, dim]``; embeddings are
    ``embedding``, LayerNorms ``scale``/``bias``.  A stored quantized
    kernel (any object with ``q``/``scale``/``scheme``, JAX's
    ``QuantizedParam`` included) keeps its Flax layout as ``{name}.q`` and
    ``{name}.scale`` (``WqLinear``'s buffers).  Leaves may be numpy arrays
    or tensors; the result holds the same kind.
    """
    enc = tree["encoder"]
    out: Dict[str, object] = {
        "encoder.word_embeddings.weight": f32(enc["word_embeddings"]["embedding"]),
        "encoder.position_embeddings.weight":
            f32(enc["position_embeddings"]["embedding"]),
        "encoder.embed_layer_norm.weight": f32(enc["embed_layer_norm"]["scale"]),
        "encoder.embed_layer_norm.bias": f32(enc["embed_layer_norm"]["bias"]),
    }
    n_layers = sum(1 for k in enc if k.startswith("layer_"))
    for i in range(n_layers):
        src = enc[f"layer_{i}"]
        dst = f"encoder.layers.{i}"
        att = src["attention"]
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            put_kernel(out, f"{dst}.attention.{proj}", att[proj]["kernel"],
                       n_contract=2 if proj == "o_proj" else 1)
            out[f"{dst}.attention.{proj}.bias"] = f32(att[proj]["bias"]).reshape(-1)
        for ln in ("sa_layer_norm", "output_layer_norm"):
            out[f"{dst}.{ln}.weight"] = f32(src[ln]["scale"])
            out[f"{dst}.{ln}.bias"] = f32(src[ln]["bias"])
        for lin in ("lin1", "lin2"):
            put_kernel(out, f"{dst}.ffn.{lin}", src["ffn"][lin]["kernel"])
            out[f"{dst}.ffn.{lin}.bias"] = f32(src["ffn"][lin]["bias"])
    for head in ("pre_classifier", "classifier"):
        put_kernel(out, head, tree[head]["kernel"])
        out[f"{head}.bias"] = f32(tree[head]["bias"])
    return out


def param_shapes(cfg: DistilBertConfig) -> Dict:
    """The Flax parameter tree's structure, with ``meta`` tensors of each
    leaf's float shape (the port's ``jax.eval_shape`` of ``model.init``)."""
    def leaf(*shape):
        return torch.empty(shape, device="meta")

    D, H, Dh = cfg.dim, cfg.n_heads, cfg.dim // cfg.n_heads
    enc = {
        "word_embeddings": {"embedding": leaf(cfg.vocab_size, D)},
        "position_embeddings": {"embedding": leaf(cfg.max_positions, D)},
        "embed_layer_norm": {"scale": leaf(D), "bias": leaf(D)},
    }
    for i in range(cfg.n_layers):
        att = {p: {"kernel": leaf(D, H, Dh), "bias": leaf(H, Dh)}
               for p in ("q_proj", "k_proj", "v_proj")}
        att["o_proj"] = {"kernel": leaf(H, Dh, D), "bias": leaf(D)}
        enc[f"layer_{i}"] = {
            "attention": att,
            "sa_layer_norm": {"scale": leaf(D), "bias": leaf(D)},
            "ffn": {"lin1": {"kernel": leaf(D, cfg.hidden_dim),
                             "bias": leaf(cfg.hidden_dim)},
                    "lin2": {"kernel": leaf(cfg.hidden_dim, D),
                             "bias": leaf(D)}},
            "output_layer_norm": {"scale": leaf(D), "bias": leaf(D)},
        }
    return {
        "encoder": enc,
        "pre_classifier": {"kernel": leaf(D, D), "bias": leaf(D)},
        "classifier": {"kernel": leaf(D, cfg.n_classes),
                       "bias": leaf(cfg.n_classes)},
    }


def iter_hf_param_units(params, path: str, mmap: bool = False):
    """Stream an HF DistilBERT torch ``state_dict`` as layer-sized units.

    Yields ``(unit_name, [("/"-joined Flax path, np.ndarray), ...])``:
    embeddings, one unit per transformer layer, then the classifier head,
    in Flax layouts (kernels ``[in, out]``, attention projections and
    their biases in the head layout), which is what the quantize-on-load
    pipeline and the quantized cache consume.  Every checkpoint tensor
    must be consumed (leftovers raise at the end).  ``params`` supplies
    shapes only (:func:`param_shapes`).
    """
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True,
                        mmap=mmap)
    except (RuntimeError, ValueError, TypeError):
        sd = torch.load(path, map_location="cpu", weights_only=True)
    enc_shapes = params["encoder"]
    cfg_heads = enc_shapes["layer_0"]["attention"]["q_proj"]["kernel"].shape[1]
    dim = enc_shapes["word_embeddings"]["embedding"].shape[1]
    head_dim = dim // cfg_heads
    consumed = set()

    def t(name):
        consumed.add(name)
        return np.asarray(sd[name].numpy())

    yield "embeddings", [
        ("encoder/word_embeddings/embedding",
         t("distilbert.embeddings.word_embeddings.weight")),
        ("encoder/position_embeddings/embedding",
         t("distilbert.embeddings.position_embeddings.weight")),
        ("encoder/embed_layer_norm/scale",
         t("distilbert.embeddings.LayerNorm.weight")),
        ("encoder/embed_layer_norm/bias",
         t("distilbert.embeddings.LayerNorm.bias")),
    ]
    n_layers = sum(1 for k in enc_shapes if k.startswith("layer_"))
    for i in range(n_layers):
        hf = f"distilbert.transformer.layer.{i}"
        p = f"encoder/layer_{i}"
        leaves = []
        for ours, theirs in (("q_proj", "q_lin"), ("k_proj", "k_lin"),
                             ("v_proj", "v_lin")):
            w = t(f"{hf}.attention.{theirs}.weight").T
            leaves.append((f"{p}/attention/{ours}/kernel",
                           w.reshape(dim, cfg_heads, head_dim)))
            leaves.append((f"{p}/attention/{ours}/bias",
                           t(f"{hf}.attention.{theirs}.bias").reshape(
                               cfg_heads, head_dim)))
        leaves.append((f"{p}/attention/o_proj/kernel",
                       t(f"{hf}.attention.out_lin.weight").T.reshape(
                           cfg_heads, head_dim, dim)))
        leaves.append((f"{p}/attention/o_proj/bias",
                       t(f"{hf}.attention.out_lin.bias")))
        leaves.append((f"{p}/sa_layer_norm/scale",
                       t(f"{hf}.sa_layer_norm.weight")))
        leaves.append((f"{p}/sa_layer_norm/bias",
                       t(f"{hf}.sa_layer_norm.bias")))
        for lin in ("lin1", "lin2"):
            leaves.append((f"{p}/ffn/{lin}/kernel",
                           t(f"{hf}.ffn.{lin}.weight").T))
            leaves.append((f"{p}/ffn/{lin}/bias", t(f"{hf}.ffn.{lin}.bias")))
        leaves.append((f"{p}/output_layer_norm/scale",
                       t(f"{hf}.output_layer_norm.weight")))
        leaves.append((f"{p}/output_layer_norm/bias",
                       t(f"{hf}.output_layer_norm.bias")))
        yield f"layer_{i}", leaves
    yield "head", [
        ("pre_classifier/kernel", t("pre_classifier.weight").T),
        ("pre_classifier/bias", t("pre_classifier.bias")),
        ("classifier/kernel", t("classifier.weight").T),
        ("classifier/bias", t("classifier.bias")),
    ]
    ignorable = {k for k in sd if k.endswith("position_ids")}
    leftovers = set(sd) - consumed - ignorable
    if leftovers:
        raise ValueError(
            "checkpoint keys not consumed by the DistilBERT mapping: "
            + ", ".join(sorted(leftovers)[:8])
        )


def load_hf_torch_checkpoint(model: DistilBertForSentiment, path: str) -> None:
    """Load an HF DistilBERT torch ``state_dict`` into ``model``.

    HF's torch layout is this module's layout; only the names differ.
    Every checkpoint tensor must be consumed and every parameter filled,
    so a checkpoint of another structure never half-loads.
    """
    sd = torch.load(path, map_location="cpu", weights_only=True)
    rename = {
        "distilbert.embeddings.word_embeddings.": "encoder.word_embeddings.",
        "distilbert.embeddings.position_embeddings.":
            "encoder.position_embeddings.",
        "distilbert.embeddings.LayerNorm.": "encoder.embed_layer_norm.",
        "distilbert.transformer.layer.": "encoder.layers.",
        ".attention.q_lin.": ".attention.q_proj.",
        ".attention.k_lin.": ".attention.k_proj.",
        ".attention.v_lin.": ".attention.v_proj.",
        ".attention.out_lin.": ".attention.o_proj.",
    }
    mapped = {}
    for key, value in sd.items():
        if key.endswith("position_ids"):
            continue  # non-parameter buffer some versions serialise
        new = key
        for old, rep in rename.items():
            new = new.replace(old, rep)
        mapped[new] = value
    expected = set(model.state_dict())
    leftovers = set(mapped) - expected
    missing = expected - set(mapped)
    if leftovers or missing:
        raise ValueError(
            "checkpoint does not match the DistilBERT mapping: unconsumed "
            f"{sorted(leftovers)[:8]}, missing {sorted(missing)[:8]}"
        )
    model.load_state_dict(mapped)


def derive_length_buckets(
    lengths,
    max_len: int,
    min_share: float = 0.05,
    floor: int = 16,
) -> Tuple[int, ...]:
    """Pick power-of-two sequence buckets from an observed length sample.

    Each kept bucket must absorb at least ``min_share`` of the sampled
    rows; rows skipped by a dropped bucket roll upward into the next
    candidate.  Returns ``()`` when the sample is dominated by full-length
    rows — the flat path is then already right.
    """
    lengths = np.asarray(lengths)
    out = []
    if lengths.size:
        prev = 0
        b = floor
        while b < max_len:
            share = float(((lengths > prev) & (lengths <= b)).mean())
            if share >= min_share:
                out.append(b)
                prev = b
            b <<= 1
    return tuple(out)


def pack_segments(
    lengths, capacity: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Best-fit-decreasing bin packing of per-lyric token lengths.

    Returns ``(bin_of, slot_of, starts, row_len)``: input ``i`` becomes
    segment ``slot_of[i]`` of packed row ``bin_of[i]``; ``starts[p, k]``
    is the token offset of each row's ``k``-th segment (``capacity``
    sentinel for unused slots); ``row_len[p]`` is each row's occupied
    prefix.  Same placement as the JAX package's ``pack_segments``.
    """
    lengths = np.asarray(lengths, dtype=np.int64)
    if lengths.size and (lengths <= 0).any():
        raise ValueError("pack_segments requires every length > 0")
    if lengths.size and int(lengths.max()) > capacity:
        raise ValueError(
            f"segment length {int(lengths.max())} exceeds capacity "
            f"{capacity}"
        )
    n = int(lengths.size)
    bin_of = np.zeros(n, np.int64)
    slot_of = np.zeros(n, np.int64)
    rems: list = []       # open-row remaining capacities, ascending
    rem_bin: list = []    # parallel row ids
    rows: list = []       # input indices per row, placement order
    for i in np.argsort(-lengths, kind="stable"):
        need = int(lengths[i])
        j = bisect.bisect_left(rems, need)
        if j == len(rems):
            rem, b = capacity, len(rows)
            rows.append([])
        else:
            rem, b = rems.pop(j), rem_bin.pop(j)
        bin_of[i] = b
        slot_of[i] = len(rows[b])
        rows[b].append(int(i))
        rem -= need
        j = bisect.bisect_left(rems, rem)
        rems.insert(j, rem)
        rem_bin.insert(j, b)
    n_rows = len(rows)
    n_slots = max((len(r) for r in rows), default=0)
    starts = np.full((n_rows, n_slots), capacity, np.int64)
    row_len = np.zeros(n_rows, np.int64)
    for b, members in enumerate(rows):
        offset = 0
        for k, i in enumerate(members):
            starts[b, k] = offset
            offset += int(lengths[i])
        row_len[b] = offset
    return bin_of, slot_of, starts, row_len


def expand_packed(starts: torch.Tensor, row_len: torch.Tensor, seq: int):
    """Device-side expansion of the packed wire format: ``starts`` ``[P, K]``
    (``seq`` sentinel for unused slots) and ``row_len`` ``[P]`` → segment ids
    ``[P, S]`` (1..K, 0 for padding) and restarted positions ``[P, S]``."""
    st = starts.to(torch.int32)
    s_axis = torch.arange(seq, dtype=torch.int32, device=st.device)
    started = st[:, :, None] <= s_axis[None, None, :]         # [P, K, S]
    seg = started.sum(dim=1, dtype=torch.int32)                # [P, S]
    valid = s_axis[None, :] < row_len.to(torch.int32)[:, None]
    seg = torch.where(valid, seg, torch.zeros_like(seg))
    last_start = torch.where(
        started, st[:, :, None], torch.full_like(started, -1, dtype=torch.int32)
    ).amax(dim=1)                                              # [P, S]
    positions = s_axis[None, :] - last_start.clamp(min=0)
    return seg, positions


class DistilBertClassifier(ClassifierBackend):
    """Batched sentiment backend on one device, or on a mesh of ranks
    (``mesh=``).

    ``neutral_threshold`` (default 0.6) maps the binary sst2 head onto the
    reference's three labels: a max softmax prob below it is ``Neutral``.
    Empty (post-strip) lyrics are always ``Neutral``.
    """

    name = "distilbert"

    # sst2 head order in the HF checkpoint: [NEGATIVE, POSITIVE]
    _CLASS_LABELS = ("Negative", "Positive")

    def __init__(
        self,
        config: Optional[DistilBertConfig] = None,
        checkpoint_path: Optional[str] = None,
        max_len: int = 128,
        neutral_threshold: float = 0.6,
        seed: int = 0,
        vocab_path: Optional[str] = None,
        length_buckets: Optional[Sequence[int]] = None,
        packed: bool = False,
        device: DeviceLike = "cuda",
        state_dict: Optional[Mapping[str, np.ndarray]] = None,
        wq_cache_dir: Optional[str] = None,
        mesh: Optional[DeviceMesh] = None,
    ) -> None:
        if mesh is not None and not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh must be a DeviceMesh, got "
                            f"{type(mesh).__name__}")
        self.mesh = mesh
        self.device = resolve_device(device if mesh is None else mesh.device)
        self.config = config or DistilBertConfig()
        self.max_len = max_len
        self.neutral_threshold = neutral_threshold
        self.packed = bool(packed)
        if self.packed and length_buckets:
            raise ValueError(
                "packed=True cannot be combined with length_buckets"
            )
        if isinstance(length_buckets, str):
            if length_buckets != "auto":
                raise ValueError(
                    "length_buckets must be 'auto' or a sequence of ints, "
                    f"got the string {length_buckets!r}"
                )
            self.length_buckets = "auto"
        else:
            self.length_buckets = self._check_buckets(length_buckets, max_len)
        self.tokenizer = resolve_bert_tokenizer(
            vocab_path, vocab_size=self.config.vocab_size
        )
        model = DistilBertForSentiment(self.config)
        self.pretrained = False
        wq = self.config.weight_quant
        if checkpoint_path and wq != "none" and state_dict is None:
            # Streaming quantize-on-load: the float tree never exists
            # whole; a warm quantized-cache entry skips torch.load.
            from music_analyst_tpu_torch.engines import wq_cache
            from music_analyst_tpu_torch.engines.checkpoint import (
                load_quantized_params,
            )
            from music_analyst_tpu_torch.ops.quant import WQ_DEFAULT_GROUP

            shapes = param_shapes(self.config)
            cache_dir = wq_cache.resolve_cache_dir(wq_cache_dir)
            cache_key = (
                wq_cache.wq_key(checkpoint_path, "distilbert", wq,
                                WQ_DEFAULT_GROUP)
                if cache_dir else None
            )
            state_dict = params_from_jax(load_quantized_params(
                shapes,
                lambda: iter_hf_param_units(shapes, checkpoint_path,
                                            mmap=True),
                wq, group_size=WQ_DEFAULT_GROUP, device=self.device,
                cache_dir=cache_dir, cache_key=cache_key,
            ))
            self.pretrained = True
        model = model.to(self.device)
        if state_dict is not None:
            use_float_slots_(model, state_dict)
            model.load_state_dict(
                {k: as_tensor(v) for k, v in state_dict.items()})
        elif checkpoint_path:
            load_hf_torch_checkpoint(model, checkpoint_path)
            self.pretrained = True
        else:
            init_random_(model, seed)
        if mesh is not None:
            # Megatron rules; axes absent from the mesh prune to
            # replication, so one call serves dp, tp and dp x tp.
            shard_params(model, mesh)
        self.model = model.eval()
        # Token ids ride the wire as int16 when every id fits (sized from
        # the tokenizer's range: a supplied vocab.txt can exceed the
        # config's); segment starts / row lengths likewise by max_len.
        wire_vocab = max(self.config.vocab_size, self.tokenizer.vocab_size)
        self._wire_dtype = np.int16 if wire_vocab <= (1 << 15) else np.int32

    @classmethod
    def from_pretrained_or_random(cls, model: str, **kwargs):
        """Resolve ``--model distilbert[-tiny][-packed][-int8]`` to a
        backend.

        Checkpoint: explicit kwarg, else ``$MUSICAAL_DISTILBERT_CKPT``;
        without one the weights are seeded random.  Suffixes compose in any
        order; ``-int8`` selects the dynamic int8 path and ``weight_quant``
        the stored-weight one.
        """
        ckpt = kwargs.pop("checkpoint_path", None) or os.environ.get(
            "MUSICAAL_DISTILBERT_CKPT"
        )
        config = kwargs.pop("config", None)
        quant, tiny = "none", False
        stripped = True
        while stripped:
            if model.endswith("-packed"):
                model = model[: -len("-packed")]
                kwargs.setdefault("packed", True)
            elif model.endswith("-int8"):
                model, quant = model[: -len("-int8")], "int8"
            elif model.endswith("-tiny"):
                model, tiny = model[: -len("-tiny")], True
            else:
                stripped = False
        if model != "distilbert":
            raise ValueError(f"unknown DistilBERT model name {model!r}")
        if tiny:
            config = config or DistilBertConfig.tiny()
        if quant != "none":
            config = dataclasses.replace(config or DistilBertConfig(),
                                         quant=quant)
        weight_quant = kwargs.pop("weight_quant", "none") or "none"
        if weight_quant != "none":
            config = dataclasses.replace(config or DistilBertConfig(),
                                         weight_quant=weight_quant)
        return cls(config=config, checkpoint_path=ckpt, **kwargs)

    @staticmethod
    def _check_buckets(
        buckets: Optional[Sequence[int]], max_len: int
    ) -> Optional[Tuple[int, ...]]:
        """Validate ascending sequence-length buckets; ``max_len`` is always
        the (implicit) last bucket so every row has a home."""
        if buckets is None or len(buckets) == 0:
            return None
        out = sorted(set(int(b) for b in buckets) | {max_len})
        if out[0] < 8:
            raise ValueError(f"length bucket {out[0]} is below the floor of 8")
        if out[-1] > max_len:
            raise ValueError(
                f"length bucket {out[-1]} exceeds max_len={max_len}"
            )
        return tuple(out)

    @staticmethod
    def _round_rows(n: int) -> int:
        """Next power of two (≥16): bounded batch shapes, ≤ 2× row padding."""
        return round_pow2(n, 16)

    def _plan_flat(self, token_ids: np.ndarray, lengths: np.ndarray):
        """Cast one full-width batch to its wire dtypes."""
        return (
            np.asarray(token_ids, dtype=self._wire_dtype),
            narrow_lengths(lengths, self.max_len),
        )

    @property
    def _dp(self) -> int:
        return 1 if self.mesh is None else self.mesh.axis_size("dp")

    def _plan_flat_shard(self, texts: Sequence[str]):
        """This rank's rows of a flat batch padded to a multiple of dp
        (JAX's ``_pad_batch``: zero ids, length 1); only those rows are
        tokenized."""
        n = len(texts)
        start, stop, share = shard_bounds(n, self.mesh)
        ids, lens = self.tokenizer.encode_batch(texts[start:stop],
                                                self.max_len)
        pad = share - ids.shape[0]
        if pad:
            ids = np.pad(ids, ((0, pad), (0, 0)))
            lens = np.pad(lens, (0, pad), constant_values=1)
        return None, n, self._plan_flat(ids, lens)

    def _shard_part(self, part):
        """This rank's rows of a whole-batch part: rows padded to a
        multiple of dp as JAX pads them (flat: zero ids, length 1;
        packed: empty rows), then the dp coordinate's block."""
        gather, n, arrays = part
        fill = (0, 1) if len(arrays) == 2 else (0, self.max_len, 0)
        rows = arrays[0].shape[0]
        padded = -(-rows // self._dp) * self._dp
        start, stop, _ = shard_bounds(padded, self.mesh)
        out = []
        for a, value in zip(arrays, fill):
            if padded != rows:
                widths = ((0, padded - rows),) + ((0, 0),) * (a.ndim - 1)
                a = np.pad(a, widths, constant_values=value)
            out.append(np.ascontiguousarray(a[start:stop]))
        return gather, n, tuple(out)

    def _record_mesh_collectives(self, rows: int, seq: int) -> None:
        """JAX's analytic collective bytes of one sharded forward: two
        tp all-reduces of the [rows/dp, seq, dim] bf16 activations per
        layer, and the dp gather of ~8 B of results per row."""
        if self.mesh is None:
            return
        dp, tp = self._dp, self.mesh.axis_size("tp")
        if tp > 1:
            record_collective(
                "sentiment.tp_allreduce", "psum",
                payload_bytes=(rows // max(dp, 1)) * seq * self.config.dim * 2,
                n_devices=tp, axis="tp", count=2 * self.config.n_layers,
            )
        if dp > 1:
            record_collective(
                "sentiment.result_gather", "all_gather",
                payload_bytes=(rows // dp) * 8, n_devices=dp, axis="dp",
            )

    def _plan_packed(self, token_ids: np.ndarray, lengths: np.ndarray):
        """Bin-pack lyrics into shared rows and cast the compact wire
        format; the plan carries the ``(bin_of, slot_of)`` gather map."""
        n = token_ids.shape[0]
        if n == 0:
            return []
        bin_of, slot_of, starts, row_len = pack_segments(lengths, self.max_len)
        n_rows, n_slots = starts.shape
        rows_padded = self._round_rows(n_rows)
        slots_padded = round_pow2(max(n_slots, 1), 4)
        ids = np.zeros((rows_padded, self.max_len), token_ids.dtype)
        st = np.full((rows_padded, slots_padded), self.max_len, np.int64)
        st[:n_rows, :n_slots] = starts
        rl = np.zeros((rows_padded,), np.int64)
        rl[:n_rows] = row_len
        for i in range(n):
            offset = starts[bin_of[i], slot_of[i]]
            ids[bin_of[i], offset : offset + lengths[i]] = token_ids[
                i, : lengths[i]
            ]
        return [(
            (bin_of, slot_of), n,
            (np.asarray(ids, dtype=self._wire_dtype),
             narrow_lengths(st, self.max_len),
             narrow_lengths(rl, self.max_len)),
        )]

    def prepare(self, texts: Sequence[str]):
        """Host phase: tokenize and plan the batch (no device work).

        Returns ``(texts, [(gather, n, host_arrays)...])`` with every
        array padded and cast to its wire dtype.  Length buckets group
        rows by token length and run each group at its bucket's sequence
        length; packing puts several short lyrics into one full-width row.
        """
        if self._dp > 1 and not self.packed and self.length_buckets is None:
            return texts, [self._plan_flat_shard(texts)]
        texts, parts = self._prepare_whole(texts)
        if self._dp > 1:
            parts = [self._shard_part(part) for part in parts]
        return texts, parts

    def _prepare_whole(self, texts: Sequence[str]):
        token_ids, lengths = self.tokenizer.encode_batch(texts, self.max_len)
        if self.packed:
            return texts, self._plan_packed(token_ids, lengths)
        if self.length_buckets == "auto" and lengths.size:
            # The first non-empty batch is the sample.
            self.length_buckets = self._check_buckets(
                derive_length_buckets(lengths, self.max_len), self.max_len
            )
        if self.length_buckets == "auto":
            return texts, []
        if self.length_buckets is None:
            return texts, [(None, token_ids.shape[0],
                            self._plan_flat(token_ids, lengths))]
        parts = []
        remaining = np.arange(token_ids.shape[0])
        for bucket in self.length_buckets:
            in_bucket = lengths[remaining] <= bucket
            rows = remaining[in_bucket]
            remaining = remaining[~in_bucket]
            if rows.size == 0:
                continue
            padded_rows = self._round_rows(rows.size)
            ids_b = np.zeros((padded_rows, bucket), token_ids.dtype)
            len_b = np.ones((padded_rows,), lengths.dtype)
            ids_b[: rows.size] = token_ids[rows, :bucket]
            len_b[: rows.size] = lengths[rows]
            parts.append((rows, rows.size, self._plan_flat(ids_b, len_b)))
        return texts, parts

    def transfer(self, prepared):
        """H2D phase: every planned wire array onto the device (pinned
        staging, asynchronous copy).  Bytes shipped (and saved against an
        int32 wire) land in the ``pipeline.h2d_bytes*`` counters."""
        texts, parts = prepared
        placed = []
        for gather, n, arrays in parts:
            count_h2d_bytes(arrays)
            placed.append((gather, n, to_device(arrays, self.device)))
        return texts, placed

    def _forward(self, token_ids, lengths):
        logits = self.model(token_ids.long(), lengths.to(torch.int32))
        probs = torch.softmax(logits, dim=-1)
        return logits.argmax(dim=-1), probs.amax(dim=-1)

    def _packed_logits(self, token_ids, starts, row_len):
        """Expand the compact per-segment wire format into segment ids and
        restarted positions on the device, then run the packed forward."""
        seq = token_ids.shape[1]
        seg, positions = expand_packed(starts, row_len, seq)
        return self.model(
            token_ids.long(), row_len.to(torch.int32),
            positions=positions.long(), segment_ids=seg,
            cls_index=starts.to(torch.int32).clamp(max=seq - 1),
        )                                                      # [P, K, C]

    def _forward_packed(self, token_ids, starts, row_len):
        logits = self._packed_logits(token_ids, starts, row_len)
        probs = torch.softmax(logits, dim=-1)
        return logits.argmax(dim=-1), probs.amax(dim=-1)

    def forward_logits(self, token_ids: torch.Tensor, lengths: torch.Tensor):
        """Flat-batch class logits (f32) — for checks and comparisons."""
        with torch.inference_mode():
            return self.model(token_ids.long(), lengths.to(torch.int32))

    def classify_logits(self, texts: Sequence[str]) -> torch.Tensor:
        """Flat-batch class logits (f32, on the host) ``[len(texts), C]``
        through the whole flat path, on a mesh too (this rank's rows,
        gathered over dp) — for checks and comparisons."""
        if self._dp > 1:
            _, n, arrays = self._plan_flat_shard(texts)
        else:
            n = len(texts)
            arrays = self._plan_flat(
                *self.tokenizer.encode_batch(texts, self.max_len))
        logits = self.forward_logits(*to_device(arrays, self.device))
        return all_gather(logits.float().cpu(), self.mesh, "dp")[:n]

    def forward_logits_packed(self, texts: Sequence[str]) -> torch.Tensor:
        """Per-song class logits (f32) ``[len(texts), C]`` through the whole
        packed path (plan, wire, device-side expansion, CLS gather) — for
        checks and comparisons."""
        token_ids, lengths = self.tokenizer.encode_batch(texts, self.max_len)
        [part] = self._plan_packed(token_ids, lengths)
        if self._dp > 1:
            part = self._shard_part(part)
        (bin_of, slot_of), _, arrays = part
        with torch.inference_mode():
            logits = self._packed_logits(*to_device(arrays, self.device))
        logits = all_gather(logits, self.mesh, "dp")
        return logits[torch.as_tensor(bin_of, device=logits.device),
                      torch.as_tensor(slot_of, device=logits.device)]

    def launch(self, transferred):
        """Dispatch phase: enqueue the forwards and the copies of their
        results back to the host; returns without waiting for the card."""
        texts, parts = transferred
        launched = []
        with torch.inference_mode():
            for gather, n, arrays in parts:
                rows = arrays[0].shape[0] * self._dp
                seq = arrays[0].shape[1] if len(arrays) == 2 else self.max_len
                self._record_mesh_collectives(rows, seq)
                if len(arrays) == 2:
                    classes, confidence = self._forward(*arrays)
                else:
                    classes, confidence = self._forward_packed(*arrays)
                if self._dp > 1:
                    # The gather runs here, in the thread that issued the
                    # forward's tp collectives, so every rank issues its
                    # collectives in one order.
                    classes = all_gather(classes.cpu(), self.mesh, "dp")
                    confidence = all_gather(confidence.cpu(), self.mesh, "dp")
                classes = classes.to("cpu", non_blocking=True)
                confidence = confidence.to("cpu", non_blocking=True)
                launched.append((gather, classes, confidence, n))
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
        return texts, launched, done

    def submit(self, texts: Sequence[str]):
        return self.launch(self.transfer(self.prepare(texts)))

    def collect(self, handle) -> List[str]:
        texts, parts, done = handle
        if done is not None:
            done.synchronize()
        classes = np.full((len(texts),), -1, np.int64)
        confidence = np.empty((len(texts),), np.float64)
        for rows, part_classes, part_confidence, n in parts:
            part_classes = part_classes.numpy()
            part_confidence = part_confidence.float().numpy()
            if isinstance(rows, tuple):
                bin_of, slot_of = rows
                classes[:n] = part_classes[bin_of, slot_of]
                confidence[:n] = part_confidence[bin_of, slot_of]
                continue
            if rows is None:
                rows = np.arange(len(texts))
            classes[rows] = part_classes[:n]
            confidence[rows] = part_confidence[:n]
        uncovered = np.flatnonzero(classes < 0)
        if uncovered.size:
            raise AssertionError(
                f"{uncovered.size} row(s) not covered by any length bucket "
                f"(first: {uncovered[0]})"
            )
        labels: List[str] = []
        for text, cls_id, conf in zip(texts, classes, confidence):
            if not text.strip():
                labels.append("Neutral")  # reference empty-lyric rule
            elif conf < self.neutral_threshold:
                labels.append("Neutral")
            else:
                labels.append(self._CLASS_LABELS[int(cls_id)])
        return labels

    def classify_batch(self, texts: Sequence[str]) -> List[str]:
        return self.collect(self.submit(texts))
