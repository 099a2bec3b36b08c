"""DistilBERT-sst2-style encoder classifier (PyTorch).

Counterpart of ``music_analyst_tpu/models/distilbert.py``: a 6-layer post-LN
transformer encoder with learned positions and a CLS head, in the layout of
``distilbert-base-uncased-finetuned-sst-2-english`` so real checkpoints load
(``load_hf_torch_checkpoint``), with seeded random init otherwise.
``params_from_jax`` carries a JAX classifier's parameters over, which is how
the parity tests give both packages the same weights.

The port's default attention is ``attn_impl="flash"``: every encoder
layer's attention runs the hand-written CUDA kernel
(``ops/flash_attention.py``), flat batches masked by ``lengths`` and packed
batches by ``lengths`` plus segment ids.  ``"dense"`` materialises the
logits (the JAX package's default) and is kept for comparison.

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
    padding_mask,
    segment_mask,
)
from music_analyst_tpu_torch.models.tokenization import resolve_bert_tokenizer
from music_analyst_tpu_torch.runtime.wire import narrow_lengths, to_device
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

    def __post_init__(self):
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
            dtype=dtype,
        )
        self.sa_layer_norm = LayerNorm(cfg.dim, LN_EPS)
        self.ffn = GeluMLP(cfg.dim, cfg.hidden_dim, dtype=dtype)
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
    embeddings, zero biases, unit LayerNorm scales."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, param in model.named_parameters():
            owner = model.get_submodule(name.rsplit(".", 1)[0])
            if isinstance(owner, LayerNorm):
                value = (torch.ones if name.endswith("weight")
                         else torch.zeros)(param.shape)
            elif name.endswith("bias"):
                value = torch.zeros(param.shape)
            else:
                fan = param.shape[1] if isinstance(owner, nn.Linear) else param.shape[0]
                value = torch.randn(param.shape, generator=gen) * fan ** -0.5
            param.copy_(value)


def params_from_jax(tree: Mapping) -> Dict[str, np.ndarray]:
    """Map the JAX classifier's parameter tree (numpy leaves) onto this
    model's ``state_dict`` names and layouts.

    Flax ``Dense`` kernels are ``[in, out]`` (torch ``[out, in]``);
    ``DenseGeneral`` ``q/k/v_proj`` kernels are ``[dim, H, Dh]`` with bias
    ``[H, Dh]`` and ``o_proj`` is ``[H, Dh, dim]``; embeddings are
    ``embedding``, LayerNorms ``scale``/``bias``.
    """
    def a(x):
        return np.asarray(x, dtype=np.float32)

    enc = tree["encoder"]
    out: Dict[str, np.ndarray] = {
        "encoder.word_embeddings.weight": a(enc["word_embeddings"]["embedding"]),
        "encoder.position_embeddings.weight":
            a(enc["position_embeddings"]["embedding"]),
        "encoder.embed_layer_norm.weight": a(enc["embed_layer_norm"]["scale"]),
        "encoder.embed_layer_norm.bias": a(enc["embed_layer_norm"]["bias"]),
    }
    n_layers = sum(1 for k in enc if k.startswith("layer_"))
    for i in range(n_layers):
        src = enc[f"layer_{i}"]
        dst = f"encoder.layers.{i}"
        att = src["attention"]
        for proj in ("q_proj", "k_proj", "v_proj"):
            kernel = a(att[proj]["kernel"])                  # [dim, H, Dh]
            out[f"{dst}.attention.{proj}.weight"] = (
                kernel.reshape(kernel.shape[0], -1).T.copy()
            )
            out[f"{dst}.attention.{proj}.bias"] = a(att[proj]["bias"]).reshape(-1)
        o = a(att["o_proj"]["kernel"])                       # [H, Dh, dim]
        out[f"{dst}.attention.o_proj.weight"] = o.reshape(-1, o.shape[-1]).T.copy()
        out[f"{dst}.attention.o_proj.bias"] = a(att["o_proj"]["bias"])
        for ln in ("sa_layer_norm", "output_layer_norm"):
            out[f"{dst}.{ln}.weight"] = a(src[ln]["scale"])
            out[f"{dst}.{ln}.bias"] = a(src[ln]["bias"])
        for lin in ("lin1", "lin2"):
            out[f"{dst}.ffn.{lin}.weight"] = a(src["ffn"][lin]["kernel"]).T.copy()
            out[f"{dst}.ffn.{lin}.bias"] = a(src["ffn"][lin]["bias"])
    for head in ("pre_classifier", "classifier"):
        out[f"{head}.weight"] = a(tree[head]["kernel"]).T.copy()
        out[f"{head}.bias"] = a(tree[head]["bias"])
    return out


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
    """Batched sentiment backend on one device.

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
    ) -> None:
        self.device = resolve_device(device)
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
        if state_dict is not None:
            model.load_state_dict(
                {k: torch.tensor(np.asarray(v)) for k, v in state_dict.items()}
            )
        elif checkpoint_path:
            load_hf_torch_checkpoint(model, checkpoint_path)
            self.pretrained = True
        else:
            init_random_(model, seed)
        self.model = model.to(self.device).eval()
        # Token ids ride the wire as int16 when every id fits (sized from
        # the tokenizer's range: a supplied vocab.txt can exceed the
        # config's); segment starts / row lengths likewise by max_len.
        wire_vocab = max(self.config.vocab_size, self.tokenizer.vocab_size)
        self._wire_dtype = np.int16 if wire_vocab <= (1 << 15) else np.int32

    @classmethod
    def from_pretrained_or_random(cls, model: str, **kwargs):
        """Resolve ``--model distilbert[-tiny][-packed]`` to a backend.

        Checkpoint: explicit kwarg, else ``$MUSICAAL_DISTILBERT_CKPT``;
        without one the weights are seeded random.  Suffixes compose in any
        order.  ``-int8`` and ``weight_quant`` are not yet ported.
        """
        ckpt = kwargs.pop("checkpoint_path", None) or os.environ.get(
            "MUSICAAL_DISTILBERT_CKPT"
        )
        config = kwargs.pop("config", None)
        weight_quant = kwargs.pop("weight_quant", "none") or "none"
        if weight_quant != "none":
            raise NotImplementedError(
                "weight_quant is not yet ported to music_analyst_tpu_torch"
            )
        tiny = False
        stripped = True
        while stripped:
            if model.endswith("-packed"):
                model = model[: -len("-packed")]
                kwargs.setdefault("packed", True)
            elif model.endswith("-tiny"):
                model, tiny = model[: -len("-tiny")], True
            elif model.endswith("-int8"):
                raise NotImplementedError(
                    "the -int8 DistilBERT path is not yet ported to "
                    "music_analyst_tpu_torch"
                )
            else:
                stripped = False
        if model != "distilbert":
            raise ValueError(f"unknown DistilBERT model name {model!r}")
        if tiny:
            config = config or DistilBertConfig.tiny()
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
        staging, asynchronous copy)."""
        texts, parts = prepared
        return texts, [
            (gather, n, to_device(arrays, self.device))
            for gather, n, arrays in parts
        ]

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

    def forward_logits_packed(self, texts: Sequence[str]) -> torch.Tensor:
        """Per-song class logits (f32) ``[len(texts), C]`` through the whole
        packed path (plan, wire, device-side expansion, CLS gather) — for
        checks and comparisons."""
        token_ids, lengths = self.tokenizer.encode_batch(texts, self.max_len)
        [((bin_of, slot_of), _, arrays)] = self._plan_packed(token_ids, lengths)
        with torch.inference_mode():
            logits = self._packed_logits(*to_device(arrays, self.device))
        return logits[torch.as_tensor(bin_of, device=logits.device),
                      torch.as_tensor(slot_of, device=logits.device)]

    def launch(self, transferred):
        """Dispatch phase: enqueue the forwards and the copies of their
        results back to the host; returns without waiting for the card."""
        texts, parts = transferred
        launched = []
        with torch.inference_mode():
            for gather, n, arrays in parts:
                if len(arrays) == 2:
                    classes, confidence = self._forward(*arrays)
                else:
                    classes, confidence = self._forward_packed(*arrays)
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
