"""Attention and MLP building blocks (PyTorch).

Counterpart of ``music_analyst_tpu/models/layers.py``:
``dot_product_attention`` (GQA included), ``MultiHeadAttention`` (dense
and flash paths, optional biases, GQA, RoPE, a KV cache), ``KVCache``,
``RMSNorm``, ``SwiGLU``, ``GeluMLP``, ``rope_frequencies``/``apply_rope``,
the ``causal_mask``/``padding_mask``/``segment_mask`` helpers, and the
quantized projections: ``QuantLinear`` (JAX ``QuantDenseGeneral``, dynamic
int8) and ``WqLinear`` (JAX ``WqDenseGeneral``, stored int8 / int4 codes),
picked by ``pick_dense_cls`` as JAX does.

Tensor parallelism (Megatron's pieces, plain torch, no kernel of their
own), trainable: a column-parallel projection is an ``nn.Linear`` holding
this rank's output rows and needs no communication, and attention and the
gated MLP pass their input through f (``parallel/mesh.copy_to_axis``: identity
forward, gradient summed over ``tp``); :class:`RowParallelLinear` sums its
partial products with g (``reduce_from_axis``: one ``all_reduce``,
identity backward) and adds its bias once, after the reduce;
:class:`VocabParallelEmbedding` looks up the ids of its vocabulary block
(zeros elsewhere) and sums with g; :class:`VocabParallelHead` passes its
input through f and all-gathers its f32 logits into the full vocabulary
(``gather_from_axis``: backward keeps this rank's slice), or returns its
local block for the vocab-parallel loss.  :func:`tensor_parallel_` installs them where
``parallel/sharding.py`` split a parameter.  The quantized projections
keep their class and take a role instead (:class:`_TensorParallel`): a
row-parallel one takes its scales over every rank's rows, so its
product is the unsharded one's.

Layouts follow the JAX package at the function boundaries (``[B, S, H, D]``
attention tensors, boolean masks broadcastable to ``[B, H, S, KV]``); the
projections are ``nn.Linear`` (weights ``[out, in]``), which the models'
``params_from_jax`` map from Flax's ``[in, out]``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from music_analyst_tpu_torch.ops.flash_attention import flash_attention
from music_analyst_tpu_torch.parallel.mesh import (
    copy_to_axis,
    gather_from_axis,
    reduce_from_axis,
)
from music_analyst_tpu_torch.ops.quant import (
    WQ_DEFAULT_GROUP,
    QuantizedParam,
    RowShard,
    kernel_major_empty,
    quant_linear,
    quantize_array,
    wq_group_size,
    wq_linear,
)


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain attention ``[B, S, H, D]`` with an f32 softmax.

    The JAX formulation step for step: logits in the input dtype, cast to
    f32 and scaled, masked with ``finfo(f32).min``, softmaxed in f32, cast
    back, then contracted with ``v``.  GQA broadcasts kv heads over their
    query-head groups.
    """
    n_q_heads, n_kv_heads = q.shape[2], k.shape[2]
    out_dtype = q.dtype
    # Mixed inputs (an f32 model over a bf16 cache) compute in the wider
    # type, as jnp's promotion does; the cast is exact.
    dtype = torch.promote_types(q.dtype, k.dtype)
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    if n_kv_heads != n_q_heads:
        group = n_q_heads // n_kv_heads
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(out_dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(dtype), v)


def causal_mask(q_len: int, kv_len: int, offset: int = 0,
                device=None) -> torch.Tensor:
    """``[1, 1, q_len, kv_len]`` causal mask with a cache offset."""
    q_pos = torch.arange(q_len, device=device)[:, None] + offset
    kv_pos = torch.arange(kv_len, device=device)[None, :]
    return (kv_pos <= q_pos)[None, None, :, :]


def padding_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """``[B, 1, 1, max_len]`` key-padding mask from per-row lengths."""
    pos = torch.arange(max_len, device=lengths.device)
    return (pos[None, :] < lengths[:, None])[:, None, None, :]


def segment_mask(segment_ids: torch.Tensor) -> torch.Tensor:
    """``[B, 1, S, S]`` block-diagonal mask: token pairs attend iff they
    share a segment id (packed batches)."""
    return segment_ids[:, None, :, None] == segment_ids[:, None, None, :]


def rope_frequencies(head_dim: int, max_positions: int,
                     theta: float = 10_000.0, device=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RoPE cos/sin tables ``[max_positions, head_dim / 2]`` in f32."""
    inv_freq = 1.0 / (theta ** (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
        / head_dim))
    positions = torch.arange(max_positions, dtype=torch.float32,
                             device=device)
    angles = torch.outer(positions, inv_freq)
    return torch.cos(angles), torch.sin(angles)


_ROPE_TABLES: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def _rope_tables(head_dim, max_positions, theta, device):
    """One table pair per geometry and device, shared by every layer."""
    key = (head_dim, max_positions, float(theta), str(device))
    tables = _ROPE_TABLES.get(key)
    if tables is None:
        tables = _ROPE_TABLES[key] = rope_frequencies(
            head_dim, max_positions, theta, device)
    return tables


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """Rotate ``x [B, S, H, D]`` by the angles at ``positions [B, S]``:
    contiguous halves (HF's ``rotate_half``), f32 arithmetic, result in
    ``x``'s dtype."""
    pos = positions.long()
    cos_p = cos[pos][:, :, None, :]
    sin_p = sin[pos][:, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    rotated = torch.cat(
        (x1 * cos_p - x2 * sin_p, x2 * cos_p + x1 * sin_p), dim=-1
    )
    return rotated.to(x.dtype)


@dataclasses.dataclass
class KVCache:
    """Per-layer decode cache; keys/values ``[B, max_len, n_kv_heads, D]``.

    ``length`` is the write offset: an int shared by every row (static
    batch decode), or a ``[B]`` tensor giving each row its own (slot
    views).  ``update`` writes into the buffers in place and returns the
    cache advanced past the new tokens; offsets clamp so the new tokens
    fit, as ``dynamic_update_slice`` does.
    """

    keys: torch.Tensor
    values: torch.Tensor
    length: Union[int, torch.Tensor]

    @classmethod
    def zeros(cls, batch: int, max_len: int, n_kv_heads: int, head_dim: int,
              dtype: torch.dtype = torch.bfloat16, device=None) -> "KVCache":
        shape = (batch, max_len, n_kv_heads, head_dim)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), 0)

    def update(self, k_new: torch.Tensor, v_new: torch.Tensor) -> "KVCache":
        S = k_new.shape[1]
        limit = self.keys.shape[1] - S
        k_new = k_new.to(self.keys.dtype)
        v_new = v_new.to(self.values.dtype)
        if isinstance(self.length, torch.Tensor) and self.length.dim() == 1:
            start = self.length.long().clamp(0, limit)
            rows = torch.arange(self.keys.shape[0], device=start.device)[:, None]
            cols = start[:, None] + torch.arange(S, device=start.device)
            self.keys[rows, cols] = k_new
            self.values[rows, cols] = v_new
        else:
            start = min(max(int(self.length), 0), limit)
            self.keys[:, start:start + S] = k_new
            self.values[:, start:start + S] = v_new
        return KVCache(self.keys, self.values, self.length + S)


class RMSNorm(nn.Module):
    """Root-mean-square norm with f32 statistics and an f32 scale, output
    in the input's dtype."""

    def __init__(self, dim: int, eps: float = 1e-5) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        normed = x32 * torch.rsqrt(
            x32.square().mean(dim=-1, keepdim=True) + self.eps)
        return (normed * self.weight.float()).to(x.dtype)


class LayerNorm(nn.Module):
    """LayerNorm with f32 statistics and f32 parameters, output in the
    input's dtype (Flax ``LayerNorm(dtype=bf16)`` semantics)."""

    def __init__(self, dim: int, eps: float) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.weight.shape, self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(x.dtype)


class _TensorParallel:
    """The tensor-parallel role of a quantized projection, set by
    :func:`tensor_parallel_`: ``None`` (whole, or column-parallel: its
    output block needs no collective), ``"row"`` (its block of the
    contraction rows, ``rows`` an ``ops/quant.RowShard``: maxima and sums
    over the axis, the bias once after the reduce) or ``"vocab"`` (the
    LM head's vocabulary block, all-gathered like
    :class:`VocabParallelHead`)."""

    tp_role: Optional[str] = None
    rows: Optional[RowShard] = None
    tp_mesh = None

    def _gather(self, y: torch.Tensor) -> torch.Tensor:
        if self.tp_role == "vocab":
            return gather_from_axis(y, self.tp_mesh, "tp", dim=-1)
        return y


class QuantLinear(_TensorParallel, nn.Linear):
    """``nn.Linear`` whose product runs the dynamic int8 path
    (``ops/quant.py``: weights per output channel, activations per row,
    int32 accumulation).  Parameters are ``nn.Linear``'s, so loaders and
    initialisers treat it as the float layer; output in the weight's
    dtype, bias added in f32 (JAX ``QuantDenseGeneral``).  Row-parallel,
    the weight's channel scales and the tokens' scales are maxima over
    every rank's rows, so the product is the unsharded one's."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._gather(quant_linear(
            x, self.weight, self.bias, out_dtype=self.weight.dtype,
            rows=self.rows))


class WqLinear(_TensorParallel, nn.Module):
    """A projection over a *stored* weight-quantized kernel (JAX
    ``WqDenseGeneral``).

    ``kernel_shape`` is the Flax kernel's shape ``[*contract, *features]``
    (``n_contract`` leading axes contracted; ``o_proj`` has two), whose
    flattened sizes are ``in_features`` and ``out_features``.  The buffers
    ``q`` (int8 codes, or packed int4 pairs along axis 0) and ``scale``
    (f32) keep Flax's logical shapes, so checkpoints and the quantized
    cache map onto them unchanged; ``q`` is laid out kernel-major (the
    flattened feature axis outermost in memory), the layout the card's
    int8 product is fast on.  The bias is f32.  The input's last axis is
    the flattened contraction; the output is ``[..., out_features]`` in
    ``dtype``.

    With a float kernel in the slot (:meth:`use_float_`) it computes the
    float product in ``dtype`` instead, as JAX does when the slot holds a
    float array.

    Under tensor parallelism (:meth:`shard_`) the buffers hold this
    rank's block of the codes and scales (``parallel/sharding.py``:
    JAX's ``_quantized_specs``), ``kernel_shape`` and the feature counts
    are the block's and ``full_kernel_shape`` the whole kernel's;
    :meth:`set_quantized` and :meth:`quantize_from_` take the whole
    kernel and keep the block, so the scales are the whole kernel's.
    """

    def __init__(self, in_features: int, out_features: int, scheme: str,
                 bias: bool = True, dtype: torch.dtype = torch.bfloat16,
                 kernel_shape: Optional[Tuple[int, ...]] = None,
                 n_contract: int = 1, group_size: int = WQ_DEFAULT_GROUP,
                 device=None) -> None:
        super().__init__()
        shape = tuple(kernel_shape or (in_features, out_features))
        K = math.prod(shape[:n_contract])
        F = math.prod(shape[n_contract:])
        if (K, F) != (in_features, out_features):
            raise ValueError(f"kernel shape {shape} does not contract "
                             f"{in_features} into {out_features}")
        if scheme == "int8":
            q_shape, group, G = shape, 0, 1
        elif scheme == "int4":
            if shape[0] % 2:
                raise ValueError(
                    f"int4 packing pairs elements along axis 0, which must "
                    f"be even (kernel shape {shape})")
            q_shape = (shape[0] // 2,) + shape[1:]
            group = wq_group_size(K, group_size)
            G = K // group
        else:
            raise ValueError(f"scheme must be int8/int4, got {scheme!r}")
        self.in_features, self.out_features = in_features, out_features
        self.scheme, self.kernel_shape = scheme, shape
        self.n_contract, self.group_size = n_contract, group
        self.dtype = dtype
        self.register_buffer("q", kernel_major_empty(q_shape, n_contract,
                                                     device=device))
        self.register_buffer("scale", torch.empty(
            (G,) + shape[n_contract:], dtype=torch.float32, device=device))
        self.weight = None
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device))
                     if bias else None)
        self.full_kernel_shape = shape
        # name → ShardSlice of the buffers this rank holds a block of.
        self.blocks: Dict[str, object] = {}

    @property
    def qparam(self) -> Optional[QuantizedParam]:
        """The stored kernel (views of the buffers), or ``None`` when the
        slot holds a float kernel."""
        if self.q is None:
            return None
        return QuantizedParam(self.q, self.scale, self.scheme,
                              self.kernel_shape, self.n_contract,
                              self.group_size)

    @torch.no_grad()
    def set_quantized(self, qp: QuantizedParam) -> None:
        """Copy a Flax-layout ``QuantizedParam`` of the whole kernel into
        the buffers (this rank's block of it when sharded)."""
        if (qp.scheme, tuple(qp.shape), qp.n_contract, qp.group_size) != (
                self.scheme, self.full_kernel_shape, self.n_contract,
                self.group_size):
            raise ValueError(
                f"quantized kernel {qp.scheme} {tuple(qp.shape)} "
                f"(n_contract {qp.n_contract}, group {qp.group_size}) does "
                f"not fit this slot: {self.scheme} {self.full_kernel_shape} "
                f"(n_contract {self.n_contract}, group {self.group_size})")
        for name in ("q", "scale"):
            value = torch.as_tensor(getattr(qp, name))
            block = self.blocks.get(name)
            if block is not None:
                value = block.take(value.to(self.q.device))
            getattr(self, name).copy_(value)

    @torch.no_grad()
    def quantize_from_(self, weight: torch.Tensor) -> None:
        """Quantize a float ``[out, in]`` weight (``nn.Linear`` layout) of
        the whole kernel into the buffers, on the buffers' device."""
        kernel = weight.t().reshape(self.full_kernel_shape).to(self.q.device)
        self.set_quantized(quantize_array(kernel, self.scheme,
                                          self.n_contract, self.group_size))

    @property
    def full_weight_shape(self) -> Tuple[int, int]:
        """``[out, in]`` of the whole kernel (``nn.Linear`` layout)."""
        shape = self.full_kernel_shape
        return (math.prod(shape[self.n_contract:]),
                math.prod(shape[:self.n_contract]))

    @torch.no_grad()
    def shard_(self, blocks: Dict[str, object]) -> None:
        """Keep this rank's block of each buffer ``blocks`` names
        (``parallel/sharding.py:ShardSlice``); the codes stay
        kernel-major, so the card's int8 product keeps its fast layout."""
        self.blocks = dict(blocks)
        for name, block in blocks.items():
            value = block.take(getattr(self, name))
            if name == "q":
                value = kernel_major_empty(value.shape, self.n_contract,
                                           value.dtype, value.device
                                           ).copy_(value)
            self._buffers[name] = value
        q_block = blocks.get("q")
        if q_block is not None:
            rows = q_block.bounds[0][1] - q_block.bounds[0][0]
            if self.scheme == "int4":
                rows *= 2
            self.kernel_shape = (rows,) + tuple(
                b - a for a, b in q_block.bounds[1:])
        self.in_features = math.prod(self.kernel_shape[:self.n_contract])
        self.out_features = math.prod(self.kernel_shape[self.n_contract:])

    def use_float_(self, weight: Optional[torch.Tensor] = None) -> None:
        """Hold a float ``[out, in]`` kernel instead of codes."""
        device = self.scale.device
        self.q = self.scale = None
        w = torch.empty(self.out_features, self.in_features, dtype=self.dtype,
                        device=device)
        self.weight = nn.Parameter(w, requires_grad=False)
        if weight is not None:
            with torch.no_grad():
                self.weight.copy_(weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.weight is not None:
            bias = None if self.bias is None else self.bias.to(self.dtype)
            if self.rows is None:
                y = F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                             bias)
            else:
                y = reduce_from_axis(F.linear(x.to(self.dtype),
                                              self.weight.to(self.dtype)),
                                     self.rows.mesh, self.rows.axis)
                y = y if bias is None else y + bias
            return self._gather(y)
        return self._gather(wq_linear(x, self.qparam, self.bias,
                                      out_dtype=self.dtype, rows=self.rows))

    def extra_repr(self) -> str:
        return (f"{self.in_features} -> {self.out_features}, {self.scheme}, "
                f"kernel {self.kernel_shape}, n_contract={self.n_contract}, "
                f"group={self.group_size}")


def pick_dense_cls(weight_quant: str, quant: str):
    """One projection decision for every model family: stored weight-quant
    wins, then dynamic int8, then float.  Returns a factory
    ``make(in_features, out_features, bias, dtype, kernel_shape=None,
    n_contract=1)``; the Flax kernel shape matters only to ``WqLinear``."""
    def make(in_features, out_features, bias, dtype, kernel_shape=None,
             n_contract=1):
        if weight_quant != "none":
            return WqLinear(in_features, out_features, weight_quant,
                            bias=bias, dtype=dtype, kernel_shape=kernel_shape,
                            n_contract=n_contract)
        cls = QuantLinear if quant == "int8" else nn.Linear
        return cls(in_features, out_features, bias=bias, dtype=dtype)

    return make


def use_float_slots_(model: nn.Module, state_dict) -> None:
    """Switch each ``WqLinear`` whose slot the state dict fills with a
    float ``weight`` (a Flax tree holding a float kernel there) to its
    float path, so the state dict loads."""
    for name, module in model.named_modules():
        if isinstance(module, WqLinear) and f"{name}.weight" in state_dict:
            module.use_float_()


def param_slots(model: nn.Module):
    """``(name, shape, module)`` for every float parameter slot in
    ``named_parameters`` order, with each ``WqLinear``'s kernel as a
    ``{name}.weight`` slot of ``nn.Linear`` shape ``[out, in]`` (so seeded
    initialisers draw the same values with or without quantization); a
    sharded ``WqLinear``'s slot has the whole kernel's shape, which
    :meth:`WqLinear.quantize_from_` takes."""
    for mname, module in model.named_modules():
        prefix = f"{mname}." if mname else ""
        if isinstance(module, WqLinear) and module.weight is None:
            yield f"{prefix}weight", module.full_weight_shape, module
        for pname, param in module.named_parameters(recurse=False):
            yield f"{prefix}{pname}", tuple(param.shape), module


class MultiHeadAttention(nn.Module):
    """MHA/GQA self-attention with per-Q/K/V/O projections, optional RoPE
    and an optional KV cache.

    ``attn_impl="flash"`` runs the flash-attention kernel
    (``ops/flash_attention.py``) without a cache, masking by ``lengths``,
    ``segment_ids`` and, with ``flash_causal``, causally (Llama's
    no-cache path); ``"dense"`` takes a boolean ``mask`` array and
    materialises the logits.  With a ``cache`` the new K/V rows are written
    first and attention runs over the whole cache (dense), or, for a cache
    that has an ``attend`` method (``ops/paged_attention.PagedAttnView``),
    through that method; ``forward`` then returns ``(out, new_cache)``.
    Under tensor parallelism (``tp_mesh``) the input passes f.
    """

    tp_mesh = None

    def __init__(
        self,
        dim: int,
        n_heads: int,
        attn_impl: str = "dense",
        use_bias: bool = False,
        dtype: torch.dtype = torch.bfloat16,
        n_kv_heads: Optional[int] = None,
        head_dim: Optional[int] = None,
        use_rope: bool = False,
        rope_theta: float = 10_000.0,
        max_positions: int = 4096,
        quant: str = "none",
        weight_quant: str = "none",
        flash_causal: bool = False,
    ) -> None:
        super().__init__()
        if attn_impl not in ("dense", "flash"):
            raise ValueError(f"attn_impl must be dense/flash, got {attn_impl!r}")
        self.n_heads = n_heads
        self.n_kv_heads = n_kv_heads or n_heads
        self.head_dim = head_dim or dim // n_heads
        self.attn_impl = attn_impl
        self.flash_causal = flash_causal
        self.use_rope = use_rope
        self.rope_theta = rope_theta
        self.max_positions = max_positions
        q_dim = self.n_heads * self.head_dim
        kv_dim = self.n_kv_heads * self.head_dim
        dense = pick_dense_cls(weight_quant, quant)
        self.q_proj = dense(dim, q_dim, use_bias, dtype,
                            (dim, self.n_heads, self.head_dim))
        self.k_proj = dense(dim, kv_dim, use_bias, dtype,
                            (dim, self.n_kv_heads, self.head_dim))
        self.v_proj = dense(dim, kv_dim, use_bias, dtype,
                            (dim, self.n_kv_heads, self.head_dim))
        self.o_proj = dense(q_dim, dim, use_bias, dtype,
                            (self.n_heads, self.head_dim, dim), n_contract=2)

    def forward(
        self,
        x: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        lengths: Optional[torch.Tensor] = None,
        segment_ids: Optional[torch.Tensor] = None,
        positions: Optional[torch.Tensor] = None,
        cache=None,
    ):
        x = copy_to_axis(x, self.tp_mesh)
        B, S, _ = x.shape
        q = self.q_proj(x).view(B, S, self.n_heads, self.head_dim)
        k = self.k_proj(x).view(B, S, self.n_kv_heads, self.head_dim)
        v = self.v_proj(x).view(B, S, self.n_kv_heads, self.head_dim)
        if self.use_rope:
            if positions is None:
                positions = torch.arange(S, device=x.device).expand(B, S)
            cos, sin = _rope_tables(self.head_dim, self.max_positions,
                                    self.rope_theta, x.device)
            q = apply_rope(q, cos, sin, positions)
            k = apply_rope(k, cos, sin, positions)
        new_cache = None
        paged = False
        if cache is not None:
            new_cache = cache.update(k, v)
            paged = hasattr(new_cache, "attend")
            if not paged:
                k, v = new_cache.keys, new_cache.values
        if paged:
            out = new_cache.attend(q, mask)
        elif self.attn_impl == "flash" and cache is None:
            # The kernel masks only through lengths / segments; an
            # arbitrary mask array cannot reach it, so refuse one outright.
            if mask is not None:
                raise ValueError(
                    "attn_impl='flash' cannot apply a mask array; pass "
                    "mask=None with lengths= (padding) and/or segment_ids=, "
                    "or use attn_impl='dense'"
                )
            # The kernel reads q/k/v as dense [B, S, H, D] rows.
            out = flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), lengths=lengths,
                                  causal=self.flash_causal,
                                  q_segment_ids=segment_ids)
        else:
            if segment_ids is not None:
                raise ValueError(
                    "segment_ids is the flash path's masking vocabulary; "
                    "dense callers pass a block-diagonal mask array"
                )
            out = dot_product_attention(q, k, v, mask)
        out = self.o_proj(out.reshape(B, S, self.n_heads * self.head_dim))
        if cache is not None:
            return out, new_cache
        return out


class SwiGLU(nn.Module):
    """Llama-style gated MLP: ``down(silu(gate(x)) * up(x))``."""

    def __init__(self, dim: int, hidden_dim: int,
                 dtype: torch.dtype = torch.bfloat16, quant: str = "none",
                 weight_quant: str = "none") -> None:
        super().__init__()
        dense = pick_dense_cls(weight_quant, quant)
        self.gate_proj = dense(dim, hidden_dim, False, dtype)
        self.up_proj = dense(dim, hidden_dim, False, dtype)
        self.down_proj = dense(hidden_dim, dim, False, dtype)

    tp_mesh = None   # tensor_parallel_: the input passes f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = copy_to_axis(x, self.tp_mesh)
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class GeluMLP(nn.Module):
    """BERT-style 2-layer MLP with biases and exact (erf) GELU."""

    def __init__(self, dim: int, hidden_dim: int,
                 dtype: torch.dtype = torch.bfloat16, quant: str = "none",
                 weight_quant: str = "none") -> None:
        super().__init__()
        dense = pick_dense_cls(weight_quant, quant)
        self.lin1 = dense(dim, hidden_dim, True, dtype)
        self.lin2 = dense(hidden_dim, dim, True, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lin2(F.gelu(self.lin1(x), approximate="none"))


class RowParallelLinear(nn.Module):
    """``nn.Linear`` over this rank's input columns: the partial products
    are summed over ``tp`` (g: one ``all_reduce``, identity backward),
    then the bias is added once — added on every rank before the reduce
    it would count tp times."""

    def __init__(self, linear: nn.Linear, mesh, axis: str = "tp") -> None:
        super().__init__()
        self.weight = linear.weight
        self.bias = linear.bias
        self.mesh, self.axis = mesh, axis

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = reduce_from_axis(F.linear(x, self.weight), self.mesh, self.axis)
        return y if self.bias is None else y + self.bias


class VocabParallelEmbedding(nn.Module):
    """Embedding over this rank's vocabulary block ``[start, start +
    rows)``: ids outside it give zero rows, and the all-reduce over
    ``tp`` (g) adds the one rank's row to zeros — exact; each rank's
    weight gradient is its block's rows."""

    def __init__(self, embedding: nn.Embedding, start: int, mesh,
                 axis: str = "tp") -> None:
        super().__init__()
        self.weight = embedding.weight
        self.start = int(start)
        self.mesh, self.axis = mesh, axis

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        rows = self.weight.shape[0]
        local = ids - self.start
        outside = (local < 0) | (local >= rows)
        out = F.embedding(local.clamp(0, rows - 1), self.weight)
        out = out.masked_fill(outside[..., None], 0)
        return reduce_from_axis(out, self.mesh, self.axis)


class VocabParallelHead(nn.Module):
    """LM head over this rank's vocabulary rows ``[start, start + rows)``:
    the input passes f (its gradient sums over ``tp``), local logits in
    the weight's dtype (f32 for Llama), then one all-gather along the
    vocabulary into the full ``[..., V]`` — so a greedy argmax ties to
    the lowest index exactly as on one rank; the gather's backward keeps
    this rank's slice.  ``gather=False`` returns the local logits (the
    vocab-parallel loss, ``models/llama.py:token_nll``)."""

    def __init__(self, linear: nn.Linear, mesh, axis: str = "tp",
                 start: int = 0) -> None:
        super().__init__()
        self.weight = linear.weight
        self.bias = linear.bias
        self.mesh, self.axis = mesh, axis
        self.start = int(start)

    def forward(self, x: torch.Tensor, gather: bool = True) -> torch.Tensor:
        x = copy_to_axis(x, self.mesh, self.axis)
        y = F.linear(x, self.weight, self.bias)
        return gather_from_axis(y, self.mesh, self.axis) if gather else y


def _out_rows(proj: nn.Module) -> int:
    """Output features a (possibly sharded) projection computes."""
    weight = getattr(proj, "weight", None)
    return weight.shape[0] if weight is not None else proj.out_features


def tensor_parallel_(model: nn.Module, mesh, layout) -> None:
    """Give the modules whose parameters ``layout`` split their
    tensor-parallel forms (in place; parameter names are unchanged):
    attention keeps its per-rank head counts, attention and the gated MLP
    pass their input through f (``tp_mesh``), a linear whose input
    columns were split becomes :class:`RowParallelLinear`, a split
    embedding :class:`VocabParallelEmbedding` and the split ``lm_head``
    :class:`VocabParallelHead`.  A quantized projection (``QuantLinear``,
    ``WqLinear``) keeps its class and takes its role
    (:class:`_TensorParallel`)."""
    for name, module in list(model.named_modules()):
        prefix = f"{name}." if name else ""
        if isinstance(module, MultiHeadAttention):
            module.n_heads = _out_rows(module.q_proj) // module.head_dim
            module.n_kv_heads = _out_rows(module.k_proj) // module.head_dim
        if isinstance(module, (MultiHeadAttention, SwiGLU)):
            module.tp_mesh = mesh
        piece = layout.get(f"{prefix}weight")
        parent_name, _, leaf = name.rpartition(".")
        if isinstance(module, _TensorParallel):
            if isinstance(module, WqLinear) and piece is None:
                piece = layout.get(f"{prefix}q")
            if piece is None:
                continue
            module.tp_mesh = mesh
            if leaf == "lm_head":
                module.tp_role = "vocab"
            elif piece.bounds[0] != (0, piece.full_shape[0]) and (
                    isinstance(module, WqLinear) and module.weight is None):
                # Codes [*contract, *features]: a split contraction.
                module.tp_role = "row"
            elif piece.bounds[1] != (0, piece.full_shape[1]) and (
                    module.weight is not None):
                # A float [out, in] weight: a split input axis.
                module.tp_role = "row"
            if module.tp_role == "row":
                module.rows = RowShard(mesh, "tp", _row_start(module, piece))
            continue
        if piece is None:
            continue
        parent = model.get_submodule(parent_name)
        if isinstance(module, nn.Embedding):
            setattr(parent, leaf, VocabParallelEmbedding(
                module, piece.bounds[0][0], mesh))
        elif type(module) is nn.Linear and leaf == "lm_head":
            setattr(parent, leaf, VocabParallelHead(
                module, mesh, start=piece.bounds[0][0]))
        elif type(module) is nn.Linear and (
                piece.bounds[1] != (0, piece.full_shape[1])):
            setattr(parent, leaf, RowParallelLinear(module, mesh))


def _row_start(module: nn.Module, piece) -> int:
    """The first flattened contraction row a row-parallel rank holds."""
    if module.weight is not None:
        return piece.bounds[1][0]
    # Codes: a block of axis 0 (packed pairs for int4) of [*contract, ...].
    start = piece.bounds[0][0] * (2 if module.scheme == "int4" else 1)
    return start * math.prod(module.full_kernel_shape[1:module.n_contract])
