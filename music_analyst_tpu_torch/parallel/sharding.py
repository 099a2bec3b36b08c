"""Parameter partition rules on the port's parameter names.

The counterpart of ``music_analyst_tpu/parallel/sharding.py``: the
Megatron layout — q/k/v split the *head* axis over ``tp`` and ``o_proj``
its input heads (one all-reduce per attention block); gate/up and
``lin1`` split the hidden axis and down/``lin2`` its input (one all-reduce
per MLP); embeddings and the LM head split the vocabulary.  Norms, the
position table, ``o_proj``/``lin2`` biases and the classifier heads
replicate.

A spec is a tuple with one mesh-axis name (or ``None``) per dimension of
the *port's* tensor: an ``nn.Linear`` weight is ``[out, in]``, where JAX's
q/k/v kernels are ``[dim, heads, head_dim]`` and ``o_proj`` is ``[heads,
head_dim, dim]``.  So ``q_proj.weight`` ``[H * Dh, dim]`` splits dimension
0 in blocks of whole heads — rank ``i``'s rows are JAX device ``i``'s
``[:, heads_i, :]`` — and the split must divide the *head count*, as JAX's
does.  A split that does not divide raises ``ValueError``, as JAX's
``device_put`` does.

:func:`shard_params` replaces each sharded parameter by this rank's slice
(a contiguous tensor of its own) and turns the modules that need a
collective into their tensor-parallel forms (``models/layers.py``):
row-parallel projections, the vocab-parallel embedding and LM head; each
``MultiHeadAttention`` keeps ``n_heads / tp`` and ``n_kv_heads / tp``.
A stored quantized kernel (``WqLinear``'s ``q`` / ``scale`` buffers, in
Flax's layout) is placed by :func:`quantized_specs`, JAX's
``_quantized_specs``.  Axes absent from the mesh (or of size 1) prune to
replication, so a dp-only mesh leaves the model as it is.  MoE expert
stacks split their expert axis over ``ep`` and their hidden axis over
``tp`` (JAX's rules); each ``MoESwiGLU`` takes its mesh form
(``models/moe.py``), also on a dp-only mesh, where its train-step rows
take global capacity and slots.

ZeRO-1 (:func:`zero1_slices`, JAX's ``zero1_shard_opt_state``): the
AdamW moments of a parameter with a free axis that ``dp`` divides, in
Flax's layout (``_flax_axes``), shard over ``dp``; each rank steps one
flat row of its block.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

Spec = Tuple[Optional[str], ...]

# (regex over state_dict names, spec) — first match wins.
TP_RULES: List[Tuple[str, Spec]] = [
    # attention: weight [H * Dh, dim], bias [H * Dh] — shard heads
    (r".*(q_proj|k_proj|v_proj)\.weight$", ("tp", None)),
    (r".*(q_proj|k_proj|v_proj)\.bias$", ("tp",)),
    # output projection: weight [dim, H * Dh] — shard input heads
    (r".*o_proj\.weight$", (None, "tp")),
    # gated MLP: gate/up [hidden, dim], down [dim, hidden]
    (r".*(gate_proj|up_proj)\.weight$", ("tp", None)),
    (r".*down_proj\.weight$", (None, "tp")),
    # MoE expert stacks [E, dim, hidden] / [E, hidden, dim]
    (r".*(gate_experts|up_experts)$", ("ep", None, "tp")),
    (r".*down_experts$", ("ep", "tp", None)),
    # BERT-style MLP: lin1 [hidden, dim] (+ bias), lin2 [dim, hidden]
    (r".*ffn\.lin1\.weight$", ("tp", None)),
    (r".*ffn\.lin2\.weight$", (None, "tp")),
    (r".*ffn\.lin1\.bias$", ("tp",)),
    # vocab-sharded embedding + LM head: [vocab, dim]
    (r".*(word_embeddings|tok_embeddings)\.weight$", ("tp", None)),
    (r".*lm_head\.weight$", ("tp", None)),
]

# Decode KV layout: logical axis → mesh axis.  Both caches — the slot
# cache [n_slots, max_total, n_kv_heads, head_dim] and the paged pool
# [n_pages + 1, page_size, n_kv_heads, head_dim] — put the KV-head axis
# third and shard it with the projections that feed it.
DECODE_KV_RULES = {
    "slots": None,
    "pages": None,
    "tokens": None,
    "kv_heads": "tp",
    "head_dim": None,
    "lengths": None,
}


def kv_cache_spec(mesh, n_kv_heads: int) -> Tuple[Spec, Spec]:
    """(keys/values spec, lengths spec) of a decode KV cache on ``mesh``:
    the head axis shards over ``tp`` when the mesh has a tp axis that
    divides ``n_kv_heads``, else the cache replicates (JAX's rule)."""
    head_axis = DECODE_KV_RULES["kv_heads"]
    tp = mesh.axis_size(head_axis) if mesh is not None else 1
    if tp > 1 and n_kv_heads % tp == 0:
        return (None, None, head_axis, None), ()
    return (), ()


def local_kv_heads(mesh, n_kv_heads: int) -> int:
    """The KV heads one rank's cache holds under :func:`kv_cache_spec`."""
    kv, _ = kv_cache_spec(mesh, n_kv_heads)
    return n_kv_heads // mesh.axis_size(kv[2]) if kv else n_kv_heads


def spec_for_path(path: str, rules=None) -> Spec:
    for pattern, spec in rules or TP_RULES:
        if re.match(pattern, path):
            return spec
    return ()  # replicate


def prune_spec(spec: Spec, axis_names: Sequence[str]) -> Spec:
    """Drop axes absent from the mesh (the same rules serve dp-only,
    dp×tp, ... meshes)."""
    return tuple(a if a in axis_names else None for a in spec)


def partition_specs(model: nn.Module, rules=None) -> Dict[str, Spec]:
    """Spec of every parameter of ``model``, by ``state_dict`` name."""
    return {name: spec_for_path(name, rules)
            for name, _ in model.named_parameters()}


@dataclasses.dataclass(frozen=True)
class ShardSlice:
    """One rank's block of a sharded parameter: the full shape and the
    ``(start, stop)`` kept along each dimension."""

    full_shape: Tuple[int, ...]
    bounds: Tuple[Tuple[int, int], ...]

    def take(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``full`` as a contiguous tensor of its
        own (never a strided view of ``full``)."""
        if tuple(full.shape) != self.full_shape:
            raise ValueError(f"expected shape {self.full_shape}, got "
                             f"{tuple(full.shape)}")
        block = full
        for dim, (start, stop) in enumerate(self.bounds):
            block = block.narrow(dim, start, stop - start)
        return block.clone(memory_format=torch.contiguous_format)


def _head_units(model: nn.Module) -> Dict[str, int]:
    """Rows (or columns) per head of each attention projection: a head
    split moves whole heads."""
    from music_analyst_tpu_torch.models.layers import MultiHeadAttention

    units = {}
    for name, module in model.named_modules():
        if isinstance(module, MultiHeadAttention):
            for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
                for leaf in ("weight", "bias"):
                    units[f"{name}.{proj}.{leaf}"] = module.head_dim
    return units


def shard_slice(name: str, shape: Sequence[int], spec: Spec, mesh,
                unit: int = 1) -> Optional[ShardSlice]:
    """This rank's :class:`ShardSlice` of a ``shape`` parameter under
    ``spec`` (``None`` when nothing is split).  Raises ``ValueError`` when
    a split does not divide (in units of ``unit`` elements)."""
    bounds, split = [], False
    padded = tuple(spec) + (None,) * (len(shape) - len(spec))
    for dim, (size, axis) in enumerate(zip(shape, padded)):
        parts = mesh.axis_size(axis) if axis else 1
        if parts == 1:
            bounds.append((0, size))
            continue
        if size % unit or (size // unit) % parts:
            what = "heads" if unit > 1 else "size"
            raise ValueError(
                f"{name}: sharding {spec} over {mesh.shape} implies that the "
                f"global {what} of its dimension {dim} should be divisible "
                f"by {parts}, but it is equal to {size // unit}")
        share = size // parts
        start = mesh.coord(axis) * share
        bounds.append((start, start + share))
        split = True
    return ShardSlice(tuple(shape), tuple(bounds)) if split else None


def quantized_specs(weight_spec: Spec, kernel_shape: Sequence[int],
                    n_contract: int) -> Tuple[Spec, Spec]:
    """``(q spec, scale spec)`` of a stored quantized kernel (JAX's
    ``_quantized_specs``) from the spec of its float ``nn.Linear`` weight
    ``[out, in]``.  The codes keep Flax's ``[*contract, *features]``
    layout, so the weight's ``out`` split lands on the first feature axis
    (the heads of q/k/v, the hidden axis of gate/up/``lin1``, the
    vocabulary of ``lm_head``) and its ``in`` split on axis 0 (the heads
    of ``o_proj``, the hidden axis of down/``lin2``) — for int4 the packed
    axis, whose block of byte rows is a block of code-row pairs.  The
    scale ``[G, *features]`` replicates its group axis and takes the
    features' placement."""
    out_axis, in_axis = (tuple(weight_spec) + (None, None))[:2]
    q = [None] * len(kernel_shape)
    q[0], q[n_contract] = in_axis, out_axis
    scale = [None] * (len(kernel_shape) - n_contract + 1)
    scale[1] = out_axis
    return tuple(q), tuple(scale)


def shard_layout(model: nn.Module, mesh, rules=None) -> Dict[str, ShardSlice]:
    """Every parameter this rank holds a block of, with its slice; a
    ``WqLinear`` holding codes contributes its ``q`` and ``scale``
    buffers, placed by :func:`quantized_specs`."""
    from music_analyst_tpu_torch.models.layers import WqLinear

    names = set(mesh.axis_names)
    units = _head_units(model)
    layout = {}
    tensors = [(name, param, spec_for_path(name, rules))
               for name, param in model.named_parameters()]
    for mname, module in model.named_modules():
        if isinstance(module, WqLinear) and module.weight is None:
            prefix = f"{mname}." if mname else ""
            specs = quantized_specs(spec_for_path(f"{prefix}weight", rules),
                                    module.full_kernel_shape,
                                    module.n_contract)
            for leaf, spec in zip(("q", "scale"), specs):
                tensors.append((f"{prefix}{leaf}", getattr(module, leaf),
                                spec))
    for name, tensor, spec in tensors:
        piece = shard_slice(name, tuple(tensor.shape),
                            prune_spec(spec, names), mesh, units.get(name, 1))
        if piece is not None:
            layout[name] = piece
    return layout


def _moe_to_mesh_(model: nn.Module, mesh, layout) -> None:
    """Give every ``MoESwiGLU`` its mesh form: the first expert and hidden
    row of its blocks (``models/moe.py``)."""
    from music_analyst_tpu_torch.models.moe import MoESwiGLU

    for name, module in model.named_modules():
        if isinstance(module, MoESwiGLU):
            prefix = f"{name}." if name else ""
            gate = layout.get(f"{prefix}gate_experts")
            down = layout.get(f"{prefix}down_experts")
            hidden = (down.bounds[1][0] if down is not None
                      and down.bounds[1] != (0, down.full_shape[1])
                      else None)
            module.to_mesh_(mesh, gate.bounds[0][0] if gate else 0, hidden)


def shard_params(model: nn.Module, mesh, rules=None) -> nn.Module:
    """Keep this rank's block of every sharded parameter and turn the
    modules that need a collective into their tensor-parallel forms.

    Works on a materialised model and on a ``meta`` one (whose blocks are
    then filled by the caller, e.g. a seeded init drawing each full
    tensor and keeping :attr:`ShardSlice.take` of it).  The layout is
    kept as ``model.tp_layout`` (name → :class:`ShardSlice`).
    """
    layout = shard_layout(model, mesh, rules)
    buffers: Dict[str, Dict[str, ShardSlice]] = {}
    for name, piece in layout.items():
        owner_name, _, leaf = name.rpartition(".")
        owner = model.get_submodule(owner_name)
        if leaf in owner._buffers:
            buffers.setdefault(owner_name, {})[leaf] = piece
            continue
        old = owner._parameters[leaf]
        owner._parameters[leaf] = nn.Parameter(
            piece.take(old.detach()), requires_grad=old.requires_grad)
    for owner_name, blocks in buffers.items():
        model.get_submodule(owner_name).shard_(blocks)
    if layout:
        from music_analyst_tpu_torch.models.layers import tensor_parallel_

        tensor_parallel_(model, mesh, layout)
    _moe_to_mesh_(model, mesh, layout)
    model.tp_layout = layout
    return model


def shard_state_dict(state_dict, layout: Dict[str, ShardSlice]):
    """This rank's blocks of a full state dict (tensors or arrays)."""
    out = {}
    for name, value in state_dict.items():
        piece = layout.get(name)
        if piece is not None:
            value = piece.take(torch.as_tensor(value))
        out[name] = value
    return out


# ----------------------------------------------------------------- ZeRO-1


def _flax_axes(model: nn.Module, mesh, rules=None
              ) -> Dict[str, List[Tuple[int, Optional[str]]]]:
    """Each parameter's axes in Flax's layout, as ``(global size, mesh
    axis or None)``: an ``nn.Linear`` weight ``[out, in]`` is a Flax
    kernel ``[in, out]``, with the head axis apart for attention (q/k/v
    ``[dim, H, Dh]``, ``o_proj`` ``[H, Dh, dim]``, q/k/v biases ``[H,
    Dh]``); embeddings, norms and other biases keep their layout."""
    from music_analyst_tpu_torch.models.layers import VocabParallelEmbedding

    names = set(mesh.axis_names)
    layout = getattr(model, "tp_layout", {})
    units = _head_units(model)
    out = {}
    for mname, module in model.named_modules():
        for pname, param in module.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            piece = layout.get(name)
            shape = piece.full_shape if piece else tuple(param.shape)
            spec = prune_spec(spec_for_path(name, rules), names)
            axes = list(zip(shape, tuple(spec) + (None,) * (
                len(shape) - len(spec))))
            unit = units.get(name)
            linear = (len(shape) == 2 and pname == "weight"
                      and not isinstance(module, (nn.Embedding,
                                                  VocabParallelEmbedding)))
            if linear:
                (n_out, a_out), (n_in, a_in) = axes
                if unit and name.endswith("o_proj.weight"):
                    axes = [(n_in // unit, a_in), (unit, None),
                            (n_out, a_out)]
                elif unit:
                    axes = [(n_in, a_in), (n_out // unit, a_out),
                            (unit, None)]
                else:
                    axes = [(n_in, a_in), (n_out, a_out)]
            elif unit and not name.endswith("o_proj.bias"):
                (n, a), = axes
                axes = [(n // unit, a), (unit, None)]
            out[name] = axes
    return out


@dataclasses.dataclass(frozen=True)
class Zero1Slice:
    """This rank's ZeRO-1 share of one parameter's optimizer state: the
    rank's (tp) block flattened and cut into ``parts`` equal rows, of
    which the rank steps row ``index``."""

    parts: int
    index: int

    def take(self, block: torch.Tensor) -> torch.Tensor:
        """This rank's row of ``block``: a view of a contiguous block."""
        return block.view(self.parts, -1)[self.index]


def zero1_slices(model: nn.Module, mesh, rules=None
                 ) -> Dict[str, Zero1Slice]:
    """The parameters whose AdamW moments shard over ``dp`` under ZeRO-1,
    with this rank's :class:`Zero1Slice` of each.

    JAX's rule (``engines/train.py:zero1_shard_opt_state``): ``dp`` goes
    on the first axis of the leaf, in Flax's layout (``_flax_axes``),
    that is still unsharded and whose global size ``dp`` divides; a leaf
    with no such axis keeps its moments as the parameter's.  The port cuts
    its own ``[out, in]`` block flatly instead of along that axis: the
    share holds as many elements as JAX's addressable shard (the axis is
    whole in the block, so ``dp`` divides the block)."""
    dp = mesh.axis_size("dp")
    if dp <= 1:
        return {}
    share = Zero1Slice(dp, mesh.coord("dp"))
    return {name: share for name, axes in _flax_axes(model, mesh, rules).items()
            if any(axis is None and size % dp == 0 for size, axis in axes)}
