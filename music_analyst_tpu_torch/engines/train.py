"""Training step for the decoder LM family (PyTorch, one device or a mesh
of ranks).

Counterpart of ``music_analyst_tpu/engines/train.py``: next-token
cross-entropy with packed documents (:func:`causal_lm_loss`), AdamW with
optax's defaults (:func:`make_optimizer`), the train state
(:func:`init_train_state`), the step (:func:`make_train_step`) with its
telemetry, and the host→device batch prefetch (:func:`prefetch_batches`).

Master parameters.  Flax keeps f32 parameters and casts them to the
compute dtype where they are used; optax keeps the Adam moments in the
parameters' dtype.  The port's model stores its weights in
``config.dtype`` (bf16 for inference), so a train state keeps an f32
master of every weight and steps the masters: the step loads the masters
into the model's working weights (rounding to bf16 where the model keeps
bf16), runs forward and backward on them, widens each weight's gradient
to f32 (what JAX's gradient of an f32 parameter cast to bf16 is) and takes
the AdamW step on the masters.  Both moments are f32.  The state shares no
tensor with the model, which only computes: two states can take turns on
one model.

On a mesh (``mesh=``, a ``parallel/mesh.DeviceMesh`` over ranks, one
process a rank) with ``dp``, ``tp`` and ``ep`` axes: the model keeps this rank's
tensor-parallel blocks (``parallel/sharding.py:shard_params``, JAX's
``TP_RULES``) and the masters and both moments follow them, replicated
over ``dp`` as JAX keeps ``params``.  Each rank runs forward and backward
on its own ``dp`` rows (:func:`prefetch_batches` hands them out), the loss
being its rows' summed cross-entropy over the *global* batch's valid-token
count (all-reduced over ``dp``), so the gradients sum over ``dp``
(``parallel/mesh.all_reduce_many``) and the returned loss — the sum of the
ranks' parts — is JAX's global mean on every rank.  With ``zero1=True``
the moments shard over ``dp`` by JAX's rule (``parallel/sharding.py:
zero1_slices``): each rank reduce-scatters the gradients, steps its slice
of the masters and moments, and the masters are all-gathered over ``dp``.

MoE models: under ``ep`` each rank holds its block of the experts, the
ranks of an ``ep`` line take the same rows (as those of a ``tp`` line),
and the expert stacks' gradients reduce over ``dp`` (and their moments
shard under ZeRO-1) within each ``ep`` coordinate, since the ``dp`` group
is the line of ranks that share it; the MoE layers take the global
batch's capacity and slots (``models/moe.py``).  JAX's train step adds no
load-balancing loss, and neither does this one.  Not yet ported: a mesh
with an ``sp`` axis.  The flash kernel is forward only, as the Pallas kernel is, so
:func:`make_train_step` refuses ``attn_impl="flash"``; the loss itself runs
through the kernel under ``torch.no_grad()`` (evaluation).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from music_analyst_tpu_torch.device import DeviceLike, resolve_device
from music_analyst_tpu_torch.models.layers import causal_mask, segment_mask
from music_analyst_tpu_torch.parallel import mesh as mesh_lib

# Mesh axes the train step covers; any other axis of size > 1 is refused.
MESH_AXES = ("dp", "tp", "ep")


@dataclasses.dataclass
class TrainState:
    """``params``: the f32 masters by the model's parameter names (this
    rank's tensor-parallel blocks on a mesh); ``opt_state``: the
    ``torch.optim.AdamW`` over them, in the same order (its state holds
    both f32 moments); ``step``: a 0-dim int32 tensor on their device.

    On a mesh: ``mesh``; ``tp_layout``, the model's ``ShardSlice`` of each
    tp-split parameter; ``zero1``, the ``Zero1Slice`` of each parameter
    whose moments shard over ``dp`` — for those the optimizer holds this
    rank's row of the flattened master (a view), not the whole master.

    The step updates params and moments in place and returns a state with
    the next step count, so callers reassign (``state, loss = step(state,
    ...)``) as with JAX's donated state."""

    params: Dict[str, torch.Tensor]
    opt_state: torch.optim.Optimizer
    step: torch.Tensor
    mesh: Any = None
    tp_layout: Dict[str, Any] = dataclasses.field(default_factory=dict)
    zero1: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def opt_tensors(self) -> Dict[str, torch.Tensor]:
        """The tensor the optimizer steps for each parameter name."""
        return dict(zip(self.params, self.opt_state.param_groups[0]["params"]))


def causal_lm_loss(model, token_ids: torch.Tensor, lengths: torch.Tensor,
                   segment_ids: Optional[torch.Tensor] = None,
                   mesh=None) -> torch.Tensor:
    """Next-token cross-entropy over ``token_ids [B, S+1]`` with padding
    (past ``lengths``) masked out; a 0-dim f32 tensor.

    On a mesh the rows are this rank's ``dp`` rows and the sum is divided
    by the valid-token count of every rank's rows (all-reduced over
    ``dp``): the ranks' losses sum to the global batch's mean.  Under
    ``tp`` the cross-entropy is vocab-parallel (``models/llama.py:
    token_nll``).

    ``segment_ids [B, S+1]`` (contiguous document ids per row, 0 = pad)
    packs documents into a row: attention stays within a document,
    positions restart at every document, and the boundary target (a
    document's last token predicting the next document's first) is
    dropped, so a packed row's per-token losses equal the per-document
    rows'.  The flash path takes the segment ids in the kernel; the dense
    path folds them into the mask as ``causal & same-segment``."""
    inputs = token_ids[:, :-1]
    targets = token_ids[:, 1:].long()
    B, S = inputs.shape
    dev = inputs.device
    dp_rows = mesh is not None
    s_idx = torch.arange(S, device=dev)[None, :]
    causal = causal_mask(S, S, 0, device=dev)
    if segment_ids is None:
        positions = s_idx.expand(B, S)
        logits, _ = model(inputs, positions, causal, gather_logits=False,
                          dp_rows=dp_rows)
    else:
        seg = segment_ids[:, :-1].to(torch.int32)
        # Position = offset from the document's first token: cummax of the
        # segment-start indices (contiguous ids: a start is any index
        # whose left neighbour differs).
        is_start = torch.cat(
            [torch.ones(B, 1, dtype=torch.bool, device=dev),
             seg[:, 1:] != seg[:, :-1]], dim=1)
        start_idx = torch.cummax(
            torch.where(is_start, s_idx, torch.zeros_like(s_idx)),
            dim=1).values
        positions = s_idx - start_idx
        if model.config.attn_impl == "flash":
            logits, _ = model(inputs, positions, None, segment_ids=seg,
                              gather_logits=False, dp_rows=dp_rows)
        else:
            logits, _ = model(inputs, positions, causal & segment_mask(seg),
                              gather_logits=False, dp_rows=dp_rows)
    from music_analyst_tpu_torch.models.llama import token_nll

    nll = token_nll(model, logits, targets)
    valid = (s_idx < (lengths.to(dev).long() - 1)[:, None]).float()
    if segment_ids is not None:
        # Drop pad tokens and the last token of every document: its "next
        # token" belongs to another document.
        same_doc = segment_ids[:, :-1] == segment_ids[:, 1:]
        valid = valid * (same_doc & (segment_ids[:, :-1] > 0)).float()
    count = mesh_lib.all_reduce(valid.sum(), mesh, "dp")
    return (nll * valid).sum() / count.clamp(min=1.0)


@dataclasses.dataclass(frozen=True)
class AdamW:
    """optax ``adamw``'s defaults: b1 0.9, b2 0.999, eps 1e-8, eps_root 0,
    decoupled weight decay on every parameter (norms and embeddings
    included).  ``torch.optim.AdamW`` with these values and one parameter
    group computes optax's update."""

    learning_rate: float = 3e-4
    weight_decay: float = 0.01
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: Iterable[torch.Tensor]) -> torch.optim.AdamW:
        params = list(params)
        return torch.optim.AdamW(
            params, lr=self.learning_rate, betas=(self.b1, self.b2),
            eps=self.eps, weight_decay=self.weight_decay,
            fused=bool(params) and params[0].is_cuda)


def make_optimizer(learning_rate: float = 3e-4,
                   weight_decay: float = 0.01) -> AdamW:
    return AdamW(learning_rate, weight_decay)


def _check_axes(mesh) -> None:
    """Refuse a mesh axis the mesh step does not cover yet."""
    for axis in mesh.axis_names:
        if axis not in MESH_AXES and mesh.axis_size(axis) > 1:
            raise NotImplementedError(
                f"training on a mesh with a {axis!r} axis is not yet ported "
                f"to music_analyst_tpu_torch: {', '.join(MESH_AXES)} only")


def init_train_state(
    model,
    optimizer: AdamW,
    sample_batch: Optional[Tuple[Any, ...]] = None,
    seed: Optional[int] = 0,
    mesh=None,
    zero1: bool = False,
) -> TrainState:
    """f32 masters and AdamW state for ``model`` (on its device).

    ``seed`` draws the model's weights first (``init_random_``, the Flax
    initializers' distributions); ``seed=None`` keeps the weights the
    model holds (a checkpoint, or weights carried from JAX).
    ``sample_batch`` gives JAX's init its shapes; the port's modules are
    shaped by their config, so it is accepted for the same call and not
    read.

    ``mesh``: a model not yet sharded is sharded for it first
    (``shard_params``: it keeps this rank's blocks of the weights it
    holds), and a seeded draw gives each rank its block of one device's
    draw.  ``zero1`` shards the moments over ``dp`` (JAX: a no-op
    without a ``dp`` axis of size > 1)."""
    del sample_batch
    if mesh is not None:
        _check_axes(mesh)
    if mesh is not None and not hasattr(model, "tp_layout"):
        from music_analyst_tpu_torch.parallel.sharding import shard_params

        shard_params(model, mesh)
    if seed is not None:
        from music_analyst_tpu_torch.models.llama import init_random_

        init_random_(model, seed)
    params = {}
    for name, p in model.named_parameters():
        p.requires_grad_(True)
        params[name] = p.detach().float().clone()
    slices = {}
    if zero1 and mesh is not None:
        from music_analyst_tpu_torch.parallel.sharding import zero1_slices

        slices = zero1_slices(model, mesh)
    stepped = [slices[name].take(master) if name in slices else master
               for name, master in params.items()]
    dev = next(iter(params.values())).device
    return TrainState(params=params, opt_state=optimizer.init(stepped),
                      step=torch.zeros((), dtype=torch.int32, device=dev),
                      mesh=mesh, tp_layout=dict(getattr(model, "tp_layout",
                                                        {})),
                      zero1=slices)


def load_params_(model, params: Dict[str, torch.Tensor]) -> None:
    """Copy the masters into the model's weights (in their dtypes): each
    step does so first, and an evaluation after the last step does too."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(params[name])


def _take_grads(model):
    """Each weight's gradient (cleared from the weight); JAX
    differentiates every leaf, so a weight the loss did not reach gets a
    zero gradient (and its decay), not a skip."""
    grads = []
    for _, p in model.named_parameters():
        grads.append(p.grad if p.grad is not None else torch.zeros_like(p))
        p.grad = None
    return grads


def _grads_to_masters_(model, state: TrainState) -> None:
    """Give each stepped tensor its gradient in f32: widened on one
    device; on a mesh summed over ``dp`` (all-reduced, or under ZeRO-1
    reduce-scattered to this rank's row)."""
    grads = _take_grads(model)
    stepped = state.opt_state.param_groups[0]["params"]
    mesh = state.mesh
    if mesh is None or mesh.group("dp") is None:
        for target, grad in zip(stepped, grads):
            target.grad = grad.float()
        return
    names = list(state.params)
    sharded = [i for i, name in enumerate(names) if name in state.zero1]
    whole = [i for i, name in enumerate(names) if name not in state.zero1]
    for idx, reduced in (
            (sharded, mesh_lib.reduce_scatter_rows(
                [grads[i] for i in sharded], mesh, "dp")),
            (whole, mesh_lib.all_reduce_many(
                [grads[i] for i in whole], mesh, "dp"))):
        for i, grad in zip(idx, reduced):
            stepped[i].grad = grad


def _gather_masters_(state: TrainState) -> None:
    """ZeRO-1: every rank's stepped row of each sharded master, gathered
    over ``dp`` into every rank's whole master."""
    mesh_lib.all_gather_rows_([state.params[name] for name in state.zero1],
                              state.mesh, "dp")


def _with_step_telemetry(step):
    """Wrap a train step with the span ``train_step``, the watchdog scope
    ``train.step`` (kind ``device``) and the counter ``train_steps``, as
    JAX's.  The span measures the host's enqueue of the step: the loss
    stays on the card."""
    from music_analyst_tpu_torch.observability import watchdog
    from music_analyst_tpu_torch.telemetry import get_telemetry

    @functools.wraps(step)
    def timed_step(state, token_ids, lengths, segment_ids=None):
        tel = get_telemetry()
        with tel.span("train_step"):
            with watchdog.watch("train.step", kind="device"):
                out = step(state, token_ids, lengths, segment_ids)
        tel.count("train_steps")
        return out

    return timed_step


def make_train_step(model, optimizer: AdamW, mesh=None, phase=None):
    """Build the step ``(state, token_ids, lengths, segment_ids=None) →
    (state, loss)``: loss and gradients on the model's working weights,
    gradients widened to the f32 masters, one AdamW step on them (through
    ``state.opt_state``, which ``optimizer.init`` built).  ``loss`` is a
    0-dim device tensor; on one device the step never waits for the card.

    On a mesh the batch is this rank's ``dp`` rows (as
    :func:`prefetch_batches` gives them) and ``state`` one that
    :func:`init_train_state` built for the same mesh; the gradients sum
    over ``dp`` before the AdamW step (ZeRO-1: a reduce-scatter, the step
    on this rank's slice, then an all-gather of the masters), and the
    loss is the global batch's, the same on every rank.

    ``phase``, when given, is a context-manager factory entered around
    each phase of the step by name: ``load_masters``, ``forward``,
    ``backward`` and ``optimizer`` (a timer's or a profiler's seat); on a
    mesh also ``reduce_gradients`` (before ``optimizer``) and, under
    ZeRO-1, ``gather_masters`` (after it)."""
    if mesh is not None:
        _check_axes(mesh)
    if model.config.attn_impl == "flash":
        raise NotImplementedError(
            "make_train_step cannot differentiate attn_impl='flash' (a "
            "backward of the flash kernel is not yet ported): the flash "
            "kernel is forward only, and JAX cannot differentiate its "
            "Pallas kernel either (pallas_call has no transpose rule); "
            "train with attn_impl='dense' and evaluate the loss with flash "
            "under torch.no_grad()"
        )
    del optimizer
    phase = phase or contextlib.nullcontext

    def step_fn(state: TrainState, token_ids, lengths, segment_ids=None):
        if mesh is not None and (state.mesh is None or (
                state.mesh.axes, state.mesh.rank) != (mesh.axes, mesh.rank)):
            raise ValueError(
                f"the train state was built for mesh {state.mesh}, the step "
                f"for {mesh}: restore it onto this mesh first "
                "(restore_train_state(path, like=...))")
        with phase("load_masters"):
            load_params_(model, state.params)
        with torch.enable_grad():
            with phase("forward"):
                loss = causal_lm_loss(model, token_ids, lengths,
                                      segment_ids=segment_ids, mesh=mesh)
            with phase("backward"):
                loss.backward()
        if mesh is None:
            with phase("optimizer"):
                _grads_to_masters_(model, state)
                state.opt_state.step()
                state.opt_state.zero_grad(set_to_none=True)
        else:
            with phase("reduce_gradients"):
                _grads_to_masters_(model, state)
            with phase("optimizer"):
                state.opt_state.step()
                state.opt_state.zero_grad(set_to_none=True)
            if state.zero1:
                with phase("gather_masters"):
                    _gather_masters_(state)
            loss = mesh_lib.all_reduce(loss.detach(), mesh, "dp")
        return (dataclasses.replace(state, step=state.step + 1),
                loss.detach())

    return _with_step_telemetry(step_fn)


def prefetch_batches(batches: Iterable[Tuple[np.ndarray, ...]], mesh=None,
                     depth=None, device: DeviceLike = "cuda"
                     ) -> Iterator[Tuple[Optional[torch.Tensor], ...]]:
    """Copy training batches to ``device`` up to ``depth`` ahead of the
    step loop.

    ``batches`` yields ``(token_ids, lengths)`` or ``(token_ids, lengths,
    segment_ids)`` host arrays; each comes back on the device with lengths
    and segment ids narrowed to int16 where the sequence length allows
    (the loss widens them), staged through pinned memory and copied
    asynchronously on the bounded pipeline (``runtime/prefetch.py``), so
    the copy overlaps the previous step.  Bytes count under
    ``train_pipeline.h2d_bytes``, stalls under the manifest's
    ``train_pipeline`` pipeline.

    On a mesh each batch comes back as this rank's ``dp`` rows (JAX's
    ``P('dp')``; the ranks of a ``tp`` or ``ep`` line get the same rows), which
    :func:`make_train_step` takes; a batch whose size ``dp`` does not
    divide raises ``ValueError``, as JAX's ``device_put`` does."""
    from music_analyst_tpu_torch.runtime import (
        PrefetchPipeline,
        Stage,
        resolve_prefetch_depth,
    )
    from music_analyst_tpu_torch.runtime.wire import (
        count_h2d_bytes,
        narrow_lengths,
        to_device,
    )

    if mesh is not None:
        _check_axes(mesh)
    depth = resolve_prefetch_depth(depth)
    dev = resolve_device(device) if mesh is None else mesh.device

    def h2d(batch):
        if mesh is not None:
            batch = tuple(None if a is None else
                          mesh_lib.batch_sharding(mesh, a) for a in batch)
        token_ids, lengths, *rest = batch
        segment_ids = rest[0] if rest else None
        S = token_ids.shape[1]
        arrays = [np.asarray(token_ids), narrow_lengths(lengths, S)]
        if segment_ids is not None:
            # Contiguous per-row document ids are bounded by S.
            arrays.append(narrow_lengths(segment_ids, S))
        count_h2d_bytes(arrays, prefix="train_pipeline")
        placed = to_device(arrays, dev)
        if segment_ids is None and rest:
            return (*placed, None)
        return placed

    pipe = PrefetchPipeline([Stage("h2d", h2d)], depth=depth,
                            name="train_pipeline", sink_name="step")
    return pipe.run(iter(batches))
