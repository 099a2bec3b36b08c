"""Training step for the decoder LM family (PyTorch, one device).

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

Not ported: training on a mesh of ranks (``mesh``, ``zero1``; inference
runs on one since ``parallel/mesh.py`` and ``parallel/sharding.py``).  The flash kernel is forward only, as the Pallas kernel is, so
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

_MESH_REFUSAL = ("training on a mesh (mesh=, zero1=) is not yet ported to "
                 "music_analyst_tpu_torch: one device only")


@dataclasses.dataclass
class TrainState:
    """``params``: the f32 masters by the model's parameter names;
    ``opt_state``: the ``torch.optim.AdamW`` over them (its state holds
    both f32 moments); ``step``: a 0-dim int32 tensor on their device.

    The step updates params and moments in place and returns a state with
    the next step count, so callers reassign (``state, loss = step(state,
    ...)``) as with JAX's donated state."""

    params: Dict[str, torch.Tensor]
    opt_state: torch.optim.Optimizer
    step: torch.Tensor


def causal_lm_loss(model, token_ids: torch.Tensor, lengths: torch.Tensor,
                   segment_ids: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Next-token cross-entropy over ``token_ids [B, S+1]`` with padding
    (past ``lengths``) masked out; a 0-dim f32 tensor.

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
    s_idx = torch.arange(S, device=dev)[None, :]
    causal = causal_mask(S, S, 0, device=dev)
    if segment_ids is None:
        positions = s_idx.expand(B, S)
        logits, _ = model(inputs, positions, causal)
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
            logits, _ = model(inputs, positions, None, segment_ids=seg)
        else:
            logits, _ = model(inputs, positions, causal & segment_mask(seg))
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, targets[..., None])[..., 0]
    valid = (s_idx < (lengths.to(dev).long() - 1)[:, None]).float()
    if segment_ids is not None:
        # Drop pad tokens and the last token of every document: its "next
        # token" belongs to another document.
        same_doc = segment_ids[:, :-1] == segment_ids[:, 1:]
        valid = valid * (same_doc & (segment_ids[:, :-1] > 0)).float()
    return (nll * valid).sum() / valid.sum().clamp(min=1.0)


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


def _check_mesh(mesh, zero1: bool = False) -> None:
    if mesh is not None or zero1:
        raise NotImplementedError(_MESH_REFUSAL)


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
    read."""
    del sample_batch
    _check_mesh(mesh, zero1)
    if seed is not None:
        from music_analyst_tpu_torch.models.llama import init_random_

        init_random_(model, seed)
    params = {}
    for name, p in model.named_parameters():
        p.requires_grad_(True)
        params[name] = p.detach().float().clone()
    dev = next(iter(params.values())).device
    return TrainState(params=params, opt_state=optimizer.init(params.values()),
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def load_params_(model, params: Dict[str, torch.Tensor]) -> None:
    """Copy the masters into the model's weights (in their dtypes): each
    step does so first, and an evaluation after the last step does too."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(params[name])


def _grads_to_masters_(model, params: Dict[str, torch.Tensor]) -> None:
    """Move each weight's gradient, widened to f32, onto its master."""
    for name, p in model.named_parameters():
        # JAX differentiates every leaf: a weight the loss did not reach
        # gets a zero gradient (and its decay), not a skip.
        grad = p.grad if p.grad is not None else torch.zeros_like(p)
        params[name].grad = grad.float()
        p.grad = None


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
    0-dim device tensor; the step never waits for the card.

    ``phase``, when given, is a context-manager factory entered around
    each phase of the step by name: ``load_masters``, ``forward``,
    ``backward`` and ``optimizer`` (a timer's or a profiler's seat)."""
    _check_mesh(mesh)
    if model.config.attn_impl == "flash":
        raise NotImplementedError(
            "make_train_step cannot differentiate attn_impl='flash': the "
            "flash kernel is forward only, and JAX cannot differentiate its "
            "Pallas kernel either (pallas_call has no transpose rule); "
            "train with attn_impl='dense' and evaluate the loss with flash "
            "under torch.no_grad()"
        )
    del optimizer
    phase = phase or contextlib.nullcontext

    def step_fn(state: TrainState, token_ids, lengths, segment_ids=None):
        with phase("load_masters"):
            load_params_(model, state.params)
        with torch.enable_grad():
            with phase("forward"):
                loss = causal_lm_loss(model, token_ids, lengths,
                                      segment_ids=segment_ids)
            with phase("backward"):
                loss.backward()
        with phase("optimizer"):
            _grads_to_masters_(model, state.params)
            state.opt_state.step()
            state.opt_state.zero_grad(set_to_none=True)
        return (TrainState(state.params, state.opt_state, state.step + 1),
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
    ``train_pipeline`` pipeline."""
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

    _check_mesh(mesh)
    depth = resolve_prefetch_depth(depth)
    dev = resolve_device(device)

    def h2d(batch):
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
