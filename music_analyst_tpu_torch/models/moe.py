"""Mixture-of-experts feed-forward (PyTorch).

Counterpart of ``music_analyst_tpu/models/moe.py``: top-k routed SwiGLU
experts whose weight stacks carry a leading ``E`` axis.  The parameter
names and layouts are JAX's (``gate_experts``/``up_experts`` ``[E, D, H]``,
``down_experts`` ``[E, H, D]``, an f32 bias-free ``router``), so
``models/llama.py:params_from_jax`` carries them across unchanged.

Dispatch is *sparse* (token-choice top-k with a capacity bound): assignment
``t*k + j`` (token t's j-th choice) takes the next free row of its expert's
``[E, capacity]`` buffer, the rows numbered by one cumsum over the one-hot
in assignment order; assignments past an expert's capacity are dropped and
their gathered rows masked.  The experts run over the buffer and the rows
gather back weighted by the router.  ``capacity_factor >= n_experts`` is
lossless and reproduces ``dispatch="dense"``, the exact all-experts oracle.
``quant="int8"`` runs the expert products through the per-expert dynamic
int8 product (``ops/quant.py:quant_batched_matmul``); the router stays f32.

On a mesh of ranks (``parallel/sharding.py:shard_params`` calls
:meth:`MoESwiGLU.to_mesh_`) the stacks are sharded as JAX's rules place
them, ``P('ep', None, 'tp')`` for gate/up and ``P('ep', 'tp', None)`` for
down, and the router is replicated.  The tokens are replicated over ``ep``
and ``tp``: every rank routes all of them, fills the buffer rows of its
own ``E / ep`` experts only, runs them over its block of the hidden axis,
and gathers back its share; the shares sum over ``ep`` and ``tp`` (g) and
the input's gradient over both (f).  The router's weight passes f too: a
rank's gradient of it holds only its own experts' (and hidden block's)
share.  JAX runs the dispatch as one global program, so under ``dp`` (the
train step's rows, ``dp_rows=True``) the capacity is that of the global
token count and an assignment's slot follows, in its expert, every
same-expert assignment of the ``dp`` ranks before it: one all-gather of
``E`` counts over ``dp`` (``parallel/mesh.py:counts_before``).  Pad
tokens are routed and take slots, as in JAX.  int8 experts under ``tp`` take the ``down``
product's scales as maxima over ``tp`` and sum its int32 partials there
(``quant_batched_matmul(rows=)``), so their shares sum over ``ep`` only.

Top-k keeps ``jax.lax.top_k``'s order: descending, and the lower expert
index first among equal logits (a stable sort; ``torch.topk`` promises no
order on ties).  The large products are ``torch.einsum``/``torch.bmm``, as
the JAX package computes them with XLA einsums; no kernel is written for
them.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from music_analyst_tpu_torch.ops.quant import RowShard, quant_batched_matmul
from music_analyst_tpu_torch.parallel.mesh import (
    copy_to_axes,
    counts_before,
    reduce_from_axes,
)

DISPATCHES = ("sparse", "dense")


def moe_capacity(tokens: int, top_k: int, n_experts: int,
                 capacity_factor: float) -> int:
    """Buffer slots per expert: ``ceil(ceil(T*k/E) * capacity_factor)``.

    The outer ceil matters at decode-scale token counts: ceil(8/4)*1.25 =
    2.5 gives 3 slots; truncation would give 2, capacity factor 1.0."""
    fair_share = -(-tokens * top_k // n_experts)
    return max(1, math.ceil(fair_share * capacity_factor))


def route(router_logits: torch.Tensor, k: int):
    """``(top_vals, top_idx)`` of the ``k`` largest logits along the last
    axis, in ``jax.lax.top_k``'s order (ties: lower index first)."""
    vals, idx = torch.sort(router_logits, dim=-1, descending=True,
                           stable=True)
    return vals[..., :k], idx[..., :k]


class MoESwiGLU(nn.Module):
    """Top-k routed mixture of SwiGLU experts over ``x [B, S, dim]``.

    On a mesh (:meth:`to_mesh_`, which ``parallel/sharding.py:
    shard_params`` calls) the layer holds its ``ep`` block of the experts
    and its ``tp`` block of their hidden axis; see the module's
    docstring."""

    def __init__(self, dim: int, n_experts: int, hidden_dim: int,
                 top_k: int = 2, dtype: torch.dtype = torch.bfloat16,
                 dispatch: str = "sparse", capacity_factor: float = 1.25,
                 quant: str = "none") -> None:
        super().__init__()
        if dispatch not in DISPATCHES:
            raise ValueError(f"unknown MoE dispatch {dispatch!r}")
        self.n_experts = n_experts
        self.top_k = min(top_k, n_experts)
        self.dtype = dtype
        self.dispatch = dispatch
        self.capacity_factor = capacity_factor
        self.quant = quant
        E, H = n_experts, hidden_dim
        self.gate_experts = nn.Parameter(torch.empty(E, dim, H, dtype=dtype))
        self.up_experts = nn.Parameter(torch.empty(E, dim, H, dtype=dtype))
        self.down_experts = nn.Parameter(torch.empty(E, H, dim, dtype=dtype))
        self.router = nn.Linear(dim, E, bias=False, dtype=torch.float32)
        # Assignments the last sparse call dropped past capacity, over the
        # global batch (a 0-dim device tensor: reading it is the caller's
        # sync, not the layer's).
        self.last_dropped = None
        # The mesh form (to_mesh_): the first expert this rank holds and
        # the down product's split contraction rows under tp.
        self.mesh = None
        self.expert_start = 0
        self.down_rows: Optional[RowShard] = None

    def to_mesh_(self, mesh, expert_start: int = 0,
                 hidden_start: Optional[int] = None) -> None:
        """Run on ``mesh``: the stacks hold experts ``[expert_start,
        expert_start + E_local)`` (their ``ep`` block) and, when
        ``hidden_start`` is given, the ``tp`` block of the hidden axis
        from there."""
        self.mesh = mesh
        self.expert_start = int(expert_start)
        self.down_rows = (None if hidden_start is None
                          else RowShard(mesh, "tp", int(hidden_start)))

    def _partial_axes(self) -> Tuple[str, ...]:
        """The axes this rank's output is a partial sum over: ``ep`` (its
        own experts) and, for float experts, ``tp`` (its block of the
        hidden axis; the int8 ``down`` product sums its int32 partials
        over ``tp`` itself)."""
        return ("ep",) if self.quant == "int8" else ("ep", "tp")

    def _router_weight(self) -> torch.Tensor:
        """The router's replicated weight; each rank's gradient of it is
        its share (its experts, its hidden block), so the backward sums it
        over those axes (f)."""
        return copy_to_axes(self.router.weight, self.mesh,
                            self._partial_axes())

    def _expert_mm(self, x: torch.Tensor, w: torch.Tensor,
                   rows: Optional[RowShard] = None) -> torch.Tensor:
        """``[E, C, K] @ [E, K, N]`` in ``self.dtype`` or through int8."""
        if self.quant == "int8":
            return quant_batched_matmul(x, w, rows=rows).to(self.dtype)
        return torch.bmm(x, w.to(self.dtype))

    def forward(self, x: torch.Tensor, dp_rows: bool = False
                ) -> torch.Tensor:
        """``dp_rows``: ``x`` is this rank's ``dp`` block of the batch's
        rows (the train step's rows), so capacity and slots are the global
        batch's; otherwise every rank holds the whole batch."""
        x = copy_to_axes(x, self.mesh, ("ep", "tp"))
        router_logits = F.linear(x.float(), self._router_weight())
        top_vals, top_idx = route(router_logits, self.top_k)
        top_weights = torch.softmax(top_vals, dim=-1)            # [B,S,k]
        if self.dispatch == "dense":
            out = self._dense(x, top_idx, top_weights)
        else:
            out = self._sparse(x, top_idx, top_weights, dp_rows)
        if self.mesh is not None:
            out = reduce_from_axes(out, self.mesh, self._partial_axes())
        return out.to(x.dtype)

    def _local(self):
        """``(e0, E_local)``: the experts this rank's stacks hold."""
        return self.expert_start, self.gate_experts.shape[0]

    def _dense(self, x, top_idx, top_weights):
        E = self.n_experts
        e0, El = self._local()
        B, S, D = x.shape
        combine = (F.one_hot(top_idx, E).float()
                   * top_weights[..., None]).sum(dim=-2)         # [B,S,E]
        combine = combine[..., e0:e0 + El]
        gate_w, up_w, down_w = (self.gate_experts, self.up_experts,
                                self.down_experts)
        if self.quant == "int8":
            # The sparse path's batched layout, so both dispatches quantize
            # alike: the tokens broadcast to every expert ([E, T, D]).
            T = B * S
            xb = x.reshape(T, D).to(self.dtype).expand(El, T, D)
            gate = self._expert_mm(xb, gate_w)
            up = self._expert_mm(xb, up_w)
            out = self._expert_mm(F.silu(gate) * up, down_w,
                                  self.down_rows)                # [E,T,D]
            out = torch.einsum("te,etd->td", combine.reshape(T, El),
                               out.float())
            return out.reshape(B, S, D)
        xc = x.to(self.dtype)
        gate = torch.einsum("bsd,edh->besh", xc, gate_w.to(self.dtype))
        up = torch.einsum("bsd,edh->besh", xc, up_w.to(self.dtype))
        expert_out = torch.einsum("besh,ehd->besd", F.silu(gate) * up,
                                  down_w.to(self.dtype))         # [B,E,S,D]
        out = torch.einsum("bse,besd->bsd", combine.to(self.dtype),
                           expert_out)
        # Partial sums cross the mesh in f32; one device keeps bf16.
        return out if self.mesh is None else out.float()

    def _slots(self, flat_expert: torch.Tensor, T: int, dp_rows: bool):
        """``(pos, capacity, dropped)``: each assignment's row in its
        expert's buffer, the buffer's rows, and the assignments of the
        whole batch dropped past them, as one cumsum in JAX's flat order
        ``t*k + j`` (``t = b*S + s``) numbers them.  With ``dp_rows`` this
        rank's rows are one block of that order: its slots follow the
        same-expert assignments of the ``dp`` ranks before it, and the
        capacity is the global token count's."""
        E, k = self.n_experts, self.top_k
        one_hot_e = F.one_hot(flat_expert, E)                    # [A,E]
        pos = ((one_hot_e.cumsum(dim=0) - 1) * one_hot_e).sum(dim=-1)
        counts = one_hot_e.sum(dim=0)
        parts = self.mesh.axis_size("dp") if (
            dp_rows and self.mesh is not None) else 1
        if parts > 1:
            before, counts = counts_before(counts, self.mesh, "dp")
            pos = pos + before[flat_expert]
        capacity = moe_capacity(T * parts, k, E, self.capacity_factor)
        return pos, capacity, (counts - capacity).clamp(min=0).sum()

    def _sparse(self, x, top_idx, top_weights, dp_rows=False):
        B, S, D = x.shape
        k = top_idx.shape[-1]
        e0, El = self._local()
        T = B * S
        A = T * k  # assignments: token t's choices at flat ids t*k .. t*k+k-1
        dev = x.device

        xt = x.reshape(T, D).to(self.dtype)
        flat_expert = top_idx.reshape(A)
        flat_weight = top_weights.reshape(A)
        flat_token = torch.arange(A, device=dev) // k

        pos, capacity, self.last_dropped = self._slots(flat_expert, T,
                                                       dp_rows)
        # This rank fills rows only for its own experts.  Dropped and other
        # ranks' assignments land in row `capacity`, one past the buffer,
        # which is cut off; their gathers are clamped and masked.
        local = flat_expert - e0
        keep = (pos < capacity) & (local >= 0) & (local < El)
        local = local.clamp(0, El - 1)
        safe_pos = torch.where(keep, pos, torch.full_like(pos, capacity))

        buf = xt.new_zeros(El, capacity + 1, D)
        buf = buf.index_put((local, safe_pos), xt[flat_token])
        buf = buf[:, :capacity]

        gate = self._expert_mm(buf, self.gate_experts)
        up = self._expert_mm(buf, self.up_experts)
        out_buf = self._expert_mm(F.silu(gate) * up, self.down_experts,
                                  self.down_rows)                # [E,C,D]

        gathered = out_buf[local, safe_pos.clamp(max=capacity - 1)]
        contrib = gathered.float() * (flat_weight * keep.float())[:, None]
        out = torch.zeros(T, D, dtype=torch.float32, device=dev)
        out = out.index_add(0, flat_token, contrib)
        return out.reshape(B, S, D)

    @staticmethod
    def load_balancing_loss(router_logits: torch.Tensor,
                            top_idx: torch.Tensor,
                            n_experts: int) -> torch.Tensor:
        """Switch-style auxiliary loss (mean prob × mean dispatch per
        expert)."""
        probs = torch.softmax(router_logits, dim=-1)
        mean_prob = probs.mean(dim=(0, 1))
        dispatch = F.one_hot(top_idx[..., 0], n_experts).float().mean(
            dim=(0, 1))
        return n_experts * torch.sum(mean_prob * dispatch)
