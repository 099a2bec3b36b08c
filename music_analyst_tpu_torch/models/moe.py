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

Top-k keeps ``jax.lax.top_k``'s order: descending, and the lower expert
index first among equal logits (a stable sort; ``torch.topk`` promises no
order on ties).  The large products are ``torch.einsum``/``torch.bmm``, as
the JAX package computes them with XLA einsums; no kernel is written for
them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from music_analyst_tpu_torch.ops.quant import quant_batched_matmul

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
    """Top-k routed mixture of SwiGLU experts over ``x [B, S, dim]``."""

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
        # Assignments the last sparse call dropped past capacity (a 0-dim
        # device tensor: reading it is the caller's sync, not the layer's).
        self.last_dropped = None

    def _expert_mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``[E, C, K] @ [E, K, N]`` in ``self.dtype`` or through int8."""
        if self.quant == "int8":
            return quant_batched_matmul(x, w).to(self.dtype)
        return torch.bmm(x, w.to(self.dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        router_logits = self.router(x.float())                   # [B,S,E]
        top_vals, top_idx = route(router_logits, self.top_k)
        top_weights = torch.softmax(top_vals, dim=-1)            # [B,S,k]
        if self.dispatch == "dense":
            return self._dense(x, top_idx, top_weights)
        return self._sparse(x, top_idx, top_weights)

    def _dense(self, x, top_idx, top_weights):
        E = self.n_experts
        B, S, D = x.shape
        combine = (F.one_hot(top_idx, E).float()
                   * top_weights[..., None]).sum(dim=-2)         # [B,S,E]
        gate_w, up_w, down_w = (self.gate_experts, self.up_experts,
                                self.down_experts)
        if self.quant == "int8":
            # The sparse path's batched layout, so both dispatches quantize
            # alike: the tokens broadcast to every expert ([E, T, D]).
            T = B * S
            xb = x.reshape(T, D).to(self.dtype).expand(E, T, D)
            gate = self._expert_mm(xb, gate_w)
            up = self._expert_mm(xb, up_w)
            out = self._expert_mm(F.silu(gate) * up, down_w)     # [E,T,D]
            out = torch.einsum("te,etd->td", combine.reshape(T, E),
                               out.float())
            return out.reshape(B, S, D).to(x.dtype)
        xc = x.to(self.dtype)
        gate = torch.einsum("bsd,edh->besh", xc, gate_w.to(self.dtype))
        up = torch.einsum("bsd,edh->besh", xc, up_w.to(self.dtype))
        expert_out = torch.einsum("besh,ehd->besd", F.silu(gate) * up,
                                  down_w.to(self.dtype))         # [B,E,S,D]
        out = torch.einsum("bse,besd->bsd", combine.to(self.dtype),
                           expert_out)
        return out.to(x.dtype)

    def _sparse(self, x, top_idx, top_weights):
        B, S, D = x.shape
        E, k = self.n_experts, top_idx.shape[-1]
        T = B * S
        A = T * k  # assignments: token t's choices at flat ids t*k .. t*k+k-1
        capacity = moe_capacity(T, k, E, self.capacity_factor)
        dev = x.device

        xt = x.reshape(T, D).to(self.dtype)
        flat_expert = top_idx.reshape(A)
        flat_weight = top_weights.reshape(A)
        flat_token = torch.arange(A, device=dev) // k

        # Position of each assignment within its expert: the count of
        # earlier same-expert assignments (one cumsum over the one-hot).
        one_hot_e = F.one_hot(flat_expert, E)                    # [A,E]
        pos = ((one_hot_e.cumsum(dim=0) - 1) * one_hot_e).sum(dim=-1)
        keep = pos < capacity
        self.last_dropped = (~keep).sum()
        # Dropped assignments land in row `capacity`, one past the buffer,
        # which is cut off; their gathers are clamped and masked.
        safe_pos = torch.where(keep, pos, torch.full_like(pos, capacity))

        buf = xt.new_zeros(E, capacity + 1, D)
        buf = buf.index_put((flat_expert, safe_pos), xt[flat_token])
        buf = buf[:, :capacity]

        gate = self._expert_mm(buf, self.gate_experts)
        up = self._expert_mm(buf, self.up_experts)
        out_buf = self._expert_mm(F.silu(gate) * up,
                                  self.down_experts)             # [E,C,D]

        gathered = out_buf[flat_expert, safe_pos.clamp(max=capacity - 1)]
        contrib = gathered.float() * (flat_weight * keep.float())[:, None]
        out = torch.zeros(T, D, dtype=torch.float32, device=dev)
        out = out.index_add(0, flat_token, contrib)
        return out.reshape(B, S, D).to(x.dtype)

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
