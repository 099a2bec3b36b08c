"""Slot-indexed KV cache runtime for continuous-batching decode.

Counterpart of ``music_analyst_tpu/ops/kv_slots.py``: the monolithic
cache the continuous scheduler (``serving/decode_loop.py``) selects with
``page_size=0``.  ``n_slots`` (pow2) independent sequences live side by
side in one ``[n_slots, max_total, n_kv, D]`` buffer per layer; the host
scheduler claims and frees slots between dispatches.  Eager PyTorch, the
buffers updated in place:

* ``prefill_chunk`` writes one prompt chunk into a slot's rows through a
  ``[1, max_total]`` view of them (``KVCache.update`` lands the chunk at
  its offset) and returns the greedy token after the chunk;
* ``decode_step`` runs ``decode_span`` greedy steps over all slots with
  per-slot write offsets (``KVCache`` with a ``[n_slots]`` length);
* ``verify_block`` scores a ``[n_slots, K]`` drafted block as K
  teacher-forced runs of the same 1-wide step as ``decode_step``;
* ``free_slots`` zeroes slots (the failure path);
* ``snapshot_slot`` / ``restore_slot`` copy one slot's rows out to
  stand-alone device tensors and back into any slot: the O(1)
  preempt-resume of the monolithic backend (one device copy each way,
  no host readback);
* ``upload`` puts a dispatch's host inputs on the device in one copy
  (:func:`upload_arrays`; the paged runtime has it too), so a
  tensor-parallel server's followers make their own copies of them
  (``serving/tp_dispatch.py``).

Attention is the model's dense path (``models/layers.py``), as in the
JAX package: no kernel runs here.  The layout mirrors the static path's
slot/position split — the prompt occupies rows ``[0, prompt_region)``,
decode token ``t`` sits in row ``prompt_region + t`` at RoPE position
``prompt_len + t`` under the ``prompt_part | decode_part`` mask — so with
``prompt_region`` equal to the static path's padded width, greedy tokens
equal ``generate_batch``'s.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from music_analyst_tpu_torch.models.layers import KVCache
from music_analyst_tpu_torch.parallel.sharding import local_kv_heads


@dataclasses.dataclass(frozen=True)
class SlotPlan:
    """Static geometry of one slot runtime."""

    n_slots: int        # pow2 — rows in the slot cache
    prefill_chunk: int  # tokens written per prefill dispatch
    prompt_region: int  # buffer rows reserved for the prompt (multiple of chunk)
    max_new: int        # decode rows per slot (largest per-request budget)
    decode_span: int    # greedy steps per decode dispatch

    def __post_init__(self):
        if self.n_slots < 1 or (self.n_slots & (self.n_slots - 1)):
            raise ValueError(f"n_slots must be a power of two, got {self.n_slots}")
        if self.prompt_region % self.prefill_chunk:
            raise ValueError(
                f"prompt_region ({self.prompt_region}) must be a multiple of "
                f"prefill_chunk ({self.prefill_chunk})"
            )
        if self.max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {self.max_new}")
        if self.decode_span < 1:
            raise ValueError(f"decode_span must be >= 1, got {self.decode_span}")

    @property
    def max_total(self) -> int:
        return self.prompt_region + self.max_new


def upload_arrays(device: torch.device,
                  *arrays: np.ndarray) -> List[torch.Tensor]:
    """Host int32/bool arrays → tensors on ``device`` in ONE host-to-device
    copy (bools travel as int32 and come back as bool)."""
    flat = np.concatenate([np.asarray(a).astype(np.int32, copy=False).ravel()
                           for a in arrays])
    dev = torch.from_numpy(flat).to(device)
    out, at = [], 0
    for a in arrays:
        a = np.asarray(a)
        part = dev[at:at + a.size].view(a.shape)
        out.append(part.bool() if a.dtype == np.bool_ else part)
        at += a.size
    return out


class SlotDecodeRuntime:
    """Prefill / decode / verify / free / snapshot / restore over one
    model.  Holds no request state: slots, budgets and arrival order live
    in the host scheduler."""

    def __init__(self, model, config, plan: SlotPlan, eos_id: int,
                 mesh=None) -> None:
        if plan.max_total > config.max_seq_len:
            raise ValueError(
                f"prompt_region + max_new ({plan.max_total}) exceeds the "
                f"model's max_seq_len ({config.max_seq_len})"
            )
        self.model = model
        self.config = config
        self.plan = plan
        self.eos_id = int(eos_id)
        self.dtype = torch.bfloat16
        self.device = next(model.parameters()).device
        # Each rank's cache holds its own n_kv_heads / tp heads.
        self.n_kv_heads = local_kv_heads(mesh, config.n_kv_heads)

    # -------------------------------------------------------------- state

    def init_caches(self) -> List[KVCache]:
        """Zeroed ``[n_slots, max_total, n_kv, head_dim]`` keys and values
        per layer, with ``[n_slots]`` write offsets."""
        cfg, plan = self.config, self.plan
        shape = (plan.n_slots, plan.max_total, self.n_kv_heads,
                 cfg.dim // cfg.n_heads)
        dev = self.device
        return [KVCache(torch.zeros(shape, dtype=self.dtype, device=dev),
                        torch.zeros(shape, dtype=self.dtype, device=dev),
                        torch.zeros((plan.n_slots,), dtype=torch.int32,
                                    device=dev))
                for _ in range(cfg.n_layers)]

    def kv_bytes(self) -> int:
        """Resident bytes of the whole cache (keys + values, every layer
        and slot)."""
        cfg, plan = self.config, self.plan
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        return (cfg.n_layers * 2 * plan.n_slots * plan.max_total
                * self.n_kv_heads * (cfg.dim // cfg.n_heads) * itemsize)

    def upload(self, *arrays: np.ndarray) -> List[torch.Tensor]:
        """A dispatch's host inputs on this runtime's device."""
        return upload_arrays(self.device, *arrays)

    def compiled_variants(self) -> int:
        """Programs compiled for this runtime: none, eager PyTorch traces
        nothing (the JAX runtime counts its jitted programs here)."""
        return 0

    def prompt_chunks(self, n_tokens: int) -> Sequence[int]:
        """Chunk start offsets covering a prompt of ``n_tokens`` tokens."""
        n = max(1, min(int(n_tokens), self.plan.prompt_region))
        C = self.plan.prefill_chunk
        return range(0, ((n + C - 1) // C) * C, C)

    # ------------------------------------------------------------ prefill

    @torch.no_grad()
    def prefill_chunk(self, caches, slot: int, chunk_ids: torch.Tensor,
                      start: int, length_after: int, last_index: int):
        """Write ``prefill_chunk`` prompt tokens (``chunk_ids`` ``[C]`` on
        the device) into slot ``slot`` at offset ``start``; ``last_index``
        is the chunk-local index of the prompt's last token.  Returns
        ``(caches, first)``, ``first`` the greedy token after the chunk as
        a device scalar."""
        C, total = self.plan.prefill_chunk, self.plan.max_total
        dev = self.device
        views = [KVCache(c.keys[slot:slot + 1], c.values[slot:slot + 1],
                         int(start)) for c in caches]
        positions = (int(start) + torch.arange(C, device=dev))[None, :]
        kv_pos = torch.arange(total, device=dev)[None, None, :]
        # Causal over the global offsets: chunk padding past the prompt's
        # end sits at later positions, so no padding mask is needed.
        mask = (kv_pos <= positions[:, :, None])[:, None, :, :]
        logits, _ = self.model(
            chunk_ids[None, :], positions, mask, views,
            last_position=torch.full((1,), int(last_index), dtype=torch.long,
                                     device=dev))
        first = logits[0, 0].argmax()
        for c in caches:
            c.length[slot] = int(length_after)
        return caches, first

    # ------------------------------------------------------------- decode

    def _step(self, caches, tokens, prompt_lens, steps, kv_pos):
        """One 1-wide step over every slot: write row ``R + step`` (clamped
        to the last row), attend under ``prompt_part | decode_part``;
        returns the greedy next tokens and the write offsets."""
        R, total = self.plan.prompt_region, self.plan.max_total
        offsets = torch.clamp(R + steps, max=total - 1)
        views = [KVCache(c.keys, c.values, offsets) for c in caches]
        prompt_part = kv_pos < prompt_lens[:, None, None, None]
        decode_part = (kv_pos >= R) & (kv_pos - R <= steps[:, None, None, None])
        logits, _ = self.model(tokens[:, None], (prompt_lens + steps)[:, None],
                               prompt_part | decode_part, views)
        return logits[:, -1].argmax(dim=-1).to(tokens.dtype), offsets

    @staticmethod
    def _set_lengths(caches, offsets) -> None:
        """Each slot's write offset after its last written row, as the
        JAX runtime's returned caches carry it."""
        for c in caches:
            c.length.copy_(offsets + 1)

    @torch.no_grad()
    def decode_step(self, caches, tokens, prompt_lens, steps, budgets, done,
                    active):
        """``decode_span`` greedy steps over all slots (``[n_slots]`` device
        tensors).  A slot advances while ``active`` and under its budget;
        rows that emitted EOS keep emitting EOS; frozen and free rows still
        write, into their own dead tail.  Returns ``(caches, tokens, steps,
        done, emitted [span, n_slots])``."""
        total = self.plan.max_total
        eos = self.eos_id
        kv_pos = torch.arange(total, device=tokens.device)[None, None, None, :]
        emitted = []
        for _ in range(self.plan.decode_span):
            adv = active & (steps < budgets)
            nxt, offsets = self._step(caches, tokens, prompt_lens, steps,
                                      kv_pos)
            new_done = done | (tokens == eos)
            nxt = torch.where(new_done, torch.full_like(nxt, eos), nxt)
            emitted.append(tokens)
            tokens = torch.where(adv, nxt, tokens)
            steps = torch.where(adv, steps + 1, steps)
            done = torch.where(adv, new_done, done)
        self._set_lengths(caches, offsets)
        return caches, tokens, steps, done, torch.stack(emitted)

    @torch.no_grad()
    def verify_block(self, caches, tokens_blk, prompt_lens, steps):
        """Score a ``[n_slots, K]`` drafted block: column 0 is each slot's
        carry, columns ``1..K-1`` drafts.  Returns ``[n_slots, K]``, the
        greedy token after consuming ``tokens_blk[:, :t+1]``.

        The block runs as K teacher-forced runs of :meth:`_step`, the same
        1-wide step as :meth:`decode_step`: a K-wide pass would reduce in
        another order and flip argmax near-ties, and speculative text must
        equal plain decode byte for byte.  Rejected drafts' rows are
        written but never read before the next dispatch overwrites them.
        """
        total = self.plan.max_total
        kv_pos = torch.arange(total, device=tokens_blk.device)[None, None, None, :]
        preds = []
        for j in range(tokens_blk.shape[1]):
            nxt, offsets = self._step(caches, tokens_blk[:, j], prompt_lens,
                                      steps, kv_pos)
            preds.append(nxt)
            steps = steps + 1
        self._set_lengths(caches, offsets)
        return caches, torch.stack(preds, dim=1)

    # ------------------------------------------------- free and checkpoint

    @torch.no_grad()
    def free_slots(self, caches, free_mask: torch.Tensor):
        """Zero the masked slots' rows and write offsets: the failure
        path's hard isolation (normal completion frees host-side only)."""
        rows = free_mask[:, None, None, None]
        for c in caches:
            c.keys.masked_fill_(rows, 0)
            c.values.masked_fill_(rows, 0)
            c.length.masked_fill_(free_mask, 0)
        return caches

    @torch.no_grad()
    def snapshot_slot(self, caches, slot: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Copy one slot's rows (every layer) and its write offset into
        stand-alone device tensors ``[n_layers, max_total, n_kv, D]``."""
        keys = torch.stack([c.keys[slot] for c in caches])
        values = torch.stack([c.values[slot] for c in caches])
        return keys, values, caches[0].length[slot].clone()

    @torch.no_grad()
    def restore_slot(self, caches, keys, values, slot: int, length):
        """Write a snapshot back into (any) slot: RoPE is baked into the
        stored rows and the layout is the same in every slot."""
        for li, c in enumerate(caches):
            c.keys[slot] = keys[li]
            c.values[slot] = values[li]
            c.length[slot] = length
        return caches
