"""Quantized inference: int8 KV pages, dynamic w8a8 matmuls, and stored
int8 / packed int4 weights.

Counterpart of ``music_analyst_tpu/ops/quant.py``, the MoE experts'
``quant_batched_matmul`` included.

* **KV pages** (``quantize_kv_page``): symmetric int8 per (page, row); one
  f32 scale covers one token's ``(n_kv_heads, head_dim)`` block, so a
  decode write never re-scales an earlier row.  The dequant runs inside
  the paged-attention kernel's load.  A row dequantized to f32 quantizes
  back to the same codes; through bf16 a code can move by +-1 once.
* **Dynamic w8a8** (``quant_matmul``): weights symmetric per output
  channel, ``s_w = max|w[:, c]| / 127``, re-derived from the float weights
  on every call; activations symmetric per row (token), so one outlier
  token costs only its own row's resolution; int32 accumulation, dequant
  ``acc * s_x * s_w`` in f32.
* **Stored weights** (``QuantizedParam``): quantized once at load.  int8
  is per output channel, ``scale [(1,), *F]``; int4 is per group of
  ``group_size`` (default 128) along the flattened contraction axis,
  ``scale [(G,), *F]``, two codes per byte along axis 0 (element 2i in the
  low nibble, 2i+1 in the high; arithmetic shifts sign-extend).  The
  codes keep the float kernel's ``[K, *F]`` shape (Flax layout), which is
  what the quantized-checkpoint cache stores (``engines/wq_cache.py``).
  Activations are row-quantized to int8 inside the op; int4 accumulates
  each group in int32, scales it by its group scale and sums the groups.

On the card the int8 x int8 -> int32 products are library calls: the JAX
package computes them with XLA ``dot_general`` (no Pallas kernel), and
``torch._int_mm`` (cuBLASLt) is the port's counterpart.  It needs more
than 16 rows and K, N multiples of 8, and it is fast only with the weight
K-contiguous ("kernel-major": the flattened output axis outermost in
memory, as ``nn.Linear`` stores ``[out, in]``; a row-major weight is
4.6-13.5x slower at the Llama-3-8B shapes, ``tools/int_mm_probe.py``),
which is how ``WqLinear`` allocates its codes; the logical shape stays
Flax's.  Fewer than 32 rows are padded with zero rows (cuBLASLt refused
17 rows with a row-major weight at K = 64) and cut off again.  int4 runs
as one ``_int_mm`` too: the codes are unpacked to int8 and each row of
activations is spread over G rows, row ``(g, t)`` holding only group g's
slice of ``x[t]`` (zeros elsewhere), so the product's ``[G * T, F]``
int32 result is every group's partial sum.  That costs G times the
arithmetic of one product but reads the weight once, and the partials
are exact.  Rows run in chunks that keep each chunk's int32 partials
under 512 MiB.  A hand-written w8/w4 GEMM is not part of the port yet.

Plain versions (CPU tensors): the same quantization, with the integer
products in float64, which is exact far beyond these sums (< 2^31), so
the card and the plain version give the same partials.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from music_analyst_tpu_torch.parallel.mesh import all_reduce


# ---------------------------------------------------------------------------
# int8 KV pages (paged decode cache)
# ---------------------------------------------------------------------------

def _div_const(t: torch.Tensor, c: float) -> torch.Tensor:
    """``t / c`` as a true division on every device.  With a Python
    scalar divisor CUDA multiplies by its reciprocal, which is off by an
    ulp now and then, and a scale an ulp off moves codes at rounding ties
    (the JAX package divides)."""
    return t / torch.full((), c, dtype=t.dtype, device=t.device)


def _kv_codes(x32: torch.Tensor, amax: torch.Tensor):
    scale = _div_const(amax.clamp(min=1e-8), 127.0)
    q = torch.round(x32 / scale[..., None, None]).clamp(-127, 127)
    return q.to(torch.int8), scale


def quantize_kv_page(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x [..., n_kv, D]`` → ``(codes int8 [..., n_kv, D], scale f32
    [...])`` with ``scale = max(|row|, 1e-8) / 127``."""
    x32 = x.float()
    return _kv_codes(x32, x32.abs().amax(dim=(-2, -1)))


def quantize_kv_pair(k: torch.Tensor, v: torch.Tensor, mesh=None,
                     axis: str = "tp"):
    """:func:`quantize_kv_page` of a K and a V block whose head axis is
    split over ``axis``: each row's scale is the maximum over *every*
    rank's heads (one all-reduce MAX for K and V together), so every
    rank stores the same scale plane, the one-device plane.  Returns
    ``((k codes, k scale), (v codes, v scale))``."""
    k32, v32 = k.float(), v.float()
    amax = torch.stack([k32.abs().amax(dim=(-2, -1)),
                        v32.abs().amax(dim=(-2, -1))])
    amax = all_reduce(amax, mesh, axis, op="max")
    return _kv_codes(k32, amax[0]), _kv_codes(v32, amax[1])


def dequantize_kv_page(
    q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype = torch.bfloat16
) -> torch.Tensor:
    """Inverse of :func:`quantize_kv_page`: ``codes [..., n_kv, D]`` x
    ``scale [...]`` → ``dtype`` rows."""
    return (q.float() * scale[..., None, None]).to(dtype)


# ---------------------------------------------------------------------------
# int8 x int8 -> int32 products
# ---------------------------------------------------------------------------

# torch._int_mm on CUDA needs more than 16 rows; 17 was refused by
# cuBLASLt at small K on the H100, so short operands are padded to 32.
INT_MM_MIN_ROWS = 32
# Row chunks keep each chunk's int32 partials (G x rows x F) under this.
_CHUNK_BYTES = 512 << 20

# Library products the quantized paths issued (for reports and tests).
_calls: Dict[str, int] = {"int_mm": 0}


def quant_calls() -> Dict[str, int]:
    return dict(_calls)


def reset_quant_calls() -> None:
    for key in _calls:
        _calls[key] = 0


def _int_mm_padded(qx: torch.Tensor, qw: torch.Tensor, mm=None
                   ) -> torch.Tensor:
    """``qx [M, K] @ qw [K, N]`` through ``mm`` (``torch._int_mm``) with
    fewer than :data:`INT_MM_MIN_ROWS` rows padded by zero rows, which add
    nothing, and cut off again."""
    mm = mm or torch._int_mm
    M = qx.shape[0]
    if M < INT_MM_MIN_ROWS:
        qx = torch.cat([qx, qx.new_zeros(INT_MM_MIN_ROWS - M, qx.shape[1])])
    return mm(qx.contiguous(), qw)[:M]


def int8_matmul_plain(qx: torch.Tensor, qw: torch.Tensor) -> torch.Tensor:
    """Plain version: exact integer product in float64, as int32."""
    return (qx.double() @ qw.double()).to(torch.int32)


def int8_matmul(qx: torch.Tensor, qw: torch.Tensor) -> torch.Tensor:
    """``[M, K] int8 @ [K, N] int8 → [M, N] int32``, exact.  A CUDA
    operand runs ``torch._int_mm`` (``qw`` should be K-contiguous, i.e.
    ``w.t()`` of a contiguous ``[N, K]``); a CPU one the plain version."""
    if qx.is_cuda:
        K, N = qw.shape
        if K % 8 or N % 8:
            raise ValueError(
                f"int8 products on the card need K and N multiples of 8, "
                f"got K={K}, N={N}"
            )
        _calls["int_mm"] += 1
        return _int_mm_padded(qx, qw)
    return int8_matmul_plain(qx, qw)


def _symmetric_scale(value: torch.Tensor, dim, keepdim: bool = True):
    amax = value.abs().amax(dim=dim, keepdim=keepdim)
    return _div_const(amax.clamp(min=1e-8), 127.0)


@dataclasses.dataclass(frozen=True)
class RowShard:
    """A row-parallel product's split: this rank holds the contraction
    rows ``[start, start + K_local)`` of a kernel whose rows are split
    over ``axis`` of ``mesh``.  Its maxima and sums run over the axis, so
    the product is the unsharded one's (JAX computes every reduction over
    the whole logical array)."""

    mesh: Any
    axis: str = "tp"
    start: int = 0


def row_absmax(amax: torch.Tensor, rows: RowShard) -> torch.Tensor:
    """The maxima of a row-parallel product's operands over every rank's
    block of the contraction axis: one all-reduce MAX."""
    return all_reduce(amax, rows.mesh, rows.axis, op="max")


def _quantize_rows(x32: torch.Tensor, rows: Optional[RowShard] = None):
    """Dynamic per-row int8: ``(codes, s_x [..., 1])``; with ``rows``
    each row's scale is taken over the whole contraction axis."""
    if rows is None:
        s_x = _symmetric_scale(x32, -1)
    else:
        amax = row_absmax(x32.abs().amax(dim=-1, keepdim=True), rows)
        s_x = _div_const(amax.clamp(min=1e-8), 127.0)
    return torch.round(x32 / s_x).to(torch.int8), s_x


def _row_chunks(T: int, per_row_bytes: int):
    step = max(1, _CHUNK_BYTES // max(1, per_row_bytes))
    for start in range(0, T, step):
        yield start, min(T, start + step)


def _rowwise(x: torch.Tensor, F: int, per_row_bytes: int, chunk_fn,
             bias: Optional[torch.Tensor], out_dtype: torch.dtype
             ) -> torch.Tensor:
    """Run ``chunk_fn(x32 rows) -> f32 [rows, F]`` over row chunks of
    ``x [..., K]``, add ``bias`` in f32, cast, and assemble
    ``[..., F]`` in ``out_dtype``."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    T = x2.shape[0]
    out = torch.empty(T, F, dtype=out_dtype, device=x.device)
    b32 = bias.float().reshape(1, F) if bias is not None else None
    for lo, hi in _row_chunks(T, per_row_bytes):
        y = chunk_fn(x2[lo:hi].float())
        if b32 is not None:
            y = y + b32
        out[lo:hi] = y.to(out_dtype)
    return out.reshape(lead + (F,))


# ---------------------------------------------------------------------------
# Dynamic w8a8
# ---------------------------------------------------------------------------

def _quantize_weight_columns(w: torch.Tensor,
                             rows: Optional[RowShard] = None):
    """``w [K, N]`` → (codes ``[K, N]`` K-contiguous, ``s_w [1, N]``),
    per output channel (with ``rows``, over every rank's rows of the
    channel).  Computed on ``w.t()`` so an ``nn.Linear`` ``weight.t()``
    quantizes without a copy into the fast layout."""
    wt32 = w.t().float()                                  # [N, K]
    amax = wt32.abs().amax(dim=-1, keepdim=True)          # [N, 1]
    if rows is not None:
        amax = row_absmax(amax, rows)
    s_w = _div_const(amax.clamp(min=1e-8), 127.0)
    qw = torch.round(wt32 / s_w).to(torch.int8).contiguous()
    return qw.t(), s_w.reshape(1, -1)


def _quant_forward(x, w, bias=None, out_dtype=torch.float32,
                   rows: Optional[RowShard] = None):
    """The dynamic int8 product; a row-parallel one (``rows``) takes its
    scales over every rank's rows and sums the int32 partial products
    over the axis (exact), before the dequant and the bias."""
    K, N = w.shape
    qw, s_w = _quantize_weight_columns(w, rows)

    def chunk(x32):
        qx, s_x = _quantize_rows(x32, rows)
        acc = int8_matmul(qx, qw)
        if rows is not None:
            acc = all_reduce(acc, rows.mesh, rows.axis)
        return acc.float() * s_x * s_w

    return _rowwise(x, N, 4 * N, chunk, bias, out_dtype)


def quant_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` via dynamic int8: x ``[..., K]`` float, w ``[K, N]``
    float.  Returns f32 ``[..., N]``."""
    return _quant_forward(x, w)


def _quantize_batched(x: torch.Tensor, w: torch.Tensor,
                      rows: Optional[RowShard] = None):
    """The codes and scales of :func:`quant_batched_matmul`: activations
    per ``(e, row)`` (``s_x [E, C, 1]``), weights per ``(e, out-channel)``
    (``s_w [E, 1, N]``), weight codes ``[E, K, N]`` K-contiguous.  With
    ``rows`` (a split contraction axis) both maxima run over every rank's
    rows of it."""
    qx, s_x = _quantize_rows(x.float(), rows)              # s_x [E, C, 1]
    qw, s_w = _quantize_rows(w.transpose(1, 2).float(), rows)  # [E, N, 1]
    return qx, s_x, qw.contiguous().transpose(1, 2), s_w.transpose(1, 2)


def quant_batched_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                               rows: Optional[RowShard] = None
                               ) -> torch.Tensor:
    """Plain version of :func:`quant_batched_matmul`: the same codes, the
    integer products in float64 (exact), on any device."""
    qx, s_x, qw, s_w = _quantize_batched(x, w, rows)
    acc = torch.bmm(qx.double(), qw.double()).to(torch.int32)
    if rows is not None:
        acc = all_reduce(acc, rows.mesh, rows.axis)
    return acc.float() * s_x * s_w


def quant_batched_matmul(x: torch.Tensor, w: torch.Tensor,
                         rows: Optional[RowShard] = None) -> torch.Tensor:
    """Per-expert ``x[e] @ w[e]`` through dynamic int8: x ``[E, C, K]``,
    w ``[E, K, N]`` float → f32 ``[E, C, N]``.

    Counterpart of JAX ``ops/quant.py:quant_batched_matmul`` (the MoE
    expert products).  Scales as :func:`quant_matmul`'s, kept per expert;
    int32 accumulation, so the two packages agree code for code on the
    same activations.  A CUDA operand runs one ``torch._int_mm`` per
    expert (the weight codes K-contiguous); a CPU one the plain version.

    ``rows``: this rank holds a block of the contraction axis (the MoE
    ``down`` stack under ``tp``).  The scales are maxima over every rank's
    block (:func:`row_absmax`) and the int32 partials sum over the axis
    before the dequant, so the product is the unsharded one's."""
    if not x.is_cuda:
        return quant_batched_matmul_plain(x, w, rows)
    qx, s_x, qw, s_w = _quantize_batched(x, w, rows)
    acc = torch.stack([int8_matmul(qx[e], qw[e])
                       for e in range(qx.shape[0])])
    if rows is not None:
        acc = all_reduce(acc, rows.mesh, rows.axis)
    return acc.float() * s_x * s_w


def quant_linear(x, weight, bias=None, out_dtype=None,
                 rows: Optional[RowShard] = None):
    """The dynamic int8 path over an ``nn.Linear`` weight ``[N, K]``:
    ``[..., K]`` → ``[..., N]`` in ``out_dtype`` (bias added in f32,
    once, after a row-parallel product's reduce)."""
    return _quant_forward(x, weight.t(), bias, out_dtype or x.dtype, rows)


def quant_dense_axis_last(x, kernel, bias=None, out_dtype=None):
    """DenseGeneral(axis=-1): x ``[..., K]``, kernel ``[K, *F]`` →
    ``[..., *F]``."""
    feat = tuple(kernel.shape[1:])
    out = _quant_forward(x, kernel.reshape(kernel.shape[0], -1),
                         None if bias is None else bias.reshape(-1),
                         out_dtype or x.dtype)
    return out.reshape(tuple(x.shape[:-1]) + feat)


def quant_dense_axis_last2(x, kernel, bias=None, out_dtype=None):
    """DenseGeneral(axis=(-2,-1)): x ``[..., H, D]``, kernel ``[H, D, N]``."""
    H, D, N = kernel.shape
    return _quant_forward(x.reshape(tuple(x.shape[:-2]) + (H * D,)),
                          kernel.reshape(H * D, N), bias,
                          out_dtype or x.dtype)


# ---------------------------------------------------------------------------
# Stored weight-quantized parameters
# ---------------------------------------------------------------------------

WQ_SCHEMES = ("int8", "int4")
WQ_DEFAULT_GROUP = 128

# (path regex, n_contract): which Flax tree paths hold weight-quantized
# kernels.  Matmul kernels only; embeddings, norms, biases and the small
# classifier heads stay float.  o_proj contracts its leading two axes.
WQ_PATH_RULES: Tuple[Tuple[str, int], ...] = (
    (r".*(q_proj|k_proj|v_proj)/kernel$", 1),
    (r".*o_proj/kernel$", 2),
    (r".*(gate_proj|up_proj|down_proj)/kernel$", 1),
    (r".*ffn/(lin1|lin2)/kernel$", 1),
    (r".*lm_head/kernel$", 1),
)


@dataclasses.dataclass
class QuantizedParam:
    """A stored weight-quantized kernel: int8 codes plus f32 scales.

    ``q`` has the float kernel's shape ``[*shape]`` (int8) or, for int4,
    ``[shape[0] / 2, *shape[1:]]`` with two codes a byte; ``scale`` is
    ``[(1|G,), *shape[n_contract:]]``.  Leaves are tensors or numpy arrays.
    """

    q: Any
    scale: Any
    scheme: str = "int8"
    shape: Tuple[int, ...] = ()
    n_contract: int = 1
    group_size: int = 0          # int4 group length over flattened K; 0 = int8

    @property
    def feat_shape(self) -> Tuple[int, ...]:
        return tuple(self.shape[self.n_contract:])

    @property
    def K(self) -> int:
        return int(math.prod(self.shape[:self.n_contract]))

    @property
    def F(self) -> int:
        return int(math.prod(self.feat_shape))

    def to(self, device) -> "QuantizedParam":
        """The same parameter with tensor leaves on ``device`` (numpy
        leaves, memory-mapped ones included, are copied into tensors)."""
        return dataclasses.replace(self, q=_tensor_on(self.q, device),
                                   scale=_tensor_on(self.scale, device))


def _tensor_on(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.tensor(np.asarray(x), device=device)


def wq_group_size(K: int, group_size: int = WQ_DEFAULT_GROUP) -> int:
    """Effective int4 group: the requested size when it divides the
    flattened contraction dim, else one group spanning all of K."""
    return group_size if group_size > 0 and K % group_size == 0 else K


def quantize_array(
    w,
    scheme: str,
    n_contract: int = 1,
    group_size: int = WQ_DEFAULT_GROUP,
) -> QuantizedParam:
    """Symmetric weight-only quantization of one Flax-layout kernel
    ``[K, *F]`` (a tensor or numpy array); returns tensor leaves on the
    kernel's device."""
    if scheme not in WQ_SCHEMES:
        raise ValueError(f"scheme must be one of {WQ_SCHEMES}, got {scheme!r}")
    w = torch.as_tensor(w)
    shape = tuple(int(s) for s in w.shape)
    K = int(math.prod(shape[:n_contract]))
    F = int(math.prod(shape[n_contract:]))
    w2 = w.float().reshape(K, F)
    if scheme == "int8":
        amax = w2.abs().amax(dim=0, keepdim=True)               # [1, F]
        scale = _div_const(amax.clamp(min=1e-8), 127.0)
        q = torch.round(w2 / scale).clamp(-127, 127).to(torch.int8)
        return QuantizedParam(
            q=q.reshape(shape),
            scale=scale.reshape((1,) + shape[n_contract:]),
            scheme="int8", shape=shape, n_contract=n_contract, group_size=0,
        )
    if shape[0] % 2:
        raise ValueError(
            f"int4 packing pairs elements along axis 0, which must be even "
            f"(kernel shape {shape})"
        )
    g = wq_group_size(K, group_size)
    G = K // g
    w3 = w2.reshape(G, g, F)
    amax = w3.abs().amax(dim=1, keepdim=True)                   # [G, 1, F]
    scale = _div_const(amax.clamp(min=1e-8), 7.0)
    q = torch.round(w3 / scale).clamp(-7, 7).to(torch.int8).reshape(shape)
    lo, hi = q[0::2], q[1::2]
    packed = torch.bitwise_or(torch.bitwise_left_shift(hi, 4),
                              torch.bitwise_and(lo, 0x0F))
    return QuantizedParam(
        q=packed,
        scale=scale.reshape((G,) + shape[n_contract:]),
        scheme="int4", shape=shape, n_contract=n_contract, group_size=g,
    )


def _unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of the axis-0 nibble packing; arithmetic shifts sign-extend."""
    lo = torch.bitwise_right_shift(torch.bitwise_left_shift(packed, 4), 4)
    hi = torch.bitwise_right_shift(packed, 4)
    stacked = torch.stack([lo, hi], dim=1)                  # [s0/2, 2, ...]
    return stacked.reshape((packed.shape[0] * 2,) + tuple(packed.shape[1:]))


def dequantize_param(qp: QuantizedParam) -> torch.Tensor:
    """Float32 kernel of the original shape (the test oracle, and what
    ``dequant_transient_bytes`` counts)."""
    q = torch.as_tensor(qp.q)
    scale = torch.as_tensor(qp.scale)
    K, F = qp.K, qp.F
    if qp.scheme == "int8":
        return (q.reshape(K, F).float() * scale.reshape(1, F)).reshape(qp.shape)
    G = K // qp.group_size
    w3 = _unpack_int4(q).reshape(G, qp.group_size, F).float()
    return (w3 * scale.reshape(G, 1, F)).reshape(qp.shape)


def _physical(q: torch.Tensor, n_contract: int) -> torch.Tensor:
    """``q [*contract, *feat]`` viewed feature-axes-first, ``[F, *contract]``
    (contiguous iff ``q`` is kernel-major)."""
    nd = q.dim()
    perm = tuple(range(n_contract, nd)) + tuple(range(n_contract))
    return q.permute(perm).reshape((-1,) + tuple(q.shape[:n_contract]))


def is_kernel_major(q: torch.Tensor, n_contract: int) -> bool:
    nd = q.dim()
    perm = tuple(range(n_contract, nd)) + tuple(range(n_contract))
    return q.permute(perm).is_contiguous()


def kernel_major_empty(shape, n_contract: int, dtype=torch.int8,
                       device=None) -> torch.Tensor:
    """An uninitialised tensor of logical ``shape`` (``[*contract,
    *feat]``) laid out with the flattened feature axis outermost, so its
    ``[K, F]`` view is K-contiguous (the layout ``_int_mm`` is fast on)."""
    shape = tuple(shape)
    contract, feat = shape[:n_contract], shape[n_contract:]
    phys = torch.empty((int(math.prod(feat)),) + contract, dtype=dtype,
                       device=device)
    perm = tuple(range(1, n_contract + 1)) + (0,)
    return phys.permute(perm).reshape(shape)


def kernel_major(qp: QuantizedParam) -> QuantizedParam:
    """``qp`` with its codes kernel-major (a copy unless they are)."""
    q = torch.as_tensor(qp.q)
    if is_kernel_major(q, qp.n_contract):
        return qp
    out = kernel_major_empty(q.shape, qp.n_contract, q.dtype, q.device)
    return dataclasses.replace(qp, q=out.copy_(q))


def _card_weight_codes(qp: QuantizedParam) -> torch.Tensor:
    """The int8 ``[K, F]`` operand for ``_int_mm``, K-contiguous; int4
    codes are unpacked into that layout (a transient of K x F bytes)."""
    q = kernel_major(qp).q
    if qp.scheme == "int8":
        return q.reshape(qp.K, qp.F)
    p = _physical(q, qp.n_contract)                      # [F, K0/2, *C]
    F = p.shape[0]
    p = p.reshape(F, p.shape[1], -1)                     # [F, K0/2, C]
    out = torch.empty(F, p.shape[1], 2, p.shape[2], dtype=torch.int8,
                      device=q.device)
    torch.bitwise_right_shift(torch.bitwise_left_shift(p, 4), 4,
                              out=out[:, :, 0])
    torch.bitwise_right_shift(p, 4, out=out[:, :, 1])
    return out.reshape(F, qp.K).t()


def _group_partials_card(qx: torch.Tensor, w_codes: torch.Tensor, G: int,
                         mm=int8_matmul) -> torch.Tensor:
    """``[G, T, F]`` int32 per-group partial sums of ``qx [T, K] @ w``:
    one product ``mm`` of the block-spread activations ``[G * T, K]``."""
    T, K = qx.shape
    g = K // G
    eye = torch.eye(G, dtype=torch.int8, device=qx.device)
    spread = qx.reshape(T, G, g).transpose(0, 1)[:, :, None, :] \
        * eye[:, None, :, None]                            # [G, T, G, g]
    acc = mm(spread.reshape(G * T, K), w_codes)
    return acc.reshape(G, T, -1)


def _group_partials_plain(qx: torch.Tensor, qw3: torch.Tensor
                          ) -> torch.Tensor:
    """Plain version: ``[T, G, g] x [G, g, F]`` per group in float64."""
    T = qx.shape[0]
    G, g, _ = qw3.shape
    qx3 = qx.reshape(T, G, g).transpose(0, 1).double()
    return torch.bmm(qx3, qw3.double()).to(torch.int32)


def _rank_groups(qp: QuantizedParam, rows: Optional[RowShard]):
    """``(G, g, s_g [G, 1, F])``: the int4 groups this rank's rows fall
    in.  Unsharded, ``qp``'s own.  A row-parallel rank holds rows
    ``[start, start + K)`` of a kernel whose ``qp.scale`` covers every
    group; cut into blocks of ``gcd(group, K)`` rows, each block lies in
    one group and takes that group's scale, so a rank boundary inside a
    group is exact."""
    K, F = qp.K, qp.F
    scale = torch.as_tensor(qp.scale).reshape(-1, F)
    if rows is None:
        G = K // qp.group_size
        return G, qp.group_size, scale.reshape(G, 1, F)
    g = math.gcd(qp.group_size, K)
    first = torch.arange(rows.start, rows.start + K, g,
                         device=scale.device) // qp.group_size
    return K // g, g, scale[first].reshape(-1, 1, F)


def wq_linear(x: torch.Tensor, qp: QuantizedParam, bias=None,
              out_dtype=torch.float32,
              rows: Optional[RowShard] = None) -> torch.Tensor:
    """``[..., K]`` → ``[..., F]`` (features flattened) in ``out_dtype``,
    bias added in f32: the stored-weight projection of ``WqLinear``.

    With ``rows`` (a row-parallel rank's block of the contraction) each
    token's activation scale is its maximum over every rank's rows; int8
    sums its int32 accumulators over the axis, then dequantizes once (an
    exact sum, so the unsharded product bit for bit); int4 sums each
    rank's scaled group partials in f32 and then over the axis.  The bias
    is added once, after the reduce."""
    K, F = qp.K, qp.F
    if x.shape[-1] != K:
        raise ValueError(f"input's last axis is {x.shape[-1]}, the kernel "
                         f"contracts {K}")

    def reduced(partial):
        if rows is None:
            return partial
        return all_reduce(partial, rows.mesh, rows.axis)

    if qp.scheme == "int8":
        s_w = torch.as_tensor(qp.scale).reshape(1, F)
        w = (_card_weight_codes(qp) if x.is_cuda
             else torch.as_tensor(qp.q).reshape(K, F))

        def chunk(x32):
            qx, s_x = _quantize_rows(x32, rows)
            return reduced(int8_matmul(qx, w)).float() * s_x * s_w

        return _rowwise(x, F, 4 * F, chunk, bias, out_dtype)
    G, g, s_g = _rank_groups(qp, rows)
    if x.is_cuda:
        w = _card_weight_codes(qp)

        def partials(qx):
            return _group_partials_card(qx, w, G)
    else:
        qw3 = _unpack_int4(torch.as_tensor(qp.q)).reshape(G, g, F)

        def partials(qx):
            return _group_partials_plain(qx, qw3)

    def chunk(x32):
        qx, s_x = _quantize_rows(x32, rows)
        acc = partials(qx)
        return reduced((acc.float() * s_g).sum(dim=0)) * s_x.reshape(-1, 1)

    return _rowwise(x, F, 4 * G * F, chunk, bias, out_dtype)


def wq_matmul(x: torch.Tensor, qp: QuantizedParam) -> torch.Tensor:
    """``x @ dequant(qp)`` with the dequant in the epilogue: x ``[..., K]``
    float (K the flattened contraction), returns f32 ``[..., F]``."""
    return wq_linear(x, qp)


def wq_dense_axis_last(x, qp: QuantizedParam, bias=None, out_dtype=None):
    """DenseGeneral(axis=-1) over a stored-quantized kernel ``[K, *F]``."""
    out = wq_linear(x, qp, None if bias is None else bias.reshape(-1),
                    out_dtype or x.dtype)
    return out.reshape(tuple(x.shape[:-1]) + qp.feat_shape)


def wq_dense_axis_last2(x, qp: QuantizedParam, bias=None, out_dtype=None):
    """DenseGeneral(axis=(-2,-1)) over a stored-quantized ``[H, D, N]``."""
    H, D = qp.shape[0], qp.shape[1]
    return wq_linear(x.reshape(tuple(x.shape[:-2]) + (H * D,)), qp, bias,
                     out_dtype or x.dtype)


def wq_rule_for_path(path: str) -> Optional[int]:
    """``n_contract`` when the "/"-joined tree path names a weight-quantized
    kernel, else ``None``."""
    for pattern, n_contract in WQ_PATH_RULES:
        if re.match(pattern, path):
            return n_contract
    return None


def iter_tree(tree, prefix: str = ""):
    """``("/"-joined path, leaf)`` for every leaf of a nested dict, in
    insertion order."""
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            yield from iter_tree(value, path + "/")
        else:
            yield path, value


def quantize_tree(tree, scheme: str, group_size: int = WQ_DEFAULT_GROUP):
    """Quantize every rule-matched kernel of a nested-dict parameter tree
    (Flax paths and layouts); other leaves pass through."""
    def walk(node, prefix):
        out = {}
        for key, value in node.items():
            path = f"{prefix}{key}"
            if isinstance(value, dict):
                out[key] = walk(value, path + "/")
                continue
            n_contract = wq_rule_for_path(path)
            out[key] = (value if n_contract is None else
                        quantize_array(value, scheme, n_contract, group_size))
        return out

    return walk(tree, "")


def _leaf_nbytes(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return int(math.prod(leaf.shape)) * np.dtype(leaf.dtype).itemsize


def _leaves(tree):
    """Quantized and float leaves of a nested dict or a module: a module's
    leaves are its parameters, and the ``qparam`` of each module that
    stores a quantized kernel."""
    if isinstance(tree, torch.nn.Module):
        for module in tree.modules():
            qp = getattr(module, "qparam", None)
            if qp is not None:
                yield qp
            yield from module.parameters(recurse=False)
        return
    for _, leaf in iter_tree(tree):
        yield leaf


def param_tree_bytes(tree) -> dict:
    """Byte accounting for a (possibly quantized) parameter tree or model.

    ``stored_bytes`` is what stays resident (codes + scales + float
    leaves); ``dequant_transient_bytes`` is the largest would-be f32
    kernel among the quantized leaves.
    """
    stored = quantized = float_bytes = transient = 0
    n_q = n_f = 0
    for leaf in _leaves(tree):
        if isinstance(leaf, QuantizedParam):
            n_q += 1
            b = _leaf_nbytes(leaf.q) + _leaf_nbytes(leaf.scale)
            quantized += b
            stored += b
            transient = max(transient, int(math.prod(leaf.shape)) * 4)
        else:
            n_f += 1
            b = _leaf_nbytes(leaf)
            float_bytes += b
            stored += b
    return {
        "stored_bytes": stored,
        "quantized_bytes": quantized,
        "float_bytes": float_bytes,
        "dequant_transient_bytes": transient,
        "n_quantized_leaves": n_q,
        "n_float_leaves": n_f,
    }
