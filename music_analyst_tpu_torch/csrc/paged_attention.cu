// Paged decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel music_analyst_tpu/ops/paged_attention.py
// (_stream_body, launched by paged_attention; its interpret-mode twin
// _exact_body computes the same function in another reduction order).
// One decode query per slot (q_len == 1) attends over that slot's KV rows,
// read through an int32 page table from a shared page pool:
//
//   q      [n, 1, H, D]              bf16
//   pools  [n_pages + 1, P, n_kv, D] bf16, or int8 codes with per-(page, row)
//                                    f32 scales [n_pages + 1, P] for K and V
//   table  [n, pps]                  int32 physical page per slot page
//   mask   [n, total]                bool (uint8), True = attend; keys at or
//                                    past `total` are masked (total <= pps*P)
//   out    [n, 1, H, D]              bf16
//
// GQA: query head hq reads kv head hq / G, G = H / n_kv (repeat_interleave).
//
// What bounds it: every valid K/V row is read once and used for G query
// heads, 2 flops per byte per head (about 8 at G = 4) -- far under the H100
// SXM's ridge of about 295 bf16 flops per byte (989 TFLOP/s over 3.35 TB/s,
// data sheet), so the bytes of the valid rows bound it, and tensor cores
// would buy nothing.  What matters is bytes in flight and blocks on every
// SM: at a decode batch of 8 slots and 8 kv heads one block per (slot, kv
// head) gives 64 blocks on 132 SMs, each walking its keys in sequence.
//
// Design: split-K over the keys.  The grid is (n_kv, n, splits); split z
// owns keys [z * chunk, min((z + 1) * chunk, total)), chunk <= 64, from the
// plan in ops/paged_attention.py:split_plan.  A block of 128 threads serves
// the G query heads of its kv head:
//   1. it scans only its own part of the mask and loads its own page-table
//      entries; a split with no valid key writes (m, l) = (NEG_INF, 0);
//   2. it issues every valid K and V row at once as 16-byte cp.async copies
//      through the table, keeping them bf16 (or int8 codes) in shared
//      memory; masked rows are zero-filled and never loaded, so garbage
//      (NaN) in the trash page cannot reach the result;
//   3. logits in f32 on the CUDA cores (a warp per row, lanes along D; int8
//      codes x scale are rounded to bf16 where they are read, the value the
//      TPU kernel makes right after its DMA), softmax over the split per
//      query head, and the weighted V sum per (head, column);
//   4. it writes its unnormalised f32 o [G, D] with its m and l per head to
//      scratch, then takes a ticket (an atomic count per (slot, kv head));
//      the last block of the (slot, kv head) combines the splits in split
//      order (a split with l == 0 is skipped; an overall l == 0 gives exact
//      zeros) and rounds to bf16 once.  No float atomics: the result is the
//      same bit for bit from run to run.
// The scratch (partials and tickets) belongs to one call: the caller
// allocates it on the launch stream, and the entry point zeroes the tickets
// on that stream before the launch, so calls on other streams, or after a
// failed launch, share no state.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 64;   // keys per split
constexpr int kMaxAcc = 8;      // accumulators per thread: G * D <= 8 * 128
constexpr float kNegInf = -1e30f;

struct PagedParams {
  const __nv_bfloat16* q;
  const void* k_pages;
  const void* v_pages;
  const float* k_scale;
  const float* v_scale;
  const int* table;
  const unsigned char* mask;
  __nv_bfloat16* out;
  float* part_o;   // [n, n_kv, splits, G, D] unnormalised
  float* part_ml;  // [n, n_kv, splits, G, 2] (m, l)
  int* tickets;    // [n, n_kv], zeroed before the launch
  int H, n_kv, P, pps, total, chunk, splits;
  float scale;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src) : "memory");
}

// Element i of a shared-memory row as f32; int8 codes x scale rounded to
// bf16 first.
template <bool kInt8>
__device__ __forceinline__ float row_at(const uint8_t* row, int i, float s) {
  if constexpr (kInt8) {
    const float x = static_cast<float>(reinterpret_cast<const int8_t*>(row)[i]);
    return __bfloat162float(__float2bfloat16(x * s));
  } else {
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(row)[i]);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sums each of NV values over the warp with NV - 1 + log2(32 / NV)
// shuffles: a butterfly that halves the values at each step (lanes with the
// step's bit set keep the upper half).  Lane l ends with, in v[0], the sum
// of value (l >> (5 - log2 NV)) & (NV - 1).  Template steps keep every
// index a compile-time constant, so v stays in registers.
template <int kWidth, int kMask, int NV>
__device__ __forceinline__ void warp_fold(float (&v)[NV], int lane) {
  if constexpr (kWidth > 1) {
    const bool upper = lane & kMask;
#pragma unroll
    for (int i = 0; i < kWidth / 2; ++i) {
      const float send = upper ? v[i] : v[i + kWidth / 2];
      const float keep = upper ? v[i + kWidth / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, kMask);
    }
    warp_fold<kWidth / 2, kMask / 2>(v, lane);
  } else {
#pragma unroll
    for (int m = kMask; m > 0; m /= 2)
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], m);
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 4 blocks per SM at least: up to 128 registers a thread (D = 64 holds
// 16 heads' query slices and partial dots in registers).
template <bool kInt8, int D>
__global__ void __launch_bounds__(kThreads, 4)
paged_split_kernel(const PagedParams p) {
  constexpr int kElem = kInt8 ? 1 : 2;
  constexpr int kRowBytes = D * kElem;
  constexpr int kPieces = kRowBytes / 16;       // 16-byte copies per row
  constexpr int kPer = D / 32;                  // row elements per lane
  constexpr int kMaxG = kMaxAcc * kThreads / D; // G * D <= 1024
  constexpr int kColThreads = kThreads / D;     // threads per output column
  static_assert(kMaxG == 8 || kMaxG == 16, "head dim 64 or 128");
  static_assert(kMaxAcc == 8, "the V sum reads a thread's 8 heads as two float4");
  const auto slot_of = [](int g) { return (g % kColThreads) * kMaxAcc + g / kColThreads; };
  const int h = blockIdx.x;
  const int slot = blockIdx.y;
  const int split = blockIdx.z;
  const int G = p.H / p.n_kv;
  const int chunk = p.chunk;
  const int start = split * chunk;
  const int rows = min(chunk, p.total - start);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* ks = smem;                                   // [chunk][row bytes]
  uint8_t* vs = ks + chunk * kRowBytes;                 // [chunk][row bytes]
  // scores [chunk][kMaxG]: row r's head g at r * kMaxG + slot_of(g), so a
  // thread's heads g0, g0 + kColThreads, ... sit side by side.
  float* scores = reinterpret_cast<float*>(vs + chunk * kRowBytes);
  float* k_sc = scores + kMaxG * chunk;                 // [chunk]
  float* v_sc = k_sc + chunk;                           // [chunk]
  int* valid = reinterpret_cast<int*>(v_sc + chunk);    // [chunk]
  float* w_s = reinterpret_cast<float*>(valid + chunk);  // [splits][G]
  float* lz_s = w_s + p.splits * G;                     // [splits][G]
  __shared__ float m_s[kMaxG], l_s[kMaxG];
  __shared__ int is_last;

  const long long pair = static_cast<long long>(slot) * p.n_kv + h;
  const long long part = pair * p.splits + split;
  const long long q_base = (static_cast<long long>(slot) * p.H + h * G) * D;

  // 1-2. Warp w owns rows [32 w, 32 w + 32) of the split: each lane reads
  // one row's mask byte and page-table entry, then the warp issues those
  // rows' K and V copies at once (2 * kPieces lanes per row).
  constexpr int kLanesPerRow = 2 * kPieces;
  constexpr int kRowsPerStep = 32 / kLanesPerRow;
  const int my_row = warp * 32 + lane;
  int ok = 0;
  long long my_prow = 0;
  if (my_row < rows) {
    const int j = start + my_row;
    // Both loads at once: j < total <= pps * P keeps the table index in range.
    const long long phys = p.table[static_cast<long long>(slot) * p.pps + j / p.P];
    ok = p.mask[static_cast<long long>(slot) * p.total + j] ? 1 : 0;
    valid[my_row] = ok;
    my_prow = ok ? phys * p.P + j % p.P : 0;
    if (kInt8) {
      k_sc[my_row] = ok ? p.k_scale[my_prow] : 0.f;
      v_sc[my_row] = ok ? p.v_scale[my_prow] : 0.f;
    }
  }
  if (warp * 32 < rows) {
    const int piece = lane % kLanesPerRow;
    const bool is_v = piece >= kPieces;
    const int off = (piece % kPieces) * 16;
    const uint8_t* pool =
        static_cast<const uint8_t*>(is_v ? p.v_pages : p.k_pages) + off;
    uint8_t* dst0 = (is_v ? vs : ks) + off;
    for (int rr = lane / kLanesPerRow; rr < 32; rr += kRowsPerStep) {
      const int r_ok = __shfl_sync(0xffffffffu, ok, rr);
      const long long r_prow = __shfl_sync(0xffffffffu, my_prow, rr);
      const int r = warp * 32 + rr;
      if (r < rows) {
        uint8_t* dst = dst0 + r * kRowBytes;
        if (r_ok)
          cp_async16(dst, pool + (r_prow * p.n_kv + h) * kRowBytes);
        else
          *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      }
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
  // The query rows of this kv head, lanes along D, while the copies land.
  float qr[kMaxG][kPer];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      qr[g][i] = g < G ? __bfloat162float(p.q[q_base + g * D + lane * kPer + i]) : 0.f;
  if (__syncthreads_or(ok)) {
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();

    // 3a. Logits: a warp per key row, lanes along D; four rows at a time
    // so that their shuffle chains overlap.
    constexpr int kRowsAtOnce = 4;
    constexpr int kShift = kMaxG == 8 ? 2 : 1;   // 5 - log2(kMaxG)
    for (int r0 = warp; r0 < rows; r0 += kRowsAtOnce * kWarps) {
      float dot[kRowsAtOnce][kMaxG];
#pragma unroll
      for (int u = 0; u < kRowsAtOnce; ++u) {
        const int r = min(r0 + u * kWarps, rows - 1);   // a repeat is never written
        float kv[kPer];
#pragma unroll
        for (int i = 0; i < kPer; ++i)
          kv[i] = row_at<kInt8>(ks + r * kRowBytes, lane * kPer + i,
                                kInt8 ? k_sc[r] : 1.f);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          dot[u][g] = 0.f;
#pragma unroll
          for (int i = 0; i < kPer; ++i) dot[u][g] = fmaf(qr[g][i], kv[i], dot[u][g]);
        }
      }
#pragma unroll
      for (int u = 0; u < kRowsAtOnce; ++u) warp_fold<kMaxG, 16>(dot[u], lane);
      const int g = (lane >> kShift) & (kMaxG - 1);
#pragma unroll
      for (int u = 0; u < kRowsAtOnce; ++u) {
        const int r = r0 + u * kWarps;
        if (r < rows && (lane & ((1 << kShift) - 1)) == 0 && g < G)
          scores[r * kMaxG + slot_of(g)] = valid[r] ? dot[u][0] * p.scale : kNegInf;
      }
    }
    __syncthreads();

    // 3b. Softmax over the split: a warp per query head.
    for (int g = warp; g < G; g += kWarps) {
      float* sg = scores + slot_of(g);
      float mx = kNegInf;
      for (int r = lane; r < rows; r += 32) mx = fmaxf(mx, sg[r * kMaxG]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int r = lane; r < rows; r += 32) {
        const float e = valid[r] ? expf(sg[r * kMaxG] - mx) : 0.f;
        sg[r * kMaxG] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        m_s[g] = mx;
        l_s[g] = sum;
      }
    }
    __syncthreads();

    // 3c. Weighted V: thread -> column `col` of heads g0, g0 + 128/D, ...
    const int col = tid % D;
    const int g0 = tid / D;
    float acc[kMaxAcc];
#pragma unroll
    for (int k = 0; k < kMaxAcc; ++k) acc[k] = 0.f;
#pragma unroll 4
    for (int r = 0; r < rows; ++r) {
      const float v = row_at<kInt8>(vs + r * kRowBytes, col, kInt8 ? v_sc[r] : 1.f);
      const float4* sr =
          reinterpret_cast<const float4*>(scores + r * kMaxG + g0 * kMaxAcc);
      const float4 a = sr[0], b = sr[1];   // heads past G: unused lanes
      acc[0] = fmaf(a.x, v, acc[0]);
      acc[1] = fmaf(a.y, v, acc[1]);
      acc[2] = fmaf(a.z, v, acc[2]);
      acc[3] = fmaf(a.w, v, acc[3]);
      acc[4] = fmaf(b.x, v, acc[4]);
      acc[5] = fmaf(b.y, v, acc[5]);
      acc[6] = fmaf(b.z, v, acc[6]);
      acc[7] = fmaf(b.w, v, acc[7]);
    }
    // 4. Partials.
#pragma unroll
    for (int k = 0; k < kMaxAcc; ++k) {
      const int g = g0 + k * kColThreads;
      if (g < G) p.part_o[(part * G + g) * D + col] = acc[k];
    }
    if (tid < G)
      reinterpret_cast<float2*>(p.part_ml)[part * G + tid] =
          make_float2(m_s[tid], l_s[tid]);
  } else if (tid < G) {
    reinterpret_cast<float2*>(p.part_ml)[part * G + tid] = make_float2(kNegInf, 0.f);
  }

  // 4. Ticket; the last block of this (slot, kv head) combines.
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(p.tickets + pair, 1) == p.splits - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // Every split's (m, l) at once, then per head the max over the splits
  // that hold a key and each split's weight, in split order.
  const int n_ml = p.splits * G;
  for (int i = tid; i < n_ml; i += kThreads) {
    const float2 ml = __ldcg(reinterpret_cast<const float2*>(p.part_ml) +
                             pair * n_ml + i);
    w_s[i] = ml.x;
    lz_s[i] = ml.y;
  }
  __syncthreads();
  if (tid < G) {
    float m_all = kNegInf;
    for (int z = 0; z < p.splits; ++z)
      if (lz_s[z * G + tid] > 0.f) m_all = fmaxf(m_all, w_s[z * G + tid]);
    float l = 0.f;
    for (int z = 0; z < p.splits; ++z) {
      const float lz = lz_s[z * G + tid];
      const float w = lz > 0.f ? expf(w_s[z * G + tid] - m_all) : 0.f;
      w_s[z * G + tid] = w;
      l = fmaf(w, lz, l);
    }
    l_s[tid] = l;
  }
  __syncthreads();
  const int col = tid % D;
  const int g0 = tid / D;
#pragma unroll
  for (int k = 0; k < kMaxAcc; ++k) {
    const int g = g0 + k * kColThreads;
    if (g >= G) continue;
    const float* src = p.part_o + (pair * p.splits * G + g) * D + col;
    float o = 0.f;
#pragma unroll 8
    for (int z = 0; z < p.splits; ++z) {
      const float w = w_s[z * G + g];
      if (w > 0.f) o = fmaf(w, __ldcg(src + static_cast<long long>(z) * G * D), o);
    }
    const float l = l_s[g];
    p.out[q_base + g * D + col] = __float2bfloat16(o / (l == 0.f ? 1.f : l));
  }
}

size_t smem_bytes(int D, int G, int chunk, int splits, bool int8) {
  const size_t row = static_cast<size_t>(D) * (int8 ? 1 : 2);
  return 2 * chunk * row +
         sizeof(float) * (kMaxAcc * kThreads / D * chunk + 2 * chunk +
                          2 * splits * G) +
         sizeof(int) * chunk;
}

template <bool kInt8, int D>
cudaError_t launch(const PagedParams& p, int n, cudaStream_t stream) {
  const int G = p.H / p.n_kv;
  const size_t smem = smem_bytes(D, G, p.chunk, p.splits, kInt8);
  cudaError_t err = cudaFuncSetAttribute(
      paged_split_kernel<kInt8, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(p.n_kv, n, p.splits);
  paged_split_kernel<kInt8, D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool kInt8>
cudaError_t launch_d(const PagedParams& p, int n, int D, cudaStream_t stream) {
  if (D == 64) return launch<kInt8, 64>(p, n, stream);
  if (D == 128) return launch<kInt8, 128>(p, n, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Returns a cudaError_t.  k_scale / v_scale are read only when quantized.
// scratch, 16-byte aligned and for this call alone, holds part_o [n, n_kv,
// splits, G, D] and part_ml [n, n_kv, splits, G, 2] f32, then tickets [n,
// n_kv] int32, which are zeroed on `stream` here.
extern "C" int paged_attention_fwd(
    const void* q, const void* k_pages, const void* v_pages,
    const float* k_scale, const float* v_scale, const int* table,
    const unsigned char* mask, void* out, void* scratch, int n, int H,
    int n_kv, int D, int P, int pps, int total, int chunk, int splits,
    int quantized, float scale, void* stream) {
  if (n <= 0 || n > 65535 || n_kv <= 0 || H % n_kv != 0 || P <= 0 ||
      total <= 0 || total > pps * P)
    return cudaErrorInvalidValue;
  if ((H / n_kv) * D > kMaxAcc * kThreads) return cudaErrorInvalidValue;
  if (chunk <= 0 || chunk > kMaxChunk || splits != (total + chunk - 1) / chunk ||
      splits > 65535)
    return cudaErrorInvalidValue;
  const long long parts = static_cast<long long>(n) * H * splits;  // n*n_kv*G
  float* part_o = static_cast<float*>(scratch);
  float* part_ml = part_o + parts * D;
  int* tickets = reinterpret_cast<int*>(part_ml + parts * 2);
  PagedParams p{static_cast<const __nv_bfloat16*>(q), k_pages, v_pages,
                k_scale, v_scale, table, mask,
                static_cast<__nv_bfloat16*>(out), part_o, part_ml, tickets,
                H, n_kv, P, pps, total, chunk, splits, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(
      tickets, 0, sizeof(int) * static_cast<size_t>(n) * n_kv, st);
  if (err != cudaSuccess) return err;
  return quantized ? launch_d<true>(p, n, D, st)
                   : launch_d<false>(p, n, D, st);
}
