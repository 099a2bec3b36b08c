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
// Design.  One block of 128 threads per (kv head, slot) serves the G query
// heads that share the kv head.  The block walks the slot's keys in tiles of
// 64 rows (several pages at page size <= 64): it copies the tile's K and V
// rows of its kv head into shared memory as f32 (int8 codes x scale are
// rounded to bf16 first, as the TPU kernel does right after its DMA), with
// masked rows written as zeros and never loaded, so garbage in a masked row
// (the trash page) cannot reach the result.  Each thread computes logits for
// one key row and its query heads in f32; one warp per query head folds the
// tile into a running max / normalizer (masked lanes contribute exact zeros
// after the exp); each thread keeps its (head, column) share of the weighted
// V sum in f32 registers.  The result acc / l, with l == 0 -> 1 so a fully
// masked row gives exact zeros, is rounded to bf16 once.  Tiles past the
// slot's last valid key, and tiles with no valid key, are skipped: an
// all-masked tile changes neither the max, nor the sum, nor the output.
//
// What bounds it: every valid K/V row is read once and used for G query
// heads, 2 flops per byte per head -- far under the H100 SXM's ridge of about
// 295 bf16 flops per byte (989 TFLOP/s over 3.35 TB/s, data sheet), so the
// bytes of the valid rows bound it.  At a decode batch of 8 slots and 8 kv
// heads the grid has only 64 blocks, and each walks its keys in sequence, so
// this first version is bound by latency, not bandwidth; splitting the key
// range over more blocks (split-K) and TMA loads are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 64;       // keys per tile
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
  int H, n_kv, P, pps, total;
  float scale;
};

// 8 consecutive row elements from the pool into shared memory as f32.
template <bool kInt8>
__device__ __forceinline__ void load8(const void* pool, long long off,
                                      float s, float* dst) {
  if constexpr (kInt8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(
        static_cast<const int8_t*>(pool) + off);
    const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      dst[i] = __bfloat162float(__float2bfloat16(static_cast<float>(c[i]) * s));
  } else {
    const uint4 raw = *reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(pool) + off);
    const __nv_bfloat16* c = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[i] = __bfloat162float(c[i]);
  }
}

template <bool kInt8, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const PagedParams p) {
  constexpr int kStride = D + 1;          // padded rows: conflict-free reads
  constexpr int kChunks = D / 8;          // 8-element loads per row
  constexpr int kThreadsPerCol = kThreads / D;
  const int h = blockIdx.x;
  const int slot = blockIdx.y;
  const int G = p.H / p.n_kv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ float smem[];
  float* ks = smem;                                  // [kRows][kStride]
  float* vs = ks + kRows * kStride;                  // [kRows][kStride]
  float* qs = vs + kRows * kStride;                  // [G][D]
  float* ps = qs + G * D;                            // [G][kRows]
  float* m_s = ps + G * kRows;                       // [G]
  float* l_s = m_s + G;                              // [G]
  float* corr_s = l_s + G;                           // [G]
  int* valid = reinterpret_cast<int*>(corr_s + G);   // [kRows]
  __shared__ int last_valid;

  const unsigned char* mrow = p.mask + static_cast<long long>(slot) * p.total;
  const int* trow = p.table + static_cast<long long>(slot) * p.pps;
  const long long q_base = (static_cast<long long>(slot) * p.H + h * G) * D;

  if (tid == 0) last_valid = -1;
  for (int i = tid; i < G * D; i += kThreads)
    qs[i] = __bfloat162float(p.q[q_base + i]);
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  __syncthreads();
  int mine = -1;
  for (int j = tid; j < p.total; j += kThreads)
    if (mrow[j]) mine = j;
  if (mine >= 0) atomicMax(&last_valid, mine);
  __syncthreads();
  const int last = last_valid;

  float acc[kMaxAcc];
#pragma unroll
  for (int k = 0; k < kMaxAcc; ++k) acc[k] = 0.f;
  const int col = tid % D;
  const int g0 = tid / D;

  for (int t0 = 0; t0 <= last; t0 += kRows) {
    int ok = 0;
    if (tid < kRows) {
      const int j = t0 + tid;
      ok = (j <= last && mrow[j]) ? 1 : 0;
      valid[tid] = ok;
    }
    if (!__syncthreads_or(ok)) continue;     // no valid key in this tile

    // K and V rows of this kv head into shared memory; masked rows -> 0.
    for (int c = tid; c < kRows * kChunks; c += kThreads) {
      const int r = c / kChunks;
      const int d0 = (c % kChunks) * 8;
      float* kd = ks + r * kStride + d0;
      float* vd = vs + r * kStride + d0;
      if (valid[r]) {
        const int j = t0 + r;
        const long long phys = trow[j / p.P];
        const long long prow = phys * p.P + j % p.P;
        const long long off = (prow * p.n_kv + h) * D + d0;
        const float sk = kInt8 ? p.k_scale[prow] : 1.f;
        const float sv = kInt8 ? p.v_scale[prow] : 1.f;
        load8<kInt8>(p.k_pages, off, sk, kd);
        load8<kInt8>(p.v_pages, off, sv, vd);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) kd[i] = vd[i] = 0.f;
      }
    }
    __syncthreads();

    // Logits in f32: thread -> one key row, query heads g0, g0 + 2, ...
    {
      const int r = tid % kRows;
      const float* kr = ks + r * kStride;
      for (int g = tid / kRows; g < G; g += kThreads / kRows) {
        const float* qg = qs + g * D;
        float s = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) s = fmaf(qg[d], kr[d], s);
        ps[g * kRows + r] = valid[r] ? s * p.scale : kNegInf;
      }
    }
    __syncthreads();

    // Online softmax: one warp per query head.
    for (int g = warp; g < G; g += kThreads / 32) {
      float s0 = ps[g * kRows + lane];
      float s1 = ps[g * kRows + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = valid[lane] ? expf(s0 - m_new) : 0.f;
      const float p1 = valid[lane + 32] ? expf(s1 - m_new) : 0.f;
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      ps[g * kRows + lane] = p0;
      ps[g * kRows + lane + 32] = p1;
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        corr_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // Weighted V: thread -> column `col` of query heads g0, g0 + 128/D, ...
#pragma unroll
    for (int k = 0; k < kMaxAcc; ++k) {
      const int g = g0 + k * kThreadsPerCol;
      if (g < G) {
        const float* pg = ps + g * kRows;
        float a = acc[k] * corr_s[g];
#pragma unroll 8
        for (int r = 0; r < kRows; ++r) a = fmaf(pg[r], vs[r * kStride + col], a);
        acc[k] = a;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int k = 0; k < kMaxAcc; ++k) {
    const int g = g0 + k * kThreadsPerCol;
    if (g < G) {
      const float l = l_s[g];
      const float denom = l == 0.f ? 1.f : l;
      p.out[q_base + g * D + col] = __float2bfloat16(acc[k] / denom);
    }
  }
}

size_t smem_bytes(int D, int G) {
  return sizeof(float) *
             (2 * kRows * (D + 1) + G * D + G * kRows + 3 * G) +
         sizeof(int) * kRows;
}

template <bool kInt8, int D>
cudaError_t launch(const PagedParams& p, int n, cudaStream_t stream) {
  const int G = p.H / p.n_kv;
  const size_t smem = smem_bytes(D, G);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<kInt8, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(p.n_kv, n);
  paged_decode_kernel<kInt8, D><<<grid, kThreads, smem, stream>>>(p);
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
extern "C" int paged_attention_fwd(
    const void* q, const void* k_pages, const void* v_pages,
    const float* k_scale, const float* v_scale, const int* table,
    const unsigned char* mask, void* out, int n, int H, int n_kv, int D,
    int P, int pps, int total, int quantized, float scale, void* stream) {
  if (n <= 0 || n > 65535 || n_kv <= 0 || H % n_kv != 0 || P <= 0 ||
      total <= 0 || total > pps * P)
    return cudaErrorInvalidValue;
  if ((H / n_kv) * D > kMaxAcc * kThreads) return cudaErrorInvalidValue;
  PagedParams p{static_cast<const __nv_bfloat16*>(q), k_pages, v_pages,
                k_scale, v_scale, table, mask,
                static_cast<__nv_bfloat16*>(out), H, n_kv, P, pps, total,
                scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return quantized ? launch_d<true>(p, n, D, st)
                   : launch_d<false>(p, n, D, st);
}
