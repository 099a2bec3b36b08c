// Blocked online-softmax attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel music_analyst_tpu/ops/flash_attention.py
// (_flash_kernel, launched by _flash_call).  Same function, same masks:
// per-row kv `lengths`, `causal` with kv-tile skipping, block-diagonal
// segment ids, global q/kv offsets, GQA (query head h reads kv head
// h / (H / Hkv)), fully-masked rows give exact zeros, and a residual mode
// that returns the unnormalised f32 accumulator plus the running max `m`
// and sum `l` per query row.
//
// Layout: q [B, S, H, D], k/v [B, KV, Hkv, D], out [B, S, H, D], row-major
// and contiguous; m/l [B, H, S] f32.
//
// Design.  One block of 256 threads per (b, h, 64-row query tile).  The
// query tile is staged once in shared memory (scaled, as f32); 64-row K and
// V tiles stream through shared memory in a loop that takes the place of
// the TPU kernel's sequential kv grid axis.  Scores, the running max/sum
// and the output accumulator stay in f32 registers: each thread owns a
// 4x4 block of the score tile and 4 rows x D/16 columns of the output.
// The 16 threads that share a query row sit in one half-warp, so row max
// and row sum are four xor-shuffles.  Ragged S and KV are masked inside the
// kernel; no divisibility rule applies.
//
// What bounds it: at the DistilBERT shape (S = KV = 128, D = 64) the call
// must read q, k, v and write o once, about 64 flops per byte moved, under
// the H100 SXM's bf16 ridge (989 TFLOP/s over 3.35 TB/s, about 295
// flops/byte, data sheet) — so memory bounds the ideal kernel.  This first
// version multiplies on the CUDA cores in f32 (no tensor cores), so its
// arithmetic, not its traffic, sets its time; moving QK^T and PV onto wgmma
// is the next step.  Numerics follow the TPU kernel:
// q * D^-0.5 in f32 before QK^T, NEG_INF = -1e30 sentinel,
// p = s > NEG_INF/2 ? exp(s - m) : 0, alpha = exp(min(m_prev - m_cur, 0)),
// denominator max(l, 1e-30).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // kv rows per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;              // T [B,S,H,D]; f32 when residual
  float* m_out;         // [B,H,S], residual only
  float* l_out;         // [B,H,S], residual only
  const int* lengths;   // [B] valid kv length (global positions)
  const int* q_seg;     // [B,S] or null
  const int* kv_seg;    // [B,KV] or null
  int B, S, KV, H, Hkv;
  int q_off, kv_off;
  int causal, residual;
  float scale;
};

constexpr size_t smem_bytes(int d) {
  return sizeof(float) *
             (size_t(kBQ) * (d + 1) + size_t(kBK) * (d + 1) +
              size_t(kBK) * d + size_t(kBQ) * kBK) +
         sizeof(int) * kBK;
}

__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(FlashParams p) {
  constexpr int DP = D + 1;  // padded smem row: column reads hit 16 banks
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                                  // [BQ][DP]
  float* Ks = Qs + kBQ * DP;                         // [BK][DP]
  float* Vs = Ks + kBK * DP;                         // [BK][D]
  float* Ps = Vs + kBK * D;                          // [BQ][BK]
  int* kseg = reinterpret_cast<int*>(Ps + kBQ * kBK);  // [BK]

  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);

  const int q_tiles = (p.S + kBQ - 1) / kBQ;
  long long bid = blockIdx.x;
  const int qt = static_cast<int>(bid % q_tiles);
  bid /= q_tiles;
  const int h = static_cast<int>(bid % p.H);
  const int b = static_cast<int>(bid / p.H);
  const int hk = h / (p.H / p.Hkv);
  const int q0 = qt * kBQ;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  // Stage the query tile once, scaled in f32 (rows past S load zeros).
  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int s = q0 + r;
    float val = 0.f;
    if (s < p.S)
      val = to_f32(q[((static_cast<long long>(b) * p.S + s) * p.H + h) * D +
                     d]) * p.scale;
    Qs[r * DP + d] = val;
  }

  const int kv_len = p.lengths[b];
  int q_pos[4], q_sg[4];
  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    q_pos[i] = p.q_off + s;
    q_sg[i] = (p.q_seg != nullptr && s < p.S)
                  ? p.q_seg[static_cast<long long>(b) * p.S + s] : 0;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < p.KV; k0 += kBK) {
    // Causal skip: this tile and every later one lie above the diagonal
    // of the whole query tile (offset-adjusted, as on the TPU).
    if (p.causal && p.kv_off + k0 > p.q_off + q0 + kBQ - 1) break;
    __syncthreads();  // previous tile fully consumed (and Qs staged)
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int r = idx / D, d = idx % D;
      const int kv = k0 + r;
      float kval = 0.f, vval = 0.f;
      if (kv < p.KV) {
        const long long off =
            ((static_cast<long long>(b) * p.KV + kv) * p.Hkv + hk) * D + d;
        kval = to_f32(k[off]);
        vval = to_f32(v[off]);
      }
      Ks[r * DP + d] = kval;
      Vs[r * D + d] = vval;
    }
    if (tid < kBK) {
      const int kv = k0 + tid;
      kseg[tid] = (p.kv_seg != nullptr && kv < p.KV)
                      ? p.kv_seg[static_cast<long long>(b) * p.KV + kv] : 0;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const int kv = k0 + c;
      const int gk = p.kv_off + kv;
      const bool col_ok = kv < p.KV && gk < kv_len;
      const int ks = kseg[c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        bool ok = col_ok;
        if (p.causal) ok = ok && gk <= q_pos[i];
        if (p.q_seg != nullptr) ok = ok && q_sg[i] == ks;
        if (!ok) s[i][j] = kNegInf;
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
      mx = row_max16(mx);
      const float m_cur = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pij = s[i][j] > kNegInf / 2 ? expf(s[i][j] - m_cur) : 0.f;
        s[i][j] = pij;
        rs += pij;
      }
      rs = row_sum16(rs);
      const float alpha = expf(fminf(m[i] - m_cur, 0.f));
      l[i] = alpha * l[i] + rs;
      m[i] = m_cur;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(ty * 4 + i) * kBK + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * kBK + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    if (s >= p.S) continue;
    const long long row = (static_cast<long long>(b) * p.S + s) * p.H + h;
    if (p.residual) {
      float* o = static_cast<float*>(p.o);
#pragma unroll
      for (int j = 0; j < DJ; ++j) o[row * D + tx + 16 * j] = acc[i][j];
      if (tx == 0) {
        const long long st = (static_cast<long long>(b) * p.H + h) * p.S + s;
        p.m_out[st] = m[i];
        p.l_out[st] = l[i];
      }
    } else {
      T* o = static_cast<T*>(p.o);
      const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int j = 0; j < DJ; ++j)
        store(&o[row * D + tx + 16 * j], acc[i][j] / denom);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const FlashParams& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long blocks =
      static_cast<long long>(p.B) * p.H * ((p.S + kBQ - 1) / kBQ);
  if (blocks <= 0 || blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  flash_fwd_kernel<T, D>
      <<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const FlashParams& p, int d, cudaStream_t stream) {
  if (d == 64) return launch<T, 64>(p, stream);
  if (d == 128) return launch<T, 128>(p, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, float* m_out,
    float* l_out, const int* lengths, const int* q_seg, const int* kv_seg,
    int B, int S, int KV, int H, int Hkv, int D, int q_off, int kv_off,
    int causal, int residual, float scale, int dtype, void* stream) {
  if (H <= 0 || Hkv <= 0 || H % Hkv != 0) return cudaErrorInvalidValue;
  FlashParams p{q, k, v, o, m_out, l_out, lengths, q_seg, kv_seg,
                B, S, KV, H, Hkv, q_off, kv_off, causal, residual, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_d<float>(p, D, st);
    case 1: return launch_d<__nv_bfloat16>(p, D, st);
    default: return cudaErrorInvalidValue;
  }
}
