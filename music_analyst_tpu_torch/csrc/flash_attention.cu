// Blocked online-softmax attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel music_analyst_tpu/ops/flash_attention.py
// (_flash_kernel, launched by _flash_call).  Same function, same masks:
// per-row kv `lengths`, `causal` with kv-tile skipping, block-diagonal
// segment ids, global q/kv offsets, GQA (query head h reads kv head
// h / (H / Hkv)), fully-masked rows give exact zeros, and a residual mode
// that returns the unnormalised f32 accumulator plus the running max `m`
// and sum `l` per query row.  Ragged S and KV are masked inside the
// kernels; no divisibility rule applies.
//
// Layout: q [B, S, H, D], k/v [B, KV, Hkv, D], out [B, S, H, D], row-major
// and contiguous; m/l [B, H, S] f32.
//
// What bounds it: at the DistilBERT shape (S = KV = 128, D = 64) the call
// must read q, k, v and write o once, about 64 flops per byte moved (96
// with the split P below), under the H100 SXM's bf16 ridge (989 TFLOP/s
// over 3.35 TB/s, about 295 flops/byte, data sheet) -- so memory bounds
// the ideal kernel, and the design's job is to keep bytes in flight and
// the arithmetic off the CUDA cores.
//
// bf16 path (flash_wgmma_kernel), the main path's.  One block per (b, h,
// 128 query rows): two warpgroups of 64 query rows each; warp 0 also issues
// the loads (a separate producer warp would cost registers, see the
// kernel).  At S = 128 a block covers a whole (b, h), so K and V are read
// once per head.  Warp 0 loads the query tile once and streams 64-row K/V
// tiles through a two-stage shared-memory ring with TMA (4-D tensor maps
// over [B, rows, heads, D], built by the C entry point for each call;
// boxes of 64 rows x 64 columns in the 128-byte swizzle that wgmma reads)
// and mbarriers.  TMA zero-fills the ragged edge; positions are still
// masked explicitly, since zero keys are not masked keys.  Each consumer
// computes S = Q K^T with wgmma m64n64k16 (bf16 operands from shared
// memory, f32 accumulation, q unscaled; bf16 x bf16 products are exact in
// f32, so this is the TPU kernel's f32 arithmetic up to the order of the
// sums), scales the f32 scores by D^-0.5 log2(e) (so exp is one ex2),
// masks them from each accumulator element's (row, column) unless every row
// sees the whole tile (causal and segment masks are template flags), and
// runs the TPU's online softmax with its sentinels: NEG_INF = -1e30,
// p = s > NEG_INF/2 ? exp(s - m) : 0, alpha = exp(min(m_prev - m_cur, 0)),
// denominator max(l, 1e-30).  The kv loop stops at the first tile past
// lengths[b] (and past the diagonal when causal).  O += P V is wgmma with P from registers and V from shared
// memory (MN-major), with P split into two bf16 halves, p_hi = bf16(p) and
// p_lo = bf16(p - p_hi): rounding P once (the usual FA2/FA3 choice) would
// put about 2^-9 of the output's scale on outputs near zero, past the
// elementwise half-ulp bound the kernel is held to; the pair keeps about
// 16 bits of p.  The epilogue normalises, rounds to bf16 once, and writes
// through shared memory with a TMA store (which clips rows past S);
// residual mode writes f32 o, m and l directly.
//
// f32 path (flash_fwd_kernel): the CUDA-core kernel, kept as it was.  wgmma
// on f32 inputs is TF32, which would change the f32 function the tests hold
// to 1e-4, and no main path runs flash in f32.  One block of 256 threads per
// (b, h, 64-row query tile); the query tile staged once in shared memory
// (scaled, f32); 64-row K/V tiles stream through shared memory; each thread
// owns a 4x4 block of the score tile and 4 rows x D/16 output columns.

#include <cuda.h>  // CUtensorMap and its enums only: the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr float kNegInf = -1e30f;

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

// ------------------------------------------------ f32 path (CUDA cores)

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // kv rows per tile
constexpr int kThreads = 256;  // 16 x 16

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

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(FlashParams p) {
  constexpr int DP = D + 1;  // padded smem row: column reads hit 16 banks
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                                  // [BQ][DP]
  float* Ks = Qs + kBQ * DP;                         // [BK][DP]
  float* Vs = Ks + kBK * DP;                         // [BK][D]
  float* Ps = Vs + kBK * D;                          // [BQ][BK]
  int* kseg = reinterpret_cast<int*>(Ps + kBQ * kBK);  // [BK]

  const float* q = static_cast<const float*>(p.q);
  const float* k = static_cast<const float*>(p.k);
  const float* v = static_cast<const float*>(p.v);

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
      val = q[((static_cast<long long>(b) * p.S + s) * p.H + h) * D + d] *
            p.scale;
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
        kval = k[off];
        vval = v[off];
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
    float* o = static_cast<float*>(p.o);
    if (p.residual) {
#pragma unroll
      for (int j = 0; j < DJ; ++j) o[row * D + tx + 16 * j] = acc[i][j];
      if (tx == 0) {
        const long long st = (static_cast<long long>(b) * p.H + h) * p.S + s;
        p.m_out[st] = m[i];
        p.l_out[st] = l[i];
      }
    } else {
      const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int j = 0; j < DJ; ++j) o[row * D + tx + 16 * j] = acc[i][j] / denom;
    }
  }
}

template <int D>
cudaError_t launch_f32(const FlashParams& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long blocks =
      static_cast<long long>(p.B) * p.H * ((p.S + kBQ - 1) / kBQ);
  if (blocks <= 0 || blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  flash_fwd_kernel<D>
      <<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// ------------------------------------- bf16 path (wgmma + TMA, warp-specialised)

constexpr int kRows = 64;                        // rows of one wgmma tile
constexpr int kConsumers = 2;                    // consumer warpgroups
constexpr int kBlockQ = kRows * kConsumers;      // query rows per block
constexpr int kWgThreads = kConsumers * 128;      // warp 0 also loads
constexpr int kStages = 2;                       // K/V ring depth
constexpr int kChunk = kRows * 128;              // [64 rows][64 bf16], 8 KB

template <int D>
struct Layout {
  static constexpr int kChunks = D / 64;             // 64-column chunks
  static constexpr int kTile = kChunks * kChunk;     // one 64-row tile
  static constexpr int kQ = 0;                       // [kConsumers][kTile]
  static constexpr int kK = kQ + kConsumers * kTile; // [kStages][kTile]
  static constexpr int kV = kK + kStages * kTile;    // [kStages][kTile]
  static constexpr int kSeg = kV + kStages * kTile;  // int [kStages][64]
  static constexpr int kBar = kSeg + kStages * kRows * 4;  // 5 mbarriers
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;  // + align
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Returns once the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// One 64x64 box of a 4-D map {D, heads, rows, B} into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d0, int head,
                                         int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d0), "r"(head),
      "r"(row), "r"(b) : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int d0, int head, int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(d0), "r"(head), "r"(row), "r"(b) : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle.  Offsets in
// bytes: `lbo` steps between 64-column chunks of an MN-major operand (unused
// here, where every wgmma reads one chunk), `sbo` between 8-row groups.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  constexpr uint64_t lbo = kChunk >> 4, sbo = 1024 >> 4;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (lbo << 16) |
         (sbo << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma window.
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A B, m64n64k16, A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B, m64n64k16, A (4 registers of bf16 pairs) from registers, B
// MN-major in shared memory (trans-b).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  uint32_t u;
  memcpy(&u, &v, sizeof(u));
  return u;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return bits(__floats2bfloat162_rn(lo, hi));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Accumulator fragment of wgmma m64nN (per warpgroup thread t, warp w =
// t / 32, lane): element 4j + 2h + e sits at row 16w + lane/4 + 8h, column
// 8j + 2(lane % 4) + e.  The same registers, paired as bf16, are the A
// fragment of the next wgmma (k-step kk takes elements 8kk .. 8kk + 7).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// kCausal / kSeg compile the causal and segment masks in or out.
template <int D, bool kCausal, bool kSeg>
__global__ void __launch_bounds__(kWgThreads, D == 64 ? 2 : 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_o,
                   const FlashParams p) {
  using L = Layout<D>;
  constexpr int kChunks = L::kChunks;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const smem = smem_raw + (base - smem_u32(smem_raw));
  int* const segs = reinterpret_cast<int*>(smem + L::kSeg);
  const uint32_t q_full = base + L::kBar;
  const uint32_t full0 = q_full + 8;                 // full[s] = full0 + 8 s
  const uint32_t empty0 = full0 + 8 * kStages;       // empty[s]

  const int q_tiles = (p.S + kBlockQ - 1) / kBlockQ;
  long long bid = blockIdx.x;
  const int qt = static_cast<int>(bid % q_tiles);
  bid /= q_tiles;
  const int h = static_cast<int>(bid % p.H);
  const int b = static_cast<int>(bid / p.H);
  const int hk = h / (p.H / p.Hkv);
  const int q0 = qt * kBlockQ;

  // Local kv rows below `kv_valid` pass the length mask; tiles from
  // `n_tiles` on hold no key that any row of this block may see.
  const int kv_valid = min(p.KV, p.lengths[b] - p.kv_off);
  int kv_lim = kv_valid;
  if (kCausal)
    kv_lim = min(kv_lim, p.q_off + min(q0 + kBlockQ, p.S) - p.kv_off);
  const int n_tiles = kv_lim > 0 ? (kv_lim + kRows - 1) / kRows : 0;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 32);               // warp 0's lanes
      mbar_init(empty0 + 8 * s, kConsumers * 128);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Warp 0 doubles as the producer: it loads Q once and K/V tile T into
  // stage T % kStages after both warpgroups have released that stage (its
  // copy of the tile's kv segment ids goes with it).  A separate producer
  // warp would make 9 warps a block, 18 on an SM, and so 5 warps on one of
  // the SM's four register partitions: ptxas then caps a thread at 96
  // registers and the D = 64 kernels spill.  With 8 warps, 4 per partition
  // at two blocks an SM, the cap is 128.
  const int lane = tid & 31;
  const auto issue = [&](int T) {
    const int st = T % kStages;
    const int k0 = T * kRows;
    mbar_wait(empty0 + 8 * st, ((T / kStages) & 1) ^ 1);
    if (kSeg)
      for (int i = lane; i < kRows; i += 32)
        segs[st * kRows + i] =
            k0 + i < p.KV
                ? p.kv_seg[static_cast<long long>(b) * p.KV + k0 + i] : 0;
    if (lane == 0) {
      const uint32_t bar = full0 + 8 * st;
      mbar_expect_tx(bar, 2 * L::kTile);
      for (int c = 0; c < kChunks; ++c) {
        tma_load(base + L::kK + st * L::kTile + c * kChunk, &tm_k, bar,
                 c * 64, hk, k0, b);
        tma_load(base + L::kV + st * L::kTile + c * kChunk, &tm_v, bar,
                 c * 64, hk, k0, b);
      }
    } else {
      mbar_arrive(full0 + 8 * st);
    }
  };
  if (tid < 32) {
    if (lane == 0) {
      mbar_expect_tx(q_full, kConsumers * L::kTile);
      for (int g = 0; g < kConsumers; ++g)
        for (int c = 0; c < kChunks; ++c)
          tma_load(base + L::kQ + g * L::kTile + c * kChunk, &tm_q, q_full,
                   c * 64, h, q0 + g * kRows, b);
    }
    for (int T = 0; T < min(kStages, n_tiles); ++T) issue(T);
  }

  {
    // ---------------- warpgroup g: query rows q0 + 64 g ...
    const int g = tid >> 7;
    const int t128 = tid & 127;
    const int quad = lane & 3;
    const int rows[2] = {(t128 >> 5) * 16 + (lane >> 2),
                         (t128 >> 5) * 16 + (lane >> 2) + 8};
    int q_pos[2], q_sg[2];
    float m[2], l[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int s = q0 + g * kRows + rows[hh];
      q_pos[hh] = p.q_off + s;
      q_sg[hh] = (kSeg && s < p.S)
                     ? p.q_seg[static_cast<long long>(b) * p.S + s] : 0;
      m[hh] = kNegInf;
      l[hh] = 0.f;
    }
    float o[kChunks][32];
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
    const uint32_t q_tile = base + L::kQ + g * L::kTile;
    const float scale2 = p.scale * 1.4426950408889634f;   // D^-0.5 log2(e)

    mbar_wait(q_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % kStages;
      const int k0 = t * kRows;
      mbar_wait(full0 + 8 * st, (t / kStages) & 1);
      const uint32_t k_tile = base + L::kK + st * L::kTile;
      const uint32_t v_tile = base + L::kV + st * L::kTile;

      // S = Q K^T (unscaled), D / 16 k-steps of 32 bytes along each row.
      float s[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * kChunk + (kk % 4) * 32;
        wgmma_ss(s, sw128_desc(q_tile + off), sw128_desc(k_tile + off),
                 kk > 0);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(s);

      // Scores into the log2 domain, x2 = x * D^-0.5 * log2(e), so that
      // exp(s - m) = 2^(x2 - m2).  A tile that every row sees whole (no
      // causal or segment mask, all keys below the length) needs no mask;
      // otherwise each element is masked from its (row, column).
      const bool whole = !kCausal && !kSeg && k0 + kRows <= kv_valid;
      if (whole) {
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] *= scale2;
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * j + 2 * quad + e;
            const int kv = k0 + col;
            const int ks = kSeg ? segs[st * kRows + col] : 0;
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              bool ok = kv < kv_valid;
              if (kCausal) ok = ok && p.kv_off + kv <= q_pos[hh];
              if (kSeg) ok = ok && q_sg[hh] == ks;
              float& x = s[4 * j + 2 * hh + e];
              x = ok ? x * scale2 : kNegInf;
            }
          }
        }
      }

      // Online softmax, f32, the TPU kernel's sentinels (a masked score is
      // NEG_INF, and only a masked tile can hold one).  l stays a
      // per-thread partial sum until the epilogue.
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          mx = fmaxf(mx, fmaxf(s[4 * j + 2 * hh], s[4 * j + 2 * hh + 1]));
        const float m_cur = fmaxf(m[hh], quad_max(mx));
        const float alpha = ex2(fminf(m[hh] - m_cur, 0.f));
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[4 * j + 2 * hh + e];
            x = whole || x > kNegInf / 2 ? ex2(x - m_cur) : 0.f;
            sum += x;
          }
        l[hh] = alpha * l[hh] + sum;
        m[hh] = m_cur;
        if (t > 0)   // o is still zero after no tile
#pragma unroll
          for (int c = 0; c < kChunks; ++c)
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              o[c][4 * j + 2 * hh] *= alpha;
              o[c][4 * j + 2 * hh + 1] *= alpha;
            }
      }

      // P as two bf16 halves in the A-fragment order.
      uint32_t p_hi[16], p_lo[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float x0 = s[2 * i], x1 = s[2 * i + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
        p_hi[i] = bits(hi);
        p_lo[i] = pack_bf16(x0 - __low2float(hi), x1 - __high2float(hi));
      }

      // O += P_hi V + P_lo V; V MN-major, k-step kk = 16 keys = 2 KB.
#pragma unroll
      for (int c = 0; c < kChunks; ++c) fence_regs(o[c]);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t dv = sw128_desc(v_tile + c * kChunk + kk * 2048);
          wgmma_rs(o[c], p_hi + 4 * kk, dv);
          wgmma_rs(o[c], p_lo + 4 * kk, dv);
        }
      wgmma_commit();
      wgmma_wait();
#pragma unroll
      for (int c = 0; c < kChunks; ++c) fence_regs(o[c]);
      mbar_arrive(empty0 + 8 * st);
      if (tid < 32 && t + kStages < n_tiles) issue(t + kStages);
    }

    // Epilogue.
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l[hh] = quad_sum(l[hh]);
    const int s_first = q0 + g * kRows;
    if (p.residual) {
      float* out = static_cast<float*>(p.o);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int s = s_first + rows[hh];
        if (s >= p.S) continue;
        const long long row = (static_cast<long long>(b) * p.S + s) * p.H + h;
#pragma unroll
        for (int c = 0; c < kChunks; ++c)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            *reinterpret_cast<float2*>(out + row * D + c * 64 + 8 * j + 2 * quad) =
                make_float2(o[c][4 * j + 2 * hh], o[c][4 * j + 2 * hh + 1]);
        if (quad == 0) {
          const long long at = (static_cast<long long>(b) * p.H + h) * p.S + s;
          // m back to natural units.
          p.m_out[at] = m[hh] == kNegInf ? kNegInf : m[hh] * 0.6931471805599453f;
          p.l_out[at] = l[hh];
        }
      }
    } else if (s_first < p.S) {
      // Normalise, round once, stage in this warpgroup's (finished) query
      // tile in the TMA's swizzled layout, and store; rows past S clip.
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float inv = 1.f / fmaxf(l[hh], 1e-30f);
        const int r = rows[hh];
#pragma unroll
        for (int c = 0; c < kChunks; ++c)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const uint32_t v = pack_bf16(o[c][4 * j + 2 * hh] * inv,
                                         o[c][4 * j + 2 * hh + 1] * inv);
            *reinterpret_cast<uint32_t*>(
                smem + L::kQ + g * L::kTile + c * kChunk + r * 128 +
                ((j ^ (r & 7)) << 4) + quad * 4) = v;
          }
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("bar.sync %0, 128;" ::"r"(1 + g) : "memory");
      if (t128 == 0) {
        for (int c = 0; c < kChunks; ++c)
          tma_store(&tm_o, q_tile + c * kChunk, c * 64, h, s_first, b);
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so the
// library needs no -lcuda.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                              cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(ptr) : nullptr;
  }();
  return fn;
}

// bf16 [B, rows, heads, D] as a 4-D map {D, heads, rows, B}; 64x64 boxes
// (64 rows of 128 bytes), 128-byte swizzle, zero fill past the edges.
bool make_map(CUtensorMap* map, const void* ptr, int B, int rows, int heads,
              int D) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(heads),
                              cuuint64_t(rows), cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(D) * 2, cuuint64_t(heads) * D * 2,
                                 cuuint64_t(rows) * heads * D * 2};
  const cuuint32_t box[4] = {64, 1, kRows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_bf16(const FlashParams& p, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, to;
  if (!make_map(&tq, p.q, p.B, p.S, p.H, D)) return cudaErrorInvalidValue;
  if (p.KV > 0) {
    if (!make_map(&tk, p.k, p.B, p.KV, p.Hkv, D) ||
        !make_map(&tv, p.v, p.B, p.KV, p.Hkv, D))
      return cudaErrorInvalidValue;
  } else {
    tk = tv = tq;  // no kv tile is ever loaded
  }
  if (p.residual) {
    to = tq;       // residual outputs are f32 and stored directly
  } else if (!make_map(&to, p.o, p.B, p.S, p.H, D)) {
    return cudaErrorInvalidValue;
  }
  const bool seg = p.q_seg != nullptr;
  const auto kernel =
      p.causal ? (seg ? flash_wgmma_kernel<D, true, true>
                      : flash_wgmma_kernel<D, true, false>)
               : (seg ? flash_wgmma_kernel<D, false, true>
                      : flash_wgmma_kernel<D, false, false>);
  constexpr int smem = Layout<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long blocks =
      static_cast<long long>(p.B) * p.H * ((p.S + kBlockQ - 1) / kBlockQ);
  if (blocks <= 0 || blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(blocks), kWgThreads, smem, stream>>>(
      tq, tk, tv, to, p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, float* m_out,
    float* l_out, const int* lengths, const int* q_seg, const int* kv_seg,
    int B, int S, int KV, int H, int Hkv, int D, int q_off, int kv_off,
    int causal, int residual, float scale, int dtype, void* stream) {
  if (H <= 0 || Hkv <= 0 || H % Hkv != 0) return cudaErrorInvalidValue;
  if (D != 64 && D != 128) return cudaErrorInvalidValue;
  FlashParams p{q, k, v, o, m_out, l_out, lengths, q_seg, kv_seg,
                B, S, KV, H, Hkv, q_off, kv_off, causal, residual, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return D == 64 ? launch_f32<64>(p, st) : launch_f32<128>(p, st);
    case 1: return D == 64 ? launch_bf16<64>(p, st) : launch_bf16<128>(p, st);
    default: return cudaErrorInvalidValue;
  }
}
