// Flash-decode attention over an INT8 KV cache with power-of-two scales,
// for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel int8_kv_attention_kernel
// (repro/kernels/int8_kv_attention/kernel.py:93, body _kv_attn_kernel :36).
//
// q [B, C, Hq, hd] f32 (C = 1: decode; C > 1: a causal prefill chunk whose
// last row sits at position len-1, row t sees positions < len-C+1+t),
// k/v codes [B, S, Hkv, hd] int8, exponents [B, Hkv] int32, len [B] int32
// -> out [B, C, Hq, hd] f32.  GQA: the C*G query rows of one kv-head
// share its K/V tiles.
//
// Design.  One block of 128 threads per (b, kv-head) walks the whole S
// in 32-position tiles staged in shared memory as floats (4 codes per
// load; the wrapper passes 4-byte-aligned rows, hd a multiple of 4).
// Query rows (r = t*G + g, up to 32 per pass) and their f32 accumulators
// live in shared memory; per tile the threads split the (row, position)
// score pairs, then one thread per row updates the online-softmax
// statistics of the Pallas kernel, then the threads split the
// (row, dim) pairs of P.V.  The K scale 2^ke folds into the score scale,
// the V scale 2^ve multiplies the P.V product, masked scores are -1e30
// (never -inf, so an all-masked tile gives exp(0) = 1 that the first
// real score washes out instead of NaN).
//
// Shared memory: the tiles take (2*RB*HD + TS*(2*HD+1) + RB*(TS+4))
// floats, 37.5 KB at hd=64 and 70.3 KB at hd=128 (OLMoE), past the
// 48 KB a block may declare statically.  An instance whose tiles fit
// keeps them static (the dynamic form measured about 20% slower at
// hd=64); the hd=128 instance takes them as dynamic shared memory,
// after raising the kernel's limit
// (cudaFuncAttributeMaxDynamicSharedMemorySize).  Three of its blocks
// fit one SM's 227 KB.

// The walk over S stops at the pass's last visible position: a masked
// score adds exp(-1e30 - m) = 0 once its row has seen a real score, so
// positions past every row's limit change nothing.  A row that sees no
// position at all (limit <= 0) averages V over all S in the reference,
// so a pass holding such a row walks the whole S.
//
// Bound on the H100: decode reads each visible cache byte once per step,
// so the bound is bytes (2*Hkv*hd*sum_b min(len_b, S) int8 at
// 3.35 TB/s).  With B*Hkv blocks a decode step fills few of the 132 SMs;
// splitting S across blocks (flash-decoding) is the next step, not this
// first kernel's.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TS = 32;                 // cache positions per tile
constexpr int RB = 32;                 // query rows per pass
constexpr int THREADS = 128;
constexpr float NEG_INF = -1e30f;

// The block's tiles, one struct in shared memory.
template <int HD>
struct Tiles {
  float qs[RB][HD];
  float acc[RB][HD];
  float ks[TS][HD + 1];                // +1: lanes walk j, no bank conflict
  float vs[TS][HD];
  float sc[RB][TS + 1];
  float m_s[RB], l_s[RB], corr_s[RB];
};

constexpr size_t STATIC_SMEM = 48 * 1024;

// Dynamic shared memory bytes of an instance's launch (0: static tiles).
template <int HD>
__host__ __device__ constexpr size_t dynamic_bytes() {
  return sizeof(Tiles<HD>) > STATIC_SMEM ? sizeof(Tiles<HD>) : 0;
}

template <int HD>
__device__ __forceinline__ void
kv_attn_body(Tiles<HD>& t, const float* __restrict__ q,
             const int8_t* __restrict__ kc, const int8_t* __restrict__ vc,
             const int32_t* __restrict__ kexp,
             const int32_t* __restrict__ vexp,
             const int32_t* __restrict__ len, float* __restrict__ out, int C,
             int Hq, int S, int Hkv, float scale) {
  auto& qs = t.qs;
  auto& acc = t.acc;
  auto& ks = t.ks;
  auto& vs = t.vs;
  auto& sc = t.sc;
  auto& m_s = t.m_s;
  auto& l_s = t.l_s;
  auto& corr_s = t.corr_s;
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int G = Hq / Hkv, CG = C * G;
  const float sk = scale * ldexpf(1.0f, kexp[b * Hkv + h]);
  const float v_scale = ldexpf(1.0f, vexp[b * Hkv + h]);

  for (int r0 = 0; r0 < CG; r0 += RB) {
    const int nr = min(RB, CG - r0);
    // row r0 + r is chunk token t = (r0 + r) / G, head h*G + (r0 + r) % G
    for (int idx = tid; idx < nr * HD; idx += THREADS) {
      const int r = idx / HD, d = idx % HD, row = r0 + r;
      qs[r][d] = q[(((size_t)b * C + row / G) * Hq + h * G + row % G) * HD
                   + d];
      acc[r][d] = 0.0f;
    }
    for (int r = tid; r < nr; r += THREADS) {
      m_s[r] = NEG_INF;
      l_s[r] = 0.0f;
    }
    // row r sees positions < len - C + 1 + (r0 + r) / G
    const int lim_lo = len[b] - C + 1 + r0 / G;
    const int lim_hi = len[b] - C + 1 + (r0 + nr - 1) / G;
    const int s_end = lim_lo >= 1 ? min(S, lim_hi) : S;
    for (int s0 = 0; s0 < s_end; s0 += TS) {
      const int nj = min(TS, s_end - s0);
      __syncthreads();
      for (int idx = tid; idx < nj * HD / 4; idx += THREADS) {
        const int j = idx / (HD / 4), d = (idx % (HD / 4)) * 4;
        const size_t off = (((size_t)b * S + s0 + j) * Hkv + h) * HD + d;
        const char4 k4 = *reinterpret_cast<const char4*>(kc + off);
        const char4 v4 = *reinterpret_cast<const char4*>(vc + off);
        ks[j][d] = k4.x; ks[j][d + 1] = k4.y;
        ks[j][d + 2] = k4.z; ks[j][d + 3] = k4.w;
        vs[j][d] = v4.x; vs[j][d + 1] = v4.y;
        vs[j][d + 2] = v4.z; vs[j][d + 3] = v4.w;
      }
      __syncthreads();
      // scores: one (row, position) pair per thread step
      for (int idx = tid; idx < nr * nj; idx += THREADS) {
        const int r = idx / nj, j = idx % nj;
        float dot = 0.0f;
#pragma unroll 16
        for (int d = 0; d < HD; ++d) dot = fmaf(qs[r][d], ks[j][d], dot);
        const int limit = len[b] - C + 1 + (r0 + r) / G;
        sc[r][j] = (s0 + j < limit) ? dot * sk : NEG_INF;
      }
      __syncthreads();
      // online-softmax statistics, one row per thread
      for (int r = tid; r < nr; r += THREADS) {
        float mt = m_s[r];
        for (int j = 0; j < nj; ++j) mt = fmaxf(mt, sc[r][j]);
        float psum = 0.0f;
        for (int j = 0; j < nj; ++j) {
          const float pj = expf(sc[r][j] - mt);
          sc[r][j] = pj;
          psum += pj;
        }
        const float corr = expf(m_s[r] - mt);
        l_s[r] = l_s[r] * corr + psum;
        m_s[r] = mt;
        corr_s[r] = corr;
      }
      __syncthreads();
      // P.V: one (row, dim) pair per thread step
      for (int idx = tid; idx < nr * HD; idx += THREADS) {
        const int r = idx / HD, d = idx % HD;
        float pv = 0.0f;
        for (int j = 0; j < nj; ++j) pv = fmaf(sc[r][j], vs[j][d], pv);
        acc[r][d] = acc[r][d] * corr_s[r] + pv * v_scale;
      }
    }
    __syncthreads();
    for (int idx = tid; idx < nr * HD; idx += THREADS) {
      const int r = idx / HD, d = idx % HD, row = r0 + r;
      out[(((size_t)b * C + row / G) * Hq + h * G + row % G) * HD + d] =
          acc[r][d] / fmaxf(l_s[r], 1e-30f);
    }
    __syncthreads();
  }
}

// The tiles are static where they fit, else dynamic shared memory; the
// body is the same either way.
template <int HD>
__global__ void __launch_bounds__(THREADS)
kv_attn_kernel(const float* __restrict__ q, const int8_t* __restrict__ kc,
               const int8_t* __restrict__ vc,
               const int32_t* __restrict__ kexp,
               const int32_t* __restrict__ vexp,
               const int32_t* __restrict__ len, float* __restrict__ out,
               int C, int Hq, int S, int Hkv, float scale) {
  if constexpr (dynamic_bytes<HD>() > 0) {
    extern __shared__ float4 smem_raw[];
    kv_attn_body<HD>(*reinterpret_cast<Tiles<HD>*>(smem_raw), q, kc, vc,
                     kexp, vexp, len, out, C, Hq, S, Hkv, scale);
  } else {
    __shared__ Tiles<HD> tiles;
    kv_attn_body<HD>(tiles, q, kc, vc, kexp, vexp, len, out, C, Hq, S, Hkv,
                     scale);
  }
}

template <int HD>
int launch(const void* q, const void* kc, const void* vc, const void* ke,
           const void* ve, const void* len, void* out, int B, int C, int Hq,
           int S, int Hkv, float scale, cudaStream_t stream) {
  constexpr size_t bytes = dynamic_bytes<HD>();
  if (bytes > 0) {
    // once per device: the attribute call costs tens of microseconds
    constexpr int MAX_DEVICES = 64;
    static bool raised[MAX_DEVICES] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= MAX_DEVICES || !raised[dev]) {
      err = cudaFuncSetAttribute(kv_attn_kernel<HD>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)bytes);
      if (err != cudaSuccess) return (int)err;
      if (dev < MAX_DEVICES) raised[dev] = true;
    }
  }
  dim3 grid(Hkv, B);
  kv_attn_kernel<HD><<<grid, THREADS, bytes, stream>>>(
      (const float*)q, (const int8_t*)kc, (const int8_t*)vc,
      (const int32_t*)ke, (const int32_t*)ve, (const int32_t*)len,
      (float*)out, C, Hq, S, Hkv, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch; -1 for an unsupported hd.
extern "C" int int8_kv_attention_launch(const void* q, const void* kc,
                                        const void* vc, const void* ke,
                                        const void* ve, const void* len,
                                        void* out, int B, int C, int Hq,
                                        int S, int Hkv, int hd, float scale,
                                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 8: return launch<8>(q, kc, vc, ke, ve, len, out, B, C, Hq, S, Hkv, scale, st);
    case 16: return launch<16>(q, kc, vc, ke, ve, len, out, B, C, Hq, S, Hkv, scale, st);
    case 64: return launch<64>(q, kc, vc, ke, ve, len, out, B, C, Hq, S, Hkv, scale, st);
    case 128: return launch<128>(q, kc, vc, ke, ve, len, out, B, C, Hq, S, Hkv, scale, st);
    default: return -1;
  }
}
