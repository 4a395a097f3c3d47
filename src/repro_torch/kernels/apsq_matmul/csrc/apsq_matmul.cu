// APSQ integer GEMMs for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernels of repro/kernels/apsq_matmul/kernel.py:
//   * apsq_matmul_kernel     (:214, body _apsq_kernel :115)
//       -> apsq_matmul_launch     (generic M)
//   * apsq_matmul_m1_kernel  (:294, body _apsq_m1_kernel :271 and
//                             _algorithm1_unrolled :84)
//       -> apsq_matmul_m1_launch  (M == 1 decode)
//   * baseline_matmul_kernel (:509, body _baseline_kernel :167)
//       -> baseline_matmul_launch (INT32-accumulator W8A8)
//   * apsq_expert_matmul_kernel (:419, body _apsq_expert_kernel :339)
//       -> apsq_expert_matmul_launch (fused MoE expert bank)
//   * baseline_expert_matmul_kernel (:472, body _baseline_expert_kernel
//                                    :395)
//       -> baseline_expert_matmul_launch (INT32-accumulator expert bank)
//
// Semantics: bit-exact with the integer oracle (ref.py).  [M, K] int8 x
// [K, N] int8 -> [M, N] int32 in product-scale units, K = n_p * bk (the
// wrapper zero-pads ragged K).  Exponents are [n_p] (exp_cols = 0) or
// [n_p, N] (exp_cols = 1) int32.  Shifts follow XLA: a count outside
// [0, 32) gives 0 for << and the sign for >>; adds and << wrap mod 2^32
// (done on uint32 here, where C++ would leave overflow undefined).
//
// Design.  On the TPU the K grid axis is sequential and the gs INT8 PSUM
// banks live in VMEM scratch across grid steps.  Blocks on Hopper run in
// no order, so here ONE block owns 32 output columns (one per lane) x BM
// rows and walks all n_p PSUM tiles itself.  Its 8 warps split each
// tile's K range (neighbouring lanes read neighbouring weight bytes), the
// per-warp INT32 partial products are summed in shared memory, and warp
// 0 requantizes the tile on the spot: the <= gs stored INT8 codes of the
// current group stay in its registers, packed 8 to a 64-bit word
// (gs <= 16), exactly the recurrence of _algorithm1_unrolled.  Activation
// rows are staged through shared memory in KC-byte chunks.
//
// Expert banks.  The Pallas expert kernels put the expert on a grid axis
// of one pallas_call; here it is blockIdx.z, and each block offsets x,
// w, out and the exponent bank ([E, n_p] or [E, n_p, N]) by its expert,
// so one launch serves all E experts with the same Algorithm-1 body.
// M is the expert capacity (1-3 rows at OLMoE serving shapes): the
// launch picks BM in {1, 2, 4, 8} from M and masks the rows past M,
// where the JAX wrapper pads M to 8.

// Bound on the H100: at decode (M <= 16) every weight byte is read once
// and reused M times, so the bound is bytes (K*N weight bytes at
// 3.35 TB/s); at prefill M it becomes int8 operations (2*M*K*N at the
// int8 tensor-core peak).  An expert bank reads all E*K*N weight bytes
// whatever the routing (E*K*N at 3.35 TB/s: 40 us for one OLMoE expert
// GEMM, 64 x 2048 x 1024).  These first kernels use scalar int32
// multiply-adds, not tensor cores: correct first, fast in a later change.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int KC = 1024;        // activation bytes staged per row per pass
constexpr int WARPS = 8, THREADS = 32 * WARPS, COLS = 32;
constexpr int GEN_BM = 8;         // rows per block of the generic kernel

__device__ __forceinline__ int32_t shl(int32_t a, int32_t s) {
  return (s >= 0 && s < 32) ? (int32_t)((uint32_t)a << s) : 0;
}

__device__ __forceinline__ int32_t sra(int32_t a, int32_t s) {
  return (s >= 0 && s < 32) ? (a >> s) : (a >> 31);
}

__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

// INT32 PSUM -> INT8 code at 2^e: round-half-up shift, clip.
__device__ __forceinline__ int32_t quant(int32_t v, int32_t e) {
  int32_t r = v;
  if (e > 0) r = sra(wadd(v, shl(1, e - 1)), e);
  return r < -128 ? -128 : (r > 127 ? 127 : r);
}

// INT8 code at 2^e -> INT32 product-scale value.
__device__ __forceinline__ int32_t deq(int32_t code, int32_t e) {
  return shl(code, e);
}

// gs <= 16 INT8 bank codes of one output element, packed in two words.
struct Banks {
  unsigned long long lo, hi;
  __device__ __forceinline__ void clear() { lo = 0ull; hi = 0ull; }
  __device__ __forceinline__ void set(int p, int32_t code) {
    unsigned long long b = (unsigned long long)(uint8_t)(int8_t)code;
    if (p < 8) lo |= b << (8 * p);
    else hi |= b << (8 * (p - 8));
  }
  __device__ __forceinline__ int32_t get(int p) const {
    unsigned long long w = p < 8 ? lo >> (8 * p) : hi >> (8 * (p - 8));
    return (int32_t)(int8_t)(uint8_t)(w & 0xffull);
  }
};

__device__ __forceinline__ int32_t exp_at(const int32_t* exps, int i, int n,
                                          int N, int exp_cols) {
  return exp_cols ? exps[(size_t)i * N + n] : exps[i];
}

// One block owns COLS = 32 output columns (one per lane) x BM rows and
// walks every PSUM tile; its WARPS warps split each tile's K range, and
// the per-warp INT32 partial products are summed (mod 2^32, so the order
// does not matter) in shared memory before warp 0 applies the Algorithm-1
// step for that tile.  APSQ = false is the INT32-accumulator baseline:
// one tile over all of K, no requantization.  EXPERT: blockIdx.z is the
// expert, operands are [E, M, K], [E, K, N] -> [E, M, N] (a separate
// instance, so the plain GEMMs' code is untouched by the offsets).
template <int BM, bool APSQ, bool EXPERT = false>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
            const int32_t* __restrict__ exps, int32_t* __restrict__ out,
            int M, int N, int n_p, int bk, int gs, int exp_cols) {
  __shared__ int8_t xs[BM][KC];
  __shared__ int32_t red[WARPS][BM][COLS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = blockIdx.x * COLS + lane;
  const int row0 = blockIdx.y * BM;
  const int K = n_p * bk;
  if (EXPERT) {
    const size_t e = blockIdx.z;
    x += e * M * K;
    w += e * K * N;
    out += e * M * N;
    if (APSQ) exps += e * n_p * (exp_cols ? N : 1);
  }
  const int last = n_p - 1;
  Banks bank[BM];
#pragma unroll
  for (int r = 0; r < BM; ++r) bank[r].clear();

  for (int i = 0; i < n_p; ++i) {
    int32_t prod[BM];
#pragma unroll
    for (int r = 0; r < BM; ++r) prod[r] = 0;
    for (int kc = 0; kc < bk; kc += KC) {
      const int cl = min(KC, bk - kc);
      const int kbase = i * bk + kc;
      for (int idx = threadIdx.x; idx < BM * cl; idx += THREADS) {
        const int r = idx / cl, kk = idx % cl;
        const int row = row0 + r;
        xs[r][kk] = row < M ? x[(size_t)row * K + kbase + kk] : (int8_t)0;
      }
      __syncthreads();
      const int per = (cl + WARPS - 1) / WARPS;
      const int k0 = warp * per, k1 = min(cl, k0 + per);
      if (n < N) {
        const int8_t* wp = w + (size_t)kbase * N + n;
#pragma unroll 4
        for (int kk = k0; kk < k1; ++kk) {
          const int32_t wv = wp[(size_t)kk * N];
#pragma unroll
          for (int r = 0; r < BM; ++r)
            prod[r] = wadd(prod[r], (int32_t)xs[r][kk] * wv);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < BM; ++r) red[warp][r][lane] = prod[r];
    __syncthreads();
    if (warp == 0 && n < N) {
#pragma unroll
      for (int r = 0; r < BM; ++r) {
        int32_t p = 0;
#pragma unroll
        for (int v = 0; v < WARPS; ++v) p = wadd(p, red[v][r][lane]);
        const int row = row0 + r;
        if (!APSQ) {
          if (row < M) out[(size_t)row * N + n] = p;
          continue;
        }
        const int g0 = (i / gs) * gs;      // group start of tile i
        const int q0 = i - g0;             // position inside the group
        const int32_t ei = exp_at(exps, i, n, N, exp_cols);
        if (q0 == 0) {                     // group start: APSQ
          int32_t acc = p;
          if (i > 0)
            for (int q = 0; q < gs; ++q)   // fold the previous group's banks
              acc = wadd(acc, deq(bank[r].get(q),
                                  exp_at(exps, i - gs + q, n, N, exp_cols)));
          const int32_t code = quant(acc, ei);
          if (i == last) {
            if (row < M) out[(size_t)row * N + n] = deq(code, ei);
          } else {
            bank[r].clear();
            bank[r].set(0, code);
          }
        } else if (i < last) {             // tail tile: plain PSQ
          bank[r].set(q0, quant(p, ei));
        } else {                           // final tile closes mid-group
          int32_t acc = p;
          for (int q = 0; q < q0; ++q)
            acc = wadd(acc, deq(bank[r].get(q),
                                exp_at(exps, g0 + q, n, N, exp_cols)));
          if (row < M) out[(size_t)row * N + n] = deq(quant(acc, ei), ei);
        }
      }
    }
    __syncthreads();
  }
}

template <int BM, bool APSQ, bool EXPERT = false>
int launch(const void* x, const void* w, const void* exps, void* out, int M,
           int N, int n_p, int bk, int gs, int exp_cols, void* stream,
           int E = 1) {
  dim3 grid((N + COLS - 1) / COLS, (M + BM - 1) / BM, E);
  gemm_kernel<BM, APSQ, EXPERT><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)x, (const int8_t*)w, (const int32_t*)exps,
      (int32_t*)out, M, N, n_p, bk, gs, exp_cols);
  return (int)cudaGetLastError();
}

// Expert banks: the fewest rows per block that cover M (up to GEN_BM).
template <bool APSQ>
int launch_experts(const void* x, const void* w, const void* exps, void* out,
                   int E, int M, int N, int n_p, int bk, int gs,
                   int exp_cols, void* stream) {
  if (M <= 1)
    return launch<1, APSQ, true>(x, w, exps, out, M, N, n_p, bk, gs,
                                 exp_cols, stream, E);
  if (M <= 2)
    return launch<2, APSQ, true>(x, w, exps, out, M, N, n_p, bk, gs,
                                 exp_cols, stream, E);
  if (M <= 4)
    return launch<4, APSQ, true>(x, w, exps, out, M, N, n_p, bk, gs,
                                 exp_cols, stream, E);
  return launch<GEN_BM, APSQ, true>(x, w, exps, out, M, N, n_p, bk, gs,
                                    exp_cols, stream, E);
}

}  // namespace

extern "C" int apsq_matmul_launch(const void* x, const void* w,
                                  const void* exps, void* out, int M, int N,
                                  int n_p, int bk, int gs, int exp_cols,
                                  void* stream) {
  return launch<GEN_BM, true>(x, w, exps, out, M, N, n_p, bk, gs, exp_cols,
                              stream);
}

extern "C" int apsq_matmul_m1_launch(const void* x, const void* w,
                                     const void* exps, void* out, int N,
                                     int n_p, int bk, int gs, int exp_cols,
                                     void* stream) {
  return launch<1, true>(x, w, exps, out, 1, N, n_p, bk, gs, exp_cols,
                         stream);
}

extern "C" int baseline_matmul_launch(const void* x, const void* w, void* out,
                                      int M, int N, int K, void* stream) {
  return launch<GEN_BM, false>(x, w, nullptr, out, M, N, 1, K, 1, 0, stream);
}

extern "C" int apsq_expert_matmul_launch(const void* x, const void* w,
                                         const void* exps, void* out, int E,
                                         int M, int N, int n_p, int bk,
                                         int gs, int exp_cols, void* stream) {
  return launch_experts<true>(x, w, exps, out, E, M, N, n_p, bk, gs,
                              exp_cols, stream);
}

extern "C" int baseline_expert_matmul_launch(const void* x, const void* w,
                                             void* out, int E, int M, int N,
                                             int K, void* stream) {
  return launch_experts<false>(x, w, nullptr, out, E, M, N, 1, K, 1, 0,
                               stream);
}
