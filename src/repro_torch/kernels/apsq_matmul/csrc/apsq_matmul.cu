// APSQ integer GEMMs for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernels of repro/kernels/apsq_matmul/kernel.py:
//   * apsq_matmul_kernel     (:214, body _apsq_kernel :115)
//       -> apsq_matmul_launch     (M >= 2: int8 tensor-core tile partials,
//          apsq_partial_mma_kernel, then apsq_epilogue_kernel)
//   * apsq_matmul_m1_kernel  (:294, body _apsq_m1_kernel :271 and
//                             _algorithm1_unrolled :84)
//       -> apsq_matmul_m1_launch  (M == 1 decode: the same two stages, the
//          partials from the one-row body its plan picks)
//   * baseline_matmul_kernel (:509, body _baseline_kernel :167)
//       -> baseline_matmul_launch (INT32-accumulator W8A8, on the int8
//          tensor cores: w8a8_mma_kernel)
//   * apsq_expert_matmul_kernel (:419, body _apsq_expert_kernel :339)
//       -> apsq_expert_matmul_launch (fused MoE expert bank, gemm_kernel)
//   * baseline_expert_matmul_kernel (:472, body _baseline_expert_kernel
//                                    :395)
//       -> baseline_expert_matmul_launch (INT32-accumulator expert bank,
//          gemm_kernel)
//
// Semantics: bit-exact with the integer oracle (ref.py).  [M, K] int8 x
// [K, N] int8 -> [M, N] int32 in product-scale units, K = n_p * bk (the
// wrapper zero-pads ragged K).  Exponents are [n_p] (exp_cols = 0) or
// [n_p, N] (exp_cols = 1) int32.  Shifts follow XLA: a count outside
// [0, 32) gives 0 for << and the sign for >>; adds and << wrap mod 2^32
// (done on uint32 here, where C++ would leave overflow undefined).
//
// Bound on the H100: at serving M (1-16 rows: decode slots, prefill
// chunks) every weight byte is read once and reused M times, so the
// bound is bytes (K*N weight bytes at 3.35 TB/s: 3.4 us at K=2048
// N=5632); at large M it becomes int8 operations (2*M*K*N at the int8
// tensor-core peak).  An expert bank reads all E*K*N weight bytes
// whatever the routing (E*K*N at 3.35 TB/s: 40 us for one OLMoE expert
// GEMM, 64 x 2048 x 1024).
//
// Algorithm 1 on Hopper (apsq_matmul_launch, apsq_matmul_m1_launch).  On
// the TPU the K grid axis is sequential and the gs INT8 PSUM banks live
// in VMEM scratch across grid steps.  But each tile's INT32 partial
// x[:, tile] @ w[tile, :] is an exact integer sum that does not depend on
// the recurrence: only the n_p-step requantization is sequential.  So:
//
// * Stage 1 computes every tile's partial at once, on the int8 tensor
//   cores, with the W8A8 kernel's operand path (mma_partial below: 16 K
//   rows x 8 columns per lane, a __byte_perm 4x4 transpose, mma.sync
//   m16n8k32).  Its grid is (64 columns, BM rows, PSUM tile x K range):
//   a block's K range never crosses its tile's end, which plays the role
//   of ke (a bk that is no multiple of 16 loads zeros past it), and a
//   tile is cut into `splits` ranges until about three blocks per SM are
//   busy (ops.apsq_plan).  Each block stores its partial with plain
//   stores into its own slot of a [n_p * splits, M, N] int32 scratch, so
//   no memset and no atomics across blocks: weights are read once,
//   whatever M <= BM.
// * Stage 2 (apsq_epilogue_kernel), one thread per output element, sums
//   each tile's split slots (int32 adds commute mod 2^32: every order
//   gives the same bits) and walks Algorithm 1 over the n_p values, each
//   group's INT8 codes folded into one running int32 sum as they are
//   made.  The scratch (1.4 MB at M=8 N=5632 n_p=8) stays in the 50 MB
//   L2.
// * At M == 1 the m16 tensor-core tile wastes 15 of its 16 rows, so the
//   plan may take a one-row body instead (apsq_partial_dp4a_kernel: the
//   same transposed weight words into __dp4a, the sums met by warp
//   shuffles), whichever was measured faster at M=1 K=5632 N=2048.
//
// Expert banks (gemm_kernel: scalar int32 multiply-adds, no tensor
// cores).  One block owns 32 output columns (one per lane) x BM
// rows and walks all n_p PSUM tiles itself; its 8 warps split each
// tile's K range, the per-warp partials are summed in shared memory and
// warp 0 requantizes the tile on the spot.  The expert is blockIdx.z:
// each block offsets x, w, out and the exponent bank ([E, n_p] or
// [E, n_p, N]) by its expert, so one launch serves all E experts.  M is
// the expert capacity (1-3 rows at OLMoE serving shapes): the launch
// picks BM in {1, 2, 4, 8} from M and masks the rows past M, where the
// JAX wrapper pads M to 8.

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

// ---------------------------------------------------------------------------
// INT32-accumulator W8A8 GEMM on the int8 tensor cores
// (baseline_matmul_launch; replaces kernel.py:509 baseline_matmul_kernel).
//
// Bound on the H100: at serving M (1-33 rows) the weights dominate, so
// the bound is bytes (K*N at 3.35 TB/s); the scalar template above
// reached 3% of it at M=8.  Design:
//
// * mma.sync m16n8k32 s8 x s8 -> s32 (inline PTX).  Its B operand wants
//   4 consecutive K of one column in a register, and the weights are
//   [K, N] with N contiguous (the export's layout, kept).  So each lane
//   loads 8 columns of 16 consecutive K rows (16 x 8 bytes, coalesced:
//   the 8 lanes of a row read 64 bytes), transposes each 4x4 byte block
//   in registers with four __byte_perm pairs (PRMT_* below) and feeds the
//   words to the mma as they are: the 8 columns of a lane go to 8
//   different n8 tiles, all at the lane's own column index g, so no
//   shuffle or shared memory is needed.  The mma's 32 K slots are mapped
//   to the lane's 16-row run (and a second mma takes the next 16), the
//   same permutation for A and B, so the sum is unchanged; one 16-byte
//   load of an activation row gives a lane its A words for both.
// * A block of 4 warps owns BM (16 or 32) rows x 64 columns and a range
//   of K; its warps take 64-deep K slices in turn, fold their sums into
//   a shared tile with shared-memory atomics, and the tile goes out with
//   plain stores, or with global atomic adds where K is split across
//   blocks (split-K fills the card: N=2048 gives only 32 column tiles;
//   ops.baseline_plan aims at about three blocks per SM).
//   int32 addition mod 2^32 is associative and commutative, so every
//   order gives the same bits; the output is zeroed first (cudaMemset on
//   the same stream, part of the call).
// * No .satfinite: the reference wraps mod 2^32 like XLA's int32; at
//   K <= 5632 a sum stays within +-9.2e7 and never wraps anyway.
// * Rows past M load zeros and are not stored; a ragged K tail or N, or a
//   misaligned operand, takes byte loads with bounds checks.

constexpr int W8_WARPS = 4, W8_THREADS = 32 * W8_WARPS;
constexpr int W8_BN = 64;        // columns per block: 8 per lane group
constexpr int W8_KS = 64;        // K rows per warp slice: two mma steps

// __byte_perm selectors of the 4x4 byte transpose: rows r0..r3 (4 bytes
// of one K row each, 4 columns) -> one word per column holding its 4 K.
constexpr unsigned PRMT_PAIR_LO = 0x5140u;   // x.b0 y.b0 x.b1 y.b1
constexpr unsigned PRMT_PAIR_HI = 0x7362u;   // x.b2 y.b2 x.b3 y.b3
constexpr unsigned PRMT_HALF_LO = 0x5410u;   // x.h0 y.h0
constexpr unsigned PRMT_HALF_HI = 0x7632u;   // x.h1 y.h1

__device__ __forceinline__ void transpose4x4(uint32_t r0, uint32_t r1,
                                             uint32_t r2, uint32_t r3,
                                             uint32_t* col) {
  const uint32_t t0 = __byte_perm(r0, r1, PRMT_PAIR_LO);
  const uint32_t t1 = __byte_perm(r0, r1, PRMT_PAIR_HI);
  const uint32_t t2 = __byte_perm(r2, r3, PRMT_PAIR_LO);
  const uint32_t t3 = __byte_perm(r2, r3, PRMT_PAIR_HI);
  col[0] = __byte_perm(t0, t2, PRMT_HALF_LO);
  col[1] = __byte_perm(t0, t2, PRMT_HALF_HI);
  col[2] = __byte_perm(t1, t3, PRMT_HALF_LO);
  col[3] = __byte_perm(t1, t3, PRMT_HALF_HI);
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

__device__ __forceinline__ void mma_s8(int32_t* c, uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Weight row k, columns col .. col+7 (zeros past N or at k >= ke).
__device__ __forceinline__ uint2 w8_load_w(const int8_t* __restrict__ w,
                                           int k, int col, int N, int ke,
                                           bool vec) {
  uint2 r = make_uint2(0u, 0u);
  if (k >= ke) return r;
  const int8_t* p = w + (size_t)k * N + col;
  if (vec) {
    if (col < N) r = __ldg(reinterpret_cast<const uint2*>(p));
    return r;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (col + i < N) r.x |= (uint32_t)(uint8_t)p[i] << (8 * i);
    if (col + 4 + i < N) r.y |= (uint32_t)(uint8_t)p[4 + i] << (8 * i);
  }
  return r;
}

// Activation row m, K bytes k .. k+15 (zeros past M or at k >= ke).
__device__ __forceinline__ uint4 w8_load_x(const int8_t* __restrict__ x,
                                           int m, int k, int M, int K,
                                           int ke, bool vec) {
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if (m >= M) return r;
  const int8_t* p = x + (size_t)m * K + k;
  if (vec && k + 16 <= ke) return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (k + i < ke) v[i / 4] |= (uint32_t)(uint8_t)p[i] << (8 * (i % 4));
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// The block's INT32 partial product x[m0 : m0+BM, kb : ke] @
// w[kb : ke, n0 : n0+64] into the shared `tile` (zeroed here): its warps
// take 64-deep K slices in turn and fold their sums in with shared-memory
// atomics.  Ends with the tile complete (after a __syncthreads).
template <int BM>
__device__ __forceinline__ void mma_partial(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w, int M,
    int N, int K, int m0, int n0, int kb, int ke, bool x_vec, bool w_vec,
    int32_t (*tile)[W8_BN + 4]) {
  constexpr int MT = BM / 16;                  // m16 tiles
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  for (int i = threadIdx.x; i < BM * W8_BN; i += W8_THREADS)
    tile[i / W8_BN][i % W8_BN] = 0;
  int32_t acc[MT][8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][q][c] = 0;
  const int col = n0 + 8 * g;                  // the lane's 8 columns

  for (int k0 = kb + warp * W8_KS; k0 < ke; k0 += W8_WARPS * W8_KS) {
    const int kr = k0 + 16 * t;                // the lane's 16 K rows
    uint2 wr[16];
#pragma unroll
    for (int i = 0; i < 16; ++i)
      wr[i] = w8_load_w(w, kr + i, col, N, ke, w_vec);
    uint4 xr[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        xr[mt][hh] = w8_load_x(x, m0 + 16 * mt + g + 8 * hh, kr, M, K, ke,
                               x_vec);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      // b[half][n8 tile]: K rows kr + 8s + 4*half + 0..3 of column col+q
      uint32_t b[2][8];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = 8 * s + 4 * hh;
        transpose4x4(wr[i].x, wr[i + 1].x, wr[i + 2].x, wr[i + 3].x,
                     &b[hh][0]);
        transpose4x4(wr[i].y, wr[i + 1].y, wr[i + 2].y, wr[i + 3].y,
                     &b[hh][4]);
      }
      // A: rows g (xr[.][0]) and g + 8 (xr[.][1]), K bytes 8s .. 8s+7
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int q = 0; q < 8; ++q)
          mma_s8(acc[mt][q], word(xr[mt][0], 2 * s), word(xr[mt][1], 2 * s),
                 word(xr[mt][0], 2 * s + 1), word(xr[mt][1], 2 * s + 1),
                 b[0][q], b[1][q]);
    }
  }
  __syncthreads();                             // the tile is zeroed
  // accumulator c of n8 tile q: row g + 8*(c/2), column 16t + 8*(c%2) + q
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        atomicAdd(&tile[16 * mt + g + 8 * (c / 2)][16 * t + 8 * (c % 2) + q],
                  acc[mt][q][c]);
  __syncthreads();
}

template <int BM>
__global__ void __launch_bounds__(W8_THREADS)
w8a8_mma_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                int32_t* __restrict__ out, int M, int N, int K, int k_split,
                int x_vec, int w_vec) {
  __shared__ int32_t tile[BM][W8_BN + 4];
  const int n0 = blockIdx.x * W8_BN, m0 = blockIdx.y * BM;
  const int kb = blockIdx.z * k_split, ke = min(K, kb + k_split);
  mma_partial<BM>(x, w, M, N, K, m0, n0, kb, ke, x_vec, w_vec, tile);
  for (int i = threadIdx.x; i < BM * W8_BN; i += W8_THREADS) {
    const int r = i / W8_BN, cc = i % W8_BN;
    const int m = m0 + r, n = n0 + cc;
    if (m >= M || n >= N) continue;
    if (gridDim.z == 1) out[(size_t)m * N + n] = tile[r][cc];
    else atomicAdd(&out[(size_t)m * N + n], tile[r][cc]);
  }
}

// bm: 16 or 32 rows per block; splits blocks along K, each k_split deep.
int launch_w8a8(const void* x, const void* w, void* out, int M, int N, int K,
                int bm, int splits, int k_split, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bool x_vec = K % 16 == 0 && (uintptr_t)x % 16 == 0;
  const bool w_vec = N % 8 == 0 && (uintptr_t)w % 8 == 0;
  if (splits > 1) {
    cudaError_t err = cudaMemsetAsync(out, 0, (size_t)M * N * 4, st);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((N + W8_BN - 1) / W8_BN, (M + bm - 1) / bm, splits);
  if (bm == 16)
    w8a8_mma_kernel<16><<<grid, W8_THREADS, 0, st>>>(
        (const int8_t*)x, (const int8_t*)w, (int32_t*)out, M, N, K, k_split,
        x_vec, w_vec);
  else if (bm == 32)
    w8a8_mma_kernel<32><<<grid, W8_THREADS, 0, st>>>(
        (const int8_t*)x, (const int8_t*)w, (int32_t*)out, M, N, K, k_split,
        x_vec, w_vec);
  else
    return -1;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Algorithm 1 in two stages (apsq_matmul_launch, apsq_matmul_m1_launch):
// tile partials into a [n_p * splits, M, N] int32 scratch, then the
// recurrence per output element (see the note at the top of the file).

constexpr int EPI_THREADS = 256;
constexpr int EPI_TILES = 8;     // tiles whose partials load together

// The K range [kb, ke) of partial slot z: PSUM tile z / splits, range
// z % splits of it, never past the tile's end.
__device__ __forceinline__ void tile_range(int z, int bk, int splits,
                                           int k_split, int* kb, int* ke) {
  const int i = z / splits, s = z - i * splits;
  *kb = i * bk + s * k_split;
  *ke = min(i * bk + bk, *kb + k_split);
}

// Algorithm 1 for output element idx = m * N + n over its n_p tile
// partials (tile i's is the wrapping sum of its `splits` slots, mn
// apart): APSQ at group starts, PSQ on tails, the final tile closing
// mid-group.  Where gemm_kernel keeps the group's INT8 codes and
// dequantizes them at the next fold, each code is dequantized as it is
// made into one running int32 sum (`carry`): the same values added mod
// 2^32 in another order, so the same bits, with no bank registers and no
// exponent reloads.  Partials and exponents of EPI_TILES tiles load
// together, so a thread waits about one L2 round trip per EPI_TILES
// tiles.
__device__ __forceinline__ int32_t algorithm1(
    const int32_t* __restrict__ part, const int32_t* __restrict__ exps,
    size_t mn, size_t idx, int n, int N, int n_p, int splits, int gs,
    int exp_cols) {
  const int last = n_p - 1;
  int32_t carry = 0, result = 0;
  for (int i0 = 0; i0 < n_p; i0 += EPI_TILES) {
    int32_t p[EPI_TILES], e[EPI_TILES];
#pragma unroll
    for (int j = 0; j < EPI_TILES; ++j) {
      const int i = min(i0 + j, last);
      e[j] = exp_at(exps, i, n, N, exp_cols);
      p[j] = part[(size_t)i * splits * mn + idx];
    }
    for (int s = 1; s < splits; ++s)
#pragma unroll
      for (int j = 0; j < EPI_TILES; ++j)
        p[j] = wadd(p[j], part[((size_t)min(i0 + j, last) * splits + s) *
                               mn + idx]);
#pragma unroll
    for (int j = 0; j < EPI_TILES; ++j) {
      const int i = i0 + j;
      if (i > last) break;
      if (i % gs == 0) {                     // group start: APSQ
        carry = deq(quant(wadd(p[j], carry), e[j]), e[j]);
        result = carry;                      // the output if i == last
      } else if (i < last) {                 // tail tile: plain PSQ
        carry = wadd(carry, deq(quant(p[j], e[j]), e[j]));
      } else {                               // final tile closes mid-group
        result = deq(quant(wadd(p[j], carry), e[j]), e[j]);
      }
    }
  }
  return result;
}

template <int BM>
__global__ void __launch_bounds__(W8_THREADS)
apsq_partial_mma_kernel(const int8_t* __restrict__ x,
                        const int8_t* __restrict__ w,
                        int32_t* __restrict__ part, int M, int N, int bk,
                        int splits, int k_split, int x_vec, int w_vec) {
  __shared__ int32_t tile[BM][W8_BN + 4];
  const int n0 = blockIdx.x * W8_BN, m0 = blockIdx.y * BM;
  int kb, ke;
  tile_range(blockIdx.z, bk, splits, k_split, &kb, &ke);
  mma_partial<BM>(x, w, M, N, (int)(gridDim.z / splits) * bk, m0, n0, kb,
                  ke, x_vec, w_vec, tile);
  int32_t* dst = part + (size_t)blockIdx.z * M * N;
  for (int i = threadIdx.x; i < BM * W8_BN; i += W8_THREADS) {
    const int r = i / W8_BN, cc = i % W8_BN;
    const int m = m0 + r, n = n0 + cc;
    if (m < M && n < N) dst[(size_t)m * N + n] = tile[r][cc];
  }
}

// The one-row body (M == 1): each lane loads and transposes the same 16 K
// rows x 8 columns as mma_partial, and __dp4a takes each transposed word
// (4 K of one column) against the 4 activation bytes of those K.  The 4
// lanes of a column group meet by shuffles, the 4 warps in shared memory.
__global__ void __launch_bounds__(W8_THREADS)
apsq_partial_dp4a_kernel(const int8_t* __restrict__ x,
                         const int8_t* __restrict__ w,
                         int32_t* __restrict__ part, int N, int bk,
                         int splits, int k_split, int x_vec, int w_vec) {
  __shared__ int32_t red[W8_WARPS][W8_BN];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * W8_BN, col = n0 + 8 * g;
  const int K = (int)(gridDim.z / splits) * bk;
  int kb, ke;
  tile_range(blockIdx.z, bk, splits, k_split, &kb, &ke);
  int32_t acc[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) acc[q] = 0;
  for (int k0 = kb + warp * W8_KS; k0 < ke; k0 += W8_WARPS * W8_KS) {
    const int kr = k0 + 16 * t;
    uint2 wr[16];
#pragma unroll
    for (int i = 0; i < 16; ++i)
      wr[i] = w8_load_w(w, kr + i, col, N, ke, w_vec);
    const uint4 xr = w8_load_x(x, 0, kr, 1, K, ke, x_vec);
#pragma unroll
    for (int hh = 0; hh < 4; ++hh) {          // K rows kr + 4hh .. + 3
      uint32_t b[8];
      const int i = 4 * hh;
      transpose4x4(wr[i].x, wr[i + 1].x, wr[i + 2].x, wr[i + 3].x, &b[0]);
      transpose4x4(wr[i].y, wr[i + 1].y, wr[i + 2].y, wr[i + 3].y, &b[4]);
      const int xw = (int)word(xr, hh);
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[q] = __dp4a((int)b[q], xw, acc[q]);
    }
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    acc[q] = wadd(acc[q], __shfl_xor_sync(0xffffffffu, acc[q], 1));
    acc[q] = wadd(acc[q], __shfl_xor_sync(0xffffffffu, acc[q], 2));
  }
  if (t == 0)
#pragma unroll
    for (int q = 0; q < 8; ++q) red[warp][8 * g + q] = acc[q];
  __syncthreads();
  if (threadIdx.x < W8_BN && n0 + (int)threadIdx.x < N) {
    int32_t p = 0;
#pragma unroll
    for (int v = 0; v < W8_WARPS; ++v) p = wadd(p, red[v][threadIdx.x]);
    part[(size_t)blockIdx.z * N + n0 + threadIdx.x] = p;
  }
}

// One thread per output element.
__global__ void __launch_bounds__(EPI_THREADS)
apsq_epilogue_kernel(const int32_t* __restrict__ part,
                     const int32_t* __restrict__ exps,
                     int32_t* __restrict__ out, int M, int N, int n_p,
                     int splits, int gs, int exp_cols) {
  const size_t mn = (size_t)M * N;
  const size_t idx = (size_t)blockIdx.x * EPI_THREADS + threadIdx.x;
  if (idx >= mn) return;
  out[idx] = algorithm1(part, exps, mn, idx, (int)(idx % N), N, n_p, splits,
                        gs, exp_cols);
}

// bm: 16 or 32 rows per block on the tensor cores, 1 for the one-row body
// (M == 1); each PSUM tile in `splits` K ranges of k_split rows.  `part`
// holds n_p * splits * M * N int32.
int launch_apsq(const void* x, const void* w, const void* exps, void* part,
                void* out, int M, int N, int n_p, int bk, int gs,
                int exp_cols, int bm, int splits, int k_split, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bool x_vec = bk % 16 == 0 && k_split % 16 == 0 &&
                     (uintptr_t)x % 16 == 0;
  const bool w_vec = N % 8 == 0 && (uintptr_t)w % 8 == 0;
  const int8_t* xp = (const int8_t*)x;
  const int8_t* wp = (const int8_t*)w;
  int32_t* pp = (int32_t*)part;
  if (splits < 1 || (bm == 1 && M != 1)) return -1;
  dim3 grid((N + W8_BN - 1) / W8_BN, (M + bm - 1) / bm, n_p * splits);
  if (bm == 1)
    apsq_partial_dp4a_kernel<<<grid, W8_THREADS, 0, st>>>(
        xp, wp, pp, N, bk, splits, k_split, x_vec, w_vec);
  else if (bm == 16)
    apsq_partial_mma_kernel<16><<<grid, W8_THREADS, 0, st>>>(
        xp, wp, pp, M, N, bk, splits, k_split, x_vec, w_vec);
  else if (bm == 32)
    apsq_partial_mma_kernel<32><<<grid, W8_THREADS, 0, st>>>(
        xp, wp, pp, M, N, bk, splits, k_split, x_vec, w_vec);
  else
    return -1;
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t mn = (size_t)M * N;
  apsq_epilogue_kernel<<<(unsigned)((mn + EPI_THREADS - 1) / EPI_THREADS),
                         EPI_THREADS, 0, st>>>(
      pp, (const int32_t*)exps, (int32_t*)out, M, N, n_p, splits, gs,
      exp_cols);
  return (int)cudaGetLastError();
}

}  // namespace

// bm, splits, k_split: the wrapper's plan (ops.apsq_plan); part: the
// partials' scratch, n_p * splits * M * N int32.
extern "C" int apsq_matmul_launch(const void* x, const void* w,
                                  const void* exps, void* part, void* out,
                                  int M, int N, int n_p, int bk, int gs,
                                  int exp_cols, int bm, int splits,
                                  int k_split, void* stream) {
  return launch_apsq(x, w, exps, part, out, M, N, n_p, bk, gs, exp_cols, bm,
                     splits, k_split, stream);
}

extern "C" int apsq_matmul_m1_launch(const void* x, const void* w,
                                     const void* exps, void* part, void* out,
                                     int N, int n_p, int bk, int gs,
                                     int exp_cols, int bm, int splits,
                                     int k_split, void* stream) {
  return launch_apsq(x, w, exps, part, out, 1, N, n_p, bk, gs, exp_cols, bm,
                     splits, k_split, stream);
}

// bm, splits, k_split: the wrapper's plan (ops.baseline_plan).
extern "C" int baseline_matmul_launch(const void* x, const void* w, void* out,
                                      int M, int N, int K, int bm,
                                      int splits, int k_split, void* stream) {
  return launch_w8a8(x, w, out, M, N, K, bm, splits, k_split, stream);
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
