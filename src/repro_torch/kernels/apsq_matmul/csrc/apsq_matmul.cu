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
//       -> apsq_expert_matmul_launch (fused MoE expert bank,
//          expert_stream_kernel: Algorithm 1 in registers)
//   * baseline_expert_matmul_kernel (:472, body _baseline_expert_kernel
//                                    :395)
//       -> baseline_expert_matmul_launch (INT32-accumulator expert bank,
//          the same kernel with one accumulation over all of K)
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
// tensor-core peak).  An expert bank reads the weights of the experts
// that routing filled (E*K*N at 3.35 TB/s: 40 us for one OLMoE expert
// GEMM, 64 x 2048 x 1024, with every expert live).
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
// Expert banks (apsq_expert_matmul_launch, baseline_expert_matmul_launch;
// expert_stream_kernel below).  M is the expert capacity (1-3 rows at
// OLMoE serving shapes), so each weight byte feeds about 2 int8
// operations and only the bytes count: the design streams them and
// skips the ones it can.
//
// * Grid (BN columns, 16 rows, expert): a block owns one expert's BN
//   (64 or 128, ops.expert_plan) columns and walks all of K itself.  E=64
//   gives >= 512 blocks at N=1024 with no K split: no scratch, no atomics,
//   one kernel.  Its warps split the columns, 32 each, so a warp's
//   mma.sync m16n8k32 accumulators hold the whole tile's exact INT32
//   partial of its columns.
// * The expert's weight rows stream through a ring of STAGES shared
//   stages of 64 K rows, filled with 16-byte cp.async copies that stay in
//   flight while earlier stages are consumed.  A stage never crosses a
//   PSUM tile's end: it loads zeros at and past it (bk = 12, 37, 138).
//   A tile's last stage also brings the tile's exponents, so the step
//   below never waits on a global load and n_p needs no shared memory.
// * At each PSUM tile's end every lane applies Algorithm 1's carry form
//   (as algorithm1 below) to its accumulators in registers, and clears
//   them: no cross-warp reduction, no bank registers, gs unbounded.
//   Each exponent becomes three shift operands first (po2_of), so the
//   step is a few integer ops per element: the integer pipes are shared
//   with the stream's address arithmetic.
// * A block first ORs its expert's activation codes; if all are zero
//   (routing left the expert empty: the dispatch buffer is zeros there)
//   it stores zeros and reads no weight byte.  That is exact: a zero row
//   gives 0 through the W8A8 sum and through Algorithm 1 under every
//   exponent (quant(0, e) = 0 for e != 32; at e = 32 the code is -1 and
//   deq(-1, 32) = 0).
//

#include <cstdint>
#include <cuda_runtime.h>

namespace {


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

__device__ __forceinline__ int32_t exp_at(const int32_t* exps, int i, int n,
                                          int N, int exp_cols) {
  return exp_cols ? exps[(size_t)i * N + n] : exps[i];
}

// ---------------------------------------------------------------------------
// INT32-accumulator W8A8 GEMM on the int8 tensor cores
// (baseline_matmul_launch; replaces kernel.py:509 baseline_matmul_kernel).
//
// Bound on the H100: at serving M (1-33 rows) the weights dominate, so
// the bound is bytes (K*N at 3.35 TB/s); scalar int32 multiply-adds
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
// mid-group.  Where the TPU kernel keeps the group's INT8 codes and
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

// ---------------------------------------------------------------------------
// Fused MoE expert banks (see the note at the top of the file):
// [E, M, K] int8 x [E, K, N] int8 -> [E, M, N] int32, Algorithm 1 per
// expert (APSQ) or one INT32 sum over K (APSQ = false, W8A8).

constexpr int XS_BK = 64;              // K rows per pipeline stage
constexpr int XS_BM = 16;              // rows per block: one m16 tile
constexpr int XS_WPAD = 32;            // bytes past BN in a weight row
constexpr int XS_XROW = XS_BK + 16;    // bytes per activation row

// The activation word of the mma's K slots 4t .. 4t+3: bytes t, t+4, t+8,
// t+12 of a 16-byte run (column t of its 4x4 transpose), the selector
// PRMT_COL_BASE + t * PRMT_COL_STEP taking byte t of two words.
constexpr unsigned PRMT_COL_BASE = 0x40u;    // x.b0 y.b0
constexpr unsigned PRMT_COL_STEP = 0x11u;

// quant and deq at 2^e as three shift operands, XLA's semantics folded
// in: quant(v, e) = clip((v + bias) >> sh) and deq(c, e) = (c << dsh) &
// dmask.  e <= 0: bias 0, sh 0; 1 <= e < 32: bias 2^(e-1), sh e; e = 32:
// bias shl(1, 31), sh 31 (sra by 32 is a shift by 31); e > 32: bias 0,
// sh 31; deq is c << e for 0 <= e < 32 and 0 otherwise.  So a step costs
// an add, a shift, a clip and a masked shift per element.
struct Po2 {
  int32_t bias, sh, dsh, dmask;
};

__device__ __forceinline__ Po2 po2_of(int32_t e) {
  Po2 p;
  p.bias = e > 0 ? shl(1, e - 1) : 0;
  p.sh = e <= 0 ? 0 : min(e, 31);
  p.dsh = e & 31;
  p.dmask = (e >= 0 && e < 32) ? -1 : 0;
  return p;
}

__device__ __forceinline__ int32_t quant_deq(int32_t v, const Po2& p) {
  const int32_t r = min(max(wadd(v, p.bias) >> p.sh, -128), 127);
  return (int32_t)((uint32_t)r << p.dsh) & p.dmask;
}

__device__ __forceinline__ uint32_t xcol(const uint4& v, unsigned sel) {
  return __byte_perm(__byte_perm(v.x, v.y, sel), __byte_perm(v.z, v.w, sel),
                     PRMT_HALF_LO);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 16 bytes at src into the shared dst, of which the first n (<= 0: none)
// are read and the rest are zeros: one cp.async where all 16 are read and
// the copy is aligned (vec), else byte loads and one shared store.
__device__ __forceinline__ void stage16(int8_t* dst, const int8_t* src,
                                        int n, bool vec) {
  if (vec && n >= 16) {
    cp_async16(dst, src);
    return;
  }
  uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (i < n) v[i / 4] |= (uint32_t)(uint8_t)src[i] << (8 * (i % 4));
  *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
}

// Stage st = (PSUM tile, 64-row step) of a block's walk into its ring
// slot: weight rows kb .. kb+63 x the block's BN columns, and the same K
// bytes of its `rows` activation rows; zeros at and past the tile's end
// ke and past N.  Activation rows past `rows` are left as they are (the
// mma loads never read them).  The last stage of a tile also brings the
// tile's exponents `ex` (of the block's columns, or the one of the tile)
// into `esl`, so the Algorithm-1 step reads them from shared memory.
template <int BN, int THREADS>
__device__ __forceinline__ void expert_stage(
    int8_t* __restrict__ wsl, int8_t* __restrict__ xsl,
    int32_t* __restrict__ esl, const int8_t* __restrict__ x,
    const int8_t* __restrict__ w, const int32_t* __restrict__ ex, int rows,
    int N, int K, int n0, int kb, int ke, bool x_vec, bool w_vec,
    int exp_cols) {
  if (ex != nullptr) {
    for (int c = threadIdx.x; c < (exp_cols ? BN : 1); c += THREADS) {
      const int col = exp_cols ? n0 + c : 0;
      if (col < N) cp_async4(esl + c, ex + col);
      else esl[c] = 0;
    }
  }
  constexpr int WCH = BN / 16;             // 16-byte chunks per weight row
  if (w_vec && x_vec && ke - kb == XS_BK && n0 + BN <= N) {
    // a whole stage: each thread copies rows r + 16u of its chunk, and
    // one 16-byte run of an activation row (THREADS = BN >= 4 * rows)
    const int r = threadIdx.x / WCH, cc = 16 * (threadIdx.x % WCH);
    const int8_t* src = w + (size_t)(kb + r) * N + n0 + cc;
#pragma unroll
    for (int u = 0; u < XS_BK * WCH / THREADS; ++u)
      cp_async16(wsl + (r + u * (THREADS / WCH)) * (BN + XS_WPAD) + cc,
                 src + (size_t)u * (THREADS / WCH) * N);
    if (threadIdx.x < rows * (XS_BK / 16)) {
      const int xr = threadIdx.x / (XS_BK / 16);
      const int kk = 16 * (threadIdx.x % (XS_BK / 16));
      cp_async16(xsl + xr * XS_XROW + kk, x + (size_t)xr * K + kb + kk);
    }
    return;
  }
  for (int c = threadIdx.x; c < XS_BK * WCH; c += THREADS) {
    const int r = c / WCH, cc = 16 * (c % WCH);
    const int k = kb + r, col = n0 + cc;
    stage16(wsl + r * (BN + XS_WPAD) + cc, w + (size_t)k * N + col,
            k < ke ? N - col : 0, w_vec);
  }
  for (int c = threadIdx.x; c < rows * (XS_BK / 16); c += THREADS) {
    const int r = c / (XS_BK / 16), kk = 16 * (c % (XS_BK / 16));
    stage16(xsl + r * XS_XROW + kk, x + (size_t)r * K + kb + kk,
            ke - kb - kk, x_vec);
  }
}

// One block: expert blockIdx.z, rows m0 .. m0+15 (masked past M), columns
// n0 .. n0+BN-1, all of K.  Warp `warp` owns columns n0 + 32*warp + 0..31
// in 4 n8 tiles: tile q's column j is 32*warp + 4j + q, so a lane's one
// 4-byte load of a weight row gives 4 columns, one per tile, at its own
// index g, and a __byte_perm 4x4 transpose of 4 such rows gives its B
// words.  The mma's K slots 4t+i (and 16+4t+i) take the stage rows
// 32s + t + 4i (and 32s + 16 + t + 4i): the 4 lane groups t read 4
// neighbouring rows, which the 32-byte row pad puts on distinct banks,
// and the activation side takes the same K permutation (xcol).
template <int WARPS, int STAGES, bool APSQ>
__global__ void __launch_bounds__(32 * WARPS, 16 / WARPS)
expert_stream_kernel(const int8_t* __restrict__ x,
                     const int8_t* __restrict__ w,
                     const int32_t* __restrict__ exps,
                     int32_t* __restrict__ out, int M, int N, int n_p, int bk,
                     int gs, int exp_cols, int x_vec, int w_vec) {
  constexpr int BN = 32 * WARPS, THREADS = 32 * WARPS;
  constexpr int WROW = BN + XS_WPAD;
  constexpr int WSTAGE = XS_BK * WROW, XSTAGE = XS_BM * XS_XROW;
  constexpr int ESTAGE = APSQ ? BN : 0;        // int32 exponents a stage
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* const ws = smem;
  int8_t* const xs = smem + STAGES * WSTAGE;
  int32_t* const es = reinterpret_cast<int32_t*>(xs + STAGES * XSTAGE);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * XS_BM;
  const size_t e = blockIdx.z;
  const int K = n_p * bk;
  const int rows = min(XS_BM, M - m0);
  x += (e * M + m0) * K;                   // the block's activation rows
  w += e * K * N;
  out += (e * M + m0) * N;
  if (APSQ) exps += e * n_p * (exp_cols ? N : 1);

  // An expert that routing left empty: zeros out, no weight byte read.
  int any = 0;
  if (x_vec) {
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    for (int i = threadIdx.x; i < rows * K / 16; i += THREADS) {
      const uint4 v = __ldg(xv + i);
      any |= (int)(v.x | v.y | v.z | v.w);
    }
  } else {
    for (int i = threadIdx.x; i < rows * K; i += THREADS) any |= x[i];
  }
  if (!__syncthreads_or(any)) {
    for (int i = threadIdx.x; i < rows * BN; i += THREADS) {
      const int n = n0 + i % BN;
      if (n < N) out[(size_t)(i / BN) * N + n] = 0;
    }
    return;
  }

  const int spt = max(1, (bk + XS_BK - 1) / XS_BK);   // stages per tile
  const int total = n_p * spt, last = n_p - 1;
  // the next stage to issue: its tile ni, step nj and ring slot ns
  int ni = 0, nj = 0, ns = 0;
  auto issue_next = [&]() {
    const int kb = ni * bk + nj * XS_BK;
    const int32_t* ex = APSQ && nj == spt - 1
        ? exps + (size_t)ni * (exp_cols ? N : 1) : nullptr;
    expert_stage<BN, THREADS>(ws + ns * WSTAGE, xs + ns * XSTAGE,
                              es + ns * ESTAGE, x, w, ex, rows, N, K, n0, kb,
                              min(ni * bk + bk, kb + XS_BK), x_vec, w_vec,
                              exp_cols);
    if (++nj == spt) nj = 0, ++ni;
    if (++ns == STAGES) ns = 0;
  };
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < total) issue_next();
    cp_async_commit();
  }

  // acc[q][c]: n8 tile q, fragment c: row g + 8*(c/2), column
  // 32*warp + 8t + 4*(c%2) + q; carry: Algorithm 1's running sum there.
  int32_t acc[4][4], carry[4][4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[q][c] = carry[q][c] = 0;
  const unsigned xsel = PRMT_COL_BASE + (unsigned)t * PRMT_COL_STEP;
  const bool live0 = g < rows, live1 = g + 8 < rows;
  const int ncol = n0 + 32 * warp + 8 * t;      // the lane's 8 columns
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  // stage it: tile i, step j, ring slot cs
  for (int it = 0, i = 0, j = 0, cs = 0; it < total; ++it) {
    cp_async_wait<STAGES - 2>();                // stage it has landed
    __syncthreads();                            // ... for every thread
    if (it + STAGES - 1 < total) issue_next();
    cp_async_commit();
    const int8_t* wsl = ws + cs * WSTAGE + 32 * warp + 4 * g;
    const int8_t* xsl = xs + cs * XSTAGE;
#pragma unroll
    for (int s = 0; s < XS_BK / 32; ++s) {
      const int8_t* x0 = xsl + g * XS_XROW + 32 * s;
      const int8_t* x1 = x0 + 8 * XS_XROW;
      const uint4 r00 = live0 ? *reinterpret_cast<const uint4*>(x0) : zero;
      const uint4 r01 = live0 ? *reinterpret_cast<const uint4*>(x0 + 16)
                              : zero;
      const uint4 r10 = live1 ? *reinterpret_cast<const uint4*>(x1) : zero;
      const uint4 r11 = live1 ? *reinterpret_cast<const uint4*>(x1 + 16)
                              : zero;
      uint32_t b[2][4];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int8_t* p = wsl + (32 * s + 16 * hh + t) * WROW;
        transpose4x4(*reinterpret_cast<const uint32_t*>(p),
                     *reinterpret_cast<const uint32_t*>(p + 4 * WROW),
                     *reinterpret_cast<const uint32_t*>(p + 8 * WROW),
                     *reinterpret_cast<const uint32_t*>(p + 12 * WROW),
                     b[hh]);
      }
      const uint32_t a0 = xcol(r00, xsel), a1 = xcol(r10, xsel);
      const uint32_t a2 = xcol(r01, xsel), a3 = xcol(r11, xsel);
#pragma unroll
      for (int q = 0; q < 4; ++q) mma_s8(acc[q], a0, a1, a2, a3, b[0][q],
                                         b[1][q]);
    }
    if (APSQ && j == spt - 1) {                 // PSUM tile i is complete
      Po2 pe[8];              // the exponents of the lane's columns
      const int32_t* esl = es + cs * ESTAGE;
      if (exp_cols) {
        const int4 lo = *reinterpret_cast<const int4*>(esl + ncol - n0);
        const int4 hi = *reinterpret_cast<const int4*>(esl + ncol - n0 + 4);
        pe[0] = po2_of(lo.x); pe[1] = po2_of(lo.y);
        pe[2] = po2_of(lo.z); pe[3] = po2_of(lo.w);
        pe[4] = po2_of(hi.x); pe[5] = po2_of(hi.y);
        pe[6] = po2_of(hi.z); pe[7] = po2_of(hi.w);
      } else {
        const Po2 p0 = po2_of(esl[0]);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) pe[jj] = p0;
      }
      // rows g + 8 (fragments 2, 3) hold no output where M <= 8
      const int nc = rows > 8 ? 4 : 2;
      if (i % gs == 0 || i == last) {
        // group start (APSQ) or the final tile: requantize the tile's
        // partial with the running sum
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (c < nc)
              carry[q][c] = quant_deq(wadd(acc[q][c], carry[q][c]),
                                      pe[4 * (c % 2) + q]);
      } else {                                  // a tail: add its PSQ code
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (c < nc)
              carry[q][c] = wadd(carry[q][c],
                                 quant_deq(acc[q][c], pe[4 * (c % 2) + q]));
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[q][c] = 0;
    }
    if (++j == spt) j = 0, ++i;
    if (++cs == STAGES) cs = 0;
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {              // rows g and g + 8
    const int r = g + 8 * hh;
    if (r >= rows) continue;
    int32_t v[8];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[q] = APSQ ? carry[q][2 * hh] : acc[q][2 * hh];
      v[4 + q] = APSQ ? carry[q][2 * hh + 1] : acc[q][2 * hh + 1];
    }
    int32_t* o = out + (size_t)r * N + ncol;
    if (N % 4 == 0 && ncol + 8 <= N) {
      reinterpret_cast<int4*>(o)[0] = make_int4(v[0], v[1], v[2], v[3]);
      reinterpret_cast<int4*>(o)[1] = make_int4(v[4], v[5], v[6], v[7]);
    } else {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        if (ncol + jj < N) o[jj] = v[jj];
    }
  }
}

template <int WARPS, int STAGES, bool APSQ>
int launch_expert_stream(const void* x, const void* w, const void* exps,
                         void* out, int E, int M, int N, int n_p, int bk,
                         int gs, int exp_cols, cudaStream_t st) {
  constexpr int BN = 32 * WARPS;
  const int smem = STAGES * (XS_BK * (BN + XS_WPAD) + XS_BM * XS_XROW +
                            (APSQ ? 4 * BN : 0));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        expert_stream_kernel<WARPS, STAGES, APSQ>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int K = n_p * bk;
  const bool x_vec = K % 16 == 0 && bk % 16 == 0 && (uintptr_t)x % 16 == 0;
  const bool w_vec = N % 16 == 0 && (uintptr_t)w % 16 == 0;
  dim3 grid((N + BN - 1) / BN, (M + XS_BM - 1) / XS_BM, E);
  expert_stream_kernel<WARPS, STAGES, APSQ><<<grid, 32 * WARPS, smem, st>>>(
      (const int8_t*)x, (const int8_t*)w, (const int32_t*)exps,
      (int32_t*)out, M, N, n_p, bk, gs, exp_cols, x_vec, w_vec);
  return (int)cudaGetLastError();
}

// bn (32 per warp), stages, bm: the wrapper's plan (ops.expert_plan).
template <bool APSQ>
int launch_expert(const void* x, const void* w, const void* exps, void* out,
                  int E, int M, int N, int n_p, int bk, int gs, int exp_cols,
                  int bn, int stages, int bm, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bm != XS_BM || E > 65535 || n_p < 1 || gs < 1) return -1;
#define EXPERT_CASE(W, S)                                                   \
  if (bn == 32 * W && stages == S)                                          \
    return launch_expert_stream<W, S, APSQ>(x, w, exps, out, E, M, N, n_p,  \
                                            bk, gs, exp_cols, st);
  EXPERT_CASE(2, 4) EXPERT_CASE(4, 4)
#undef EXPERT_CASE
  return -1;
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

// bn, stages, bm: the wrapper's plan (ops.expert_plan).
extern "C" int apsq_expert_matmul_launch(const void* x, const void* w,
                                         const void* exps, void* out, int E,
                                         int M, int N, int n_p, int bk,
                                         int gs, int exp_cols, int bn,
                                         int stages, int bm, void* stream) {
  return launch_expert<true>(x, w, exps, out, E, M, N, n_p, bk, gs, exp_cols,
                             bn, stages, bm, stream);
}

extern "C" int baseline_expert_matmul_launch(const void* x, const void* w,
                                             void* out, int E, int M, int N,
                                             int K, int bn, int stages,
                                             int bm, void* stream) {
  return launch_expert<false>(x, w, nullptr, out, E, M, N, 1, K, 1, 0, bn,
                              stages, bm, stream);
}
