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
// (row r = t*G + g) share its K/V tiles.
//
// Bound on the H100: a decode step or a serving chunk reads each visible
// cache byte once and does 4*hd float operations per (row, visible
// position), a few microseconds of either at most; what holds a kernel
// back at these shapes is latency and how many SMs it keeps busy.  The
// design is about parallelism:
//
// * Grid (row block x kv-head, batch, S split).  A block of 4 warps owns
//   RB = 4*RW query rows of one kv-head and one split of S.  RW, the
//   rows per warp, is 1 unless that would pass 4 blocks per SM (then
//   2, which the card measured faster there: PERF.md).  Where rows,
//   heads and batch give fewer blocks than the card has SMs, the
//   wrapper splits S (flash-decoding) into splits of at
//   least 4 tiles: a shorter walk costs less than the merge kernel.  The
//   plan is a pure function of the shapes (ops.attention_plan), so
//   results repeat from run to run.
// * K/V stay int8 in shared memory, double-buffered 32-position tiles
//   filled by cp.async (16-byte copies where every row is 16-byte
//   aligned, else 4-byte ones), and are converted in registers with an
//   exact byte-permute trick (float(2^23 + code + 128) - (2^23 + 128)).
// * Scores: lane j of a warp owns position j of the tile and its RW
//   dot products (query rows read as float4 broadcasts); the online-
//   softmax statistics of each row are warp-wide shuffle reductions.
//   P.V: lane owns hd/32 dimensions of each of its warp's rows.
// * FP32 arithmetic only: tensor cores in TF32 or bf16 would leave the
//   rtol 2e-5 / atol 2e-6 contract the reference holds its kernel to.
// * With S split, each block writes its rows' partial (m, l, acc) to a
//   scratch the wrapper allocates, and a second kernel merges the splits
//   of each row by log-sum-exp, in split order.
//
// Semantics kept from the Pallas kernel:
// * masked scores are -1e30, never -inf: a tile a row sees none of gives
//   exp(0) = 1 per position, which the first real score washes out
//   (corr = exp(-1e30 - m) = 0), and a split a row sees none of merges
//   in with weight exp(-1e30 - M) = 0;
// * a row whose limit is <= 0 sees no position; the reference averages V
//   over all S for it, so a block holding such a row walks all of its
//   split, and every split does, giving the average on merge;
// * otherwise a block stops at its last row's limit (later positions are
//   masked for all its rows), and a split wholly past it does nothing
//   and merges in with weight 0.  Positions outside a block's walk are
//   excluded (probability 0), not masked.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TS = 32;                 // cache positions per tile (1 per lane)
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int KPAD = 16;               // bytes after each K row in shared
                                       // memory: lanes read different rows
constexpr float NEG_INF = -1e30f;
constexpr unsigned MINUS_INF_BITS = 0xff800000u;   // -inf: outside the walk

// Selector of __byte_perm(u, 0x4b000000, .) that puts byte i of u under
// the exponent bits of 2^23.
constexpr unsigned I8F_SEL = 0x7440u;

// Byte i of a word of four int8 codes, as an exact float.
__device__ __forceinline__ float i8f(uint32_t w, int i) {
  const uint32_t u = w ^ 0x80808080u;  // code + 128 in each byte
  return __int_as_float(__byte_perm(u, 0x4b000000u, I8F_SEL + i))
         - 8388736.0f;                 // 2^23 + 128
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The block's shared memory: its query rows, two K/V tiles, and each
// warp's probabilities of the current tile.
template <int HD, int RW>
struct __align__(16) Smem {
  float q[WARPS * RW][HD];
  int8_t k[2][TS][HD + KPAD];
  int8_t v[2][TS][HD];
  float p[WARPS][RW][TS];
};

// Copy positions s0 .. s0+nj-1 of kv-head h, batch b into buffer buf.
template <int HD, int RW>
__device__ __forceinline__ void load_tile(Smem<HD, RW>& sm, int buf,
                                          const int8_t* __restrict__ kc,
                                          const int8_t* __restrict__ vc,
                                          int b, int h, int S, int Hkv,
                                          int s0, int nj, bool vec16) {
  const size_t base = ((size_t)b * S + s0) * Hkv + h;
  if constexpr (HD % 16 == 0) {
    if (vec16) {
      constexpr int PER = HD / 16;
      for (int idx = threadIdx.x; idx < nj * PER; idx += THREADS) {
        const int j = idx / PER, c = (idx % PER) * 16;
        const size_t off = (base + (size_t)j * Hkv) * HD + c;
        cp_async16(&sm.k[buf][j][c], kc + off);
        cp_async16(&sm.v[buf][j][c], vc + off);
      }
      cp_async_commit();
      return;
    }
  }
  {
    constexpr int PER = HD / 4;
    for (int idx = threadIdx.x; idx < nj * PER; idx += THREADS) {
      const int j = idx / PER, c = (idx % PER) * 4;
      const size_t off = (base + (size_t)j * Hkv) * HD + c;
      cp_async4(&sm.k[buf][j][c], kc + off);
      cp_async4(&sm.v[buf][j][c], vc + off);
    }
  }
  cp_async_commit();
}

// DPL codes of V starting at p (DPL = 1, 2 or 4), as one word.
template <int DPL>
__device__ __forceinline__ uint32_t v_word(const int8_t* p) {
  if constexpr (DPL == 4) return *reinterpret_cast<const uint32_t*>(p);
  else if constexpr (DPL == 2) return *reinterpret_cast<const uint16_t*>(p);
  else return *reinterpret_cast<const uint8_t*>(p);
}

template <int HD, int RW>
__global__ void __launch_bounds__(THREADS)
attn_kernel(const float* __restrict__ q, const int8_t* __restrict__ kc,
            const int8_t* __restrict__ vc, const int32_t* __restrict__ kexp,
            const int32_t* __restrict__ vexp, const int32_t* __restrict__ len,
            float* __restrict__ out, float* __restrict__ part, int C, int Hq,
            int S, int Hkv, float scale, int row_blocks, int split_len,
            int vec16) {
  __shared__ Smem<HD, RW> sm;
  constexpr int RB = WARPS * RW;
  constexpr int CH = HD >= 16 ? 16 : HD;      // K bytes per lane read
  constexpr int DPL = HD >= 32 ? HD / 32 : 1; // V dims per lane
  constexpr int DL = HD / DPL;                // lanes that own dims
  const int rb = blockIdx.x % row_blocks, h = blockIdx.x / row_blocks;
  const int b = blockIdx.y, sp = blockIdx.z, n_split = gridDim.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int G = Hq / Hkv, CG = C * G;
  const int r0 = rb * RB, nr = min(RB, CG - r0);
  const float sk = scale * ldexpf(1.0f, kexp[b * Hkv + h]);
  const float v_scale = ldexpf(1.0f, vexp[b * Hkv + h]);
  const int first = len[b] - C + 1;           // limit of chunk token 0
  // rows r0 .. r0+nr-1 see positions < first + row / G
  const int lim_lo = first + r0 / G, lim_hi = first + (r0 + nr - 1) / G;
  const int s_begin = sp * split_len;
  const int split_end = min(S, s_begin + split_len);
  const int s_end = lim_lo >= 1 ? min(split_end, lim_hi) : split_end;
  const int ntiles = s_end > s_begin ? (s_end - s_begin + TS - 1) / TS : 0;
  if (ntiles > 0)
    load_tile(sm, 0, kc, vc, b, h, S, Hkv, s_begin,
              min(TS, s_end - s_begin), vec16);

  for (int idx = threadIdx.x; idx < RB * HD; idx += THREADS) {
    const int r = idx / HD, d = idx % HD, row = r0 + r;
    sm.q[r][d] = row < CG ? q[(((size_t)b * C + row / G) * Hq + h * G
                               + row % G) * HD + d]
                          : 0.0f;
  }
  const int wr0 = warp * RW;                  // the warp's first row
  const bool live = wr0 < nr;
  float m[RW], l[RW], acc[RW][DPL];
  int lim[RW];
#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    m[rr] = NEG_INF;
    l[rr] = 0.0f;
    lim[rr] = first + (r0 + wr0 + rr) / G;
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) acc[rr][dd] = 0.0f;
  }

  for (int it = 0; it < ntiles; ++it) {
    const int s0 = s_begin + it * TS, nj = min(TS, s_end - s0);
    const int buf = it & 1;
    if (it + 1 < ntiles) {
      load_tile(sm, buf ^ 1, kc, vc, b, h, S, Hkv, s0 + TS,
                min(TS, s_end - s0 - TS), vec16);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (live) {
      // scores: lane j owns position s0 + j
      float dot[RW];
#pragma unroll
      for (int rr = 0; rr < RW; ++rr) dot[rr] = 0.0f;
      const int8_t* krow = sm.k[buf][lane];
#pragma unroll
      for (int c = 0; c < HD; c += CH) {
        uint32_t kw[CH / 4];
        if constexpr (CH == 16) {
          const uint4 w4 = *reinterpret_cast<const uint4*>(krow + c);
          kw[0] = w4.x; kw[1] = w4.y; kw[2] = w4.z; kw[3] = w4.w;
        } else {
          const uint2 w2 = *reinterpret_cast<const uint2*>(krow + c);
          kw[0] = w2.x; kw[1] = w2.y;
        }
#pragma unroll
        for (int e = 0; e < CH / 4; ++e) {
          const float k0 = i8f(kw[e], 0), k1 = i8f(kw[e], 1);
          const float k2 = i8f(kw[e], 2), k3 = i8f(kw[e], 3);
#pragma unroll
          for (int rr = 0; rr < RW; ++rr) {
            const float4 qv =
                *reinterpret_cast<const float4*>(&sm.q[wr0 + rr][c + 4 * e]);
            dot[rr] = fmaf(qv.x, k0, dot[rr]);
            dot[rr] = fmaf(qv.y, k1, dot[rr]);
            dot[rr] = fmaf(qv.z, k2, dot[rr]);
            dot[rr] = fmaf(qv.w, k3, dot[rr]);
          }
        }
      }
      // online softmax, one warp-wide reduction per row
      const bool in = lane < nj;
#pragma unroll
      for (int rr = 0; rr < RW; ++rr) {
        const float sc = !in ? __int_as_float(MINUS_INF_BITS)
                             : (s0 + lane < lim[rr] ? dot[rr] * sk : NEG_INF);
        const float mt = fmaxf(m[rr], warp_max(sc));
        const float pj = in ? expf(sc - mt) : 0.0f;
        const float corr = expf(m[rr] - mt);
        l[rr] = l[rr] * corr + warp_sum(pj);
        m[rr] = mt;
#pragma unroll
        for (int dd = 0; dd < DPL; ++dd) acc[rr][dd] *= corr;
        sm.p[warp][rr][lane] = pj;
      }
      __syncwarp();
      // P.V: lane owns dims lane*DPL .. lane*DPL + DPL - 1
      if (lane < DL) {
        const int8_t* vcol = &sm.v[buf][0][lane * DPL];
#pragma unroll 4
        for (int j = 0; j < nj; ++j) {
          const uint32_t vw = v_word<DPL>(vcol + j * HD);
          float vf[DPL];
#pragma unroll
          for (int dd = 0; dd < DPL; ++dd) vf[dd] = i8f(vw, dd);
#pragma unroll
          for (int rr = 0; rr < RW; ++rr) {
            const float pr = sm.p[warp][rr][j];
#pragma unroll
            for (int dd = 0; dd < DPL; ++dd)
              acc[rr][dd] = fmaf(pr, vf[dd], acc[rr][dd]);
          }
        }
      }
    }
    __syncthreads();      // the buffer is free for the tile after next
  }

  if (!live || lane >= DL) return;
  const size_t rows_total = (size_t)gridDim.y * C * Hq;
#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    const int row = r0 + wr0 + rr;
    if (wr0 + rr >= nr) break;
    const size_t o = ((size_t)b * C + row / G) * Hq + h * G + row % G;
    if (n_split == 1) {
      const float inv = 1.0f / fmaxf(l[rr], 1e-30f);
#pragma unroll
      for (int dd = 0; dd < DPL; ++dd)
        out[o * HD + lane * DPL + dd] = acc[rr][dd] * v_scale * inv;
    } else {
      // partials: acc [n_split, rows, HD], then (m, l) [n_split, rows, 2]
      float* pacc = part + ((size_t)sp * rows_total + o) * HD;
#pragma unroll
      for (int dd = 0; dd < DPL; ++dd)
        pacc[lane * DPL + dd] = acc[rr][dd] * v_scale;
      if (lane == 0) {
        float* pml = part + (size_t)n_split * rows_total * HD
                     + ((size_t)sp * rows_total + o) * 2;
        pml[0] = m[rr];
        pml[1] = l[rr];
      }
    }
  }
}

// Merge each output row's n_split partials by log-sum-exp, one warp per
// row, splits in order.
template <int HD>
__global__ void __launch_bounds__(THREADS)
merge_kernel(const float* __restrict__ part, float* __restrict__ out,
             int rows_total, int n_split) {
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows_total) return;
  const float* pml = part + (size_t)n_split * rows_total * HD;
  float mx = NEG_INF;
  for (int s = 0; s < n_split; ++s)
    mx = fmaxf(mx, pml[((size_t)s * rows_total + row) * 2]);
  float lsum = 0.0f;
  for (int s = 0; s < n_split; ++s) {
    const float* ml = pml + ((size_t)s * rows_total + row) * 2;
    lsum += expf(ml[0] - mx) * ml[1];
  }
  const float inv = 1.0f / fmaxf(lsum, 1e-30f);
  for (int d = lane; d < HD; d += 32) {
    float a = 0.0f;
    for (int s = 0; s < n_split; ++s)
      a = fmaf(expf(pml[((size_t)s * rows_total + row) * 2] - mx),
               part[((size_t)s * rows_total + row) * HD + d], a);
    out[(size_t)row * HD + d] = a * inv;
  }
}

template <int HD, int RW>
int launch(const void* q, const void* kc, const void* vc, const void* ke,
           const void* ve, const void* len, void* out, void* part, int B,
           int C, int Hq, int S, int Hkv, float scale, int n_split,
           int split_len, int vec16, cudaStream_t stream) {
  const int rows = C * (Hq / Hkv);
  const int row_blocks = (rows + WARPS * RW - 1) / (WARPS * RW);
  dim3 grid(row_blocks * Hkv, B, n_split);
  attn_kernel<HD, RW><<<grid, THREADS, 0, stream>>>(
      (const float*)q, (const int8_t*)kc, (const int8_t*)vc,
      (const int32_t*)ke, (const int32_t*)ve, (const int32_t*)len,
      (float*)out, (float*)part, C, Hq, S, Hkv, scale, row_blocks,
      split_len, vec16);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return (int)err;
  const int rows_total = B * C * Hq;
  merge_kernel<HD><<<(rows_total + WARPS - 1) / WARPS, THREADS, 0, stream>>>(
      (const float*)part, (float*)out, rows_total, n_split);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_hd(const void* q, const void* kc, const void* vc, const void* ke,
              const void* ve, const void* len, void* out, void* part, int B,
              int C, int Hq, int S, int Hkv, float scale, int rw,
              int n_split, int split_len, int vec16, cudaStream_t st) {
  switch (rw) {
    case 1: return launch<HD, 1>(q, kc, vc, ke, ve, len, out, part, B, C, Hq, S, Hkv, scale, n_split, split_len, vec16, st);
    case 2: return launch<HD, 2>(q, kc, vc, ke, ve, len, out, part, B, C, Hq, S, Hkv, scale, n_split, split_len, vec16, st);
    default: return -1;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launches; -1 for an unsupported hd
// or rows-per-warp.  part: n_split * B*C*Hq * (hd + 2) floats of scratch
// when n_split > 1 (unused otherwise).  vec16: every K/V row is 16-byte
// aligned (16-byte copies), else 4-byte copies.
extern "C" int int8_kv_attention_launch(const void* q, const void* kc,
                                        const void* vc, const void* ke,
                                        const void* ve, const void* len,
                                        void* out, void* part, int B, int C,
                                        int Hq, int S, int Hkv, int hd,
                                        float scale, int rw, int n_split,
                                        int split_len, int vec16,
                                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 8: return launch_hd<8>(q, kc, vc, ke, ve, len, out, part, B, C, Hq, S, Hkv, scale, rw, n_split, split_len, vec16, st);
    case 16: return launch_hd<16>(q, kc, vc, ke, ve, len, out, part, B, C, Hq, S, Hkv, scale, rw, n_split, split_len, vec16, st);
    case 64: return launch_hd<64>(q, kc, vc, ke, ve, len, out, part, B, C, Hq, S, Hkv, scale, rw, n_split, split_len, vec16, st);
    case 128: return launch_hd<128>(q, kc, vc, ke, ve, len, out, part, B, C, Hq, S, Hkv, scale, rw, n_split, split_len, vec16, st);
    default: return -1;
  }
}
