// Variant family of the fused bf16 MaxSim, doc-major output, for Hopper
// (sm_90a).
//
// Replaces the Pallas variant sweep of scripts/profile_kernel_variants.py
// (build(...) -> kernel_iota, kernel_addmask, kernel_addflat,
// kernel_iota_scratch, kernel_addflat_fold, kernel_dotsonly). Every variant
// but the probe computes
//
//   out[n, q] = sum_{t < tq} max_{j valid in doc n} <queries[q*tq + t], grid[n, j]>
//
// with bf16 products accumulated in f32 on the tensor cores and only the
// [ND, Q] scores written to device memory; a doc with no valid row scores 0.
// The sweep's axes, as template or runtime parameters of ONE kernel:
//   - mask input (MASK): kLens compares the row index with doclens[n] and
//     stops a doc's walk at its length; kAdditive adds an f32 mask value
//     (0 or -1e30) per row and walks all td rows. The Pallas script's 2-D
//     [ND, Td] and flat [ND*Td, 1] mask layouts differ only in TPU
//     lane/sublane placement; here both are the same row-major memory;
//   - geometry: docs per thread block (dpb, runtime) and token rows staged
//     per block barrier (ROWS: 16, 32 or 64), the counterparts of dblk/sub;
//   - row reduction (REDUCE): kRegisters keeps each doc's running max in the
//     mma accumulator layout and finishes it with warp shuffles; kShared
//     stages every 16x8 accumulator tile through shared memory and scans its
//     columns there (the counterparts of concatenate / scratch / fold);
//   - the dots-only probe (MASK = kDots): the same loads and tensor-core
//     products with a SUM in place of the max, wrong by design, defined as
//     kernel_dotsonly: out[n, q] is the sum, over every token row of the dpb
//     docs of n's block and every token of query q, of the products. It
//     isolates what the mask, max and epilogue cost.
//
// Bound on the H100: compute. At the sweep's shape (2,048 query tokens
// against 5,184 docs x Td 384 x d 128, ~0.99M valid rows) the valid rows'
// products are ~0.52 TFLOP (0.52 ms at 989 TFLOP/s) over a 510 MB grid
// (0.15 ms at 3.35 TB/s). The design is the simple one of maxsim_bf16.cu,
// with mma.sync m16n8k16 in place of wmma so that the accumulator layout is
// known and the register reduction is possible: a block stages ~128 query-
// token columns (whole queries) in shared memory once, walks its docs' rows
// in ROWS-row tiles (two barriers a tile), and each of 4 warps multiplies
// the tile by its 8-column groups. blockIdx.x runs over query blocks, so the
// blocks in flight share docs and read their rows from L2. No wgmma, TMA or
// pipelined loads: this family exists to be right and to measure which axis
// matters before the two serving kernels are redesigned.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// Interface: plain C, loaded with ctypes (nextplaid_tpu_torch/ops/maxsim_variants.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTargetCols = 128;  // query-token columns a block aims at
constexpr int kMaxGroups = 8;     // 8-column groups a warp may own: 256 columns
constexpr int kPad = 8;           // bf16 row padding in shared memory
constexpr float kNeg = -1e30f;    // the Pallas kernels' mask value

enum : int { kLens = 0, kAdditive = 1, kDots = 2 };
enum : int { kRegisters = 0, kShared = 1 };

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int MASK, int ROWS, int REDUCE>
__global__ void __launch_bounds__(kThreads) maxsim_variant_kernel(
    const __nv_bfloat16* __restrict__ queries,  // [q_n * tq, d]
    const __nv_bfloat16* __restrict__ grid,     // [nd, td, d]
    const int* __restrict__ doclens,            // [nd] (kLens)
    const float* __restrict__ addmask,          // [nd, td] (kAdditive)
    float* __restrict__ out,                    // [nd, q_n]
    int q_n, int tq, int qpb, int nd, int td, int d, int dpb) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int cols = qpb * tq;  // a multiple of 8
  const int ld = d + kPad;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [cols, ld]
  __nv_bfloat16* ts = qs + (size_t)cols * ld;                   // [ROWS, ld]
  float* rowmask = reinterpret_cast<float*>(ts + ROWS * ld);    // [ROWS]
  float* scratch = rowmask + ROWS;        // [kWarps][16 * 8]
  float* tokmax = scratch + kWarps * 128;  // [dpb, cols] ([cols] for kDots)

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gid = lane >> 2;  // accumulator rows gid and gid + 8
  const int tig = lane & 3;   // accumulator columns 2 * tig and 2 * tig + 1
  const int groups = cols / 8;
  const int vec_per_row = d / 8;  // 16-byte vectors of 8 bf16
  const int qblock = blockIdx.x;
  const int doc0 = blockIdx.y * dpb;

  // Stage this block's query tokens; rows past the last query are zero.
  const long long qf = (long long)q_n * tq;
  const long long col0 = (long long)qblock * cols;
  for (int i = threadIdx.x; i < cols * vec_per_row; i += kThreads) {
    const int c = i / vec_per_row;
    const int v = i % vec_per_row;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (col0 + c < qf) {
      val = reinterpret_cast<const uint4*>(queries + (col0 + c) * d)[v];
    }
    reinterpret_cast<uint4*>(qs + (size_t)c * ld)[v] = val;
  }

  float acc[kMaxGroups][4];
  if (MASK == kDots) {
#pragma unroll
    for (int gi = 0; gi < kMaxGroups; ++gi) {
      acc[gi][0] = acc[gi][1] = acc[gi][2] = acc[gi][3] = 0.0f;
    }
  }

  for (int dl = 0; dl < dpb; ++dl) {
    const int doc = doc0 + dl;
    if (doc >= nd) break;  // uniform across the block
    int len = td;
    if (MASK == kLens) {
      len = doclens[doc];
      len = len < 0 ? 0 : (len > td ? td : len);
    }
    const __nv_bfloat16* rows = grid + (long long)doc * td * d;

    // Running max of the doc per owned column: kRegisters holds columns
    // 2*tig and 2*tig+1 of each group in [0] and [1]; kShared holds column
    // lane & 7 in [0].
    float rmax[kMaxGroups][2];
#pragma unroll
    for (int gi = 0; gi < kMaxGroups; ++gi) rmax[gi][0] = rmax[gi][1] = kNeg;

    for (int row0 = 0; row0 < len; row0 += ROWS) {
      __syncthreads();  // queries staged; previous tile no longer read
      for (int i = threadIdx.x; i < ROWS * vec_per_row; i += kThreads) {
        const int r = i / vec_per_row;
        const int v = i % vec_per_row;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (row0 + r < len) {
          val = reinterpret_cast<const uint4*>(rows + (long long)(row0 + r) * d)[v];
        }
        reinterpret_cast<uint4*>(ts + r * ld)[v] = val;
      }
      if (MASK == kAdditive) {
        for (int r = threadIdx.x; r < ROWS; r += kThreads) {
          rowmask[r] = row0 + r < td ? addmask[(long long)doc * td + row0 + r] : kNeg;
        }
      }
      __syncthreads();

#pragma unroll
      for (int sub = 0; sub < ROWS / 16; ++sub) {
        const int srow = sub * 16;
        if (row0 + srow >= len) break;  // uniform: a sub-tile of padding only
        if (MASK != kDots) {
#pragma unroll
          for (int gi = 0; gi < kMaxGroups; ++gi) {
            acc[gi][0] = acc[gi][1] = acc[gi][2] = acc[gi][3] = 0.0f;
          }
        }
        const __nv_bfloat16* a_lo = ts + (srow + gid) * ld + tig * 2;
        const __nv_bfloat16* a_hi = a_lo + 8 * ld;
        for (int k0 = 0; k0 < d; k0 += 16) {
          const uint32_t a0 = lds32(a_lo + k0);
          const uint32_t a1 = lds32(a_hi + k0);
          const uint32_t a2 = lds32(a_lo + k0 + 8);
          const uint32_t a3 = lds32(a_hi + k0 + 8);
#pragma unroll
          for (int gi = 0; gi < kMaxGroups; ++gi) {
            const int g = warp + gi * kWarps;
            if (g < groups) {  // uniform across the warp
              const __nv_bfloat16* b = qs + (size_t)(g * 8 + gid) * ld + k0 + tig * 2;
              mma_bf16(acc[gi], a0, a1, a2, a3, lds32(b), lds32(b + 8));
            }
          }
        }
        if (MASK == kDots) continue;

        const int r_lo = row0 + srow + gid;
#pragma unroll
        for (int gi = 0; gi < kMaxGroups; ++gi) {
          const int g = warp + gi * kWarps;
          if (g >= groups) continue;  // uniform across the warp
          if (REDUCE == kRegisters) {
            float v0 = acc[gi][0], v1 = acc[gi][1], v2 = acc[gi][2], v3 = acc[gi][3];
            if (MASK == kLens) {
              if (r_lo >= len) v0 = v1 = kNeg;
              if (r_lo + 8 >= len) v2 = v3 = kNeg;
            } else {
              const float m_lo = rowmask[srow + gid];
              const float m_hi = rowmask[srow + gid + 8];
              v0 += m_lo; v1 += m_lo; v2 += m_hi; v3 += m_hi;
            }
            rmax[gi][0] = fmaxf(rmax[gi][0], fmaxf(v0, v2));
            rmax[gi][1] = fmaxf(rmax[gi][1], fmaxf(v1, v3));
          } else {
            float* sc = scratch + warp * 128;  // [16, 8]
            sc[gid * 8 + tig * 2] = acc[gi][0];
            sc[gid * 8 + tig * 2 + 1] = acc[gi][1];
            sc[(gid + 8) * 8 + tig * 2] = acc[gi][2];
            sc[(gid + 8) * 8 + tig * 2 + 1] = acc[gi][3];
            __syncwarp();
            // Lane l scans rows 4*(l/8) .. +3 of column l % 8.
            const int col = lane & 7;
            const int r4 = (lane >> 3) * 4;
            float m = kNeg;
#pragma unroll
            for (int r = r4; r < r4 + 4; ++r) {
              const float v = sc[r * 8 + col];
              if (MASK == kLens) {
                if (row0 + srow + r < len) m = fmaxf(m, v);
              } else {
                m = fmaxf(m, v + rowmask[srow + r]);
              }
            }
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 8));
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 16));
            rmax[gi][0] = fmaxf(rmax[gi][0], m);
            __syncwarp();
          }
        }
      }
    }

    if (MASK != kDots) {
#pragma unroll
      for (int gi = 0; gi < kMaxGroups; ++gi) {
        const int g = warp + gi * kWarps;
        if (g >= groups) continue;
        float* tm = tokmax + (size_t)dl * cols + g * 8;
        if (REDUCE == kRegisters) {
          float m0 = rmax[gi][0], m1 = rmax[gi][1];
#pragma unroll
          for (int s = 4; s < 32; s <<= 1) {  // over the 8 row groups
            m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, s));
            m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, s));
          }
          if (gid == 0) {
            tm[tig * 2] = m0 > kNeg / 2 ? m0 : 0.0f;
            tm[tig * 2 + 1] = m1 > kNeg / 2 ? m1 : 0.0f;
          }
        } else if (lane < 8) {
          const float m = rmax[gi][0];
          tm[lane] = m > kNeg / 2 ? m : 0.0f;
        }
      }
    }
  }

  if (MASK == kDots) {
    // Column sums over every row the block walked: the two accumulator rows
    // of a lane, then the 8 row groups.
#pragma unroll
    for (int gi = 0; gi < kMaxGroups; ++gi) {
      const int g = warp + gi * kWarps;
      if (g >= groups) continue;
      float s0 = acc[gi][0] + acc[gi][2];
      float s1 = acc[gi][1] + acc[gi][3];
#pragma unroll
      for (int s = 4; s < 32; s <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, s);
        s1 += __shfl_xor_sync(0xffffffffu, s1, s);
      }
      if (gid == 0) {
        tokmax[g * 8 + tig * 2] = s0;
        tokmax[g * 8 + tig * 2 + 1] = s1;
      }
    }
  }
  __syncthreads();

  // Sum each query's per-token values in f32, in token order; doc-major out.
  for (int i = threadIdx.x; i < dpb * qpb; i += kThreads) {
    const int dl = i / qpb;
    const int qi = i % qpb;
    const int doc = doc0 + dl;
    const long long q = (long long)qblock * qpb + qi;
    if (doc >= nd || q >= q_n) continue;
    const float* tm = tokmax + (MASK == kDots ? 0 : (size_t)dl * cols) + qi * tq;
    float s = 0.0f;
    for (int t = 0; t < tq; ++t) s += tm[t];
    out[(long long)doc * q_n + q] = s;
  }
}

int queries_per_block(int tq) {
  return tq >= kTargetCols ? 1 : kTargetCols / tq;
}

long long smem_bytes(int tq, int d, int dpb, int rows) {
  const int cols = queries_per_block(tq) * tq;
  return (long long)(cols + rows) * (d + kPad) * 2 + rows * 4 +
         kWarps * 128 * 4 + (long long)dpb * cols * 4;
}

template <int MASK, int ROWS, int REDUCE>
cudaError_t launch(const __nv_bfloat16* queries, const __nv_bfloat16* grid,
                   const int* doclens, const float* addmask, float* out,
                   int q_n, int tq, int nd, int td, int d, int dpb,
                   cudaStream_t stream) {
  const int qpb = queries_per_block(tq);
  const long long smem = smem_bytes(tq, d, dpb, ROWS);
  cudaError_t err = cudaFuncSetAttribute(
      maxsim_variant_kernel<MASK, ROWS, REDUCE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 blocks((q_n + qpb - 1) / qpb, (nd + dpb - 1) / dpb);
  maxsim_variant_kernel<MASK, ROWS, REDUCE><<<blocks, kThreads, (size_t)smem, stream>>>(
      queries, grid, doclens, addmask, out, q_n, tq, qpb, nd, td, d, dpb);
  return cudaGetLastError();
}

template <int MASK, int REDUCE>
cudaError_t launch_rows(int rows, const __nv_bfloat16* queries,
                        const __nv_bfloat16* grid, const int* doclens,
                        const float* addmask, float* out, int q_n, int tq,
                        int nd, int td, int d, int dpb, cudaStream_t stream) {
  switch (rows) {
    case 16:
      return launch<MASK, 16, REDUCE>(queries, grid, doclens, addmask, out, q_n, tq, nd, td, d, dpb, stream);
    case 32:
      return launch<MASK, 32, REDUCE>(queries, grid, doclens, addmask, out, q_n, tq, nd, td, d, dpb, stream);
    case 64:
      return launch<MASK, 64, REDUCE>(queries, grid, doclens, addmask, out, q_n, tq, nd, td, d, dpb, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches one variant on `stream`. mask: 0 doclens, 1 additive f32 mask,
// 2 the dots-only probe (neither mask input is read). rows: 16, 32 or 64
// token rows per barrier. reduce: 0 registers, 1 shared memory (ignored by
// the probe). Shapes are checked by the caller: tq a multiple of 8 and d a
// multiple of 16, both up to 256; 1 <= dpb <= 64; q_n >= 1;
// 1 <= nd <= 65535 * dpb; 16-byte aligned inputs. Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for an unknown variant.
int maxsim_variants_scores(const void* queries, const void* grid,
                           const int* doclens, const float* addmask,
                           float* out, int q_n, int tq, int nd, int td, int d,
                           int mask, int dpb, int rows, int reduce,
                           void* stream) {
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(queries);
  const __nv_bfloat16* g = static_cast<const __nv_bfloat16*>(grid);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (mask == kDots) {
    err = launch_rows<kDots, kRegisters>(rows, q, g, doclens, addmask, out, q_n, tq, nd, td, d, dpb, s);
  } else if (mask == kLens && reduce == kRegisters) {
    err = launch_rows<kLens, kRegisters>(rows, q, g, doclens, addmask, out, q_n, tq, nd, td, d, dpb, s);
  } else if (mask == kLens && reduce == kShared) {
    err = launch_rows<kLens, kShared>(rows, q, g, doclens, addmask, out, q_n, tq, nd, td, d, dpb, s);
  } else if (mask == kAdditive && reduce == kRegisters) {
    err = launch_rows<kAdditive, kRegisters>(rows, q, g, doclens, addmask, out, q_n, tq, nd, td, d, dpb, s);
  } else if (mask == kAdditive && reduce == kShared) {
    err = launch_rows<kAdditive, kShared>(rows, q, g, doclens, addmask, out, q_n, tq, nd, td, d, dpb, s);
  }
  return (int)err;
}

const char* maxsim_variants_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
