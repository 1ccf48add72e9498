// Fused MaxSim over the pinned bf16 token grid, for Hopper (sm_90a).
//
// Replaces the Pallas kernel nextplaid_tpu/ops/maxsim_kernel.py
// (maxsim_grid_scores / _kernel). It computes
//
//   scores[q, n] = sum_{t < tq} max_{j < doclens[n]} <queries[q*tq + t], grid[n, j]>
//
// with bf16 products accumulated in f32 on the tensor cores, the per-token
// maxima kept on chip, and the sum over query tokens taken in f32. Only the
// [Q, ND] scores reach device memory. A doc with doclens == 0 scores 0; token
// rows at or beyond doclens are masked by their index, not by their value (a
// zero padding row would otherwise beat a real token whose similarities are
// all negative).
//
// Bound on the H100: compute. At the main path's shapes (10,240 query tokens
// against 5,696 grid rows x Td 304 x d 128) one pass is ~4.5 TFLOP of bf16
// products over a 443 MB grid: ~295 operations per byte are needed to leave
// the memory bound, and this is ~10,000. The design keeps the tensor cores
// fed from shared memory and keeps the grid read from device memory about
// once:
//   - a block takes a block of whole queries (about 128 query-token columns)
//     staged once in shared memory, and walks 8 docs' rows in 16-row tiles;
//   - blockIdx.x runs over query blocks, so the blocks in flight at one time
//     share the same few docs and read their rows from L2;
//   - each of 4 warps multiplies the tile by its 16-column groups of queries
//     with wmma m16n16k16 (bf16 in, f32 accumulators) and folds the masked
//     rows into a running per-token max;
//   - the tile loop stops at the doc's length, so padding rows and empty
//     (padding) docs cost no products.
// This first design is simple rather than fast: no wgmma, TMA or pipelined
// loads, and a block barrier around every tile.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// Interface: plain C, loaded with ctypes (nextplaid_tpu_torch/ops/maxsim_kernel.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <math.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kDocsPerBlock = 8;
constexpr int kTileRows = 16;
constexpr int kTargetCols = 128;     // query-token columns a block aims at
constexpr int kMaxGroupsPerWarp = 4;  // 16-column groups: up to 256 columns
constexpr int kPad = 8;               // bf16 row padding in shared memory

__global__ void __launch_bounds__(kThreads) maxsim_bf16_kernel(
    const __nv_bfloat16* __restrict__ queries,  // [q_n * tq, d]
    const __nv_bfloat16* __restrict__ grid,     // [nd, td, d]
    const int* __restrict__ doclens,            // [nd]
    float* __restrict__ out,                    // [q_n, nd]
    int q_n, int tq, int qpb, int nd, int td, int d) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int cols = qpb * tq;  // a multiple of 16
  const int ld = d + kPad;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [cols, ld]
  __nv_bfloat16* ts = qs + (size_t)cols * ld;                   // [16, ld]
  float* scratch = reinterpret_cast<float*>(ts + kTileRows * ld);  // [warps][256]
  float* tokmax = scratch + kWarps * 256;  // [kDocsPerBlock, cols]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int groups = cols / 16;
  const int vec_per_row = d / 8;  // 16-byte vectors of 8 bf16
  const int qblock = blockIdx.x;
  const int doc0 = blockIdx.y * kDocsPerBlock;

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

  for (int dl = 0; dl < kDocsPerBlock; ++dl) {
    const int doc = doc0 + dl;
    if (doc >= nd) break;  // uniform across the block
    int len = doclens[doc];
    len = len < 0 ? 0 : (len > td ? td : len);
    const __nv_bfloat16* rows = grid + (long long)doc * td * d;

    float rmax[kMaxGroupsPerWarp];
#pragma unroll
    for (int gi = 0; gi < kMaxGroupsPerWarp; ++gi) rmax[gi] = -INFINITY;

    for (int row0 = 0; row0 < len; row0 += kTileRows) {
      __syncthreads();  // queries staged; previous tile no longer read
      for (int i = threadIdx.x; i < kTileRows * vec_per_row; i += kThreads) {
        const int r = i / vec_per_row;
        const int v = i % vec_per_row;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (row0 + r < len) {
          val = reinterpret_cast<const uint4*>(rows + (long long)(row0 + r) * d)[v];
        }
        reinterpret_cast<uint4*>(ts + r * ld)[v] = val;
      }
      __syncthreads();

#pragma unroll
      for (int gi = 0; gi < kMaxGroupsPerWarp; ++gi) {
        const int g = warp + gi * kWarps;
        if (g < groups) {  // uniform across the warp
          wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
          wmma::fill_fragment(acc, 0.0f);
          for (int k0 = 0; k0 < d; k0 += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> a;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                           wmma::col_major> b;
            wmma::load_matrix_sync(a, ts + k0, ld);
            wmma::load_matrix_sync(b, qs + (size_t)g * 16 * ld + k0, ld);
            wmma::mma_sync(acc, a, b, acc);
          }
          float* sc = scratch + warp * 256;
          wmma::store_matrix_sync(sc, acc, 16, wmma::mem_row_major);
          __syncwarp();
          // Lanes 0-15 take rows 0-7 of column `lane`, lanes 16-31 rows 8-15.
          const int col = lane & 15;
          const int r0 = (lane >> 4) * 8;
          float m = -INFINITY;
#pragma unroll
          for (int r = r0; r < r0 + 8; ++r) {
            if (row0 + r < len) m = fmaxf(m, sc[r * 16 + col]);
          }
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 16));
          rmax[gi] = fmaxf(rmax[gi], m);
          __syncwarp();
        }
      }
    }

#pragma unroll
    for (int gi = 0; gi < kMaxGroupsPerWarp; ++gi) {
      const int g = warp + gi * kWarps;
      if (g < groups && lane < 16) {
        tokmax[dl * cols + g * 16 + lane] = len > 0 ? rmax[gi] : 0.0f;
      }
    }
  }
  __syncthreads();

  // Sum each query's per-token maxima in f32, in token order.
  for (int i = threadIdx.x; i < kDocsPerBlock * qpb; i += kThreads) {
    const int dl = i / qpb;
    const int qi = i % qpb;
    const int doc = doc0 + dl;
    const long long q = (long long)qblock * qpb + qi;
    if (doc >= nd || q >= q_n) continue;
    const float* tm = tokmax + dl * cols + qi * tq;
    float s = 0.0f;
    for (int t = 0; t < tq; ++t) s += tm[t];
    out[q * nd + doc] = s;
  }
}

}  // namespace

extern "C" {

// Queries per block for query-token count `tq` (a multiple of 16, <= 256).
int maxsim_bf16_queries_per_block(int tq) {
  return tq >= kTargetCols ? 1 : kTargetCols / tq;
}

// Dynamic shared memory of one block, in bytes.
long long maxsim_bf16_smem_bytes(int tq, int d) {
  const int cols = maxsim_bf16_queries_per_block(tq) * tq;
  return (long long)(cols + kTileRows) * (d + kPad) * 2 + kWarps * 256 * 4 +
         (long long)kDocsPerBlock * cols * 4;
}

// Launches the kernel on `stream`. Shapes are checked by the caller:
// tq and d multiples of 16 up to 256, q_n >= 1, 1 <= nd <= 65535 * 8,
// 16-byte aligned inputs. Returns cudaGetLastError() after the launch.
int maxsim_bf16_scores(const void* queries, const void* grid,
                       const int* doclens, float* out, int q_n, int tq,
                       int nd, int td, int d, void* stream) {
  const int qpb = maxsim_bf16_queries_per_block(tq);
  const long long smem = maxsim_bf16_smem_bytes(tq, d);
  cudaError_t err = cudaFuncSetAttribute(
      maxsim_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 blocks((q_n + qpb - 1) / qpb,
                    (nd + kDocsPerBlock - 1) / kDocsPerBlock);
  maxsim_bf16_kernel<<<blocks, kThreads, (size_t)smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(queries),
      static_cast<const __nv_bfloat16*>(grid), doclens, out, q_n, tq, qpb, nd,
      td, d);
  return (int)cudaGetLastError();
}

const char* maxsim_bf16_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
