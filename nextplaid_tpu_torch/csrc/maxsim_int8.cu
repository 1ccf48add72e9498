// Fused MaxSim over a pinned int8 token grid, for Hopper (sm_90a).
//
// Replaces the Pallas kernel nextplaid_tpu/ops/maxsim_kernel.py
// (maxsim_grid_scores_int8i / _kernel_int8i). Per query q and doc n:
//
//   v[t, j]   = float(dot_s32(queries[q*tq + t], grid[n, j])) * scale[n, j]
//               (-1e30 where scale[n, j] is not > 0: an invalid token)
//   m_t       = max_j v[t, j], replaced by 0 if no token of doc n is valid
//   out[q, n] = sum_t qscale[q*tq + t] * m_t        (f32)
//
// Layout (the port's, not the TPU's): the grid is doc-major [nd, td, d] int8
// with per-token bf16 dequant scales [nd, td]. The Pallas kernel's 128-doc
// token interleave only makes the per-doc max a lane tree-reduce on a TPU;
// here the int8 tensor-core operands must have d contiguous (K-major), and
// the per-doc max then runs over the rows of the accumulator tile.
//
// Bound on the H100: compute. At the grid-only main path (2,048 query tokens
// against ~75.7M valid doc tokens, d 128) one 64-query batch is 3.97e13 int8
// operations, 20 ms at 1,979 TOPS, against ~11 GB of grid (3.3 ms at
// 3.35 TB/s). The design:
//   - a block takes up to 512 query-token columns (whole queries) and 16
//     docs; blockIdx runs query blocks fastest, so the blocks in flight share
//     the same docs and read their rows from L2; registers are capped at 128
//     so two blocks share an SM and one's barrier waits overlap the other's
//     products (faster at 64 queries than one 160-register block despite a
//     few spilled registers; PERF.md has the times);
//   - each of 8 warps holds its query columns (G groups of 8, G up to 8) as
//     mma.sync B fragments in registers for the whole block;
//   - the block walks its docs' rows in 16-row tiles through an 8-stage ring
//     in shared memory, filled with cp.async by all threads 7 tiles ahead of
//     the warps that multiply them (one barrier a tile), so load latency
//     hides behind products; rows are padded to d + 8 bytes so the lanes'
//     8-byte fragment reads hit distinct banks;
//   - products run as mma.sync m16n8k32 s8 x s8 -> s32, k-steps outside the
//     groups so G accumulator chains interleave. The contraction axis is
//     permuted the same way in A and B (lane t owns bytes [t*8*KS, +8*KS)
//     of every row), so each lane reads contiguous bytes;
//   - the epilogue stays in registers: int -> float through the 1.5 * 2^23
//     bit trick and one fma with the row's scale gives exactly
//     float(dot) * scale (|dot| < 2^22), masked rows get -1e30 from the same
//     fma, and a running max per query column spans the doc's tiles; the max
//     over the 8 row groups is three shuffles when the doc ends;
//   - a doc's tiles stop after its last token with a positive scale, found
//     by a scan of its scales, so padding rows and empty docs cost no
//     products (scale 0 stays the mask inside a tile);
//   - the qscale-weighted sum over query tokens runs in f32 from shared
//     memory, in token order.
// This first design is simple rather than fast: mma.sync, not wgmma fed by
// TMA, and a block barrier per 16-row tile.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// Interface: plain C, loaded with ctypes (nextplaid_tpu_torch/ops/maxsim_kernel.py).

#include <cuda_runtime.h>

#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
// Column groups of 8 a warp may own (the cap of G below); half that at
// d 256, where each group's fragments are twice as wide.
constexpr int kMaxGroups = 8;
constexpr int kDocsPerBlock = 16;
constexpr int kTileRows = 16;
constexpr int kStages = 8;  // tiles in flight in the shared-memory ring
constexpr int kMaxCols = kWarps * kMaxGroups * 8;  // columns of one block
constexpr float kNeg = -1e30f;          // the Pallas kernel's mask value
constexpr int kMagicBits = 0x4B400000;  // 1.5 * 2^23 as an f32 bit pattern
constexpr float kMagic = 12582912.0f;   // 1.5 * 2^23

// Not volatile: the product has no side effect, so the compiler may
// interleave the independent chains of several column groups.
__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 8-byte asynchronous copy global -> shared; zero-fills when !valid.
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 8 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A lane's 8*KS contiguous bytes of one row, as 2*KS words.
template <int KS>
__device__ __forceinline__ void load_chunk(const int8_t* p,
                                           uint32_t (&w)[2 * KS]) {
  const uint2* v = reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int i = 0; i < KS; ++i) {
    const uint2 x = v[i];
    w[2 * i] = x.x;
    w[2 * i + 1] = x.y;
  }
}

// Position of a tile in the block's walk: doc dl, rows [row0, row0 + 16).
struct Cursor {
  int dl;
  int row0;
};

// The next tile after `c`, skipping docs without a valid token.
__device__ __forceinline__ Cursor next_tile(Cursor c, const int* lens,
                                            int ndocs) {
  c.row0 += kTileRows;
  if (c.row0 >= lens[c.dl]) {
    c.row0 = 0;
    ++c.dl;
    while (c.dl < ndocs && lens[c.dl] == 0) ++c.dl;
  }
  return c;
}

// KS: d / 32 k-steps. G: column groups of 8 a warp owns (1, 2, 4 or 8, up
// to 4 at d 256); a warp with fewer real groups multiplies zero columns.
template <int KS, int G>
__global__ void __launch_bounds__(kThreads, 2) maxsim_int8_kernel(
    const int8_t* __restrict__ queries,   // [q_n * tq, d]
    const float* __restrict__ qscales,    // [q_n * tq]
    const int8_t* __restrict__ grid,      // [nd, td, d]
    const uint16_t* __restrict__ scales,  // [nd, td] bf16 bits
    float* __restrict__ out,              // [q_n, nd]
    int q_n, int tq, int qpb, int nd, int td, int n_qblocks) {
  constexpr int D = 32 * KS;
  constexpr int kWords = 2 * KS;
  constexpr int kGroups = G;
  constexpr int kRow = D + 8;  // smem row stride: conflict-free 8-byte reads
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* ring = reinterpret_cast<int8_t*>(smem);  // [kStages][16][kRow]
  uint16_t* ring_sc = reinterpret_cast<uint16_t*>(
      smem + kStages * kTileRows * kRow);  // [kStages][16]
  float(*tokmax)[kMaxCols] = reinterpret_cast<float(*)[kMaxCols]>(
      smem + kStages * kTileRows * kRow + kStages * kTileRows * 2);
  int* lens = reinterpret_cast<int*>(&tokmax[kDocsPerBlock][0]);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // row group of the mma fragments
  const int t = lane & 3;   // lane within the group
  const int qb = blockIdx.x % n_qblocks;
  const int doc0 = (blockIdx.x / n_qblocks) * kDocsPerBlock;
  const int ndocs = min(kDocsPerBlock, nd - doc0);
  const int q0 = qb * qpb;
  const int nq = min(qpb, q_n - q0);
  const int ngroups = nq * tq / 8;  // tq is a multiple of 8
  const int grp0 = warp * G;
  const int my_groups = max(0, min(G, ngroups - grp0));
  const long long col_base = (long long)q0 * tq;

  // Each doc's tile bound: 1 + its last token with a positive scale.
  for (int dl = warp; dl < ndocs; dl += kWarps) {
    const uint16_t* s = scales + (long long)(doc0 + dl) * td;
    int last = 0;
    for (int j = lane; j < td; j += 32) {
      const uint16_t b = s[j];
      if (b != 0 && (b & 0x8000) == 0) last = j + 1;
    }
    last = __reduce_max_sync(0xffffffffu, last);
    if (lane == 0) lens[dl] = last;
  }
  for (int i = threadIdx.x; i < kDocsPerBlock * kMaxCols; i += kThreads) {
    (&tokmax[0][0])[i] = 0.0f;  // empty docs keep 0
  }

  // This warp's query columns as B fragments, held for the whole block.
  uint32_t bq[kGroups][kWords];
#pragma unroll
  for (int gi = 0; gi < kGroups; ++gi) {
    if (gi < my_groups) {
      const long long col = col_base + (grp0 + gi) * 8 + g;
      load_chunk<KS>(queries + col * D + t * 8 * KS, bq[gi]);
    } else {
#pragma unroll
      for (int i = 0; i < kWords; ++i) bq[gi][i] = 0u;
    }
  }
  __syncthreads();

  float rmax[kGroups][2];
#pragma unroll
  for (int gi = 0; gi < kGroups; ++gi) rmax[gi][0] = rmax[gi][1] = kNeg;

  // The block walks its docs' tiles in order; all threads copy tile i +
  // kStages - 1 into the ring while the warps multiply tile i.
  int n_tiles = 0;
  for (int dl = 0; dl < ndocs; ++dl) n_tiles += (lens[dl] + kTileRows - 1) / kTileRows;
  Cursor first{0, 0};
  while (first.dl < ndocs && lens[first.dl] == 0) ++first.dl;
  Cursor load = first;
  auto issue = [&](int slot) {
    const long long row_base = (long long)(doc0 + load.dl) * td + load.row0;
    int8_t* dst = ring + slot * kTileRows * kRow;
    for (int c = threadIdx.x; c < kTileRows * D / 8; c += kThreads) {
      const int r = c / (D / 8);
      const int off = (c % (D / 8)) * 8;
      const bool ok = load.row0 + r < td;
      cp_async8(dst + r * kRow + off,
                ok ? grid + (row_base + r) * D + off : grid, ok);
    }
    if (threadIdx.x < kTileRows / 4) {  // 4 scales per copy; td % 4 == 0
      const int r = threadIdx.x * 4;
      const bool ok = load.row0 + r < td;
      cp_async8(ring_sc + slot * kTileRows + r, ok ? scales + row_base + r : scales, ok);
    }
    load = next_tile(load, lens, ndocs);
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles) issue(st);
    cp_async_commit();
  }

  Cursor cur = first;
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile i landed; every warp is done with tile i - 1
    if (i + kStages - 1 < n_tiles) issue((i + kStages - 1) % kStages);
    cp_async_commit();
    if (my_groups > 0) {  // uniform across the warp
      const int8_t* tile = ring + (i % kStages) * kTileRows * kRow;
      const uint16_t* tsc = ring_sc + (i % kStages) * kTileRows;
      uint32_t a[2][kWords];
      float sv[2], cv[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        load_chunk<KS>(tile + (g + 8 * h) * kRow + t * 8 * KS, a[h]);
        const float x = __uint_as_float(static_cast<uint32_t>(tsc[g + 8 * h]) << 16);
        const bool ok = x > 0.0f;
        sv[h] = ok ? x : 0.0f;
        cv[h] = ok ? -kMagic * x : kNeg;
      }
      // k-steps outer, groups inner: G independent accumulator chains.
      int acc[kGroups][4];
#pragma unroll
      for (int gi = 0; gi < kGroups; ++gi) {
        acc[gi][0] = acc[gi][1] = acc[gi][2] = acc[gi][3] = 0;
      }
#pragma unroll
      for (int k = 0; k < KS; ++k) {
#pragma unroll
        for (int gi = 0; gi < kGroups; ++gi) {
          mma_s8(acc[gi], a[0][2 * k], a[1][2 * k], a[0][2 * k + 1],
                 a[1][2 * k + 1], bq[gi][2 * k], bq[gi][2 * k + 1]);
        }
      }
#pragma unroll
      for (int gi = 0; gi < kGroups; ++gi) {
        // acc[gi][0..1]: row g, columns 2t and 2t+1; acc[gi][2..3]: row g + 8.
        const float v0 = fmaf(__int_as_float(acc[gi][0] + kMagicBits), sv[0], cv[0]);
        const float v1 = fmaf(__int_as_float(acc[gi][1] + kMagicBits), sv[0], cv[0]);
        const float v2 = fmaf(__int_as_float(acc[gi][2] + kMagicBits), sv[1], cv[1]);
        const float v3 = fmaf(__int_as_float(acc[gi][3] + kMagicBits), sv[1], cv[1]);
        rmax[gi][0] = fmaxf(rmax[gi][0], fmaxf(v0, v2));
        rmax[gi][1] = fmaxf(rmax[gi][1], fmaxf(v1, v3));
      }
      if (cur.row0 + kTileRows >= lens[cur.dl]) {
        // Doc cur.dl is done: max over the 8 row groups.
#pragma unroll
        for (int gi = 0; gi < kGroups; ++gi) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float r = rmax[gi][j];
            r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 4));
            r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 8));
            r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 16));
            if (g == 0 && gi < my_groups) {
              tokmax[cur.dl][(grp0 + gi) * 8 + 2 * t + j] = r > 0.5f * kNeg ? r : 0.0f;
            }
            rmax[gi][j] = kNeg;
          }
        }
      }
    }
    cur = next_tile(cur, lens, ndocs);
  }
  cp_async_wait<0>();
  __syncthreads();

  // Sum each query's scaled per-token maxima in f32, in token order.
  for (int i = threadIdx.x; i < nq * kDocsPerBlock; i += kThreads) {
    const int qi = i / kDocsPerBlock;
    const int d2 = i % kDocsPerBlock;
    if (d2 >= ndocs) continue;
    const float* tm = tokmax[d2] + qi * tq;
    const float* qs = qscales + col_base + (long long)qi * tq;
    float sum = 0.0f;
    for (int k = 0; k < tq; ++k) sum += qs[k] * tm[k];
    out[(long long)(q0 + qi) * nd + doc0 + d2] = sum;
  }
}

// Dynamic shared memory of one block at d = 32 * KS, in bytes.
template <int KS>
constexpr int smem_bytes() {
  return kStages * kTileRows * (32 * KS + 8) + kStages * kTileRows * 2 +
         kDocsPerBlock * kMaxCols * 4 + kDocsPerBlock * 4;
}

template <int KS, int G>
int launch(const void* queries, const void* qscales, const void* grid,
           const void* scales, void* out, int q_n, int tq, int qpb, int nd,
           int td, int n_qblocks, int blocks, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      maxsim_int8_kernel<KS, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<KS>());
  if (err != cudaSuccess) return (int)err;
  maxsim_int8_kernel<KS, G><<<blocks, kThreads, smem_bytes<KS>(), stream>>>(
      static_cast<const int8_t*>(queries), static_cast<const float*>(qscales),
      static_cast<const int8_t*>(grid), static_cast<const uint16_t*>(scales),
      static_cast<float*>(out), q_n, tq, qpb, nd, td, n_qblocks);
  return (int)cudaGetLastError();
}

// The group count: the fewest of 1, 2, 4, 8 that cover a block's columns,
// within the cap for this d.
template <int KS>
int launch_groups(int groups, const void* queries, const void* qscales,
                  const void* grid, const void* scales, void* out, int q_n,
                  int tq, int qpb, int nd, int td, int n_qblocks, int blocks,
                  cudaStream_t stream) {
  constexpr int kCap = KS > 4 ? kMaxGroups / 2 : kMaxGroups;
#define MAXSIM_INT8_LAUNCH(G)                                                \
  if (G >= kCap || groups <= G) {                                            \
    return launch<KS, (G < kCap ? G : kCap)>(queries, qscales, grid, scales, \
                                             out, q_n, tq, qpb, nd, td,      \
                                             n_qblocks, blocks, stream);     \
  }
  MAXSIM_INT8_LAUNCH(1)
  MAXSIM_INT8_LAUNCH(2)
  MAXSIM_INT8_LAUNCH(4)
  MAXSIM_INT8_LAUNCH(8)
#undef MAXSIM_INT8_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// Query-token columns one block holds at dim `d`.
int max_cols(int d) { return d <= 128 ? kMaxCols : kMaxCols / 2; }

}  // namespace

extern "C" {

// Launches the kernel on `stream`. Shapes are checked by the caller: d one of
// 32, 64, 128, 256; tq a multiple of 8 up to 512 (256 at d 256); td a
// multiple of 4; q_n, nd >= 1; 16-byte aligned inputs. Returns
// cudaGetLastError() after the launch.
int maxsim_int8_scores(const void* queries, const void* qscales,
                       const void* grid, const void* scales, void* out,
                       int q_n, int tq, int nd, int td, int d, void* stream) {
  if (tq <= 0 || tq % 8 || tq > max_cols(d) || q_n <= 0 || nd <= 0 ||
      td <= 0 || td % 4) {
    return (int)cudaErrorInvalidValue;
  }
  const int qpb = max_cols(d) / tq;  // whole queries per block
  const int n_qblocks = (q_n + qpb - 1) / qpb;
  const long long blocks =
      (long long)n_qblocks * ((nd + kDocsPerBlock - 1) / kDocsPerBlock);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // Column groups per warp, from the columns a block really holds.
  const int groups = ((qpb < q_n ? qpb : q_n) * tq / 8 + kWarps - 1) / kWarps;
  switch (d) {
    case 32:
      return launch_groups<1>(groups, queries, qscales, grid, scales, out,
                              q_n, tq, qpb, nd, td, n_qblocks, (int)blocks, s);
    case 64:
      return launch_groups<2>(groups, queries, qscales, grid, scales, out,
                              q_n, tq, qpb, nd, td, n_qblocks, (int)blocks, s);
    case 128:
      return launch_groups<4>(groups, queries, qscales, grid, scales, out,
                              q_n, tq, qpb, nd, td, n_qblocks, (int)blocks, s);
    case 256:
      return launch_groups<8>(groups, queries, qscales, grid, scales, out,
                              q_n, tq, qpb, nd, td, n_qblocks, (int)blocks, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* maxsim_int8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
