// Stage 3b of staged search, the reference approximate score, for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel: the JAX package scores the pool with an XLA
// gather (nextplaid_tpu/index/search.py, `_approx_codes_scores`), where the
// port ran the same gather as a loop of eager PyTorch kernels over tiles of
// candidates, each writing and re-reading a [Q, tile, Td, Tq] f32 block of
// looked-up scores. One launch writes
//
//   out[q, i] = sum_{j < Tq, qmask[q, j]} (isfinite(m) ? m : 0),
//   m = max_{t < len} s_t[q, codes[min(off + t, nvec - 1)], j]
//
// for every query q and pool slot i, where id = ids[q, i], safe =
// clamp(id, 0, num_docs_padded - 1), off = doc_offsets[safe] and len =
// min(doclens[safe], td) for id < num_documents, else 0 (a sentinel, an id
// past the live docs: out is 0). An empty max is -inf, so it adds 0; a NaN
// looked up propagates to m, as torch's amax does, and adds 0. That is
// `index/search.py:_approx_codes_scores_eager` ("gather") with the lookups
// and the max exact, and the sum over query tokens taken in f64 and rounded
// once: the exact sum of the same f32 maxima to within about half an f32 ulp,
// where the eager loop's f32 sum carries its own order's rounding (which,
// where the terms cancel, passes a millionth of the score).
//
// Bound on the H100: bytes, and of them the table rows. At the LoTTE staged
// cell's shape (Q 64, pool 4,096, Td 224, Tq 32, K 65,536, ~160 live tokens
// a doc) the looked-up rows are 42M of 128 bytes, 5.4 GB, but they come from
// a per-query table of 8 MB, which L2 (50 MB) holds while one query's
// candidates are scored; device memory sees the table once (0.54 GB), the
// codes (0.17 GB), the ids, doclens and offsets, and the output: ~0.7 GB,
// ~0.2 ms at 3.35 TB/s. The design: one warp a (query, candidate); lane j
// keeps query token j's running max in a register (C columns a lane for Tq
// up to 32 C; past 256 the widest instance walks the doc once a slice of
// 256 columns). A warp loads 32 of the doc's codes at once, one a lane,
// hands them out by shuffle, and reads each code's contiguous row of the
// table, one 128-byte line a row at Tq 32; U rows are in flight at once,
// and a whole run of 32 codes takes them with no per-row length test.
// Slots past the doc's length are not visited. Blocks are ordered query
// by query, so the warps resident on the card at any time read one or two
// queries' tables, which stay in L2. The epilogue is an f64 shuffle sum and
// one f32 store by lane 0.
//
// Shapes: any Tq (not only multiples of 32), pool, td and K; ids int32 or
// int64.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// Interface: plain C, loaded with ctypes (nextplaid_tpu_torch/ops/approx_codes.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps a block, a candidate each
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const float* s_t;  // [Q, K, Tq] centroid scores, -inf rows for masked tokens
  const uint8_t* qmask;  // [Q, Tq] bool
  const void* ids;  // [Q, pool] int32 or int64
  const int* doclens;  // [num_docs_padded]
  const int* doc_offsets;  // [num_docs_padded + 1]
  const int* codes;  // [nvec]
  float* out;  // [Q, pool]
  int ids64, pool, blocks_per_query, k, tq, td, nvec, num_documents, num_docs_padded;
};

// torch's amax: a NaN on either side wins.
__device__ __forceinline__ float max_nan(float m, float v) {
  return (v > m || v != v) ? v : m;
}

// Folds `n` codes' table rows (the codes held one a lane, from lane 0) into
// the running maxima `m` of columns c0 + lane + 32 c. kWhole: n is 32, so
// every one of the U rows in flight is live.
template <int C, int U, bool kWhole>
__device__ __forceinline__ void fold_rows(float (&m)[C], const float* table, int tq, int c0,
                                          int lane, int code, int n) {
  for (int j = 0; j < (kWhole ? 32 : n); j += U) {
    float v[U][C];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float* row = table + static_cast<size_t>(__shfl_sync(kFull, code, j + u)) * tq;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int col = c0 + lane + 32 * c;
        v[u][c] = ((kWhole || j + u < n) && col < tq) ? __ldg(row + col) : -INFINITY;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int c = 0; c < C; ++c) m[c] = max_nan(m[c], v[u][c]);
    }
  }
}

// C columns a lane (c0 + lane + 32 c), U rows in flight; a Tq past 32 C
// takes one walk over the doc a slice of 32 C columns.
template <int C, int U>
__global__ void __launch_bounds__(kThreads) approx_codes_kernel(const Params p) {
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x / p.blocks_per_query;
  const int i = (blockIdx.x % p.blocks_per_query) * kWarps + (threadIdx.x >> 5);
  if (i >= p.pool) return;  // whole warps: the shuffles below see all 32 lanes
  const size_t slot = static_cast<size_t>(q) * p.pool + i;
  const long long id = p.ids64 ? static_cast<const long long*>(p.ids)[slot]
                               : static_cast<const int*>(p.ids)[slot];
  const long long safe = id < 0 ? 0 : (id < p.num_docs_padded ? id : p.num_docs_padded - 1);
  const int len = id < p.num_documents ? min(p.doclens[safe], p.td) : 0;
  const int off = p.doc_offsets[safe];
  const float* table = p.s_t + static_cast<size_t>(q) * p.k * p.tq;
  const uint8_t* qmask = p.qmask + static_cast<size_t>(q) * p.tq;

  double s = 0.0;  // the sum over query tokens, rounded to f32 once at the store
  for (int c0 = 0; c0 < p.tq; c0 += 32 * C) {
    float m[C];
#pragma unroll
    for (int c = 0; c < C; ++c) m[c] = -INFINITY;
    for (int base = 0; base < len; base += 32) {
      const int n = min(32, len - base);
      // The codes are read once a slice: loads that stream past the cache.
      const int code = lane < n ? __ldcs(p.codes + min(off + base + lane, p.nvec - 1)) : 0;
      if (n == 32) {
        fold_rows<C, U, true>(m, table, p.tq, c0, lane, code, n);
      } else {
        fold_rows<C, U, false>(m, table, p.tq, c0, lane, code, n);
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = c0 + lane + 32 * c;
      const bool live = col < p.tq && qmask[col];
      if (live && fabsf(m[c]) < INFINITY) s += m[c];  // finite: neither +-inf nor NaN
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
  if (lane == 0) p.out[slot] = static_cast<float>(s);
}

template <int C, int U>
cudaError_t launch(const Params& p, int q_n, cudaStream_t stream) {
  approx_codes_kernel<C, U><<<q_n * p.blocks_per_query, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Fills out [q_n, pool] f32 on `stream` (the caller allocates it). Returns 0
// or a CUDA error code for approx_codes_error_string; shapes the kernel does
// not take return cudaErrorInvalidValue without a launch.
int approx_codes_scores(const float* s_t, const void* qmask, const void* ids, int ids64,
                        int q_n, int pool, int k, int tq, const int* doclens,
                        const int* doc_offsets, const int* codes, int nvec, int num_documents,
                        int num_docs_padded, int td, float* out, void* stream) {
  if (q_n < 0 || pool < 0 || k <= 0 || tq <= 0 || td < 0 || nvec <= 0 ||
      num_docs_padded <= 0 || num_documents > num_docs_padded) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (q_n == 0 || pool == 0) return 0;
  const int blocks_per_query = (pool + kWarps - 1) / kWarps;
  if (static_cast<long long>(q_n) * blocks_per_query > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p{s_t, static_cast<const uint8_t*>(qmask), ids, doclens, doc_offsets, codes, out,
                 ids64, pool, blocks_per_query, k, tq, td, nvec, num_documents, num_docs_padded};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // Eight table loads in flight a warp whatever the columns; a Tq past 256
  // walks each doc once a slice of 256.
  if (tq <= 32) return static_cast<int>(launch<1, 8>(p, q_n, s));
  if (tq <= 64) return static_cast<int>(launch<2, 4>(p, q_n, s));
  if (tq <= 128) return static_cast<int>(launch<4, 2>(p, q_n, s));
  return static_cast<int>(launch<8, 1>(p, q_n, s));
}

const char* approx_codes_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
