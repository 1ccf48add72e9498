// The staged route's transient union grid, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package builds this grid in a scan of
// jnp tiles that XLA fuses (nextplaid_tpu/index/search.py,
// `_exact_on_candidates_kernel`'s `build_tile`), where the port ran the same
// chain as some fifteen eager PyTorch kernels a tile of docs, each writing a
// temporary the size of the grid or larger. One launch writes every row of
//
//   grid [rows, td_k, d] bf16 and doclens [rows] int32
//
// from the index's packed codes. Row r holds doc id = ids[r] for r < cmax
// (rows past cmax are padding). For a stored doc (0 <= id <
// num_docs_padded), token t < min(doclens[id], td) is
//
//   v = centroids[codes[off + t]] + bucket_weights[bucket(residuals[off + t])]
//   grid[r, t] = bf16(v / max(||v||, 1e-12))                  (off = doc_offsets[id])
//
// in f32 with IEEE square root and division, rounded once to bf16
// (`ops/codec.py:decompress_residuals` then `.to(torch.bfloat16)`; only the
// order of the sum of squares differs). Every other token row, of every
// row, is zero. doclens[r] is doclens[id] for 0 <= id < num_documents, else
// 0 (`index/search.py:_union_doclens`). The buckets are unpacked in the
// codec's bit order: dim j's value sits in byte j / (8 / nbits) at shift
// 8 - nbits * (j % (8 / nbits) + 1), its nbits bits reversed.
//
// Bound on the H100: bytes. At the LoTTE stage-4 shape (65,536 rows x td_k
// 224 x d 128, nbits 2, ~7.7M live tokens) the grid is 3.76 GB written; a
// live token reads a 4-byte code and 32 bytes of residual (0.28 GB in all)
// and a 512-byte centroid row of a 32 MB table that L2 mostly holds
// (counted once): ~4.0 GB of device memory, ~1.2 ms at 3.35 TB/s. The design: one block a
// grid row, a group of `lanes` lanes a token, each lane 8 dims (16 lanes a
// token at d 128, so a warp takes two tokens at once). A lane loads its
// dims' packed bits and two float4 of centroid, adds the bucket weights
// (from shared memory), and the token's lanes sum the squares by warp
// shuffles; it stores its 8 bf16 as one 16-byte streaming store, so a warp
// writes whole rows. The next slot's code and bits load while this slot's
// centroid row does. The walk stops at the doc's last live step; the rest
// of the row (all of it for a sentinel or a padding row) is zeroed by
// flat 16-byte stores. Per element the work is a handful of instructions
// (an IEEE division is the largest): with 4 dims a lane and the dead slots
// walked token by token the kernel was bound by instruction issue (PERF.md
// has the measured steps).
//
// Shapes: d a multiple of 16 up to 256 (the bf16 MaxSim kernel's), nbits 1,
// 2, 4 or 8, any td <= td_k and rows >= cmax; 16-byte aligned inputs.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// Interface: plain C, loaded with ctypes (nextplaid_tpu_torch/ops/union_grid.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 8;  // blocks an SM: 64 warps
constexpr int kDims = 8;  // dims a lane owns: one 16-byte store of bf16

struct Params {
  const void* ids;  // [cmax] int32 or int64
  const int* doclens;  // [num_docs_padded]
  const int* doc_offsets;  // [num_docs_padded + 1]
  const int* codes;  // [ntok]
  const uint8_t* residuals;  // [ntok, packed_dim]
  const float* centroids;  // [K, d]
  const float* bucket_weights;  // [2^nbits]
  __nv_bfloat16* grid;  // [rows, td_k, d]
  int* out_doclens;  // [rows]
  int ids64, cmax, num_documents, num_docs_padded;
  int td, td_k, d, packed_dim, lanes;
};

// Where a lane's tokens and dims lie in its block's row.
struct Lanes {
  int first;  // the lane's first token slot
  int step;  // token slots the block takes at once
  int c, L;  // the lane's chunk of kDims dims (valid below d / kDims), lanes a token
  bool owns;  // c < d / kDims
  int len, off;  // the doc's live tokens and its first token
};

// One token of a lane: its code and the packed bits of its chunk.
struct Token {
  int code;
  uint64_t bits;
};

// The packed bits of dims 8c .. 8c + 7 of one token's residual row (nbits
// bytes from byte c * nbits), the first byte in the low 8 bits. Codes and
// residuals are read once: loads that stream past the cache (`__ldcs`).
template <int NBITS>
__device__ __forceinline__ uint64_t load_bits(const uint8_t* row, int c) {
  const uint8_t* at = row + c * NBITS;
  if constexpr (NBITS == 1) {
    return __ldcs(at);
  } else if constexpr (NBITS == 2) {
    return __ldcs(reinterpret_cast<const unsigned short*>(at));
  } else if constexpr (NBITS == 4) {
    return __ldcs(reinterpret_cast<const unsigned int*>(at));
  } else {
    return __ldcs(reinterpret_cast<const unsigned long long*>(at));
  }
}

// Bucket of dim 8c + i from load_bits: the codec's byte and shift, then the
// nbits-bit reversal.
template <int NBITS>
__device__ __forceinline__ int bucket(uint64_t bits, int c, int i) {
  constexpr int vpb = 8 / NBITS;
  const int j = kDims * c + i;
  const int byte = j / vpb - (kDims * c) / vpb;
  const int pos = 8 * byte + 8 - NBITS * (j % vpb + 1);
  const uint32_t v = static_cast<uint32_t>(bits >> pos) & ((1u << NBITS) - 1);
  return static_cast<int>(__brev(v) >> (32 - NBITS));
}

// The lane's token in slot t (zeros for a dead slot).
template <int NBITS>
__device__ __forceinline__ Token load_token(const Params& p, const Lanes& w, int t) {
  Token x{0, 0};
  if (t < w.len) {
    const int tok = w.off + t;
    x.code = __ldcs(p.codes + tok);
    if (w.owns) {
      x.bits = load_bits<NBITS>(p.residuals + static_cast<size_t>(tok) * p.packed_dim, w.c);
    }
  }
  return x;
}

// Decompresses the lane's token in slot t and stores its chunk (zeros for
// a dead slot). Every lane of the warp calls it: the norm is a shuffle.
template <int NBITS>
__device__ __forceinline__ void emit_token(const Params& p, const Lanes& w, int t,
                                           const Token& x, const float* weights,
                                           __nv_bfloat16* out_row) {
  const bool live = t < w.len && w.owns;
  float v[kDims];
  float ss = 0.f;
  if (live) {
    const float4* cent =
        reinterpret_cast<const float4*>(p.centroids + static_cast<size_t>(x.code) * p.d) + 2 * w.c;
    const float4 c0 = __ldg(cent), c1 = __ldg(cent + 1);
    const float c[kDims] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
    for (int i = 0; i < kDims; ++i) {
      v[i] = __fadd_rn(c[i], weights[bucket<NBITS>(x.bits, w.c, i)]);
      ss = __fadd_rn(ss, __fmul_rn(v[i], v[i]));
    }
  }
  // The token's lanes are an aligned group of L: xor offsets below L stay in it.
  for (int m = w.L >> 1; m > 0; m >>= 1) ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, m));
  if (t >= p.td_k || !w.owns) return;
  uint4 packed = make_uint4(0u, 0u, 0u, 0u);
  if (live) {
    const float norm = fmaxf(__fsqrt_rn(ss), 1e-12f);
    uint32_t h[kDims / 2];
#pragma unroll
    for (int i = 0; i < kDims / 2; ++i) {
      const __nv_bfloat162 b =
          __floats2bfloat162_rn(__fdiv_rn(v[2 * i], norm), __fdiv_rn(v[2 * i + 1], norm));
      h[i] = *reinterpret_cast<const uint32_t*>(&b);
    }
    packed = make_uint4(h[0], h[1], h[2], h[3]);
  }
  // Written once and read by the next kernel: a streaming store.
  __stcs(reinterpret_cast<uint4*>(out_row + static_cast<size_t>(t) * p.d) + w.c, packed);
}

// One block a grid row: the doc's live tokens a lane group each, then its
// dead tail (and all of a sentinel's or a padding row's) as flat zeros.
template <int NBITS>
__global__ void __launch_bounds__(kThreads, kMinBlocks) union_grid_kernel(const Params p) {
  __shared__ float weights[1 << NBITS];
  for (int i = threadIdx.x; i < (1 << NBITS); i += kThreads) weights[i] = p.bucket_weights[i];

  const int row = blockIdx.x;
  long long id = -1;
  if (row < p.cmax) {
    id = p.ids64 ? static_cast<const long long*>(p.ids)[row]
                 : static_cast<const int*>(p.ids)[row];
  }
  const bool stored = id >= 0 && id < p.num_docs_padded;
  if (threadIdx.x == 0) {
    p.out_doclens[row] = (id >= 0 && id < p.num_documents) ? p.doclens[id] : 0;
  }
  const int lane = threadIdx.x & 31;
  Lanes w;
  w.L = p.lanes;
  w.c = lane % w.L;
  w.owns = w.c < p.d / kDims;
  const int tpw = 32 / w.L;  // tokens a warp takes at once
  w.first = (threadIdx.x >> 5) * tpw + lane / w.L;
  w.step = kWarps * tpw;
  w.len = stored ? min(p.doclens[id], p.td) : 0;
  w.off = stored ? p.doc_offsets[id] : 0;
  __nv_bfloat16* out_row = p.grid + static_cast<size_t>(row) * p.td_k * p.d;

  Token cur = load_token<NBITS>(p, w, w.first);
  __syncthreads();  // the weights
  int t0 = 0;
  for (; t0 < w.len; t0 += w.step) {
    // The next slot's code and bits load while this one's centroid row does.
    const Token next = load_token<NBITS>(p, w, t0 + w.step + w.first);
    emit_token<NBITS>(p, w, t0 + w.first, cur, weights, out_row);
    cur = next;
  }
  if (t0 < p.td_k) {
    uint4* tail = reinterpret_cast<uint4*>(out_row + static_cast<size_t>(t0) * p.d);
    const int n = (p.td_k - t0) * p.d / 8;  // 16-byte stores
    for (int i = threadIdx.x; i < n; i += kThreads) __stcs(tail + i, make_uint4(0u, 0u, 0u, 0u));
  }
}

template <int NBITS>
cudaError_t launch(const Params& p, int rows, cudaStream_t stream) {
  union_grid_kernel<NBITS><<<rows, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Fills grid [rows, td_k, d] bf16 and doclens [rows] int32 on `stream`
// (the caller allocates both). Returns 0 or a CUDA error code for
// union_grid_error_string; shapes the kernel does not take return
// cudaErrorInvalidValue without a launch.
int union_grid_fill(const void* ids, int ids64, int cmax, const int* doclens,
                    const int* doc_offsets, const int* codes, const void* residuals,
                    const float* centroids, const float* bucket_weights, int nbits,
                    int num_documents, int num_docs_padded, int td, void* grid,
                    int* out_doclens, int rows, int td_k, int d, void* stream) {
  if (d <= 0 || d % 16 || d > 256 || td < 0 || td > td_k || cmax < 0 || rows < cmax ||
      num_documents > num_docs_padded) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  int lanes = 1;  // a token's lanes: a power of two holding its d / 8 chunks
  while (lanes < d / kDims) lanes <<= 1;
  const Params p{ids, doclens, doc_offsets, codes, static_cast<const uint8_t*>(residuals),
                 centroids, bucket_weights, static_cast<__nv_bfloat16*>(grid), out_doclens,
                 ids64, cmax, num_documents, num_docs_padded, td, td_k, d, d * nbits / 8,
                 lanes};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (nbits) {
    case 1: err = launch<1>(p, rows, s); break;
    case 2: err = launch<2>(p, rows, s); break;
    case 4: err = launch<4>(p, rows, s); break;
    case 8: err = launch<8>(p, rows, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

const char* union_grid_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
