// Fused MaxSim over a pinned int8 token grid, for Hopper (sm_90a).
//
// Replaces the Pallas kernel nextplaid_tpu/ops/maxsim_kernel.py
// (maxsim_grid_scores_int8i / _kernel_int8i). Per query q and doc n:
//
//   v[t, j]   = float(dot_s32(queries[q*tq + t], grid[n, j])) * scale[n, j]
//               (-1e30 where scale[n, j] is not > 0: an invalid token)
//   m_t       = max_j v[t, j], replaced by 0 if no token of doc n is valid
//   out[q, n] = sum_t qscale[q*tq + t] * m_t        (f32, in token order)
//
// Layout (the port's, not the TPU's): the grid is doc-major [nd, td, d] int8
// with per-token bf16 dequant scales [nd, td]. The Pallas kernel's 128-doc
// token interleave only makes the per-doc max a lane tree-reduce on a TPU;
// here the int8 tensor-core operands must have d contiguous (K-major), and
// the per-doc max runs over the rows of the accumulator tile.
//
// Bound on the H100: operations for a batch, bytes for one query. At the
// `lotte.int8.window2` cell (2,048 query tokens against the pinned LoTTE
// grid [119,461, 224, 128], 19.1M valid tokens, d 128) one 64-query batch
// is 1.00e13 int8 operations, 5.06 ms at 1,979 TOP/s, against 3.4 GB of
// grid (1.0 ms at 3.35 TB/s); one query (32 columns) is bound by the bytes.
// The design (maxsim_wgmma.cuh holds it, shared with the bf16 kernel):
// wgmma m64nNk32 s8 x s8 -> s32 on 64-row doc tiles, A and B from shared
// memory in the 128-byte swizzle (a d-128 row is exactly one panel); a ring
// of tiles and their 64 scales filled by one producer thread's TMA loads
// and handed over by mbarriers; two consumer warpgroups on the same tiles,
// each with its own N <= 256 query-token columns. The epilogue spends three
// instructions on each product (an integer add of the 1.5 * 2^23 bit
// pattern, one fma with the row's scale, which gives exactly
// float(dot) * scale since |dot| < 2^22 and masks a zero-scale row to -1e30
// in the same fma, and one max), so it is as long as the products, and it
// does not run under them: a warpgroup's one group in flight does not keep
// the tensor cores busy, and 256 columns leave no registers for a second
// accumulator (the header lists what was tried). What the kernel does
// instead is keep each doc's end off the products: the 4 warps' fold and
// the token sums run in the producer warpgroup's spare warps. At the
// cell's shape (an H100 80GB HBM3 at 700 W) that takes the kernel from
// 16.8 to 14.0 ms, 30.0 to 36.3% of its bound; its products alone take
// 7.7 ms, with a wait a tile 10.1. One query, bound by the bytes, gains
// 5% (0.853 -> 0.808 ms against [118,272, 160, 128]). A doc's tiles stop
// after its last token with a positive scale (a scan of its scales when the
// block starts); scale 0 stays the mask inside a tile, and rows past td are
// zero-filled by TMA, scales included.
//
// Shapes: d 128 or 256 (one or two panels), any tq up to 256, td a multiple
// of 8 (the scales' TMA map needs 16-byte row strides). The wrapper pads
// other shapes: d with zero features, td with zero-scale tokens; both add
// exactly 0 and mask nothing real.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// Interface: plain C, loaded with ctypes (nextplaid_tpu_torch/ops/maxsim_kernel.py).

#include "maxsim_wgmma.cuh"

extern "C" {

// Dynamic shared memory of one block under a plan, in bytes.
int maxsim_int8_smem_bytes(int n, int n_wg, int panels, int stages) {
  return maxsim::smem_layout(n, n_wg, panels, stages, true).total;
}

// Launches the kernel on `stream`. Shapes are checked by the caller: d 128
// or 256, tq <= n, n one of 32, 64, 128, 256, n_wg 1 or 2, dpb up to 64 docs
// a block, 2 to 8 stages, td a multiple of 8, 16-byte aligned inputs.
// Returns 0 or an error code for maxsim_int8_error_string.
int maxsim_int8_scores(const void* queries, const void* qscales, const void* grid,
                       const void* scales, void* out, int q_n, int tq, int nd, int td, int d,
                       int n, int n_wg, int dpb, int stages, void* stream) {
  if (d != 128 && d != 256) return (int)cudaErrorInvalidValue;
  return maxsim::launch<maxsim::Int8>(queries, grid, scales, scales,
                                      static_cast<const float*>(qscales),
                                      static_cast<float*>(out), q_n, tq, nd, td, d, n, n_wg,
                                      dpb, stages, static_cast<cudaStream_t>(stream));
}

const char* maxsim_int8_error_string(int code) { return maxsim::error_string(code); }

}  // extern "C"
