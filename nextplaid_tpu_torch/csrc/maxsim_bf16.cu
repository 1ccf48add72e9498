// Fused MaxSim over the pinned bf16 token grid, for Hopper (sm_90a).
//
// Replaces the Pallas kernel nextplaid_tpu/ops/maxsim_kernel.py
// (maxsim_grid_scores / _kernel). It computes
//
//   scores[q, n] = sum_{t < tq} max_{j < doclens[n]} <queries[q*tq + t], grid[n, j]>
//
// with bf16 products accumulated in f32 on the tensor cores, the per-token
// maxima kept on chip, and the sum over query tokens taken in f32, in token
// order. Only the [Q, ND] scores reach device memory. A doc with doclens == 0
// scores 0; token rows at or beyond doclens are masked by their index, not
// by their value (a zero padding row would otherwise beat a real token whose
// similarities are all negative).
//
// Bound on the H100: operations. At the SciFact pass (10,240 query tokens
// against 5,696 grid rows x Td 304 x d 128) one call is ~3.8 TFLOP of bf16
// products on the docs' real tokens over a 443 MB grid, ~8,500 operations a
// byte where ~295 leave the memory bound; the staged stage 4 (2,048 query
// tokens against [65536, 224, 128]) is the same kind. Only wgmma reaches
// the tensor cores' rate, and it must be fed without the warps that start
// it waiting on loads. The design (maxsim_wgmma.cuh holds it, shared with
// the int8 kernel): wgmma m64nNk16 on 64-row doc tiles, A and B from
// shared memory in the 128-byte swizzle; a ring of tiles filled by one
// producer thread's TMA loads and handed over by mbarriers; two consumer
// warpgroups on the same tiles, each with its own N <= 256 query-token
// columns, so a tile read once from L2 meets up to 512 columns; the per-doc
// max taken in registers on the accumulator's layout, a full tile without
// any mask, the doc's last tile masked by row index; the walk stops at the
// doc's length, so padding costs at most the rest of one 64-row tile. At
// the main paths' shapes the kernel draws the card's full power (700 W) and
// its time is the products': the reduction adds nothing to it.
//
// Shapes: d a multiple of 64 up to 256 (a row is d / 64 panels of 128
// bytes; d 128 is the main paths'), any tq up to 256, any td and nd. The
// wrapper pads other d (multiples of 16) with zero features, which add
// exactly 0 to every product; the caller's plan picks N from the columns
// the call has, so one query does not pay for 512 columns.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// Interface: plain C, loaded with ctypes (nextplaid_tpu_torch/ops/maxsim_kernel.py).

#include "maxsim_wgmma.cuh"

extern "C" {

// Dynamic shared memory of one block under a plan, in bytes.
int maxsim_bf16_smem_bytes(int n, int n_wg, int panels, int stages) {
  return maxsim::smem_layout(n, n_wg, panels, stages, false).total;
}

// Launches the kernel on `stream`. Shapes are checked by the caller: d a
// multiple of 64 up to 256, tq <= n, n one of 32, 64, 128, 256, n_wg 1 or 2,
// dpb up to 64 docs a block, 2 to 8 stages, 16-byte aligned inputs. Returns
// 0 or an error code for maxsim_bf16_error_string.
int maxsim_bf16_scores(const void* queries, const void* grid, const int* doclens, float* out,
                       int q_n, int tq, int nd, int td, int d, int n, int n_wg, int dpb,
                       int stages, void* stream) {
  if (d <= 0 || d % 64 || d > 256) return (int)cudaErrorInvalidValue;
  return maxsim::launch<maxsim::Bf16>(queries, grid, nullptr, doclens, nullptr, out, q_n, tq,
                                      nd, td, d * 2, n, n_wg, dpb, stages,
                                      static_cast<cudaStream_t>(stream));
}

const char* maxsim_bf16_error_string(int code) { return maxsim::error_string(code); }

}  // extern "C"
