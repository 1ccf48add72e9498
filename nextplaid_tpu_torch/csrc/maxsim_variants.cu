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
//
// Every variant is an instance of the served kernels' design, the template
// of maxsim_wgmma.cuh (wgmma m64nN on 64-row doc tiles, a TMA ring handed
// over by mbarriers from one producer thread to two consumer warpgroups of
// up to 256 query-token columns each), under a Policy that picks:
//   - the mask input: kLens compares the row index with doclens[n] and stops
//     a doc's walk at its length (the served bf16 kernel's rule); kAdditive
//     brings an f32 mask value a row into the ring beside each tile (a 2-D
//     TMA map, one 64-value box a tile, on the tile's full mbarrier, as the
//     int8 kernel brings its scales), adds it before the max and walks all
//     ceil(td / 64) tiles of every doc. The Pallas script's 2-D [ND, Td] and
//     flat [ND*Td, 1] mask layouts differ only in TPU lane/sublane placement;
//     here both are the same row-major memory;
//   - the row reduction: kRegisters keeps each doc's running max on the
//     accumulator's layout and folds it with shuffles (the served fold);
//     kShared stages every tile's accumulator in shared memory and scans its
//     columns there (the counterparts of concatenate / scratch / fold);
//   - the rows a ring stage holds (64 or 128: one or two m64 products
//     between two mbarrier waits, the Hopper counterpart of the Pallas
//     `sub`), with docs per block (1..64) the caller's;
//   - the dots-only probe (kDots): the same loads and products with a SUM in
//     one accumulator across all tiles, wrong by design, defined as
//     kernel_dotsonly: out[n, q] is the sum, over every token row of the dpb
//     docs of n's block and every token of query q, of the products. It
//     isolates what the mask, max and epilogue cost.
// The plan (N, warpgroups, ring stages) comes from plan_variant in
// nextplaid_tpu_torch/ops/maxsim_kernel.py, beside the served plan.
//
// Bound on the H100: operations. At the sweep's shape (2,048 query tokens
// against 5,184 docs x Td 384 x d 128) the valid rows' (996,738) products
// are 0.52 TFLOP (0.528 ms at 989 TFLOP/s); the additive variants and the
// probe multiply every row (1,990,656): 1.04 TFLOP, 1.055 ms. The grid is
// 510 MB (0.152 ms at 3.35 TB/s).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// Interface: plain C, loaded with ctypes (nextplaid_tpu_torch/ops/maxsim_variants.py).

#include "maxsim_wgmma.cuh"

namespace {

using maxsim::Bf16;
using maxsim::kAdditive;
using maxsim::kDots;
using maxsim::kLens;
using maxsim::kRegisters;
using maxsim::kShared;

template <int MASK, int REDUCE, int SUB>
using Variant = maxsim::Policy<MASK, REDUCE, SUB, true>;

// Calls fn with a value of the Policy type of (mask, reduce, sub); the
// probe ignores `reduce`. Returns cudaErrorInvalidValue for an unknown one.
template <class Fn>
int dispatch(int mask, int reduce, int sub, Fn fn) {
  if (sub != 1 && sub != 2) return (int)cudaErrorInvalidValue;
  const bool two = sub == 2;
  if (mask == kDots) {
    return two ? fn(Variant<kDots, kRegisters, 2>()) : fn(Variant<kDots, kRegisters, 1>());
  }
  if (mask == kLens && reduce == kRegisters) {
    return two ? fn(Variant<kLens, kRegisters, 2>()) : fn(Variant<kLens, kRegisters, 1>());
  }
  if (mask == kLens && reduce == kShared) {
    return two ? fn(Variant<kLens, kShared, 2>()) : fn(Variant<kLens, kShared, 1>());
  }
  if (mask == kAdditive && reduce == kRegisters) {
    return two ? fn(Variant<kAdditive, kRegisters, 2>()) : fn(Variant<kAdditive, kRegisters, 1>());
  }
  if (mask == kAdditive && reduce == kShared) {
    return two ? fn(Variant<kAdditive, kShared, 2>()) : fn(Variant<kAdditive, kShared, 1>());
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block of a variant under a plan, in bytes.
int maxsim_variants_smem_bytes(int n, int n_wg, int panels, int stages, int mask, int reduce,
                               int sub) {
  return dispatch(mask, reduce, sub, [&](auto v) {
    return maxsim::smem_bytes<Bf16, decltype(v)>(n, n_wg, panels, stages);
  });
}

// Launches one variant on `stream`. mask: 0 doclens [nd] int32, 1 additive
// f32 mask [nd, mask_cols] (mask_cols >= td, a multiple of 4), 2 the
// dots-only probe (no mask input is read). reduce: 0 registers, 1 shared
// memory (ignored by the probe). sub: 64-row tiles a ring stage holds (1 or
// 2). Shapes are checked by the caller: d a multiple of 64 up to 256,
// tq <= n, n one of 32, 64, 128, 256, n_wg 1 or 2, 1 <= dpb <= 64, 2 to 8
// stages, 16-byte aligned inputs. Out is [nd, q_n] f32. Returns 0 or an
// error code for maxsim_variants_error_string.
int maxsim_variants_scores(const void* queries, const void* grid, const void* mask_or_lens,
                           float* out, int q_n, int tq, int nd, int td, int mask_cols, int d,
                           int mask, int reduce, int sub, int n, int n_wg, int dpb, int stages,
                           void* stream) {
  if (d <= 0 || d % 64 || d > 256) return (int)cudaErrorInvalidValue;
  const void* lens = mask == kLens ? mask_or_lens : nullptr;
  const void* side = mask == kAdditive ? mask_or_lens : nullptr;
  return dispatch(mask, reduce, sub, [&](auto v) {
    return maxsim::launch<Bf16, decltype(v)>(queries, grid, side, lens, nullptr, out, q_n, tq, nd,
                                             td, d * 2, n, n_wg, dpb, stages,
                                             static_cast<cudaStream_t>(stream), mask_cols);
  });
}

const char* maxsim_variants_error_string(int code) { return maxsim::error_string(code); }

}  // extern "C"
