// Shared device and host code of the MaxSim kernels (maxsim_bf16.cu,
// maxsim_int8.cu and the variant family maxsim_variants.cu): one kernel
// template for Hopper (sm_90a), instantiated for bf16 and for int8 token
// grids. The served kernels take the default Policy; the variant family
// (bf16 only) picks, at compile time, the mask input (doc lengths, an
// additive f32 row mask, or the dots-only probe's sum), the row reduction
// (registers, or a column scan in shared memory), the 64-row tiles a ring
// stage holds (1 or 2) and a doc-major output.
//
// The design, common to both types:
//   - a block has three warpgroups: two consumers and one producer. The
//     producer's one elected thread starts TMA tensor loads; the consumers
//     start wgmma products and reduce them in registers;
//   - a consumer warpgroup owns N query-token columns (whole queries, N one
//     of 32, 64, 128, 256, chosen by the caller from the columns the call
//     really has). They are the B operand, loaded once by TMA into shared
//     memory and kept for the block's life. A block's two warpgroups hold
//     neighbouring query groups and read the same doc tiles, so a tile
//     fetched once from L2 meets up to 512 columns;
//   - a block walks `dpb` docs. Each doc's rows go through a ring of 64-row
//     tiles in shared memory (the A operand), one TMA load a 128-byte panel
//     of the rows, with a full and an empty mbarrier a stage: no block-wide
//     barrier in the steady state. The TMA map is 3-D over [nd, td, row
//     bytes], so rows past td are zero-filled by the hardware and never
//     reach into the next doc or past the allocation; the walk stops at the
//     doc's last valid row, so padding costs at most the rest of one tile;
//   - both operands are K-major with the 128-byte swizzle that TMA writes
//     and the wgmma descriptor names, so a row of 128 int8 (or 64 bf16)
//     features is one panel and a k-step advances the descriptor by 32
//     bytes inside it; wider rows are more panels;
//   - TMA rather than cp.async: the copy needs no registers or address
//     arithmetic in the consumers, the swizzle and the zero fill past td
//     come free, and completion lands on the mbarrier the consumers wait on;
//   - the accumulator (64 x N, N/2 registers a thread) is reduced where it
//     lies: thread (warp w, lane l) holds rows 16w + l/4 and + 8 and column
//     pairs 8j + 2(l%4), so a running max per column spans the doc's tiles
//     in N/4 registers; when the doc ends, a halving exchange of three
//     shuffle steps folds the 8 row groups, shared memory folds the 4
//     warps, and the query's tokens are summed in f32 in token order;
//   - at N 256 the consumers need about 200 registers, so the producer gives
//     its registers up (setmaxnreg 40) and the consumers take 232.
// What was tried and did not pay on an H100 (PERF.md has the times): making
// the two warpgroups take turns at the tensor cores with named barriers (a
// barrier on a branch next to wgmma also makes ptxas serialize the
// products); two accumulators of N/2 a warpgroup, one multiplied while the
// other is reduced (m64n128 products are slower than m64n256); an integer
// epilogue for int8. The bf16 kernel runs at the card's power limit; in the
// int8 kernel the products and the reduction take turns rather than overlap.
//
// Build: included by the three sources; no separate compilation.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time
#include <cuda_runtime.h>

#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace maxsim {

constexpr int kTileRows = 64;     // rows of one wgmma A tile
constexpr int kPanelBytes = 128;  // bytes of a row in one swizzle panel
constexpr int kTilePanelBytes = kTileRows * kPanelBytes;
constexpr int kConsumers = 2;     // consumer warpgroups of a block
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kMaxDocsPerBlock = 64;
constexpr int kMaxStages = 8;
constexpr int kScratchPad = 8;    // f32 past N in a scratch row (conflict-free float2 stores)
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use
constexpr int kEncodeFailed = 100000;  // error codes above cudaError_t's

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Waits until the barrier's phase differs from `parity`. A wait that never
// ends (a fault in the pipeline) traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  for (unsigned spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1u << 24)) __trap();
  }
}

// TMA tensor loads into shared memory; completion is counted on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most `Pending` of this thread's committed groups are open.
template <int Pending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(Pending) : "memory");
}
// Barrier among the 128 threads of one consumer warpgroup (ids 1 and 2;
// id 0 is __syncthreads').
__device__ __forceinline__ void group_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// Shared-memory matrix descriptor of a K-major operand in the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1,024 bytes apart (SBO 64 in
// 16-byte units; LBO is not read for this layout and set to 1). The tile
// base is 1,024-byte aligned, so the base offset is 0. A k-step of 32 bytes
// adds 2 to the address field; a panel adds its bytes / 16.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

#define MAXSIM_F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define MAXSIM_F16(d, i) \
  MAXSIM_F4(d, i), MAXSIM_F4(d, i + 4), MAXSIM_F4(d, i + 8), MAXSIM_F4(d, i + 12)
#define MAXSIM_R4(d, i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])
#define MAXSIM_R16(d, i) \
  MAXSIM_R4(d, i), MAXSIM_R4(d, i + 4), MAXSIM_R4(d, i + 8), MAXSIM_R4(d, i + 12)

// One wgmma of a 64-row A tile by n columns of B, both from shared memory,
// over one k-step of 32 bytes; n is twice the accumulator's length. The
// accumulator is overwritten when scale_d is 0, added to otherwise.

__device__ __forceinline__ void wgmma_bf16(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : MAXSIM_F16(d, 0)
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : MAXSIM_F16(d, 0), MAXSIM_F16(d, 16)
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : MAXSIM_F16(d, 0), MAXSIM_F16(d, 16), MAXSIM_F16(d, 32), MAXSIM_F16(d, 48)
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      : MAXSIM_F16(d, 0), MAXSIM_F16(d, 16), MAXSIM_F16(d, 32), MAXSIM_F16(d, 48), MAXSIM_F16(d, 64), MAXSIM_F16(d, 80), MAXSIM_F16(d, 96), MAXSIM_F16(d, 112)
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[16], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p;\n}\n"
      : MAXSIM_R16(d, 0)
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      : MAXSIM_R16(d, 0), MAXSIM_R16(d, 16)
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : MAXSIM_R16(d, 0), MAXSIM_R16(d, 16), MAXSIM_R16(d, 32), MAXSIM_R16(d, 48)
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n}\n"
      : MAXSIM_R16(d, 0), MAXSIM_R16(d, 16), MAXSIM_R16(d, 32), MAXSIM_R16(d, 48), MAXSIM_R16(d, 64), MAXSIM_R16(d, 80), MAXSIM_R16(d, 96), MAXSIM_R16(d, 112)
      : "l"(da), "l"(db), "r"(scale_d));
}

#undef MAXSIM_F4
#undef MAXSIM_F16
#undef MAXSIM_R4
#undef MAXSIM_R16

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

constexpr float kNeg = -1e30f;          // the Pallas int8 kernel's mask value
constexpr int kMagicBits = 0x4B400000;  // 1.5 * 2^23 as an f32 bit pattern
constexpr float kMagic = 12582912.0f;   // 1.5 * 2^23

// The two element types. kScales: rows carry a bf16 dequant scale, scale 0
// is the mask, and query tokens carry an f32 scale (the int8 contract);
// otherwise rows are masked by index against the doc's length (bf16).
struct Bf16 {
  using Acc = float;
  static constexpr bool kScales = false;
  static constexpr int kElemBytes = 2;
  template <int H>
  static __device__ __forceinline__ void mma(float (&d)[H], uint64_t a, uint64_t b, int s) {
    wgmma_bf16(d, a, b, s);
  }
};
struct Int8 {
  using Acc = int;
  static constexpr bool kScales = true;
  static constexpr int kElemBytes = 1;
  template <int H>
  static __device__ __forceinline__ void mma(int (&d)[H], uint64_t a, uint64_t b, int s) {
    wgmma_s8(d, a, b, s);
  }
};

// What marks a doc's valid rows, and what is taken over them:
//   kLens     bf16: the rows below the doc's length (doclens), max over
//             them; int8: the rows with a positive scale (the type decides);
//   kAdditive bf16: an f32 value a row ([nd, td] in device memory; 0 or
//             -1e30 in the sweep) added before the max. Every row is
//             walked: the mask need not be a prefix, so no length is
//             derived from it. A doc whose maxima all stay below -1e30 / 2
//             scores 0;
//   kDots     the sweep's dots-only probe: no mask, every row of the
//             block's docs SUMMED in one accumulator (scale-d 1 across
//             tiles, no per-tile epilogue); each doc of the block gets the
//             block's sum. Wrong by design: it times the products and feed.
enum Mask : int { kLens = 0, kAdditive = 1, kDots = 2 };
// Where a tile's row max is taken: in registers on the accumulator's layout
// (kRegisters), or by a column scan of the accumulator staged in shared
// memory (kShared; [n_wg][64][N + pad] f32 of scratch).
enum Reduce : int { kRegisters = 0, kShared = 1 };

// An instance's compile-time choices. SUB: 64-row tiles a ring stage holds,
// the products between two mbarrier waits. DOC_MAJOR: out is [nd, q_n]
// (the variant family's), else [q_n, nd] (the served kernels').
template <int MASK = kLens, int REDUCE = kRegisters, int SUB = 1, bool DOC_MAJOR = false>
struct Policy {
  static constexpr int kMask = MASK;
  static constexpr int kReduce = REDUCE;
  static constexpr int kSub = SUB;
  static constexpr bool kDocMajor = DOC_MAJOR;
};
using Served = Policy<>;

struct Params {
  const void* lens_src;  // bf16 kLens: doclens [nd] int32; int8: scales [nd, td] bf16 bits
  const float* qscales;  // int8 only: [q_n * tq]
  float* out;            // [q_n, nd], or [nd, q_n] under DOC_MAJOR
  int q_n, tq, nd, td;
  int qpw;          // whole queries a warpgroup owns (qpw * tq <= N)
  int n_wg;         // query groups (consumer warpgroups at work) a block takes
  int dpb;          // docs a block walks
  int n_qblocks;    // blocks per doc group; they are neighbours in blockIdx
  int panels;       // 128-byte panels of a row
  int panel_elems;  // features of a panel (TMA coordinates count elements)
  int stages;       // tiles in the ring
};

// Offsets of a block's dynamic shared memory, from a 1,024-byte aligned base.
// sub: tiles a stage; side: bytes of a tile's side input (the additive
// mask's 64 f32; int8's 64 bf16 scales come with `scales`); scratch: the
// shared-memory row reduction's staging.
struct Layout {
  int b, ring, sc, scratch, wmax, colmax, qs, lens, bars, total;
};
__host__ __device__ inline Layout smem_layout(int n, int n_wg, int panels, int stages,
                                              bool scales, int sub = 1, int side = 0,
                                              bool scratch = false) {
  Layout l;
  int off = 0;
  l.b = off;  // [n_wg][panels][n rows][128 bytes], swizzled
  off += n_wg * panels * n * kPanelBytes;
  l.ring = off;  // [stages][sub][panels][64 rows][128 bytes], swizzled
  off += stages * sub * panels * kTilePanelBytes;
  l.sc = off;  // [stages][sub][64] bf16 row scales or f32 row mask values
  off += stages * sub * (scales ? kTileRows * 2 : side);
  l.scratch = off;  // [n_wg][64 rows][n + pad] f32
  off += scratch ? n_wg * kTileRows * (n + kScratchPad) * 4 : 0;
  l.wmax = off;  // [consumers][4 warps][n] f32
  off += kConsumers * 4 * n * 4;
  l.colmax = off;  // [consumers][n] f32
  off += kConsumers * n * 4;
  l.qs = off;  // [consumers][n] f32 query-token scales
  off += scales ? kConsumers * n * 4 : 0;
  l.lens = off;
  off += kMaxDocsPerBlock * 4;
  l.bars = off;  // full[kMaxStages], empty[kMaxStages], queries
  off += (2 * kMaxStages + 1) * 8;
  l.total = off + 1024;  // slack to align the base
  return l;
}

// Max over the 8 row groups of a warp (lane bits 2-4) of C values a lane,
// by halving: at each of three steps a lane keeps one half of its values
// and trades the other half with the lane across, so 7 C / 8 shuffles do
// what 3 C would. Afterwards v[0 .. C/8) of the lane in row group g are the
// maxima of the original indices g * C/8 + r. SUM: sums instead of maxima.
template <int HALF, int MASK, int C, bool SUM>
__device__ __forceinline__ void fold_step(float (&v)[C], int lane) {
  const bool upper = (lane & MASK) != 0;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = upper ? v[i] : v[i + HALF];
    const float keep = upper ? v[i + HALF] : v[i];
    const float other = __shfl_xor_sync(0xffffffffu, send, MASK);
    v[i] = SUM ? keep + other : fmaxf(keep, other);
  }
}
template <int C, bool SUM = false>
__device__ __forceinline__ void fold_rows(float (&v)[C], int lane) {
  fold_step<C / 2, 16, C, SUM>(v, lane);
  fold_step<C / 4, 8, C, SUM>(v, lane);
  fold_step<C / 8, 4, C, SUM>(v, lane);
}

// Writes a warp's folded columns (fold_rows' v[0 .. C/8) of row group g)
// into its row of wmax [4 warps][N].
template <int N, int C>
__device__ __forceinline__ void store_folded(const float (&v)[C], float* wmax, int warp, int g,
                                             int t4) {
  constexpr int kKeep = C / 8;  // columns this lane holds after the fold
  const int first = g * kKeep;  // index of v[0] among the C
  if constexpr (kKeep == 1) {
    wmax[warp * N + 8 * (first >> 1) + 2 * t4 + (first & 1)] = v[0];
  } else {
#pragma unroll
    for (int r = 0; r < kKeep; r += 2) {
      *reinterpret_cast<float2*>(wmax + warp * N + 8 * ((first + r) >> 1) + 2 * t4) =
          make_float2(v[r], v[r + 1]);
    }
  }
}

// Stages a tile's accumulator (H registers: rows g and g + 8 of the warp's
// 16, column pairs 8j + 2 t4) in scratch [64 rows][N + kScratchPad] f32.
template <int N, int H>
__device__ __forceinline__ void stage_tile(const float (&acc)[H], float* scratch, int warp, int g,
                                           int t4) {
  constexpr int kLd = N + kScratchPad;
  float* row = scratch + (warp * 16 + g) * kLd + 2 * t4;
#pragma unroll
  for (int j = 0; j < H / 4; ++j) {
    *reinterpret_cast<float2*>(row + 8 * j) = make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(row + 8 * kLd + 8 * j) = make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// The products of one 64-row tile (descriptor da0) with a warpgroup's
// columns (descriptor db0) into `acc`, as one wgmma group; added to `acc`
// if `accumulate`, else overwriting it.
template <class T, int H>
__device__ __forceinline__ void multiply_tile(typename T::Acc (&acc)[H], uint64_t da0, uint64_t db0,
                                           int panels, int b_panel_units,
                                           bool accumulate = false) {
  wgmma_fence();
  for (int pp = 0; pp < panels; ++pp) {
    const uint64_t da = da0 + pp * (kTilePanelBytes >> 4);
    const uint64_t db = db0 + pp * b_panel_units;
#pragma unroll
    for (int k = 0; k < 4; ++k) T::mma(acc, da + 2 * k, db + 2 * k, accumulate || (pp | k) != 0);
  }
  wgmma_commit();
}

// Folds the accumulator (H registers: rows g and g + 8 of H / 2 columns)
// into the running maxima rmax.
// int8: int -> float through the 1.5 * 2^23 bit pattern, then one fma with
// the row's scale: exactly float(dot) * scale (|dot| < 2^22); a masked row
// (sv 0, cv -1e30) gets -1e30 from the same fma.
template <int H, int C>
__device__ __forceinline__ void tile_max_scaled(const int (&acc)[H], float (&rmax)[C],
                                                const float (&sv)[2], const float (&cv)[2]) {
#pragma unroll
  for (int j = 0; j < H / 4; ++j) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float v0 = fmaf(__int_as_float(acc[4 * j + c] + kMagicBits), sv[0], cv[0]);
      const float v1 = fmaf(__int_as_float(acc[4 * j + 2 + c] + kMagicBits), sv[1], cv[1]);
      rmax[2 * j + c] = fmaxf(rmax[2 * j + c], fmaxf(v0, v1));
    }
  }
}
// bf16: a full tile takes no mask; in the doc's last tile the rows at or
// past its length (ok0, ok1 false) drop out.
template <int H, int C>
__device__ __forceinline__ void tile_max_masked(const float (&acc)[H], float (&rmax)[C],
                                                bool full_tile, bool ok0, bool ok1) {
  if (full_tile) {
#pragma unroll
    for (int j = 0; j < H / 4; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        rmax[2 * j + c] = fmaxf(rmax[2 * j + c], fmaxf(acc[4 * j + c], acc[4 * j + 2 + c]));
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < H / 4; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float v0 = ok0 ? acc[4 * j + c] : -INFINITY;
        const float v1 = ok1 ? acc[4 * j + 2 + c] : -INFINITY;
        rmax[2 * j + c] = fmaxf(rmax[2 * j + c], fmaxf(v0, v1));
      }
    }
  }
}
// Additive mask: rows g and g + 8 get mv[0] and mv[1] (-inf past td) added
// before the max.
template <int H, int C>
__device__ __forceinline__ void tile_max_added(const float (&acc)[H], float (&rmax)[C],
                                               const float (&mv)[2]) {
#pragma unroll
  for (int j = 0; j < H / 4; ++j) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      rmax[2 * j + c] =
          fmaxf(rmax[2 * j + c], fmaxf(acc[4 * j + c] + mv[0], acc[4 * j + 2 + c] + mv[1]));
    }
  }
}

template <class T, int N, class V = Served>
__global__ void __launch_bounds__(kThreads, (N <= 64 ? 2 : 1))
    maxsim_kernel(const __grid_constant__ CUtensorMap map_q,  // [q_n * tq, row]
                  const __grid_constant__ CUtensorMap map_g,  // [nd, td, row]
                  const __grid_constant__ CUtensorMap map_s,  // [nd, td] int8 scales or f32 mask
                  const Params p) {
  using Acc = typename T::Acc;
  constexpr int kAcc = N / 2;   // accumulator registers a thread
  constexpr int kCols = N / 4;  // columns a thread sees (two rows of each)
  constexpr bool kAdd = V::kMask == kAdditive;
  constexpr bool kSum = V::kMask == kDots;
  constexpr bool kScan = V::kReduce == kShared && !kSum;
  constexpr int kScanCols = N >= 128 ? N / 128 : 1;  // columns a thread scans
  // Bytes of a tile's side input in the ring: its rows' scales or mask values.
  constexpr int kSide = T::kScales ? kTileRows * 2 : (kAdd ? kTileRows * 4 : 0);
  static_assert(!T::kScales || (V::kMask == kLens && V::kReduce == kRegisters),
                "the int8 instance takes its scales as the mask and reduces in registers");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* sm = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  const Layout L = smem_layout(N, p.n_wg, p.panels, p.stages, T::kScales, V::kSub, kSide, kScan);
  int* lens = reinterpret_cast<int*>(sm + L.lens);
  const uint32_t full0 = smem_u32(sm + L.bars);
  const uint32_t empty0 = full0 + 8 * kMaxStages;
  const uint32_t bfull = empty0 + 8 * kMaxStages;
  const int tile_bytes = p.panels * kTilePanelBytes;  // one tile's rows in the ring
  const int b_panel_bytes = N * kPanelBytes;

  const int lane = threadIdx.x & 31;
  const int wg = threadIdx.x >> 7;
  const int qb = blockIdx.x % p.n_qblocks;
  const int doc0 = (blockIdx.x / p.n_qblocks) * p.dpb;
  const int ndocs = min(p.dpb, p.nd - doc0);
  const int n_qgroups = (p.q_n + p.qpw - 1) / p.qpw;
  const int qg0 = qb * p.n_wg;
  const int active = min(p.n_wg, n_qgroups - qg0);  // consumer warpgroups at work

  // Each doc's row bound: its length, or 1 + its last token with a positive
  // scale, or (additive mask, probe) td. Tiles past it are neither loaded
  // nor multiplied.
  if constexpr (T::kScales) {
    const uint16_t* scales = static_cast<const uint16_t*>(p.lens_src);
    for (int dl = threadIdx.x >> 5; dl < ndocs; dl += kThreads / 32) {
      const uint16_t* s = scales + (long long)(doc0 + dl) * p.td;
      int last = 0;
      for (int j = lane; j < p.td; j += 32) {
        const uint16_t b = s[j];
        if (b != 0 && (b & 0x8000) == 0) last = j + 1;
      }
      last = __reduce_max_sync(0xffffffffu, last);
      if (lane == 0) lens[dl] = last;
    }
  } else if constexpr (V::kMask == kLens) {
    const int* doclens = static_cast<const int*>(p.lens_src);
    for (int dl = threadIdx.x; dl < ndocs; dl += kThreads) {
      lens[dl] = max(0, min(doclens[doc0 + dl], p.td));
    }
  } else {
    for (int dl = threadIdx.x; dl < ndocs; dl += kThreads) lens[dl] = p.td;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full0 + 8 * s, 1);            // the producer's expect_tx arrival
      mbar_init(empty0 + 8 * s, 4 * active);  // one arrival a consumer warp
    }
    mbar_init(bfull, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The roles part here and never meet again: from this point on only
  // mbarriers and the warpgroups' own barriers synchronise.
  if (wg == kConsumers) {
    // ---- producer ----
    if constexpr (N == 256) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kConsumers * 128) {
      const uint32_t b0 = smem_u32(sm + L.b);
      mbar_expect_tx(bfull, active * p.panels * b_panel_bytes);
      for (int w = 0; w < active; ++w) {
        for (int pp = 0; pp < p.panels; ++pp) {
          tma_load_2d(b0 + (w * p.panels + pp) * b_panel_bytes, &map_q, bfull,
                      pp * p.panel_elems, (qg0 + w) * p.qpw * p.tq);
        }
      }
      const uint32_t ring0 = smem_u32(sm + L.ring);
      const uint32_t sc0 = smem_u32(sm + L.sc);
      int stage = 0, phase = 0;
      for (int dl = 0; dl < ndocs; ++dl) {
        const int n_tiles = (lens[dl] + kTileRows - 1) / kTileRows;
        // A stage holds up to kSub tiles of one doc.
        for (int t = 0; t < n_tiles; t += V::kSub) {
          const int ns = V::kSub == 1 ? 1 : min(V::kSub, n_tiles - t);
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          const uint32_t full = full0 + 8 * stage;
          mbar_expect_tx(full, ns * (tile_bytes + kSide));
          for (int s = 0; s < ns; ++s) {
            const int slot = stage * V::kSub + s;
            for (int pp = 0; pp < p.panels; ++pp) {
              tma_load_3d(ring0 + slot * tile_bytes + pp * kTilePanelBytes, &map_g, full,
                          pp * p.panel_elems, (t + s) * kTileRows, doc0 + dl);
            }
            if constexpr (kSide > 0) {
              tma_load_2d(sc0 + slot * kSide, &map_s, full, (t + s) * kTileRows, doc0 + dl);
            }
          }
          if (++stage == p.stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else if (wg < active) {
    // ---- consumer ----
    if constexpr (N == 256) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5;
    const int g = lane >> 2;   // row of the thread inside its 8-row group
    const int t4 = lane & 3;   // column pair inside an 8-column group
    const int q0 = (qg0 + wg) * p.qpw;
    const int nq = min(p.qpw, p.q_n - q0);
    float* wmax = reinterpret_cast<float*>(sm + L.wmax) + wg * 4 * N;  // [4][N]
    float* colmax = reinterpret_cast<float*>(sm + L.colmax) + wg * N;
    float* qs = reinterpret_cast<float*>(sm + L.qs) + wg * N;
    // The score of query q0 + tid and doc doc0 + dl lands at out0[dl * out_step].
    float* const out0 = V::kDocMajor ? p.out + (long long)doc0 * p.q_n + q0 + tid
                                     : p.out + (long long)(q0 + tid) * p.nd + doc0;
    const long long out_step = V::kDocMajor ? p.q_n : 1;
    if constexpr (T::kScales) {
      for (int c = tid; c < N; c += 128) {
        qs[c] = c < nq * p.tq ? p.qscales[(long long)q0 * p.tq + c] : 0.0f;
      }
      group_sync(wg);
    }
    // The next doc at or after d with a valid row; docs without one score 0.
    auto next_doc = [&](int d) {
      while (d < ndocs && lens[d] == 0) {
        if (tid < nq) out0[d * out_step] = 0.0f;
        ++d;
      }
      return d;
    };
    mbar_wait(bfull, 0);
    const uint64_t desc_b = make_desc(smem_u32(sm + L.b) + wg * p.panels * b_panel_bytes);
    const int b_panel_units = b_panel_bytes >> 4;
    const uint32_t ring0 = smem_u32(sm + L.ring);
    constexpr float kLowest = T::kScales ? kNeg : -INFINITY;

    Acc acc[kAcc];
    int stage = 0, phase = 0;
    if constexpr (kSum) {
      // The probe: every tile into one accumulator. A stage is handed back
      // once the products of the next are started (wait_group 1), so the
      // tensor cores never drain between tiles.
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
      int held = -1;  // the stage the products in flight may still read
      for (int dl = 0; dl < ndocs; ++dl) {
        const int n_tiles = (lens[dl] + kTileRows - 1) / kTileRows;
        for (int t = 0; t < n_tiles; t += V::kSub) {
          const int ns = min(V::kSub, n_tiles - t);
          mbar_wait(full0 + 8 * stage, phase);
          for (int s = 0; s < ns; ++s) {
            multiply_tile<T>(acc, make_desc(ring0 + (stage * V::kSub + s) * tile_bytes), desc_b,
                             p.panels, b_panel_units, true);
          }
          wgmma_wait<1>();
          if (held >= 0) {
            __syncwarp();
            if (lane == 0) mbar_arrive(empty0 + 8 * held);
          }
          held = stage;
          if (++stage == p.stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
      wgmma_wait<0>();
      // Column sums: a lane's two rows, the 8 row groups, the 4 warps, then
      // each query's tokens in order; every doc of the block gets the sum.
      float csum[kCols];
#pragma unroll
      for (int j = 0; j < kAcc / 4; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) csum[2 * j + c] = acc[4 * j + c] + acc[4 * j + 2 + c];
      }
      fold_rows<kCols, true>(csum, lane);
      store_folded<N>(csum, wmax, warp, g, t4);
      group_sync(wg);
      for (int c = tid; c < N; c += 128) {
        colmax[c] = (wmax[c] + wmax[N + c]) + (wmax[2 * N + c] + wmax[3 * N + c]);
      }
      group_sync(wg);
      if (tid < nq) {
        const float* cm = colmax + tid * p.tq;
        float sum = 0.0f;
        for (int k = 0; k < p.tq; ++k) sum += cm[k];
        for (int dl = 0; dl < ndocs; ++dl) out0[dl * out_step] = sum;
      }
    } else {
      // Running maxima: kCols a thread on the accumulator's layout, or the
      // kScanCols columns it scans in shared memory.
      float rmax[kScan ? kScanCols : kCols];
      float* scratch = reinterpret_cast<float*>(sm + L.scratch) +
                       wg * kTileRows * (N + kScratchPad);  // [64][N + pad]
      for (int dl = next_doc(0); dl < ndocs; dl = next_doc(dl + 1)) {
        const int len = lens[dl];
#pragma unroll
        for (int i = 0; i < (kScan ? kScanCols : kCols); ++i) rmax[i] = kLowest;

        for (int t = 0; t * kTileRows < len; t += V::kSub) {
          const int ns =
              V::kSub == 1 ? 1 : min(V::kSub, (len + kTileRows - 1) / kTileRows - t);
          mbar_wait(full0 + 8 * stage, phase);
          for (int s = 0; s < ns; ++s) {
            const int slot = stage * V::kSub + s;
            const int r0 = (t + s) * kTileRows;  // the tile's first row in the doc
            const bool last = s == ns - 1;       // the stage is read after this tile
            multiply_tile<T>(acc, make_desc(ring0 + slot * tile_bytes), desc_b, p.panels,
                             b_panel_units);
            if constexpr (T::kScales) {
              // The rows' scales, read before the tile is handed back.
              const uint16_t* tsc = reinterpret_cast<const uint16_t*>(sm + L.sc) +
                                    slot * kTileRows + warp * 16 + g;
              float sv[2], cv[2];
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float x = __uint_as_float(static_cast<uint32_t>(tsc[8 * h]) << 16);
                const bool ok = x > 0.0f;
                sv[h] = ok ? x : 0.0f;
                cv[h] = ok ? -kMagic * x : kNeg;
              }
              wgmma_wait<0>();
              __syncwarp();
              if (last && lane == 0) mbar_arrive(empty0 + 8 * stage);  // the stage is read
              tile_max_scaled(acc, rmax, sv, cv);
            } else if constexpr (kScan) {
              // Stage the accumulator, then each thread scans its columns
              // over the tile's valid rows (mask values added).
              const float* tm = reinterpret_cast<const float*>(sm + L.sc) + slot * kTileRows;
              const int nr = min(kTileRows, len - r0);
              wgmma_wait<0>();
              stage_tile<N>(acc, scratch, warp, g, t4);
              group_sync(wg);
#pragma unroll
              for (int i = 0; i < kScanCols; ++i) {
                const int c = tid + 128 * i;
                if (c < N) {
                  float m = rmax[i];
                  for (int r = 0; r < nr; ++r) {
                    const float v = scratch[r * (N + kScratchPad) + c];
                    m = fmaxf(m, kAdd ? v + tm[r] : v);
                  }
                  rmax[i] = m;
                }
              }
              group_sync(wg);  // scratch and mask values read
              if (last && lane == 0) mbar_arrive(empty0 + 8 * stage);
            } else if constexpr (kAdd) {
              // The rows' mask values, read before the tile is handed back;
              // rows past td (zero-filled) drop out.
              const float* tm = reinterpret_cast<const float*>(sm + L.sc) + slot * kTileRows +
                                warp * 16 + g;
              const int row = r0 + warp * 16 + g;  // and row + 8
              float mv[2];
              mv[0] = row < len ? tm[0] : -INFINITY;
              mv[1] = row + 8 < len ? tm[8] : -INFINITY;
              wgmma_wait<0>();
              __syncwarp();
              if (last && lane == 0) mbar_arrive(empty0 + 8 * stage);
              tile_max_added(acc, rmax, mv);
            } else {
              const int row = r0 + warp * 16 + g;  // and row + 8
              wgmma_wait<0>();
              __syncwarp();
              if (last && lane == 0) mbar_arrive(empty0 + 8 * stage);  // the stage is read
              tile_max_masked(acc, rmax, r0 + kTileRows <= len, row < len, row + 8 < len);
            }
          }
          if (++stage == p.stages) {
            stage = 0;
            phase ^= 1;
          }
        }

        // The doc is done: fold the 8 row groups of each warp, then the 4
        // warps (or take the scanned columns), then sum each query's tokens
        // in order.
        if constexpr (kScan) {
#pragma unroll
          for (int i = 0; i < kScanCols; ++i) {
            const int c = tid + 128 * i;
            if (c < N) colmax[c] = !kAdd || rmax[i] > 0.5f * kNeg ? rmax[i] : 0.0f;
          }
        } else {
          fold_rows<kCols>(rmax, lane);
          store_folded<N>(rmax, wmax, warp, g, t4);
          group_sync(wg);
          for (int c = tid; c < N; c += 128) {
            float m = fmaxf(fmaxf(wmax[c], wmax[N + c]), fmaxf(wmax[2 * N + c], wmax[3 * N + c]));
            if constexpr (T::kScales) m = (m > 0.5f * kNeg ? m : 0.0f) * qs[c];
            if constexpr (kAdd) m = m > 0.5f * kNeg ? m : 0.0f;
            colmax[c] = m;
          }
        }
        group_sync(wg);
        if (tid < nq) {
          const float* cm = colmax + tid * p.tq;
          float sum = 0.0f;
          for (int k = 0; k < p.tq; ++k) sum += cm[k];
          out0[dl * out_step] = sum;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda, not in the runtime; it is looked
// up through the runtime so the library links against nothing but cudart.
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* sym = nullptr;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &sym, cudaEnableDefault) !=
        cudaSuccess) {
      sym = nullptr;
    }
    return reinterpret_cast<EncodeTiledFn>(sym);
  }();
  return fn;
}

// A tiled map of `rank` dimensions (innermost first); out-of-bounds
// elements of a box are filled with zeros. Returns 0 or an error code.
inline int encode_map(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* base,
                      const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
                      CUtensorMapSwizzle swizzle) {
  const EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return kEncodeFailed;
  const cuuint32_t ones[3] = {1, 1, 1};
  const CUresult res =
      fn(map, type, rank, const_cast<void*>(base), dims, strides, box, ones,
         CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kEncodeFailed + (int)res;
}

inline const char* error_string(int code) {
  if (code >= kEncodeFailed) return "cuTensorMapEncodeTiled failed or is not available";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

template <class T, int N, class V>
int launch_n(const CUtensorMap& mq, const CUtensorMap& mg, const CUtensorMap& ms,
             const Params& p, int blocks, int smem, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      maxsim_kernel<T, N, V>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  maxsim_kernel<T, N, V><<<blocks, kThreads, smem, stream>>>(mq, mg, ms, p);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of one block of an instance under a plan, in bytes.
template <class T, class V = Served>
int smem_bytes(int n, int n_wg, int panels, int stages) {
  const bool sum = V::kMask == kDots;
  return smem_layout(n, n_wg, panels, stages, T::kScales, V::kSub,
                     V::kMask == kAdditive ? kTileRows * 4 : 0, V::kReduce == kShared && !sum)
      .total;
}

// Encodes the maps and launches the kernel on `stream`. `row_bytes` (a
// multiple of 128, up to 512 for bf16 and 256 for int8) is the byte width
// of a query or grid row; n, n_wg, dpb and stages are the caller's plan.
// `side` is the int8 scales [nd, td] or the additive mask [nd, side_cols]
// (side_cols >= td, a multiple of 4: 16-byte rows for TMA); `lens_src` is
// the bf16 doclens. Returns 0, a cudaError_t, or a code at or above
// kEncodeFailed.
template <class T, class V = Served>
int launch(const void* queries, const void* grid, const void* side, const void* lens_src,
           const float* qscales, float* out, int q_n, int tq, int nd, int td, int row_bytes,
           int n, int n_wg, int dpb, int stages, cudaStream_t stream, int side_cols = 0) {
  if (q_n <= 0 || nd <= 0 || td <= 0 || tq <= 0 || tq > n || n_wg < 1 || n_wg > kConsumers ||
      dpb < 1 || dpb > kMaxDocsPerBlock || stages < 2 || stages > kMaxStages ||
      row_bytes <= 0 || row_bytes % kPanelBytes || (T::kScales && td % 8) ||
      (V::kMask == kAdditive && (side_cols < td || side_cols % 4))) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.lens_src = lens_src;
  p.qscales = qscales;
  p.out = out;
  p.q_n = q_n;
  p.tq = tq;
  p.nd = nd;
  p.td = td;
  p.qpw = n / tq;
  p.n_wg = n_wg;
  p.dpb = dpb;
  p.panels = row_bytes / kPanelBytes;
  p.panel_elems = kPanelBytes / T::kElemBytes;
  p.stages = stages;
  const int n_qgroups = (q_n + p.qpw - 1) / p.qpw;
  p.n_qblocks = (n_qgroups + n_wg - 1) / n_wg;
  const long long blocks = (long long)p.n_qblocks * ((nd + dpb - 1) / dpb);
  const int smem = smem_bytes<T, V>(n, n_wg, p.panels, stages);
  if (blocks > INT_MAX || smem > kSmemLimit) return (int)cudaErrorInvalidValue;

  const CUtensorMapDataType type =
      T::kElemBytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const cuuint64_t row_elems = (cuuint64_t)row_bytes / T::kElemBytes;
  CUtensorMap mq, mg, ms;
  {
    const cuuint64_t dims[2] = {row_elems, (cuuint64_t)q_n * tq};
    const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
    const cuuint32_t box[2] = {(cuuint32_t)p.panel_elems, (cuuint32_t)n};
    const int rc = encode_map(&mq, type, 2, queries, dims, strides, box,
                              CU_TENSOR_MAP_SWIZZLE_128B);
    if (rc != 0) return rc;
  }
  {
    const cuuint64_t dims[3] = {row_elems, (cuuint64_t)td, (cuuint64_t)nd};
    const cuuint64_t strides[2] = {(cuuint64_t)row_bytes, (cuuint64_t)td * row_bytes};
    const cuuint32_t box[3] = {(cuuint32_t)p.panel_elems, (cuuint32_t)kTileRows, 1};
    const int rc =
        encode_map(&mg, type, 3, grid, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
    if (rc != 0) return rc;
  }
  if (T::kScales || V::kMask == kAdditive) {
    // One 64-row box a tile: bf16 scales [nd, td] or the f32 mask [nd, side_cols].
    const int cols = T::kScales ? td : side_cols;
    const int elem = T::kScales ? 2 : 4;
    const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)nd};
    const cuuint64_t strides[1] = {(cuuint64_t)cols * elem};
    const cuuint32_t box[2] = {(cuuint32_t)kTileRows, 1};
    const int rc = encode_map(
        &ms, T::kScales ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
        side, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (rc != 0) return rc;
  } else {
    ms = mg;  // not read
  }
  switch (n) {
    case 32:
      return launch_n<T, 32, V>(mq, mg, ms, p, (int)blocks, smem, stream);
    case 64:
      return launch_n<T, 64, V>(mq, mg, ms, p, (int)blocks, smem, stream);
    case 128:
      return launch_n<T, 128, V>(mq, mg, ms, p, (int)blocks, smem, stream);
    case 256:
      return launch_n<T, 256, V>(mq, mg, ms, p, (int)blocks, smem, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace maxsim
