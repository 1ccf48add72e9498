// The dots-only probe of the int8 MaxSim kernel (maxsim_int8.cu), for
// Hopper (sm_90a). Replaces no TPU kernel: it times what the served
// kernel's products and feed alone cost, and is built and run only by
// scripts/profile_torch_maxsim.py, never on a served path.
//
// One instance of maxsim_wgmma.cuh's template, Policy<kDots> on Int8, with
// the served kernel's loads, tiles and plan, wrong by design: every tile's
// products summed in one accumulator with no wait inside the walk (a stage
// is handed back one product group later). Against the served kernel at
// the same plan, it says how far the served schedule is from the products.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// Interface: plain C, loaded with ctypes by the profiling script.

#include "maxsim_wgmma.cuh"

extern "C" {

// Launches the probe with the arguments and plan of maxsim_int8_scores.
// Returns 0 or an error code for maxsim_int8_probe_error_string.
int maxsim_int8_probe_scores(const void* queries, const void* qscales, const void* grid,
                             const void* scales, void* out, int q_n, int tq, int nd, int td,
                             int d, int n, int n_wg, int dpb, int stages, void* stream) {
  if (d != 128 && d != 256) return (int)cudaErrorInvalidValue;
  return maxsim::launch<maxsim::Int8, maxsim::Policy<maxsim::kDots>>(
      queries, grid, scales, scales, static_cast<const float*>(qscales),
      static_cast<float*>(out), q_n, tq, nd, td, d, n, n_wg, dpb, stages,
      static_cast<cudaStream_t>(stream));
}

const char* maxsim_int8_probe_error_string(int code) { return maxsim::error_string(code); }

}  // extern "C"
