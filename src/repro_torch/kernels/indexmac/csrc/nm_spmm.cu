// nm_spmm: y[M, N] = x[M, K] @ decompress(vals, idx), vals in x's dtype
// (f32 or bf16). The kernel and its design are in nm_spmm.cuh; it
// replaces src/repro/kernels/indexmac/kernel.py nm_spmm_pallas.
#include "nm_spmm.cuh"

// C interface (loaded with ctypes by kernels/indexmac/kernel.py). The
// wrapper has checked shapes, dtypes, contiguity and 1 <= n < m <= 32,
// K % m == 0. Returns cudaGetLastError() of the launch.
extern "C" int nm_spmm(int dtype, const void* x, const void* vals,
                       const void* idx, void* y, int M, int K, int N, int n,
                       int m, void* stream) {
  cudaGetLastError();  // clear a stale error so the result is this launch's
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == nmk::kF32)
    nmk::nm_spmm_launch<float, float>(x, vals, idx, nullptr, y, M, K, N, n,
                                      m, s);
  else if (dtype == nmk::kBF16)
    nmk::nm_spmm_launch<__nv_bfloat16, __nv_bfloat16>(x, vals, idx, nullptr,
                                                      y, M, K, N, n, m, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
