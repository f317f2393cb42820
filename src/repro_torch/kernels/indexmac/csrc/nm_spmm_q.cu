// nm_spmm_q: y[M, N] = (x[M, K] @ decompress(vals, idx)) * scales[col],
// vals int8, scales f32 (N,), x and y f32 or bf16. The kernel and its
// design are in nm_spmm.cuh (the int8 values are widened to f32 as the
// dense shared-memory tile is expanded; the scale multiplies the f32
// accumulator once, at writeback). Replaces
// src/repro/kernels/indexmac/kernel.py nm_spmm_pallas_q.
#include "nm_spmm.cuh"

// C interface (loaded with ctypes by kernels/indexmac/kernel.py). The
// wrapper has checked shapes, dtypes (vals int8, scales f32 of N),
// contiguity and 1 <= n < m <= 32, K % m == 0. Returns
// cudaGetLastError() of the launch.
extern "C" int nm_spmm_q(int dtype, const void* x, const void* vals,
                         const void* idx, const void* scales, void* y, int M,
                         int K, int N, int n, int m, void* stream) {
  cudaGetLastError();  // clear a stale error so the result is this launch's
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == nmk::kF32)
    nmk::nm_spmm_launch<float, int8_t>(x, vals, idx, scales, y, M, K, N, n,
                                       m, s);
  else if (dtype == nmk::kBF16)
    nmk::nm_spmm_launch<__nv_bfloat16, int8_t>(x, vals, idx, scales, y, M, K,
                                               N, n, m, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
