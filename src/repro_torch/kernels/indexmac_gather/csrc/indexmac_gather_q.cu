// indexmac_gather_q: C[Mr, Nc] = (decompress(vals, idx) @ B) * scales[row],
// vals int8, scales f32 (Mr,), B and C f32 or bf16. The kernel and its
// design are in indexmac_gather.cuh (the int8 value widens to f32 as the
// strip is staged; the row's scale multiplies the f32 accumulator once,
// at writeback). Replaces src/repro/kernels/indexmac_gather/kernel.py
// indexmac_gather_pallas_q.
#include "indexmac_gather.cuh"

// C interface (loaded with ctypes by kernels/indexmac_gather/kernel.py).
// The wrapper has checked shapes, dtypes (vals int8, scales f32 of Mr),
// contiguity and 1 <= n < m <= 64, K % m == 0. Returns
// cudaGetLastError() of the launch.
extern "C" int indexmac_gather_q(int b_dtype, const void* vals,
                                 const void* idx, const void* scales,
                                 const void* b, void* c, int Mr, int K,
                                 int Nc, int n, int m, void* stream) {
  cudaGetLastError();  // clear a stale error so the result is this launch's
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b_dtype == nmk::kF32)
    nmk::indexmac_gather_launch<float, int8_t>(vals, idx, scales, b, c, Mr,
                                               K, Nc, n, m, s);
  else if (b_dtype == nmk::kBF16)
    nmk::indexmac_gather_launch<__nv_bfloat16, int8_t>(vals, idx, scales, b,
                                                       c, Mr, K, Nc, n, m, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
