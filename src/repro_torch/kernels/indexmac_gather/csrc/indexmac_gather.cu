// indexmac_gather: C[Mr, Nc] = decompress(vals, idx) @ B, A compressed
// along its rows, vals f32 or bf16, B and C f32 or bf16. The kernel and
// its design are in indexmac_gather.cuh; it replaces
// src/repro/kernels/indexmac_gather/kernel.py indexmac_gather_pallas.
#include "indexmac_gather.cuh"

namespace {

template <typename TB>
int launch_b(int v_dtype, const void* vals, const void* idx, const void* b,
             void* c, int Mr, int K, int Nc, int n, int m, cudaStream_t s) {
  if (v_dtype == nmk::kF32)
    nmk::indexmac_gather_launch<TB, float>(vals, idx, nullptr, b, c, Mr, K,
                                           Nc, n, m, s);
  else if (v_dtype == nmk::kBF16)
    nmk::indexmac_gather_launch<TB, __nv_bfloat16>(vals, idx, nullptr, b, c,
                                                   Mr, K, Nc, n, m, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

// C interface (loaded with ctypes by kernels/indexmac_gather/kernel.py).
// The wrapper has checked shapes, dtypes, contiguity and
// 1 <= n < m <= 64, K % m == 0. Returns cudaGetLastError() of the launch.
extern "C" int indexmac_gather(int b_dtype, int v_dtype, const void* vals,
                               const void* idx, const void* b, void* c,
                               int Mr, int K, int Nc, int n, int m,
                               void* stream) {
  cudaGetLastError();  // clear a stale error so the result is this launch's
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (b_dtype == nmk::kF32)
    rc = launch_b<float>(v_dtype, vals, idx, b, c, Mr, K, Nc, n, m, s);
  else if (b_dtype == nmk::kBF16)
    rc = launch_b<__nv_bfloat16>(v_dtype, vals, idx, b, c, Mr, K, Nc, n, m,
                                 s);
  else
    rc = static_cast<int>(cudaErrorInvalidValue);
  return rc != 0 ? rc : static_cast<int>(cudaGetLastError());
}
