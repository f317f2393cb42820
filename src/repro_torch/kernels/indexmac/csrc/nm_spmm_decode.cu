// nm_spmm_decode: y[M, N] = act(x[M, K] @ decompress(vals, idx) + bias)
// for M <= 8, vals in x's dtype (f32 or bf16). The kernels and their
// design are in nm_spmm_decode.cuh; they replace
// src/repro/kernels/indexmac/decode_kernel.py nm_spmm_pallas_decode.
// Vector width: one 16-byte load of vals per thread (8 bf16 or 4 f32).
#include "nm_spmm_decode.cuh"

// C interface (loaded with ctypes by kernels/indexmac/decode_kernel.py).
// The wrapper has checked shapes, dtypes and contiguity, 1 <= M <= 8,
// 1 <= n < m <= 1024, K % m == 0, N % vec == 0, rows_per_split % n == 0,
// and allocated partial as (splits, M, N) f32. bias is an (N,) f32
// pointer or null. Returns cudaGetLastError() of the two launches.
extern "C" int nm_spmm_decode(int dtype, int act, const void* x,
                              const void* vals, const void* idx,
                              const void* bias, void* y, void* partial, int M,
                              int K, int N, int n, int m, int vec,
                              int rows_per_split, int splits, void* stream) {
  cudaGetLastError();  // clear a stale error so the result is this call's
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == nmk::kF32)
    return nmk::decode_launch<float, float, 4>(
        act, x, vals, idx, nullptr, bias, y, partial, M, K, N, n, m, vec,
        rows_per_split, splits, s);
  if (dtype == nmk::kBF16)
    return nmk::decode_launch<__nv_bfloat16, __nv_bfloat16, 8>(
        act, x, vals, idx, nullptr, bias, y, partial, M, K, N, n, m, vec,
        rows_per_split, splits, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
