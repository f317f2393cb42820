// nm_spmm_decode: y[M, N] = act(x[M, K] @ decompress(vals, idx) + bias)
// for M <= 8, vals in x's dtype (f32 or bf16), in one launch. The kernel
// and its design are in nm_spmm_decode.cuh; it replaces
// src/repro/kernels/indexmac/decode_kernel.py nm_spmm_pallas_decode.
// A thread holds 8 bf16 or 4 f32 columns: one 16-byte shared load of a
// staged row.
#include "nm_spmm_decode.cuh"

// C interface (loaded with ctypes by kernels/indexmac/decode_kernel.py).
// The wrapper has checked shapes, dtypes and contiguity and made the plan
// (padding.decode_plan: cols, per, splits); with splits > 1 it passes the
// f32 workspace of (splits, M, N) and the tiles' counters (zeros, left
// zeroed). bias is an (N,) f32 pointer or null. Returns the launch's
// CUDA error (0 on success).
extern "C" int nm_spmm_decode(int dtype, int act, const void* x,
                              const void* vals, const void* idx,
                              const void* bias, void* y, void* ws,
                              void* counters, int M, int K, int N, int n,
                              int m, int cols, int per, int splits,
                              void* stream) {
  cudaGetLastError();  // clear a stale error so the result is this call's
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == nmk::kF32)
    return nmk::decode_launch<float, float>(act, x, vals, idx, nullptr, bias,
                                            y, ws, counters, M, K, N, n, m,
                                            cols, per, splits, s);
  if (dtype == nmk::kBF16)
    return nmk::decode_launch<__nv_bfloat16, __nv_bfloat16>(
        act, x, vals, idx, nullptr, bias, y, ws, counters, M, K, N, n, m,
        cols, per, splits, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// out[5]: CTAs per SM, threads, dynamic shared memory, registers and
// local memory a thread of the kernel for rows (1, 2, 4 or 8) rows
extern "C" int nm_spmm_decode_occupancy(int dtype, int rows, int* out) {
  if (dtype == nmk::kF32)
    return nmk::decode_occupancy<float, float>(rows, out);
  if (dtype == nmk::kBF16)
    return nmk::decode_occupancy<__nv_bfloat16, __nv_bfloat16>(rows, out);
  return static_cast<int>(cudaErrorInvalidValue);
}
