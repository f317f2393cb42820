// nm_spmm_decode_q: y[M, N] = act((x[M, K] @ decompress(vals, idx))
// * scales[col] + bias) for M <= 8, vals int8, scales f32 (N,), x and y
// f32 or bf16, in one launch. The kernel and its design are in
// nm_spmm_decode.cuh; its epilogue applies the scale, then the bias, then
// the activation. Replaces src/repro/kernels/indexmac/decode_kernel.py
// nm_spmm_pallas_decode_q.
//
// A thread holds 8 int8 columns: one 8-byte shared load of values and one
// of indices a staged row. 16 columns were tried with the earlier
// (two-launch) kernel and dropped: at M = 8 they hold acc[8][16], and the
// registers allowed one block an SM (0.07576 ms against 0.05885 ms at
// K x N = 4096 x 11008, M = 4, bf16 x, chip_smoke.py on an H100 SXM at
// 700 W).
#include "nm_spmm_decode.cuh"

// C interface (loaded with ctypes by kernels/indexmac/decode_kernel.py).
// As nm_spmm_decode, with vals int8 and scales f32 of (N,).
extern "C" int nm_spmm_decode_q(int dtype, int act, const void* x,
                                const void* vals, const void* idx,
                                const void* scales, const void* bias, void* y,
                                void* ws, void* counters, int M, int K, int N,
                                int n, int m, int cols, int per, int splits,
                                void* stream) {
  cudaGetLastError();  // clear a stale error so the result is this call's
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == nmk::kF32)
    return nmk::decode_launch<float, int8_t>(act, x, vals, idx, scales, bias,
                                             y, ws, counters, M, K, N, n, m,
                                             cols, per, splits, s);
  if (dtype == nmk::kBF16)
    return nmk::decode_launch<__nv_bfloat16, int8_t>(
        act, x, vals, idx, scales, bias, y, ws, counters, M, K, N, n, m, cols,
        per, splits, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int nm_spmm_decode_q_occupancy(int dtype, int rows, int* out) {
  if (dtype == nmk::kF32)
    return nmk::decode_occupancy<float, int8_t>(rows, out);
  if (dtype == nmk::kBF16)
    return nmk::decode_occupancy<__nv_bfloat16, int8_t>(rows, out);
  return static_cast<int>(cudaErrorInvalidValue);
}
