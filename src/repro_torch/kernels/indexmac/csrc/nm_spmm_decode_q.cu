// nm_spmm_decode_q: y[M, N] = act((x[M, K] @ decompress(vals, idx))
// * scales[col] + bias) for M <= 8, vals int8, scales f32 (N,), x and y
// f32 or bf16. The kernels and their design are in nm_spmm_decode.cuh;
// the finishing pass applies the scale, then the bias, then the
// activation. Replaces src/repro/kernels/indexmac/decode_kernel.py
// nm_spmm_pallas_decode_q.
//
// Vector width: 8 int8 columns per thread, one 8-byte load of vals and
// one of idx (kernels/padding.py decode_vec). 16 columns with 16-byte
// loads were tried and dropped: at M = 8 they hold acc[8][16] and ptxas
// gives the kernel about 200 registers a thread, so one 256-thread block
// fits an SM (about 120 registers and two blocks at 8 columns), and the
// wider loads halve the column blocks, which fills the 132 SMs worse at
// N = 512. Measured with chip_smoke.py on an H100 SXM (700 W) at
// K x N = 4096 x 11008, M = 4, bf16 x: 0.05885 ms at 8 columns, 0.07576
// ms at 16.
#include "nm_spmm_decode.cuh"

// C interface (loaded with ctypes by kernels/indexmac/decode_kernel.py).
// The wrapper has checked shapes, dtypes (vals int8, scales f32 of N) and
// contiguity, 1 <= M <= 8, 1 <= n < m <= 1024, K % m == 0, vec is 8 or 1
// with N % vec == 0, rows_per_split % n == 0, and allocated partial as
// (splits, M, N) f32.
// bias is an (N,) f32 pointer or null. Returns cudaGetLastError() of the
// two launches.
extern "C" int nm_spmm_decode_q(int dtype, int act, const void* x,
                                const void* vals, const void* idx,
                                const void* scales, const void* bias, void* y,
                                void* partial, int M, int K, int N, int n,
                                int m, int vec, int rows_per_split,
                                int splits, void* stream) {
  cudaGetLastError();  // clear a stale error so the result is this call's
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == nmk::kF32)
    return nmk::decode_launch<float, int8_t, 8>(
        act, x, vals, idx, scales, bias, y, partial, M, K, N, n, m, vec,
        rows_per_split, splits, s);
  if (dtype == nmk::kBF16)
    return nmk::decode_launch<__nv_bfloat16, int8_t, 8>(
        act, x, vals, idx, scales, bias, y, partial, M, K, N, n, m, vec,
        rows_per_split, splits, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
