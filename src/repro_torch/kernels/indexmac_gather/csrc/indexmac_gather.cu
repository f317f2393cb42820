// indexmac_gather: C[Mr, Nc] = decompress(vals, idx) @ B, A compressed
// along its rows, vals f32 or bf16, B and C f32 or bf16. The kernel and
// its design are in indexmac_gather.cuh; it replaces
// src/repro/kernels/indexmac_gather/kernel.py indexmac_gather_pallas.
#include "indexmac_gather.cuh"

namespace {

// f(TB, TV) for the dtype codes, or cudaErrorInvalidValue
template <typename F>
int by_dtypes(int b_dtype, int v_dtype, F f) {
  if (b_dtype == nmk::kF32 && v_dtype == nmk::kF32)
    return f(float(), float());
  if (b_dtype == nmk::kF32 && v_dtype == nmk::kBF16)
    return f(float(), __nv_bfloat16());
  if (b_dtype == nmk::kBF16 && v_dtype == nmk::kF32)
    return f(__nv_bfloat16(), float());
  if (b_dtype == nmk::kBF16 && v_dtype == nmk::kBF16)
    return f(__nv_bfloat16(), __nv_bfloat16());
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// C interface (loaded with ctypes by kernels/indexmac_gather/kernel.py).
// The wrapper has checked shapes, dtypes, contiguity and
// 1 <= n < m <= 64, K % m == 0, and chose the tile code, the K steps a
// split and the split count (padding.gather_plan). partial and counters
// are its scratch (splits > 1 only). Returns the launch's CUDA error.
extern "C" int indexmac_gather(int b_dtype, int v_dtype, const void* vals,
                               const void* idx, const void* b, void* c,
                               void* partial, void* counters, int Mr, int K,
                               int Nc, int n, int m, int tile, int per,
                               int splits, void* stream) {
  cudaGetLastError();  // clear a stale error so the result is this launch's
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_dtypes(b_dtype, v_dtype, [&](auto tb, auto tv) {
    return nmk::indexmac_gather_launch<decltype(tb), decltype(tv)>(
        vals, idx, nullptr, b, c, partial, counters, Mr, K, Nc, n, m, tile,
        per, splits, s);
  });
}

// out[0] CTAs per SM, out[1] threads, out[2] dynamic shared memory of the
// kernel a call with these dtypes, tile code and pattern launches.
extern "C" int indexmac_gather_occupancy(int b_dtype, int v_dtype, int tile,
                                         int n, int m, int* out) {
  cudaGetLastError();
  return by_dtypes(b_dtype, v_dtype, [&](auto tb, auto tv) {
    return nmk::indexmac_gather_occupancy<decltype(tb), decltype(tv)>(
        tile, n, m, out);
  });
}
