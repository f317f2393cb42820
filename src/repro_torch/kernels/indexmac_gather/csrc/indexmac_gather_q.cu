// indexmac_gather_q: C[Mr, Nc] = (decompress(vals, idx) @ B) * scales[row],
// vals int8, scales f32 (Mr,), B and C f32 or bf16. The kernel and its
// design are in indexmac_gather.cuh (the int8 value widens to f32 as the
// strip is resolved; the row's scale multiplies the fully reduced f32 sum
// once, at writeback). Replaces src/repro/kernels/indexmac_gather/kernel.py
// indexmac_gather_pallas_q.
#include "indexmac_gather.cuh"

// C interface (loaded with ctypes by kernels/indexmac_gather/kernel.py).
// The wrapper has checked shapes, dtypes (vals int8, scales f32 of Mr),
// contiguity and 1 <= n < m <= 64, K % m == 0, and chose the tile code,
// the K steps a split and the split count (padding.gather_plan). partial
// and counters are its scratch (splits > 1 only). Returns the launch's
// CUDA error.
extern "C" int indexmac_gather_q(int b_dtype, const void* vals,
                                 const void* idx, const void* scales,
                                 const void* b, void* c, void* partial,
                                 void* counters, int Mr, int K, int Nc,
                                 int n, int m, int tile, int per, int splits,
                                 void* stream) {
  cudaGetLastError();  // clear a stale error so the result is this launch's
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b_dtype == nmk::kF32)
    return nmk::indexmac_gather_launch<float, int8_t>(
        vals, idx, scales, b, c, partial, counters, Mr, K, Nc, n, m, tile,
        per, splits, s);
  if (b_dtype == nmk::kBF16)
    return nmk::indexmac_gather_launch<__nv_bfloat16, int8_t>(
        vals, idx, scales, b, c, partial, counters, Mr, K, Nc, n, m, tile,
        per, splits, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// out[0] CTAs per SM, out[1] threads, out[2] dynamic shared memory of the
// kernel a call with B in this dtype, tile code and pattern launches.
extern "C" int indexmac_gather_q_occupancy(int b_dtype, int tile, int n,
                                           int m, int* out) {
  cudaGetLastError();
  if (b_dtype == nmk::kF32)
    return nmk::indexmac_gather_occupancy<float, int8_t>(tile, n, m, out);
  if (b_dtype == nmk::kBF16)
    return nmk::indexmac_gather_occupancy<__nv_bfloat16, int8_t>(tile, n, m,
                                                                  out);
  return static_cast<int>(cudaErrorInvalidValue);
}
