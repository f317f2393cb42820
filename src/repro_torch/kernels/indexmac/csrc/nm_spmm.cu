// nm_spmm: y[M, N] = x[M, K] @ W, W stored N:M-compressed along K as
// vals[Kc, N] (x's dtype) and idx[Kc, N] (int8 in [0, m)), Kc = K * n / m.
//
// Replaces the TPU kernel src/repro/kernels/indexmac/kernel.py
// nm_spmm_pallas (body _nm_spmm_kernel, expansion _decompress_block).
//
// What bounds it on an H100: operations. At the prefill shapes (M = 512,
// K and N in the thousands) the product does about 2*M*K*N / (bytes moved)
// > 100 FLOP per byte; this kernel expands W into a dense tile and runs
// the dense product on the f32 CUDA cores (67 TFLOP/s peak), so it is
// compute bound there by design. The tensor cores (wgmma, mma.sp with
// the 2:4 metadata) are the later step that lifts that ceiling.
//
// Design:
// * One block per 64 x 64 output tile (the TPU's parallel (mi, ni) grid
//   axes); the TPU's sequential ki grid axis with a VMEM accumulator
//   becomes a K loop inside the block with a 4 x 4 f32 register
//   accumulator per thread. Blocks run in any order; nothing carries
//   over between them.
// * Per K chunk (whole m-blocks, at most 32 dense rows) the block stages
//   the x tile in shared memory, transposed, as f32, and expands the
//   compressed (chunk*n/m, 64) tile of vals/idx into a dense (chunk, 64)
//   f32 tile in shared memory. One thread owns one (m-block, column)
//   pair: it zeroes the block's m rows of that column and then ADDS each
//   of its n values at row (r/n)*m + idx, so repeated indices sum as
//   decompress_nm's one-hot einsum does. No value is gathered from HBM:
//   vals and idx are read once, coalesced along N.
// * Exact f32 fused multiply-adds, no TF32. bf16 inputs are widened to
//   f32 on the way into shared memory; the output is cast to x's dtype.
// * Ragged M, N and K edges are masked in the kernel (zero x columns,
//   zero W columns, no store outside [M, N]); nothing is padded on the
//   host.
#include "common.cuh"

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int KROWS = 32;  // dense rows per K chunk at most
constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
nm_spmm_kernel(const T* __restrict__ x, const T* __restrict__ vals,
               const int8_t* __restrict__ idx, T* __restrict__ y, int M,
               int K, int N, int n, int m) {
  // +4 keeps each row 16-byte aligned and spreads the transposed stores
  __shared__ __align__(16) float xs[KROWS][BM + 4];
  __shared__ __align__(16) float ws[KROWS][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // 4 output columns each
  const int ty = tid / 16;  // 4 output rows each
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int gblocks = KROWS / m;     // m-blocks per chunk
  const int kchunk = gblocks * m;    // dense rows per chunk
  const int nblocks = K / m;         // m-blocks along K

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int kb0 = 0; kb0 < nblocks; kb0 += gblocks) {
    const int k0 = kb0 * m;
    // x tile (BM rows x kchunk columns), read along K, stored transposed
    for (int e = tid; e < BM * kchunk; e += THREADS) {
      const int r = e / kchunk, c = e - (e / kchunk) * kchunk;
      const int gr = row0 + r, gk = k0 + c;
      xs[c][r] = (gr < M && gk < K) ? nmk::to_f32(x[(size_t)gr * K + gk]) : 0.f;
    }
    // dense W tile: thread owns (m-block b, column c); zero, then add
    for (int e = tid; e < gblocks * BN; e += THREADS) {
      const int b = e / BN, c = e % BN;
      const int gc = col0 + c, gb = kb0 + b;
      for (int j = 0; j < m; ++j) ws[b * m + j][c] = 0.f;
      if (gc < N && gb < nblocks) {
        for (int s = 0; s < n; ++s) {
          const size_t off = (size_t)(gb * n + s) * N + gc;
          const int i = idx[off];
          if (i >= 0 && i < m) ws[b * m + i][c] += nmk::to_f32(vals[off]);
        }
      }
    }
    __syncthreads();
    for (int kk = 0; kk < kchunk; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
      const float4 w = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = row0 + ty * 4 + i;
    if (gr >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = col0 + tx * 4 + j;
      if (gc < N) y[(size_t)gr * N + gc] = nmk::from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
void launch(const void* x, const void* vals, const void* idx, void* y, int M,
            int K, int N, int n, int m, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  nm_spmm_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(vals),
      static_cast<const int8_t*>(idx), static_cast<T*>(y), M, K, N, n, m);
}

}  // namespace

// C interface (loaded with ctypes by kernels/indexmac/kernel.py). The
// wrapper has checked shapes, dtypes, contiguity and 1 <= n < m <= 32,
// K % m == 0. Returns cudaGetLastError() of the launch.
extern "C" int nm_spmm(int dtype, const void* x, const void* vals,
                       const void* idx, void* y, int M, int K, int N, int n,
                       int m, void* stream) {
  cudaGetLastError();  // clear a stale error so the result is this launch's
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == nmk::kF32)
    launch<float>(x, vals, idx, y, M, K, N, n, m, s);
  else if (dtype == nmk::kBF16)
    launch<__nv_bfloat16>(x, vals, idx, y, M, K, N, n, m, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
