// nm_spmm: y[M, N] = x[M, K] @ W, W stored N:M-compressed along K as
// vals[Kc, N] and idx[Kc, N] (int8 in [0, m)), Kc = K * n / m. vals are
// x's dtype (nm_spmm.cu) or int8 with an f32 scale per output column
// (nm_spmm_q.cu: y = (x @ W8) * scales[col]).
//
// Replaces the TPU kernels src/repro/kernels/indexmac/kernel.py
// nm_spmm_pallas (body _nm_spmm_kernel, expansion _decompress_block) and
// nm_spmm_pallas_q (body _nm_spmm_q_kernel).
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
// * Exact f32 fused multiply-adds, no TF32. bf16 inputs and int8 values
//   are widened to f32 (exactly) on the way into shared memory; int8
//   values stay unscaled there, and the f32 accumulator is multiplied by
//   its column's scale once, at writeback, then cast to x's dtype.
// * Ragged M, N and K edges are masked in the kernel (zero x columns,
//   zero W columns, no store and no scale read outside [M, N]); nothing
//   is padded on the host.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace nmk {

constexpr int PF_BM = 64;
constexpr int PF_BN = 64;
constexpr int PF_KROWS = 32;  // dense rows per K chunk at most
constexpr int PF_THREADS = 256;

// T: x and y; V: vals (T, or int8_t with per-column f32 scales)
template <typename T, typename V>
__global__ void __launch_bounds__(PF_THREADS)
nm_spmm_kernel(const T* __restrict__ x, const V* __restrict__ vals,
               const int8_t* __restrict__ idx,
               const float* __restrict__ scales, T* __restrict__ y, int M,
               int K, int N, int n, int m) {
  constexpr bool kScaled = std::is_same<V, int8_t>::value;
  // +4 keeps each row 16-byte aligned and spreads the transposed stores
  __shared__ __align__(16) float xs[PF_KROWS][PF_BM + 4];
  __shared__ __align__(16) float ws[PF_KROWS][PF_BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // 4 output columns each
  const int ty = tid / 16;  // 4 output rows each
  const int row0 = blockIdx.y * PF_BM;
  const int col0 = blockIdx.x * PF_BN;
  const int gblocks = PF_KROWS / m;  // m-blocks per chunk
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
    for (int e = tid; e < PF_BM * kchunk; e += PF_THREADS) {
      const int r = e / kchunk, c = e - (e / kchunk) * kchunk;
      const int gr = row0 + r, gk = k0 + c;
      xs[c][r] = (gr < M && gk < K) ? to_f32(x[(size_t)gr * K + gk]) : 0.f;
    }
    // dense W tile: thread owns (m-block b, column c); zero, then add
    for (int e = tid; e < gblocks * PF_BN; e += PF_THREADS) {
      const int b = e / PF_BN, c = e % PF_BN;
      const int gc = col0 + c, gb = kb0 + b;
      for (int j = 0; j < m; ++j) ws[b * m + j][c] = 0.f;
      if (gc < N && gb < nblocks) {
        for (int s = 0; s < n; ++s) {
          const size_t off = (size_t)(gb * n + s) * N + gc;
          const int i = idx[off];
          if (i >= 0 && i < m) ws[b * m + i][c] += to_f32(vals[off]);
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
  for (int j = 0; j < 4; ++j) {
    const int gc = col0 + tx * 4 + j;
    if (gc >= N) continue;
    const float sc = kScaled ? scales[gc] : 1.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gr = row0 + ty * 4 + i;
      if (gr < M)
        y[(size_t)gr * N + gc] =
            from_f32<T>(kScaled ? __fmul_rn(acc[i][j], sc) : acc[i][j]);
    }
  }
}

template <typename T, typename V>
void nm_spmm_launch(const void* x, const void* vals, const void* idx,
                    const void* scales, void* y, int M, int K, int N, int n,
                    int m, cudaStream_t stream) {
  const dim3 grid((N + PF_BN - 1) / PF_BN, (M + PF_BM - 1) / PF_BM);
  nm_spmm_kernel<T, V><<<grid, PF_THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const V*>(vals),
      static_cast<const int8_t*>(idx), static_cast<const float*>(scales),
      static_cast<T*>(y), M, K, N, n, m);
}

}  // namespace nmk
