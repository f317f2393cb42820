// nm_spmm_decode: y[M, N] = act(x[M, K] @ W + bias) for skinny M (the
// decode step's one row per slot), W N:M-compressed along K as
// vals[Kc, N] / idx[Kc, N] (int8 in [0, m)), Kc = K * n / m. vals are
// x's dtype (nm_spmm_decode.cu) or int8 with an f32 scale per output
// column (nm_spmm_decode_q.cu: y = act((x @ W8) * scales + bias)).
//
// Replaces the TPU kernels src/repro/kernels/indexmac/decode_kernel.py
// nm_spmm_pallas_decode and nm_spmm_pallas_decode_q (_pallas_decode,
// _decode_kernel, _decode_partial, _writeback).
//
// What bounds it on an H100: bytes. With M <= 8 rows every kept weight
// value is used for at most 8 multiply-adds, far below the ~20 FLOP per
// byte where the f32 cores would take over, so the time floor is vals +
// idx (1.5 bytes per dense position in bf16, 1 in int8) over 3.35 TB/s.
//
// Design:
// * vals/idx are streamed exactly once, coalesced along N: a thread owns
//   `VEC` adjacent columns and reads them with one load of vals (16 bytes:
//   8 bf16 or 4 f32 values; 8 bytes for 8 int8 values) and one load of
//   their VEC idx bytes, four rows at a time for memory-level
//   parallelism.
// * x is the stationary operand: the block stages it in shared memory in
//   K chunks of at most 1024 dense rows (a whole 8-row bf16 x at K = 11008
//   would take 176 KB). Each kept value (r, c) adds
//   x[:, (r/n)*m + idx] * v into M f32 register accumulators - an indexed
//   read of on-chip x, never a dense W tile and never an HBM gather.
//   int8 values are widened to f32 exactly and stay unscaled in the sums.
//   M rows are taken as they are (1, 2, 4 or 8 per launch, a template
//   parameter); the 8-row padding of the TPU kernel was a sublane size.
// * Occupancy: the 8 warps of a block split the block's rows of K, and
//   the grid splits K once more (grid.y) so that narrow projections
//   (N = 512 for wk / wv gives 2 column blocks) still fill 132 SMs. Each
//   block reduces its warps in shared memory in a fixed order and writes
//   f32 partials; a small finishing kernel sums the splits in a fixed
//   order and applies the epilogue: x scales[col] (int8 only), + bias,
//   then the activation (a compile-time switch), in f32, then the cast to
//   x's dtype - the composition of kernels/epilogue.py. Sums run in a
//   fixed order, so results do not change from run to run.
#pragma once

#include "common.cuh"

namespace nmk {

constexpr int DC_WARPS = 8;
constexpr int DC_KROWS = 1024;  // dense rows of x staged per chunk at most
constexpr int DC_UNROLL = 4;

// T: x and y; V: vals (T, or int8_t); VEC columns per thread
template <typename T, typename V, int MR, int VEC>
__global__ void __launch_bounds__(32 * DC_WARPS)
nm_spmm_decode_kernel(const T* __restrict__ x, const V* __restrict__ vals,
                      const int8_t* __restrict__ idx,
                      float* __restrict__ partial, int M, int K, int N,
                      int n, int m, int rows_per_split) {
  using VT = typename Bytes<VEC * sizeof(V)>::type;
  using IT = typename Bytes<VEC>::type;
  __shared__ __align__(16) T xs[DC_KROWS * MR];         // xs[k * MR + row]
  __shared__ __align__(16) float red[MR][32 * VEC];  // warp reduction

  const int lane = threadIdx.x;
  const int wy = threadIdx.y;
  const int tid = wy * 32 + lane;
  const int c0 = (blockIdx.x * 32 + lane) * VEC;
  const bool col_ok = c0 < N;  // N % VEC == 0, so c0 < N covers all VEC
  const int kc = K / m * n;
  const int rb = blockIdx.y * rows_per_split;
  const int re = min(kc, rb + rows_per_split);
  const int rows_per_chunk = (DC_KROWS / m) * n;

  float acc[MR][VEC];
#pragma unroll
  for (int i = 0; i < MR; ++i)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[i][v] = 0.f;

  for (int r0 = rb; r0 < re; r0 += rows_per_chunk) {
    const int r1 = min(re, r0 + rows_per_chunk);
    const int k0 = (r0 / n) * m;
    const int kd = ((r1 - r0) / n) * m;
    __syncthreads();  // the previous chunk is no longer read
    for (int e = tid; e < kd * MR; e += 32 * DC_WARPS) {
      const int kk = e / MR, row = e - (e / MR) * MR;
      xs[e] = row < M ? x[(size_t)row * K + k0 + kk] : from_f32<T>(0.f);
    }
    __syncthreads();
    if (!col_ok) continue;
    for (int rbase = r0 + wy; rbase < r1; rbase += DC_WARPS * DC_UNROLL) {
      VT vv[DC_UNROLL];
      IT iv[DC_UNROLL];
      int kb[DC_UNROLL];
#pragma unroll
      for (int u = 0; u < DC_UNROLL; ++u) {
        const int r = rbase + u * DC_WARPS;
        kb[u] = -1;
        if (r < r1) {
          const size_t off = (size_t)r * N + c0;
          vv[u] = *reinterpret_cast<const VT*>(vals + off);
          iv[u] = *reinterpret_cast<const IT*>(idx + off);
          kb[u] = (r / n) * m - k0;
        }
      }
#pragma unroll
      for (int u = 0; u < DC_UNROLL; ++u) {
        if (kb[u] < 0) continue;
        const V* vp = reinterpret_cast<const V*>(&vv[u]);
        const int8_t* ip = reinterpret_cast<const int8_t*>(&iv[u]);
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          const int i = ip[v];
          if (i < 0 || i >= m) continue;
          const float w = to_f32(vp[v]);
          const T* xk = xs + (kb[u] + i) * MR;
#pragma unroll
          for (int row = 0; row < MR; ++row)
            acc[row][v] = fmaf(to_f32(xk[row]), w, acc[row][v]);
        }
      }
    }
  }

  // reduce the 8 warps in a fixed order
  for (int w = 0; w < DC_WARPS; ++w) {
    if (wy == w) {
#pragma unroll
      for (int row = 0; row < MR; ++row)
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          float* p = &red[row][lane * VEC + v];
          *p = (w == 0 ? 0.f : *p) + acc[row][v];
        }
    }
    __syncthreads();
  }
  const int bcol0 = blockIdx.x * 32 * VEC;
  for (int e = tid; e < MR * 32 * VEC; e += 32 * DC_WARPS) {
    const int row = e / (32 * VEC), c = e - row * (32 * VEC);
    if (row < M && bcol0 + c < N)
      partial[((size_t)blockIdx.y * M + row) * N + bcol0 + c] = red[row][c];
  }
}

// scales: (N,) f32 for the int8 kernel, null for the float one
template <typename T, int ACT>
__global__ void nm_spmm_decode_finish(const float* __restrict__ partial,
                                      const float* __restrict__ scales,
                                      const float* __restrict__ bias,
                                      T* __restrict__ y, int M, int N,
                                      int splits) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= M * N) return;
  float s = 0.f;
  for (int p = 0; p < splits; ++p) s += partial[(size_t)p * M * N + e];
  // a rounded product, never fused with the bias add: the plain
  // composition rounds (sum * scale) before it adds the bias
  if (scales != nullptr) s = __fmul_rn(s, scales[e % N]);
  if (bias != nullptr) s += bias[e % N];
  y[e] = from_f32<T>(activate<ACT>(s));
}

template <typename T, typename V, int MR, int VEC>
void decode_launch_main(const void* x, const void* vals, const void* idx,
                        float* partial, int M, int K, int N, int n, int m,
                        int rows_per_split, int splits, cudaStream_t stream) {
  const dim3 grid((N + 32 * VEC - 1) / (32 * VEC), splits);
  nm_spmm_decode_kernel<T, V, MR, VEC>
      <<<grid, dim3(32, DC_WARPS), 0, stream>>>(
          static_cast<const T*>(x), static_cast<const V*>(vals),
          static_cast<const int8_t*>(idx), partial, M, K, N, n, m,
          rows_per_split);
}

template <typename T, typename V, int VEC>
void decode_launch_rows(const void* x, const void* vals, const void* idx,
                        float* partial, int M, int K, int N, int n, int m,
                        int rows_per_split, int splits, cudaStream_t stream) {
  if (M <= 1)
    decode_launch_main<T, V, 1, VEC>(x, vals, idx, partial, M, K, N, n, m, rows_per_split, splits, stream);
  else if (M <= 2)
    decode_launch_main<T, V, 2, VEC>(x, vals, idx, partial, M, K, N, n, m, rows_per_split, splits, stream);
  else if (M <= 4)
    decode_launch_main<T, V, 4, VEC>(x, vals, idx, partial, M, K, N, n, m, rows_per_split, splits, stream);
  else
    decode_launch_main<T, V, 8, VEC>(x, vals, idx, partial, M, K, N, n, m, rows_per_split, splits, stream);
}

template <typename T>
void decode_launch_finish(int act, const float* partial, const float* scales,
                          const float* bias, void* y, int M, int N,
                          int splits, cudaStream_t stream) {
  const int threads = 256, blocks = (M * N + threads - 1) / threads;
  T* out = static_cast<T*>(y);
  switch (act) {
    case kRelu:
      nm_spmm_decode_finish<T, kRelu><<<blocks, threads, 0, stream>>>(partial, scales, bias, out, M, N, splits);
      break;
    case kGelu:
      nm_spmm_decode_finish<T, kGelu><<<blocks, threads, 0, stream>>>(partial, scales, bias, out, M, N, splits);
      break;
    case kSilu:
      nm_spmm_decode_finish<T, kSilu><<<blocks, threads, 0, stream>>>(partial, scales, bias, out, M, N, splits);
      break;
    case kReluSq:
      nm_spmm_decode_finish<T, kReluSq><<<blocks, threads, 0, stream>>>(partial, scales, bias, out, M, N, splits);
      break;
    default:
      nm_spmm_decode_finish<T, kNone><<<blocks, threads, 0, stream>>>(partial, scales, bias, out, M, N, splits);
  }
}

// The main kernel at one of the compiled vector widths (VEC_A, or 1 for
// rows that are not aligned to it), then the finishing pass.
template <typename T, typename V, int VEC_A>
int decode_launch(int act, const void* x, const void* vals, const void* idx,
                  const void* scales, const void* bias, void* y,
                  void* partial, int M, int K, int N, int n, int m, int vec,
                  int rows_per_split, int splits, cudaStream_t stream) {
  float* part = static_cast<float*>(partial);
  if (vec == 1)
    decode_launch_rows<T, V, 1>(x, vals, idx, part, M, K, N, n, m, rows_per_split, splits, stream);
  else if (vec == VEC_A)
    decode_launch_rows<T, V, VEC_A>(x, vals, idx, part, M, K, N, n, m, rows_per_split, splits, stream);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_launch_finish<T>(act, part, static_cast<const float*>(scales),
                          static_cast<const float*>(bias), y, M, N, splits,
                          stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nmk
