// indexmac_gather: C[Mr, Nc] = A[Mr, K] @ B[K, Nc], the paper's
// Algorithm 3 (vindexmac) taken literally. A is N:M-compressed along its
// rows (the contraction dim): vals[Mr, Kc] and idx[Mr, Kc] (int8 in
// [0, m)), Kc = K * n / m. Per kept value
//
//   C[i, :] += f32(vals[i, j]) * f32(B[(j / n) * m + idx[i, j], :])
//
// with an f32 accumulator and C in B's dtype. vals are f32 or bf16
// (indexmac_gather.cu), or int8 with one f32 scale per output row
// (indexmac_gather_q.cu: C[i, :] = acc[i, :] * scales[i] at writeback).
//
// Replaces the TPU kernels src/repro/kernels/indexmac_gather/kernel.py
// indexmac_gather_pallas (body _gather_kernel) and
// indexmac_gather_pallas_q (body _gather_q_kernel).
//
// What bounds it on an H100: at the ResNet-50 layer GEMMs the bytes
// (B once, the compressed A once, C once) and the multiply-adds of the
// kept values over the f32 CUDA-core peak are within a factor of two of
// each other. This kernel is bound by neither: the mechanism costs one
// indexed shared-memory read per kept value and per column pair, the
// same number of reads as FMAs, so shared-memory bandwidth and latency
// set its pace. It exists to run the paper's mechanism faithfully, not
// to be fast; the CNN forward runs nm_spmm.
//
// Design (the paper's registers mapped onto an SM):
// * One block per (32-row, 64-column) tile of C; the TPU's sequential K
//   grid axis with a VMEM accumulator becomes a K loop inside the block,
//   8 f32 accumulators per thread in registers. Blocks run in any order.
// * Per K step (whole m-blocks, at most 64 dense rows) the block stages
//   the (rows x 64) tile of B in shared memory as f32 and keeps it there
//   while every row of the tile sweeps it: the stationary "vector
//   register file".
// * It stages the tile's strip of A as (value, row of the B tile) pairs
//   in shared memory: idx is resolved to (j / n) * m + idx once, when the
//   strip is staged. All lanes of a warp read the same pair (a broadcast):
//   the scalar register rs.
// * Warp w owns rows 4w..4w+3 of the tile, lane l columns 2l and 2l+1.
//   Per kept value a warp does one indexed shared-memory row read,
//   B_tile[r][2l..2l+1] (conflict-free: every lane reads the same row),
//   and two FMAs a lane: Hopper's nearest analogue of vindexmac's
//   indirect register-file read. No dense A tile is expanded.
// * Values are accumulated, never stored, so indices that repeat in a
//   block (the zero-padded pairs of pad_compressed_kn) add up as
//   decompress_nm's one-hot sum does; an index outside [0, m) adds
//   nothing (its value is staged as 0).
// * A thread issues all of a step's staging loads (16 of B, up to 8
//   pairs of A) before it uses any, so a step waits about one global
//   latency, not one a load.
// * Ragged Mr, Nc and the K tail are masked in the kernel (zero B columns
//   and A rows, no store outside [Mr, Nc]); nothing is padded in HBM.
// * bf16 B and bf16 values widen to f32 exactly, int8 values too; the
//   int8 kernel multiplies the f32 accumulator by its row's scale once
//   (__fmul_rn: the product rounds on its own, as in the plain version)
//   and then casts to B's dtype.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace nmk {

constexpr int G_BM = 32;      // rows of A and C per block
constexpr int G_BN = 64;      // columns of B and C per block
constexpr int G_KROWS = 64;   // dense rows of B per K step, at most
constexpr int G_THREADS = 256;
constexpr int G_ROWS = G_BM / (G_THREADS / 32);  // rows per warp (4)
constexpr int G_BPASS = G_KROWS * G_BN / G_THREADS;  // B loads a thread (16)
constexpr int G_APASS = G_BM * G_KROWS / G_THREADS;  // A slots a thread (8)

struct __align__(8) Kept {  // a staged kept value of A and its B row
  float v;
  int r;
};

// TB: B and C; TV: vals (f32 or bf16, or int8_t with per-row f32 scales)
template <typename TB, typename TV>
__global__ void __launch_bounds__(G_THREADS)
indexmac_gather_kernel(const TV* __restrict__ vals,
                       const int8_t* __restrict__ idx,
                       const float* __restrict__ scales,
                       const TB* __restrict__ b, TB* __restrict__ c, int Mr,
                       int K, int Nc, int n, int m) {
  constexpr bool kScaled = std::is_same<TV, int8_t>::value;
  __shared__ __align__(16) float bs[G_KROWS][G_BN];  // stationary B tile
  __shared__ Kept strip[G_BM][G_KROWS];  // < G_KROWS kept values a row

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int row0 = blockIdx.y * G_BM;
  const int col0 = blockIdx.x * G_BN;
  const int gblocks = G_KROWS / m;   // m-blocks per K step
  const int nblocks = K / m;         // m-blocks along K
  const int kc = nblocks * n;        // kept values per row of A
  const int gcol = col0 + tid % G_BN;  // the B column this thread stages

  float acc[G_ROWS][2];
#pragma unroll
  for (int i = 0; i < G_ROWS; ++i) acc[i][0] = acc[i][1] = 0.f;

  for (int kb0 = 0; kb0 < nblocks; kb0 += gblocks) {
    const int kr = min(gblocks, nblocks - kb0) * m;  // dense rows this step
    const int ks = kr / m * n;                       // kept values a row
    const int k0 = kb0 * m;
    // The B tile, read along Nc (coalesced) and widened to f32, and the A
    // strip as (value, row of the B tile) per kept value; every load of
    // the step is issued before any is used.
    float bt[G_BPASS];
#pragma unroll
    for (int t = 0; t < G_BPASS; ++t) {
      const int r = tid / G_BN + t * (G_THREADS / G_BN);
      bt[t] = (r < kr && gcol < Nc)
                  ? to_f32(b[(size_t)(k0 + r) * Nc + gcol]) : 0.f;
    }
    float av[G_APASS];
    int ax[G_APASS];
#pragma unroll
    for (int t = 0; t < G_APASS; ++t) {
      const int e = tid + t * G_THREADS;
      const int i = e / ks, j = e - (e / ks) * ks;
      ax[t] = -1;
      av[t] = 0.f;
      if (i < G_BM && row0 + i < Mr) {
        const size_t off = (size_t)(row0 + i) * kc + (size_t)kb0 * n + j;
        ax[t] = idx[off];
        av[t] = to_f32(vals[off]);
      }
    }
#pragma unroll
    for (int t = 0; t < G_BPASS; ++t) {
      const int r = tid / G_BN + t * (G_THREADS / G_BN);
      if (r < kr) bs[r][tid % G_BN] = bt[t];
    }
#pragma unroll
    for (int t = 0; t < G_APASS; ++t) {
      const int e = tid + t * G_THREADS;
      const int i = e / ks, j = e - (e / ks) * ks;
      if (i < G_BM) {
        const bool kept = ax[t] >= 0 && ax[t] < m;  // else it adds nothing
        strip[i][j].v = kept ? av[t] : 0.f;
        strip[i][j].r = kept ? (j / n) * m + ax[t] : 0;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < ks; ++j) {
#pragma unroll
      for (int i = 0; i < G_ROWS; ++i) {
        const Kept z = strip[warp * G_ROWS + i][j];  // broadcast: rs
        const float2 bv =
            *reinterpret_cast<const float2*>(&bs[z.r][lane * 2]);
        acc[i][0] = fmaf(z.v, bv.x, acc[i][0]);
        acc[i][1] = fmaf(z.v, bv.y, acc[i][1]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < G_ROWS; ++i) {
    const int gr = row0 + warp * G_ROWS + i;
    if (gr >= Mr) continue;
    const float sc = kScaled ? scales[gr] : 1.f;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int gc = col0 + lane * 2 + jj;
      if (gc < Nc)
        c[(size_t)gr * Nc + gc] =
            from_f32<TB>(kScaled ? __fmul_rn(acc[i][jj], sc) : acc[i][jj]);
    }
  }
}

template <typename TB, typename TV>
void indexmac_gather_launch(const void* vals, const void* idx,
                            const void* scales, const void* b, void* c,
                            int Mr, int K, int Nc, int n, int m,
                            cudaStream_t stream) {
  const dim3 grid((Nc + G_BN - 1) / G_BN, (Mr + G_BM - 1) / G_BM);
  indexmac_gather_kernel<TB, TV><<<grid, G_THREADS, 0, stream>>>(
      static_cast<const TV*>(vals), static_cast<const int8_t*>(idx),
      static_cast<const float*>(scales), static_cast<const TB*>(b),
      static_cast<TB*>(c), Mr, K, Nc, n, m);
}

}  // namespace nmk
