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
// What bounds it on an H100: the bytes (B, the compressed A and C once)
// and the kept multiply-adds over the f32 peak are both far below what
// the mechanism costs. Per kept value a warp reads one row segment of the
// stationary B tile from shared memory (16 bytes a lane for f32 B, 8 for
// bf16) for 4 FMAs a lane, so shared-memory bandwidth sets the pace:
// about 4.5 wavefronts per 128 FMAs in f32, 2.5 in bf16. The design keeps
// that read and removes everything else that waited around it.
//
// Design (the paper's registers mapped onto an SM):
// * One CTA of 128 threads per (BM x BN) tile of C and split of K. A row
//   group of LG lanes (16 or 8: the tile, chosen on the host,
//   kernels/padding.py gather_tile) spans BN = 4 LG columns; each lane
//   holds 4 columns of 4 rows (16 f32 accumulators), so BM = 512 / LG.
//   16 lanes a group resolve a step's strip in half the chunks a lane
//   that 8 do, 8 lanes pad narrow C (Nc = 196) less; the host weighs
//   both.
// * Split-K: the host splits the K steps so that the grid fills the
//   card once, up to G_CTAS CTAs per SM, fewer where the pattern's shared
//   memory allows fewer (padding.gather_ctas_per_sm); a second
//   wave costs more than the splits gain. Each split writes an f32
//   partial of its tile; the last CTA of a tile to arrive (an atomic
//   counter behind a release fence) adds the partials in split order and
//   writes C, then zeroes the counter for the next call. One launch a
//   call, and C is the same bit for bit from call to call. Grids that
//   fill the card run one split and write C directly.
// * Per K step (whole m-blocks: 32 dense rows, or one m-block for m > 32)
//   a ring of G_STAGES cp.async stages holds the (rows x BN) tile of B in
//   its own dtype (bf16 stays bf16 and is widened as it is read) and the
//   strip of A (vals and idx as they lie in HBM): step t + 3's copies are
//   in flight while step t's MACs run. Each copy is the widest (16, 8 or
//   4 bytes) that the operand's alignment allows, or element by element.
// * The strip is resolved once per step into (value, offset of B row)
//   pairs in shared memory, the offset being ((j / n) * m + idx) * BN,
//   four slots a lane at a time, with (j / n) * m from a table made once
//   per CTA (no division in the K loop; copies are mapped the same way).
//   Each warp resolves the rows its own groups read, so a step needs one
//   CTA barrier. The groups of a warp read consecutive rows, whose stride
//   is an odd multiple of 16 bytes, so their pair reads meet no bank
//   conflict; one 16-byte read brings two kept values (the scalar
//   register rs).
// * Per kept value a group does one indexed shared-memory row read,
//   B_tile[r][4l..4l+3], and four FMAs a lane: Hopper's nearest analogue
//   of vindexmac's indirect register-file read. No dense A tile is
//   expanded and the tensor cores are not used.
// * Values are accumulated, never stored, so indices that repeat in a
//   block (the zero-padded pairs of pad_compressed_kn) add up as
//   decompress_nm's one-hot sum does; an index outside [0, m) adds
//   nothing (its value is resolved to 0).
// * Ragged Mr, Nc and the K tail are masked in the kernel: only the valid
//   part of a tile is copied, strip slots past the K tail and rows past Mr
//   resolve to zero, columns past Nc are never stored; nothing is padded
//   in HBM.
// * bf16 B and bf16 values widen to f32 exactly, int8 values too; the
//   int8 kernel multiplies the fully reduced f32 sum by its row's scale
//   once (__fmul_rn: the product rounds on its own, as in the plain
//   version) and then casts to B's dtype.
#pragma once

#include <type_traits>

#include "mma.cuh"

namespace nmk {

constexpr int G_THREADS = 128;
constexpr int G_ROWS = 4;    // rows of C a thread holds
constexpr int G_COLS = 4;    // columns of C a thread holds
constexpr int G_STAGES = 4;  // cp.async ring of K steps
constexpr int G_KROWS = 32;  // dense rows of B a K step (whole m-blocks)
constexpr int G_MMAX = 64;   // largest m taken
constexpr int G_RED = 8;     // partials a thread loads at once when reducing
constexpr int G_SMEM_MAX = 227 * 1024;
constexpr int G_CTAS = 3;  // CTAs an SM holds at most (padding.GATHER_CTAS_MAX)

// tile code (padding.GATHER_TILES): 0, 1 -> LG = 16, 8 lanes a group
template <int LG>
struct GTile {
  static constexpr int GROUPS = G_THREADS / LG;
  static constexpr int BN = G_COLS * LG;
  static constexpr int BM = G_ROWS * GROUPS;
};

// dense rows of B a K step: whole m-blocks, at least one
__host__ __device__ inline int g_k_rows(int m) {
  return m > G_KROWS ? m : G_KROWS / m * m;
}

// shared memory of one CTA (padding.gather_smem mirrors it): a ring of
// G_STAGES stages (the B tile, the strip's vals and idx, rows padded to 16
// bytes), then the resolved strip of (value, B-row offset) pairs, then a
// table of each kept slot's m-block row
struct GLayout {
  int b_stage;  // bytes of a stage's B tile
  int v_ld;     // bytes of a staged row of vals
  int i_ld;     // bytes of a staged row of idx
  int stage;    // bytes of a stage
  int kept_ld;  // pairs (8 bytes) a resolved row: used width + 2
  int smem;
};
__host__ __device__ inline GLayout g_layout(int bm, int bn, int sb, int sv,
                                            int kr, int ks) {
  GLayout l;
  l.b_stage = round16(kr * bn * sb);
  l.v_ld = round16(ks * sv);
  l.i_ld = round16(ks);
  l.stage = l.b_stage + bm * (l.v_ld + l.i_ld);
  // used width a multiple of 4 pairs, + 2: the row stride is an odd
  // multiple of 16 bytes, so consecutive rows start in other banks
  l.kept_ld = (ks + 3) / 4 * 4 + 2;
  // then the first dense row of each kept slot's m-block (int32)
  l.smem = G_STAGES * l.stage + bm * l.kept_ld * 8 +
           round16((l.kept_ld - 2) * 4);
  return l;
}

struct GArgs {
  const void* vals;
  const int8_t* idx;
  const float* scales;  // int8 kernel only
  const void* b;
  void* c;
  float* partial;  // (tiles, splits, BM, BN) f32; splits > 1 only
  int* counters;   // (tiles,) zeros; splits > 1 only; left zeroed
  int Mr, K, Nc, n, m;
  int kr;     // dense rows of B a K step
  int ks;     // kept values a row a step
  int steps;  // K steps in all
  int per;    // K steps a split
  int b_bytes, v_bytes, i_bytes;  // copy widths: 16, 8, 4; 0 element-wise
  int c_vec;  // C rows allow one store of 4 elements
};

// rows x vcols elements of E from src (row stride ld) to dst (row stride
// dld); the rest of dst is left as it is (the kernel never reads it, or
// reads it only into outputs it discards). TPR threads a row, each taking
// every TPR-th copy of W bytes (cp.async, the tail of a row zero-filled),
// or every TPR-th element (W = 0: loads batched 8 at a time, then stored).
template <typename E, int TPR, int W>
__device__ __forceinline__ void g_copy(E* dst, int dld, const E* src,
                                       size_t ld, int rows, int vcols,
                                       int tid) {
  constexpr int RSTEP = G_THREADS / TPR;
  const int r0 = tid / TPR, c0 = tid % TPR;
  if constexpr (W == 0) {
#pragma unroll 1
    for (int r = r0; r < rows; r += RSTEP) {
#pragma unroll 1
      for (int cb = c0; cb < vcols; cb += 8 * TPR) {
        E v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (cb + u * TPR < vcols) v[u] = src[r * ld + cb + u * TPR];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (cb + u * TPR < vcols) dst[r * dld + cb + u * TPR] = v[u];
      }
    }
  } else {
    constexpr int EPC = W / static_cast<int>(sizeof(E));
    const int cpr = (vcols + EPC - 1) / EPC;
#pragma unroll 1
    for (int r = r0; r < rows; r += RSTEP) {
#pragma unroll 1
      for (int c = c0; c < cpr; c += TPR) {
        const int e = c * EPC;
        cp_async<W>(dst + r * dld + e, src + r * ld + e,
                    min(vcols - e, EPC) * static_cast<int>(sizeof(E)));
      }
    }
  }
}

template <typename E, int TPR>
__device__ __forceinline__ void g_copy_any(int w, E* dst, int dld,
                                           const E* src, size_t ld, int rows,
                                           int vcols, int tid) {
  if (w == 16)
    g_copy<E, TPR, 16>(dst, dld, src, ld, rows, vcols, tid);
  else if (w == 8)
    g_copy<E, TPR, 8>(dst, dld, src, ld, rows, vcols, tid);
  else if (w == 4)
    g_copy<E, TPR, 4>(dst, dld, src, ld, rows, vcols, tid);
  else
    g_copy<E, TPR, 0>(dst, dld, src, ld, rows, vcols, tid);
}

// 4 consecutive staged values of A, widened to f32
__device__ __forceinline__ void g_vals4(const float* p, float (&v)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
}
__device__ __forceinline__ void g_vals4(const __nv_bfloat16* p,
                                        float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(u.x << 16), v[1] = __uint_as_float(u.x & 0xffff0000u);
  v[2] = __uint_as_float(u.y << 16), v[3] = __uint_as_float(u.y & 0xffff0000u);
}
__device__ __forceinline__ void g_vals4(const int8_t* p, float (&v)[4]) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    v[k] = static_cast<float>(static_cast<int8_t>(u >> (8 * k)));
}

// 4 consecutive elements of the B tile, widened to f32
__device__ __forceinline__ float4 g_load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 g_load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ void g_fma4(float (&a)[G_COLS], float v,
                                       const float4& b) {
  a[0] = fmaf(v, b.x, a[0]);
  a[1] = fmaf(v, b.y, a[1]);
  a[2] = fmaf(v, b.z, a[2]);
  a[3] = fmaf(v, b.w, a[3]);
}

// TB: B and C; TV: vals (f32 or bf16, or int8_t with per-row f32 scales);
// LG: lanes of a row group
template <typename TB, typename TV, int LG>
__global__ void __launch_bounds__(G_THREADS, G_CTAS)
indexmac_gather_kernel(const GArgs p) {
  using TL = GTile<LG>;
  constexpr int BM = TL::BM, BN = TL::BN, GROUPS = TL::GROUPS;
  constexpr bool kScaled = std::is_same<TV, int8_t>::value;
  constexpr int TPR_A = G_THREADS / BM;  // threads a strip row
  constexpr int B_CPR = BN * static_cast<int>(sizeof(TB)) / 16;
  constexpr int TPR_B = B_CPR < 32 ? B_CPR : 32;  // threads a B row
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int is_last;
  const GLayout L = g_layout(BM, BN, sizeof(TB), sizeof(TV), p.kr, p.ks);
  float4* kept = reinterpret_cast<float4*>(smem + G_STAGES * L.stage);
  int* boff = reinterpret_cast<int*>(kept + BM * (L.kept_ld / 2));
  const int kq_ld = L.kept_ld / 2;  // 16-byte pairs of pairs a row
  const int ksp = L.kept_ld - 2;    // resolved width, a multiple of 4

  const int tid = threadIdx.x;
  const int g = tid / LG, l = tid % LG;
  const int col0 = blockIdx.x * BN, row0 = blockIdx.y * BM;
  const int split = blockIdx.z, splits = gridDim.z;
  const int s0 = split * p.per;
  const int ns = min(p.per, p.steps - s0);  // K steps of this split
  const size_t kc = static_cast<size_t>(p.K / p.m) * p.n;
  const int vrows = min(BM, p.Mr - row0);
  const int vcols = min(BN, p.Nc - col0);
  const TB* b = static_cast<const TB*>(p.b);
  const TV* vals = static_cast<const TV*>(p.vals);

  // first dense row of the m-block of each kept slot of a step
  for (int j = tid; j < ksp; j += G_THREADS) boff[j] = j / p.n * p.m;

  // the copies of this split's step t into ring slot t % G_STAGES: the
  // valid part of the B tile and of the strip's vals and idx; one commit
  // group a step, empty past the last
  auto load_step = [&](int t) {
    if (t < ns) {
      unsigned char* st = smem + (t % G_STAGES) * L.stage;
      const int s = s0 + t;
      const int k0 = s * p.kr;
      const int rows = min(p.kr, p.K - k0);
      const int kv = rows / p.m * p.n;
      g_copy_any<TB, TPR_B>(p.b_bytes, reinterpret_cast<TB*>(st), BN,
                            b + static_cast<size_t>(k0) * p.Nc + col0, p.Nc,
                            rows, vcols, tid);
      const size_t a0 = static_cast<size_t>(row0) * kc +
                        static_cast<size_t>(s) * p.ks;
      g_copy_any<TV, TPR_A>(p.v_bytes, reinterpret_cast<TV*>(st + L.b_stage),
                            L.v_ld / static_cast<int>(sizeof(TV)), vals + a0,
                            kc, vrows, kv, tid);
      g_copy_any<int8_t, TPR_A>(
          p.i_bytes,
          reinterpret_cast<int8_t*>(st + L.b_stage + BM * L.v_ld), L.i_ld,
          p.idx + a0, kc, vrows, kv, tid);
    }
    cp_async_commit();
  };

  float acc[G_ROWS][G_COLS];
#pragma unroll
  for (int i = 0; i < G_ROWS; ++i)
#pragma unroll
    for (int c = 0; c < G_COLS; ++c) acc[i][c] = 0.f;

#pragma unroll 1
  for (int t = 0; t < G_STAGES - 1; ++t) load_step(t);

  // the strip rows this warp's groups read, and the 4-slot chunks of one
  // of them that this lane resolves: a warp resolves its own rows, so the
  // strip needs no CTA barrier between the resolve and the MACs
  constexpr int GPW = 32 / LG;             // row groups a warp
  constexpr int TPRW = 32 / (G_ROWS * GPW);  // lanes a strip row
  const int lane = tid % 32, lr = lane / TPRW, rc = lane % TPRW;
  const int ri = (tid / 32) * GPW + lr % GPW + lr / GPW * GROUPS;
  const bool row_ok = ri < vrows;
  const unsigned m_u = p.m;

#pragma unroll 1
  for (int t = 0; t < ns; ++t) {
    cp_async_wait<G_STAGES - 2>();  // this thread's copies of step t
    __syncthreads();  // everyone's; step t - 1's slot and strip are free
    load_step(t + G_STAGES - 1);

    const unsigned char* st = smem + (t % G_STAGES) * L.stage;
    const int rows = min(p.kr, p.K - (s0 + t) * p.kr);
    const int kv = rows / p.m * p.n;  // kept values a row this step
    {  // resolve the strip: (value, offset of its B row) per kept value
      const TV* sv = reinterpret_cast<const TV*>(st + L.b_stage) +
                     ri * (L.v_ld / static_cast<int>(sizeof(TV)));
      const int8_t* si = reinterpret_cast<const int8_t*>(
                             st + L.b_stage + BM * L.v_ld) + ri * L.i_ld;
#pragma unroll 1
      for (int j0 = rc * 4; j0 < ksp; j0 += TPRW * 4) {
        const int4 bo = *reinterpret_cast<const int4*>(boff + j0);
        const uint32_t xs = *reinterpret_cast<const uint32_t*>(si + j0);
        float v[4];
        g_vals4(sv + j0, v);
        const int base[4] = {bo.x, bo.y, bo.z, bo.w};
        float o[8];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int x = static_cast<int8_t>(xs >> (8 * u));
          // an index outside [0, m) adds nothing
          const bool ok = row_ok && j0 + u < kv &&
                          static_cast<unsigned>(x) < m_u;
          o[2 * u] = ok ? v[u] : 0.f;
          o[2 * u + 1] = __int_as_float(ok ? (base[u] + x) * BN : 0);
        }
        kept[ri * kq_ld + j0 / 2] = make_float4(o[0], o[1], o[2], o[3]);
        kept[ri * kq_ld + j0 / 2 + 1] = make_float4(o[4], o[5], o[6], o[7]);
      }
    }
    __syncwarp();

    const TB* bt = reinterpret_cast<const TB*>(st) + l * G_COLS;
    const int pairs = (kv + 1) / 2;
#pragma unroll 4
    for (int q = 0; q < pairs; ++q) {
#pragma unroll
      for (int i = 0; i < G_ROWS; ++i) {
        const float4 z = kept[(g + i * GROUPS) * kq_ld + q];  // broadcast
        const float4 b0 = g_load4(bt + __float_as_int(z.y));
        const float4 b1 = g_load4(bt + __float_as_int(z.w));
        g_fma4(acc[i], z.x, b0);
        g_fma4(acc[i], z.z, b1);
      }
    }
  }
  cp_async_wait<0>();

  const int gc = col0 + l * G_COLS;
  TB* c = static_cast<TB*>(p.c);
  if (splits > 1) {
    // this split's partial, then the tile's counter; the last CTA of the
    // tile adds the partials in split order
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    float* part = p.partial + static_cast<size_t>(tile) * splits * BM * BN;
    if (gc < p.Nc) {
#pragma unroll
      for (int i = 0; i < G_ROWS; ++i) {
        const int r = g + i * GROUPS;
        if (row0 + r < p.Mr)
          __stcg(reinterpret_cast<float4*>(
                     part + (static_cast<size_t>(split) * BM + r) * BN + gc -
                     col0),
                 make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
      }
    }
    __syncthreads();  // every partial store of the CTA precedes the release
    if (tid == 0) {
      asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
      is_last = atomicAdd(&p.counters[tile], 1) == splits - 1;
      if (is_last) asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
    }
    __syncthreads();
    if (!is_last) return;
    if (gc < p.Nc) {
      float sum[G_ROWS][G_COLS];
#pragma unroll 1
      for (int s = 0; s < splits; s += G_RED) {
        float4 got[G_RED][G_ROWS];
#pragma unroll
        for (int u = 0; u < G_RED; ++u)
#pragma unroll
          for (int i = 0; i < G_ROWS; ++i) {
            const int r = g + i * GROUPS;
            got[u][i] = (s + u < splits && s + u != split &&
                         row0 + r < p.Mr)
                            ? __ldcg(reinterpret_cast<const float4*>(
                                  part +
                                  (static_cast<size_t>(s + u) * BM + r) * BN +
                                  gc - col0))
                            : make_float4(acc[i][0], acc[i][1], acc[i][2],
                                          acc[i][3]);
          }
#pragma unroll
        for (int u = 0; u < G_RED; ++u) {
          if (s + u >= splits) break;
#pragma unroll
          for (int i = 0; i < G_ROWS; ++i) {
            const float4 v = got[u][i];
            if (s + u == 0) {
              sum[i][0] = v.x, sum[i][1] = v.y, sum[i][2] = v.z,
              sum[i][3] = v.w;
            } else {
              sum[i][0] = __fadd_rn(sum[i][0], v.x);
              sum[i][1] = __fadd_rn(sum[i][1], v.y);
              sum[i][2] = __fadd_rn(sum[i][2], v.z);
              sum[i][3] = __fadd_rn(sum[i][3], v.w);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < G_ROWS; ++i)
#pragma unroll
        for (int cc = 0; cc < G_COLS; ++cc) acc[i][cc] = sum[i][cc];
    }
    if (tid == 0) p.counters[tile] = 0;  // ready for the next call
  }

  if (gc >= p.Nc) return;
#pragma unroll
  for (int i = 0; i < G_ROWS; ++i) {
    const int gr = row0 + g + i * GROUPS;
    if (gr >= p.Mr) continue;
    float o[G_COLS];
    const float sc = kScaled ? p.scales[gr] : 1.f;
#pragma unroll
    for (int cc = 0; cc < G_COLS; ++cc)
      o[cc] = kScaled ? __fmul_rn(acc[i][cc], sc) : acc[i][cc];
    TB* dst = c + static_cast<size_t>(gr) * p.Nc + gc;
    if (p.c_vec && gc + G_COLS <= p.Nc) {
      if constexpr (std::is_same<TB, float>::value) {
        *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
      } else {
        __nv_bfloat162 lo = __floats2bfloat162_rn(o[0], o[1]);
        __nv_bfloat162 hi = __floats2bfloat162_rn(o[2], o[3]);
        uint2 u;
        u.x = *reinterpret_cast<uint32_t*>(&lo);
        u.y = *reinterpret_cast<uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(dst) = u;
      }
    } else {
#pragma unroll
      for (int cc = 0; cc < G_COLS; ++cc)
        if (gc + cc < p.Nc) dst[cc] = from_f32<TB>(o[cc]);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

using GatherFn = void (*)(GArgs);

template <typename TB, typename TV>
GatherFn gather_fn(int tile) {
  if (tile == 0) return indexmac_gather_kernel<TB, TV, 16>;
  return indexmac_gather_kernel<TB, TV, 8>;
}

// the kernel of tile code `tile` for this pattern and its shared memory;
// raises the CTA's shared-memory limit where it needs more than 48 KB
template <typename TB, typename TV>
int gather_prepare(int tile, int n, int m, GatherFn* fn, int* smem) {
  if (tile < 0 || tile > 1 || n < 1 || n >= m || m > G_MMAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int lg = 16 >> tile;
  const int kr = g_k_rows(m);
  const GLayout L = g_layout(G_ROWS * G_THREADS / lg, G_COLS * lg,
                             sizeof(TB), sizeof(TV), kr, kr / m * n);
  *fn = gather_fn<TB, TV>(tile);
  *smem = L.smem;
  if (L.smem > G_SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (L.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(*fn),
        cudaFuncAttributeMaxDynamicSharedMemorySize, L.smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

// One launch: tile code, K steps a split and the split count from the
// host (padding.gather_plan); the split count must be what they give.
template <typename TB, typename TV>
int indexmac_gather_launch(const void* vals, const void* idx,
                           const void* scales, const void* b, void* c,
                           void* partial, void* counters, int Mr, int K,
                           int Nc, int n, int m, int tile, int per,
                           int splits, cudaStream_t stream) {
  GatherFn fn = nullptr;
  int smem = 0;
  const int rc = gather_prepare<TB, TV>(tile, n, m, &fn, &smem);
  if (rc != 0) return rc;
  GArgs p{vals, static_cast<const int8_t*>(idx),
          static_cast<const float*>(scales), b, c,
          static_cast<float*>(partial), static_cast<int*>(counters),
          Mr, K, Nc, n, m};
  p.kr = g_k_rows(m);
  p.ks = p.kr / m * n;
  p.steps = (K + p.kr - 1) / p.kr;
  p.per = per;
  if (per < 1 || splits != (p.steps + per - 1) / per ||
      (splits > 1 && (partial == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int lg = 16 >> tile;
  const int bm = G_ROWS * G_THREADS / lg, bn = G_COLS * lg;
  const size_t kc = static_cast<size_t>(K / m) * n;
  p.b_bytes = copy_bytes(b, sizeof(TB) * static_cast<size_t>(Nc),
                           sizeof(TB) * bn, sizeof(TB));
  p.v_bytes = copy_bytes(vals, sizeof(TV) * kc, sizeof(TV) * p.ks,
                           sizeof(TV));
  p.i_bytes = copy_bytes(idx, kc, p.ks, 1);
  p.c_vec = copy_bytes(c, sizeof(TB) * static_cast<size_t>(Nc),
                         sizeof(TB) * G_COLS, sizeof(TB)) >=
            static_cast<int>(sizeof(TB)) * G_COLS;
  const dim3 grid((Nc + bn - 1) / bn, (Mr + bm - 1) / bm, splits);
  void* args[] = {&p};
  const cudaError_t e = cudaLaunchKernel(reinterpret_cast<const void*>(fn),
                                         grid, dim3(G_THREADS), args, smem,
                                         stream);
  return static_cast<int>(e);
}

// CTAs per SM (out[0]), threads (out[1]) and dynamic shared memory
// (out[2]) of the kernel a call with this tile and pattern launches
template <typename TB, typename TV>
int indexmac_gather_occupancy(int tile, int n, int m, int* out) {
  GatherFn fn = nullptr;
  int smem = 0;
  int rc = gather_prepare<TB, TV>(tile, n, m, &fn, &smem);
  out[0] = 0;
  if (rc == 0)
    rc = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[0], reinterpret_cast<const void*>(fn), G_THREADS, smem));
  out[1] = G_THREADS;
  out[2] = smem;
  return rc;
}

}  // namespace nmk
