// bs_attention: block-sparse prefill attention over the live (q-block,
// k-block) pairs of a compiled MaskPlan, with GQA. For query row i of
// head h (KV head h / (Hq / Hkv)) and the keys j of its q-block's live
// k-blocks, in ascending order:
//
//   s_ij = mask_ij ? q_i . k_j * scale : -1e30
//   online softmax over the s_ij, out_i = sum_j p_ij v_j / max(l_i, 1e-30)
//
// with f32 scores, softmax state and sums, out in q's dtype (f32 or
// bf16). Replaces the TPU kernel
// src/repro/kernels/blocksparse_attn/kernel.py _bs_attn_call (body
// _bs_attn_kernel), reached through run_bs_attention_tpu.
//
// What bounds it on an H100: at the served shape (yi-9b, B 2, 1024
// tokens, Hq 32 / Hkv 4, head dim 128, local window 192 at block 64) the
// bytes (q, k, v and out once, the mask tiles) take about 0.011 ms at
// 3.35 TB/s and the live tokens' multiply-adds about 0.006 ms at the bf16
// tensor-core rate, so bytes bound the bf16 call; in f32 the operations
// bound it (about 0.035 ms at the 3xTF32 rate, 0.09 ms on the CUDA
// cores, where this kernel's f32 path runs). At MLA's shape (deepseek,
// B 2, 1024 tokens, Hq = Hkv = 16, dk 192, dv 128, the same mask) bytes
// bound the bf16 call too, about 0.0126 ms; the <192, 128> kernel takes
// about 6.7 times that (PERF.md; an H100 80GB HBM3 at 700 W), one CTA an
// SM, since G' = 1 there and its 121,856 bytes of shared memory leave no
// room for a second.
//
// Two kernels behind one C entry (bs_attention.cu):
//
// bf16: bs_attention_mma_kernel, on the tensor cores. At the served
// shape it takes about 6 times its bound (PERF.md; an H100 80GB HBM3 at
// 700 W): a CTA walks only 3-4 chunks, so its fixed costs (q in, out
// back, the first chunk's copies) weigh as much as the products, and
// every warp reads whole K and V chunks from shared memory for its 16
// rows.
// * mma.sync m16n8k16 (bf16 in, f32 accumulation) with ldmatrix, in
//   FlashAttention-2's layout: each warp owns 16 query rows of one head;
//   S = Q K^T leaves the scores in the accumulator fragments, where the
//   softmax runs, and P goes from those registers straight into the A
//   operand of O += P V (V read with ldmatrix.trans, so V stays in its
//   [key][dv] layout). Chosen over wgmma m64nNk16: a CTA here walks only
//   a few 64-key chunks (3-4 at the served shape), so wgmma's deeper
//   asynchrony has little to hide, while mma.sync takes any head dim
//   through padded, conflict-free rows (no swizzled layout) and keeps the
//   kernel's registers under the 128 that two CTAs per SM allow. wgmma is
//   the next step if the products come to dominate.
// * GQA: a CTA takes one 64-row part of a q-block for G' q heads of one
//   KV head (4 G' warps; G' from kernels/blocksparse_attn/kernel.py
//   heads_per_cta: 2 where Hq / Hkv is even and the grid still gives every
//   SM a CTA, else 1). Each K/V chunk and its mask tile (which depends only
//   on positions) is staged once for the G' 64 rows, which divides the
//   L2 reads of K, V and the masks by G'. 128 registers and 112 KB of
//   shared memory at G' = 2 keep two CTAs on an SM.
// * Order: the grid is 1-D, head groups fastest and q-block parts last
//   to first, so the longest q-blocks of a causal mask start first and
//   CTAs that run together share their q-block's K/V chunks in L2.
// * Chunks: the q-block's live pairs, walked through CSR row pointers,
//   are one run of n_pairs * bk key slots; chunk c is slots [64 c, 64 c +
//   64) of that run, whatever bk is (4 pairs of 16 keys, one pair of 64,
//   half a pair of 128). Slots past the run, keys >= Skv and rows past the
//   q-block are zero-filled and masked.
// * Staging: cp.async, double-buffered: chunk c + 1's K, V and mask tile
//   are copied while chunk c is multiplied (q with chunk 0). Each operand
//   uses the widest of 16, 8 or 4 bytes that its base and strides allow
//   (bs_attention.cu), element by element below that; nothing is padded
//   or transposed in HBM. Head dims are zero-filled up to D in shared
//   memory (the padded dims are compile-time: with them at run time the
//   kernel spilled registers and ran slower); rows are padded by 16
//   bytes, so the eight rows of an ldmatrix fall in distinct banks. The output tile goes back through shared memory, in
//   whole-row stores.
// * Softmax in registers, in log2 units: s = (q . k) * (scale * log2 e),
//   p = exp2(s - m). The scale multiplies the f32 score after the product;
//   the TPU kernel (and the f32 path) scale q first, (q * scale) . k,
//   which a bf16 q could not carry without one more rounding. Row max and
//   row sum stay per thread and are combined across the quad (the four
//   lanes of a row) with shuffles; the sum only once, at the end. P is
//   rounded to bf16 for P V, and l sums the rounded P, so out is the
//   weighted mean of v under exactly the weights the product used. A row
//   that sees nothing in its first chunk takes p = 1 on masked lanes until
//   a real score arrives and corr = 0 wipes them, as on the TPU. Rows >=
//   Sq are never written. ref.blocksparse_mma is the plain twin of this
//   arithmetic.
// * Templated on the padded head dims DK and DV (dk <= DK, dv <= DV): K's
//   and q's rows and the S = Q K^T loop (DK / 16 k16 steps) follow DK, V's
//   rows, the O accumulators and the output tile DV. Built at <128, 128>
//   (GQA) and <192, 128> (MLA's K = [k_nope 128 | k_rope 64] and V 128);
//   the host takes the narrower one that fits dk. <192, 128> keeps the
//   registers of <128, 128> (O stays 64 f32 a thread; q and K fragments
//   come from shared memory a k16 step at a time), but its K rows and q
//   tiles are half as long again.
//
// f32: bs_attention_kernel<float>, the exact-f32 first version on the
// CUDA cores, as before.
// * One CTA per (64-row part of a q-block, q head, batch); a pair's bk
//   keys in chunks of at most 64, each one online-softmax step. Its dk
//   loop runs to the call's dk, so only the shared memory grows with it
//   (bs_smem_bytes: 149 KB at dk 192, dv 128).
// * q staged once as f32 * scale (the TPU's order); K, V and the chunk's
//   (rows x keys) mask tile staged per chunk.
// * 256 threads: thread (ty, tx) = (tid / 16, tid % 16) holds rows
//   ty + 16 i (i < 4), score columns tx + 16 j (j < 4) and output
//   columns tx + 16 j (j < 8, dv <= 128); row max and row sum are
//   butterfly shuffles over the 16 lanes of a row.
// * The arithmetic is the TPU kernel's, in its order: m_new = max(m,
//   rowmax s), p = exp(s - m_new), corr = exp(m - m_new), l = l * corr +
//   sum p, acc = acc * corr + p @ v, out = acc / max(l, 1e-30). expf, not
//   __expf; no fast math.
// * Shared-memory rows are padded to an odd number of 32-bit words, so
//   the 16 distinct rows a warp reads at once fall in 16 banks.
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace nmk {

constexpr int BS_THREADS = 256;
constexpr int BS_TQ = 64;     // query rows per CTA
constexpr int BS_TK = 64;     // keys per online-softmax step
constexpr int BS_MAXDK = 192;  // dk (MLA's nope 128 + rope 64)
constexpr int BS_MAXDV = 128;  // dv
constexpr int BS_STAGE = 8;   // staging loads a thread issues before storing
constexpr int BS_LDP = BS_TK + 1;  // row stride of the P tile (odd words)
constexpr float BS_NEG_INF = -1e30f;

struct BsParams {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  const int* row_ptr;    // (nqb + 1,) CSR pointers into pair_k
  const int* pair_k;     // (n_live,) live k-blocks, ascending per q-block
  const uint8_t* masks;  // (n_live, bq, bk) token masks of the live pairs
  long long q_sb, q_ss, q_sh;  // strides in elements; the last dim is 1
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int batch, sq, skv, hq, hkv, dk, dv, bq, bk, nsub;
  float scale;
  // the bf16 kernel's: q heads per CTA, each operand's copy width in bytes
  // (0: element by element) and scale * log2(e)
  int group, q_bytes, k_bytes, v_bytes, m_bytes, o_bytes;
  float scale_log2;
};

// elements per row of a shared tile of `width` T's, padded to an odd
// number of 32-bit words
template <typename T>
__host__ __device__ inline int bs_ld(int width) {
  const int per_word = 4 / static_cast<int>(sizeof(T));
  int ld = (width + per_word - 1) / per_word * per_word;
  if ((ld / per_word) % 2 == 0) ld += per_word;
  return ld;
}

template <typename T>
__host__ __device__ inline size_t bs_smem_bytes(int dk, int dv) {
  return sizeof(float) * (size_t)BS_TQ * (bs_ld<float>(dk) + BS_LDP) +
         sizeof(T) * (size_t)BS_TK * (bs_ld<T>(dk) + bs_ld<T>(dv)) +
         (size_t)BS_TQ * BS_TK;
}

// dst[r * ld + d] = src[r * stride + d] for r < valid, d < width; zero
// for valid <= r < rows. A thread issues BS_STAGE loads before storing.
template <typename T>
__device__ __forceinline__ void bs_stage(T* dst, int ld,
                                         const T* __restrict__ src,
                                         long long stride, int valid,
                                         int rows, int width, int tid) {
  const int total = rows * width;
  for (int base = 0; base < total; base += BS_THREADS * BS_STAGE) {
    T tmp[BS_STAGE];
#pragma unroll
    for (int u = 0; u < BS_STAGE; ++u) {
      const int e = base + u * BS_THREADS + tid;
      const int r = e / width, d = e - r * width;
      tmp[u] = (e < total && r < valid) ? src[r * stride + d]
                                        : from_f32<T>(0.f);
    }
#pragma unroll
    for (int u = 0; u < BS_STAGE; ++u) {
      const int e = base + u * BS_THREADS + tid;
      const int r = e / width, d = e - r * width;
      if (e < total) dst[r * ld + d] = tmp[u];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(BS_THREADS)
bs_attention_kernel(const BsParams p) {
  extern __shared__ __align__(16) unsigned char bs_smem[];
  const int ldq = bs_ld<float>(p.dk), ldk = bs_ld<T>(p.dk),
            ldv = bs_ld<T>(p.dv);
  float* qs = reinterpret_cast<float*>(bs_smem);        // [BS_TQ][ldq]
  float* ps = qs + BS_TQ * ldq;                          // [BS_TQ][BS_LDP]
  T* ks = reinterpret_cast<T*>(ps + BS_TQ * BS_LDP);     // [BS_TK][ldk]
  T* vs = ks + BS_TK * ldk;                              // [BS_TK][ldv]
  uint8_t* ms = reinterpret_cast<uint8_t*>(vs + BS_TK * ldv);  // [TQ][TK]

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int qb = blockIdx.x / p.nsub, sub = blockIdx.x % p.nsub;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.hq / p.hkv);
  const int r0 = sub * BS_TQ;                 // first row inside the q-block
  const int tq = min(BS_TQ, p.bq - r0);       // rows of this CTA
  const int q0 = qb * p.bq + r0;              // its first query position
  const int qvalid = max(0, min(tq, p.sq - q0));

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  // the q part, once: f32(q) * scale, zero rows past Sq and past tq
  for (int base = 0; base < BS_TQ * p.dk; base += BS_THREADS * BS_STAGE) {
    float tmp[BS_STAGE];
#pragma unroll
    for (int u = 0; u < BS_STAGE; ++u) {
      const int e = base + u * BS_THREADS + tid;
      const int r = e / p.dk, d = e - r * p.dk;
      tmp[u] = (e < BS_TQ * p.dk && r < qvalid)
                   ? to_f32(qg[(q0 + r) * p.q_ss + d]) * p.scale : 0.f;
    }
#pragma unroll
    for (int u = 0; u < BS_STAGE; ++u) {
      const int e = base + u * BS_THREADS + tid;
      const int r = e / p.dk, d = e - r * p.dk;
      if (e < BS_TQ * p.dk) qs[r * ldq + d] = tmp[u];
    }
  }

  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = BS_NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  const int pend = p.row_ptr[qb + 1];
  for (int pi = p.row_ptr[qb]; pi < pend; ++pi) {
    const int kb = p.pair_k[pi];
    const uint8_t* mg = p.masks + ((size_t)pi * p.bq + r0) * p.bk;
    for (int kc0 = 0; kc0 < p.bk; kc0 += BS_TK) {
      const int kcn = min(BS_TK, p.bk - kc0);   // keys of this step
      const int key0 = kb * p.bk + kc0;
      const int kvalid = max(0, min(kcn, p.skv - key0));
      __syncthreads();  // the previous step's readers are done
      bs_stage<T>(ks, ldk, kg + key0 * p.k_ss, p.k_ss, kvalid, BS_TK, p.dk,
                  tid);
      bs_stage<T>(vs, ldv, vg + key0 * p.v_ss, p.v_ss, kvalid, BS_TK, p.dv,
                  tid);
      for (int e = tid; e < BS_TQ * BS_TK; e += BS_THREADS) {
        const int r = e / BS_TK, c = e % BS_TK;
        ms[e] = (r < tq && c < kcn) ? mg[r * p.bk + kc0 + c] : 0;
      }
      __syncthreads();

      // scores: rows ty + 16 i, columns tx + 16 j
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < p.dk; ++d) {
        float a[4], kk[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * ldq + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) kk[j] = to_f32(ks[(tx + 16 * j) * ldk + d]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], kk[j], s[i][j]);
      }

      // online softmax: one step over this chunk
      float corr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        float mx = BS_NEG_INF;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (!ms[r * BS_TK + tx + 16 * j]) s[i][j] = BS_NEG_INF;
          mx = fmaxf(mx, s[i][j]);
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[i], mx);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float pe = expf(s[i][j] - m_new);
          ps[r * BS_LDP + tx + 16 * j] = pe;
          sum += pe;
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        corr[i] = expf(m[i] - m_new);
        l[i] = l[i] * corr[i] + sum;
        m[i] = m_new;
      }
      __syncthreads();

      // acc = acc * corr + p @ v over the chunk's keys (zero-filled keys
      // past kcn would add exact zeros and are skipped)
      float pv[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) pv[i][j] = 0.f;
#pragma unroll 2
      for (int c = 0; c < kcn; ++c) {
        float pr[4], vv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) pr[i] = ps[(ty + 16 * i) * BS_LDP + c];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = tx + 16 * j;
          vv[j] = col < p.dv ? to_f32(vs[c * ldv + col]) : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) pv[i][j] = fmaf(pr[i], vv[j], pv[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = acc[i][j] * corr[i] + pv[i][j];
    }
  }

  T* og = static_cast<T*>(p.out) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= qvalid) continue;
    const float norm = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = tx + 16 * j;
      if (col < p.dv) og[(q0 + r) * p.o_ss + col] = from_f32<T>(acc[i][j] / norm);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int BM_ROWS = 64;     // query rows of one head per CTA (4 warps)
constexpr int BM_KEYS = 64;     // key slots per online-softmax step
constexpr int BM_GROUP_MAX = 2;  // q heads per CTA
constexpr int BM_STAGES = 2;     // K/V/mask stages in flight
constexpr int BM_MLD = 80;      // row stride of a mask tile, bytes
constexpr float BM_LOG2E = 1.4426950408889634f;

// Shared memory of the bf16 kernel at head dims up to DK and DV: G' q
// tiles [64][LDK], then BM_STAGES stages of K [64][LDK], V [64][LDV] and
// the mask tile [64][BM_MLD] bytes (after the last chunk, stage 0 holds the
// [64 G'][LDV] output tile). Head dims are zero-filled up to DK and DV;
// rows are 16 bytes longer, so LD / 2 words = 4 mod 8.
template <int DK, int DV>
struct BmLayout {
  static constexpr int LDK = DK + 8, LDV = DV + 8;
  static constexpr int STAGE =
      2 * BM_KEYS * (LDK + LDV) + BM_KEYS * BM_MLD;
  static_assert(2 * BM_GROUP_MAX * BM_ROWS * LDV <= STAGE,
                "the output tile fits in stage 0");
  static __host__ __device__ int q_bytes(int group) {
    return 2 * group * BM_ROWS * LDK;
  }
  static __host__ __device__ int bytes(int group) {
    return q_bytes(group) + BM_STAGES * STAGE;
  }
};

// One row of `cols` bf16 (a multiple of 16) into shared dst from src, its
// first `width` elements, zero beyond (all zero when src is null); the
// thread takes segments s0, s0 + step, ... BYTES per copy, 0: element by
// element. `any` is a valid, BYTES-aligned address for empty copies.
template <int BYTES>
__device__ __forceinline__ void bm_row(bf16* dst, const bf16* src, int cols,
                                       int width, int s0, int step,
                                       const void* any) {
  if constexpr (BYTES == 0) {
    for (int c = s0; c < cols; c += step)
      dst[c] = (src != nullptr && c < width) ? src[c]
                                             : __float2bfloat16_rn(0.f);
  } else {
    constexpr int EPC = BYTES / 2;
    for (int c = s0 * EPC; c < cols; c += step * EPC) {
      const int have = src != nullptr ? min(max(width - c, 0), EPC) : 0;
      cp_async<BYTES>(dst + c, have ? static_cast<const void*>(src + c) : any,
                      2 * have);
    }
  }
}

__device__ __forceinline__ void bm_row_any(int bytes, bf16* dst,
                                           const bf16* src, int cols,
                                           int width, int s0, int step,
                                           const void* any) {
  if (bytes == 16)
    bm_row<16>(dst, src, cols, width, s0, step, any);
  else if (bytes == 8)
    bm_row<8>(dst, src, cols, width, s0, step, any);
  else if (bytes == 4)
    bm_row<4>(dst, src, cols, width, s0, step, any);
  else
    bm_row<0>(dst, src, cols, width, s0, step, any);
}

template <int DK, int DV>
__global__ void __launch_bounds__(32 * 4 * BM_GROUP_MAX, 2)
bs_attention_mma_kernel(const BsParams p) {
  static_assert(DK % 16 == 0 && DV % 16 == 0,
                "head dims are multiples of the MMA's k16");
  extern __shared__ __align__(16) unsigned char bs_smem[];
  using L = BmLayout<DK, DV>;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid % 32, warp = tid / 32, g = lane / 4, t = lane % 4;
  // a 1-D grid over (q-block part, batch, head group), head groups
  // fastest and parts in descending order: CTAs start in that order, so
  // the last q-blocks (under a causal mask the longest) start first and
  // the short ones fill in behind them, and the CTAs running together
  // share their q-block's K/V chunks in L2
  const int groups = p.hq / p.group, hb = blockIdx.x % (groups * p.batch);
  const int part = gridDim.x / (groups * p.batch) - 1 -
                   blockIdx.x / (groups * p.batch);
  const int qb = part / p.nsub, sub = part % p.nsub;
  const int h0 = (hb % groups) * p.group, b = hb / groups;
  const int hk = h0 / (p.hq / p.hkv);
  const int r0 = sub * BM_ROWS;              // first row inside the q-block
  const int tq = min(BM_ROWS, p.bq - r0);    // rows of this part
  const int q0 = qb * p.bq + r0;             // its first query position
  const int qvalid = max(0, min(tq, p.sq - q0));
  if (qvalid == 0) return;  // the whole part lies past Sq

  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb + q0 * p.q_ss +
                   h0 * p.q_sh;
  bf16* qs = reinterpret_cast<bf16*>(bs_smem);
  auto kbuf = [&](int s) {
    return reinterpret_cast<bf16*>(bs_smem + L::q_bytes(p.group) +
                                   s * L::STAGE);
  };
  auto vbuf = [&](int s) { return kbuf(s) + BM_KEYS * L::LDK; };
  auto mbuf = [&](int s) {
    return reinterpret_cast<uint8_t*>(vbuf(s) + BM_KEYS * L::LDV);
  };
  const int p0 = p.row_ptr[qb], np = p.row_ptr[qb + 1] - p0;
  const int nch = (np * p.bk + BM_KEYS - 1) / BM_KEYS;

  // Chunk c into stage s: key slot r of the chunk is slot 64 c + r of the
  // q-block's run of live keys; 2 G' threads a slot copy its K and V rows.
  auto stage = [&](int c, int s) {
    const int tpr = nthreads / BM_KEYS;
    const int r = tid / tpr, f = c * BM_KEYS + r, rel = f / p.bk;
    const bf16 *ksrc = nullptr, *vsrc = nullptr;
    if (rel < np) {
      const int key = p.pair_k[p0 + rel] * p.bk + (f - rel * p.bk);
      if (key < p.skv) {
        ksrc = static_cast<const bf16*>(p.k) + b * p.k_sb + hk * p.k_sh +
               key * p.k_ss;
        vsrc = static_cast<const bf16*>(p.v) + b * p.v_sb + hk * p.v_sh +
               key * p.v_ss;
      }
    }
    bm_row_any(p.k_bytes, kbuf(s) + r * L::LDK, ksrc, DK, p.dk, tid % tpr,
               tpr, p.k);
    bm_row_any(p.v_bytes, vbuf(s) + r * L::LDV, vsrc, DV, p.dv, tid % tpr,
               tpr, p.v);
    // the mask tile: rows of this part, m_bytes slots a copy (bk is a
    // multiple of m_bytes, so a copy never spans two pairs)
    const int segs = BM_KEYS / p.m_bytes;
    for (int e = tid; e < BM_ROWS * segs; e += nthreads) {
      const int mr = e / segs, c0 = (e % segs) * p.m_bytes;
      const int fm = c * BM_KEYS + c0, relm = fm / p.bk;
      const bool ok = mr < tq && relm < np;
      const uint8_t* src =
          ok ? p.masks + ((size_t)(p0 + relm) * p.bq + r0 + mr) * p.bk +
                   (fm - relm * p.bk)
             : p.masks;
      uint8_t* dst = mbuf(s) + mr * BM_MLD + c0;
      if (p.m_bytes == 16)
        cp_async<16>(dst, src, ok ? 16 : 0);
      else
        cp_async<8>(dst, src, ok ? 8 : 0);
    }
  };

  {  // the q tiles, once: 2 threads a row, zero rows past Sq
    const int row = tid / 2, hh = row / BM_ROWS, r = row % BM_ROWS;
    bm_row_any(p.q_bytes, qs + row * L::LDK,
               r < qvalid ? qg + hh * p.q_sh + r * p.q_ss : nullptr, DK, p.dk,
               tid % 2, 2, p.q);
  }
#pragma unroll
  for (int c = 0; c < BM_STAGES - 1; ++c) {  // q goes with the first group
    if (c < nch) stage(c, c);
    cp_async_commit();
  }

  const int hh = warp / 4, wr = (warp % 4) * 16;  // head, first row (warp)
  const bool active = wr < qvalid;
  const float sl2 = p.scale_log2;
  float m[2] = {BS_NEG_INF, BS_NEG_INF}, l[2] = {0.f, 0.f};
  float o[DV / 8][4];
#pragma unroll
  for (int n = 0; n < DV / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int c = 0; c < nch; ++c) {
    const int ahead = c + BM_STAGES - 1;
    if (ahead < nch) stage(ahead, ahead % BM_STAGES);
    cp_async_commit();
    cp_async_wait<BM_STAGES - 1>();  // this thread's copies of chunk c
                                     // (and of q) landed
    __syncthreads();     // ... and every thread's
    if (active) {
      const bf16* ks = kbuf(c % BM_STAGES);
      const bf16* vs = vbuf(c % BM_STAGES);
      const uint8_t* ms = mbuf(c % BM_STAGES);
      const bf16* qw = qs + (hh * BM_ROWS + wr) * L::LDK;

      // S = Q K^T: rows wr + g (+ 8), key slots 8 j + 2 t (+ 1)
      float sc[BM_KEYS / 8][4];
#pragma unroll
      for (int j = 0; j < BM_KEYS / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, qw + (lane % 16) * L::LDK + kk * 16 + (lane / 16) * 8);
#pragma unroll
        for (int j = 0; j < BM_KEYS / 16; ++j) {
          uint32_t bb[4];
          ldmatrix_x4(bb, ks + (16 * j + (lane / 16) * 8 + lane % 8) * L::LDK +
                              kk * 16 + ((lane / 8) % 2) * 8);
          mma_bf16(sc[2 * j], a, bb[0], bb[1]);
          mma_bf16(sc[2 * j + 1], a, bb[2], bb[3]);
        }
      }

      // the mask, then the scale, in log2 units
      const uint8_t* mrow = ms + (wr + g) * BM_MLD + 2 * t;
#pragma unroll
      for (int j = 0; j < BM_KEYS / 8; ++j) {
        const unsigned lo = *reinterpret_cast<const uint16_t*>(mrow + 8 * j);
        const unsigned hi =
            *reinterpret_cast<const uint16_t*>(mrow + 8 * BM_MLD + 8 * j);
        sc[j][0] = (lo & 0xffu) ? sc[j][0] * sl2 : BS_NEG_INF;
        sc[j][1] = (lo >> 8) ? sc[j][1] * sl2 : BS_NEG_INF;
        sc[j][2] = (hi & 0xffu) ? sc[j][2] * sl2 : BS_NEG_INF;
        sc[j][3] = (hi >> 8) ? sc[j][3] * sl2 : BS_NEG_INF;
      }

      // one online-softmax step: rows g (i = 0) and g + 8 (i = 1); the
      // quad of a row shares its max, the sum stays per thread
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = m[i];
#pragma unroll
        for (int j = 0; j < BM_KEYS / 8; ++j)
          mx = fmaxf(mx, fmaxf(sc[j][2 * i], sc[j][2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float corr = exp2f(m[i] - mx);
        m[i] = mx;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < BM_KEYS / 8; ++j)
#pragma unroll
          for (int e = 2 * i; e < 2 * i + 2; ++e) {
            sc[j][e] = __bfloat162float(__float2bfloat16_rn(
                exp2f(sc[j][e] - mx)));  // P as the product takes it
            sum += sc[j][e];
          }
        l[i] = l[i] * corr + sum;
#pragma unroll
        for (int n = 0; n < DV / 8; ++n) {
          o[n][2 * i] *= corr;
          o[n][2 * i + 1] *= corr;
        }
      }

      // O += P V: P from the score registers as the A operand
#pragma unroll
      for (int j = 0; j < BM_KEYS / 16; ++j) {
        const uint32_t a[4] = {pack_bf16(sc[2 * j][0], sc[2 * j][1]),
                               pack_bf16(sc[2 * j][2], sc[2 * j][3]),
                               pack_bf16(sc[2 * j + 1][0], sc[2 * j + 1][1]),
                               pack_bf16(sc[2 * j + 1][2], sc[2 * j + 1][3])};
#pragma unroll
        for (int n = 0; n < DV / 16; ++n) {
          uint32_t bb[4];
          ldmatrix_x4_trans(
              bb, vs + (16 * j + ((lane / 8) % 2) * 8 + lane % 8) * L::LDV +
                      16 * n + (lane / 16) * 8);
          mma_bf16(o[2 * n], a, bb[0], bb[1]);
          mma_bf16(o[2 * n + 1], a, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();  // stage c % BM_STAGES is free for its next chunk
  }
  cp_async_wait<0>();

  // out = acc / max(l, 1e-30) in bf16, through shared memory: the loop
  // ended in a barrier, so the stages are free and stage 0 takes the
  // [64 G'][LDV] output tile; then whole rows go out in o_bytes stores
  bf16* os = kbuf(0);
  if (active) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float sum = l[i];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float norm = fmaxf(sum, 1e-30f);
      bf16* orow = os + (hh * BM_ROWS + wr + g + 8 * i) * L::LDV + 2 * t;
#pragma unroll
      for (int n = 0; n < DV / 8; ++n)
        *reinterpret_cast<uint32_t*>(orow + 8 * n) =
            pack_bf16(o[n][2 * i] / norm, o[n][2 * i + 1] / norm);
    }
  }
  __syncthreads();
  const int epc = p.o_bytes ? p.o_bytes / 2 : 1;  // elements a store
  const int segs = (p.dv + epc - 1) / epc;
  bf16* og = static_cast<bf16*>(p.out) + b * p.o_sb + h0 * p.o_sh +
             q0 * p.o_ss;
  for (int e = tid; e < p.group * BM_ROWS * segs; e += nthreads) {
    const int row = e / segs, c = (e % segs) * epc, r = row % BM_ROWS;
    if (r >= qvalid) continue;
    const bf16* src = os + row * L::LDV + c;
    bf16* dst = og + (row / BM_ROWS) * p.o_sh + r * p.o_ss + c;
    if (c + epc > p.dv || p.o_bytes == 0) {
      for (int k = 0; k < min(epc, p.dv - c); ++k) dst[k] = src[k];
    } else if (p.o_bytes == 16) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else if (p.o_bytes == 8) {
      *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
    } else {
      *reinterpret_cast<uint32_t*>(dst) =
          *reinterpret_cast<const uint32_t*>(src);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// The kernel of a call (dtype code of common.cuh), its threads per CTA
// and dynamic shared memory, with the function's shared-memory limit
// raised to fit: in bf16 the narrowest instantiation whose DK holds dk.
// Returns a CUDA error code (0 on success).
struct BsLaunch {
  const void* fn;
  int threads, smem;
};

inline int bs_prepare(int dtype, const BsParams& p, BsLaunch& out) {
  if (dtype == kF32)
    out = {reinterpret_cast<const void*>(bs_attention_kernel<float>),
           BS_THREADS, static_cast<int>(bs_smem_bytes<float>(p.dk, p.dv))};
  else if (p.dk <= 128)
    out = {reinterpret_cast<const void*>(bs_attention_mma_kernel<128, 128>),
           32 * 4 * p.group, BmLayout<128, 128>::bytes(p.group)};
  else
    out = {reinterpret_cast<const void*>(
               bs_attention_mma_kernel<BS_MAXDK, BS_MAXDV>),
           32 * 4 * p.group, BmLayout<BS_MAXDK, BS_MAXDV>::bytes(p.group)};
  cudaError_t e = cudaFuncSetAttribute(
      out.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, out.smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(out.fn,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  return static_cast<int>(e);
}

}  // namespace nmk
