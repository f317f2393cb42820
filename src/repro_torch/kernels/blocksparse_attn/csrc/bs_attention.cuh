// bs_attention: block-sparse prefill attention over the live (q-block,
// k-block) pairs of a compiled MaskPlan, with GQA. For query row i of
// head h (KV head h / (Hq / Hkv)) and the keys j of its q-block's live
// k-blocks, in ascending order:
//
//   s_ij = mask_ij ? (f32(q_i) * scale) . f32(k_j) : -1e30
//   online softmax over the s_ij, out_i = sum_j p_ij v_j / max(l_i, 1e-30)
//
// in f32, out in q's dtype (f32 or bf16). Replaces the TPU kernel
// src/repro/kernels/blocksparse_attn/kernel.py _bs_attn_call (body
// _bs_attn_kernel), reached through run_bs_attention_tpu.
//
// What bounds it on an H100: at the served shape (yi-9b, 1024 tokens,
// local window 192 at block 64) the bytes (q, k, v and out once, the
// mask tiles) take about 0.011 ms at 3.35 TB/s and the live tokens'
// multiply-adds about 0.09 ms at the f32 CUDA-core peak, so operations
// bound it in f32 and, on the tensor cores' bf16 rate, bytes would.
// This kernel is the simple, exact-f32 first version: scores and
// products on the CUDA cores, operands read from shared memory with
// register tiles of 4 x 4 (scores) and 4 x 8 (output); tensor cores
// (mma / wgmma) are a later change.
//
// Design:
// * One CTA per (64-row part of a q-block, q head, batch): a q-block of
//   bq rows is split into ceil(bq / 64) CTAs, so shared memory does not
//   grow with the spec's block. The TPU's sequential pair axis, whose
//   scratch carried (m, l, acc) from one live pair to the next, becomes
//   a loop inside the CTA over the q-block's live pairs, taken from CSR
//   row pointers (no padded gather slots, no scalar prefetch).
// * A pair's bk keys are taken in chunks of at most 64; each chunk is
//   one online-softmax step (the TPU kernel takes a whole pair per
//   step: the same function, summed in another order).
// * q, k and v are read in place, (B, S, H, D) through their strides
//   (the last dimension contiguous); nothing is transposed or padded in
//   HBM. The q part is staged once as f32 * scale; each chunk stages K
//   and V in their own dtype and the chunk's (rows x keys) mask tile as
//   bytes. Keys >= Skv and rows >= Sq are zero-filled (plan.tokens is
//   False there), and rows >= Sq are never written.
// * 256 threads: thread (ty, tx) = (tid / 16, tid % 16) holds rows
//   ty + 16 i (i < 4), score columns tx + 16 j (j < 4) and output
//   columns tx + 16 j (j < 8, dv <= 128). The 16 threads of a row are
//   16 lanes of one warp; row max and row sum are butterfly shuffles,
//   which leave the same bits in every lane.
// * The arithmetic is the TPU kernel's, in its order: m_new = max(m,
//   rowmax s), p = exp(s - m_new), corr = exp(m - m_new), l = l * corr +
//   sum p, acc = acc * corr + p @ v, and out = acc / max(l, 1e-30) after
//   the last pair. A row that sees nothing in its first chunk takes p = 1
//   on masked lanes until a real score arrives and corr = 0 wipes them,
//   as on the TPU. expf, not __expf; no fast math.
// * Shared-memory rows are padded to an odd number of 32-bit words, so
//   the 16 distinct rows a warp reads at once fall in 16 banks.
#pragma once

#include "common.cuh"

namespace nmk {

constexpr int BS_THREADS = 256;
constexpr int BS_TQ = 64;     // query rows per CTA
constexpr int BS_TK = 64;     // keys per online-softmax step
constexpr int BS_MAXD = 128;  // dk, dv
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
  int sq, skv, hq, hkv, dk, dv, bq, bk, nsub;
  float scale;
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

// Launch on `stream`; nqb q-blocks of the plan. Returns a CUDA error code
// of the set-up (0 when the launch was issued).
template <typename T>
int bs_attention_launch(const BsParams& p, int batch, int nqb,
                        cudaStream_t stream) {
  const size_t smem = bs_smem_bytes<T>(p.dk, p.dv);
  static size_t allowed = 48 * 1024;  // the default limit
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        bs_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed = smem;
  }
  const dim3 grid(nqb * p.nsub, p.hq, batch);
  bs_attention_kernel<T><<<grid, BS_THREADS, smem, stream>>>(p);
  return 0;
}

}  // namespace nmk
