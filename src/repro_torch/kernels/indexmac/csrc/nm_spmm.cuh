// nm_spmm: y[M, N] = x[M, K] @ W, W stored N:M-compressed along K as
// vals[Kc, N] and idx[Kc, N] (int8 in [0, m)), Kc = K * n / m. vals are
// x's dtype (nm_spmm.cu) or int8 with an f32 scale per output column
// (nm_spmm_q.cu: y = (x @ W8) * scales[col]).
//
// Replaces the TPU kernels src/repro/kernels/indexmac/kernel.py
// nm_spmm_pallas (body _nm_spmm_kernel, expansion _decompress_block) and
// nm_spmm_pallas_q (body _nm_spmm_q_kernel).
//
// What bounds it on an H100: at the prefill shapes (M = 512 or 2048 rows
// of yi-9b, the CNNs' M = 8 H W) the product does hundreds of FLOP per byte
// of its inputs, so the tensor cores set the floor: 989 TFLOP/s in bf16
// (the sparse path's kept work counts at that dense rate) and 165 for f32,
// the three TF32 products (495 / 3) an f32-accurate result needs. What
// bounds this kernel is not that: with the accumulators of mma.sync in
// registers a block covers 128 x 128 outputs, so every block re-reads its
// x rows and W columns from L2 (at w_up, 617 MB for 46 dense-equivalent
// GFLOP), and the producer warps' copies and per-stage transform of the
// compressed tile take longer than the consumers' MMAs (A/B runs with
// parts removed, PERF.md). The first version ran f32 FMAs on the CUDA
// cores on an expanded dense tile (2.8 ms at w_up).
//
// Design:
// * Orientation: a block computes a tile of y^T = W^T x^T. W^T (rows n,
//   columns k: sparse along k) is the MMA's A operand, the one the sparse
//   tensor cores take compressed; the x tile is the B operand in the
//   .col layout, which is x's own row-major K-contiguous layout, read
//   with ldmatrix (bf16) or 32-bit loads (f32). The TPU's parallel (mi,
//   ni) grid axes are the block grid, m tiles fastest so that the blocks
//   sharing a W tile run together; its sequential ki axis with a VMEM
//   accumulator is a K loop inside the block.
// * Two compiled tiles (kernels/padding.py prefill_tile picks one):
//   128 (n) x 128 (m) with 8 consumer warps of 64 x 32, and 32 x 128 with
//   4 of 32 x 32 for grids that would not fill the card, C_out < 128, and
//   f32 x with f32 vals at 26 or more kept rows a stage, where the large
//   tile's ring would not fit the shared memory.
// * Warp roles: producer warps (8 or 4) copy and transform, consumer warps
//   multiply. Copies run in a ring of PF_STAGES stages of cp.async (16
//   bytes where the rows allow it, 8 or 4 where they do not, element by
//   element below that; a ragged row's tail is zero-filled by the copy) of
//   the x tile (BM rows of 64 dense k on the sparse path, 32 on the dense
//   one) and the stage's rows of vals and idx ([Kc, N], N-contiguous), in
//   dynamic shared memory set with cudaFuncSetAttribute. The producers
//   transform stage c + 1 into one of PF_WORK work buffers while the
//   consumers multiply stage c; named barriers hand each buffer over
//   (FULL: producers arrive, consumers wait; EMPTY: the reverse), so no
//   barrier of the whole block runs in the K loop. Nothing is padded or
//   copied on the host; ragged M, N and K edges are masked in the kernel.
// * Path "sparse" (2:4 and 1:4, bf16 x, bf16 or int8 vals; the host
//   chooses, padding.prefill_path): mma.sp::ordered_metadata m16n8k32,
//   the paper's bounded index in hardware. The transform turns the
//   compressed tile into A fragments and 2-bit metadata in the registers'
//   own order, so a consumer reads them with one 16-byte and one 4-byte
//   load per 16-row tile and K step. Every group of four is first put in
//   canonical form: values that share an index are added, the pair is
//   sorted ascending, and a free slot gets a zero value at an unused
//   index (compress_nm pads a short block at its first zero positions,
//   pad_compressed_kn repeats index 0, 1:4 keeps one value a group), as
//   the hardware takes only two distinct ascending indices; four groups
//   that already are canonical are checked and packed a word at a time.
//   No dense W tile is built and half the MMA work of the dense product
//   goes away. int8 values are exact in bf16 (|q| <= 127).
// * Path "dense" (f32 x, and every other pattern): the transform expands
//   the compressed tile into a dense W^T tile (K-contiguous rows; a thread
//   owns (m-block, column) pairs and ADDS each of its n values, so
//   repeated indices sum as decompress_nm's one-hot einsum does). bf16 x
//   runs mma m16n8k16 in bf16 (exact products). f32 x runs 3xTF32 on mma
//   m16n8k8: a = a_hi + a_lo with a_hi = cvt.rna.tf32(a), a_lo =
//   cvt.rna.tf32(a - a_hi), and a_hi b_lo + a_lo b_hi + a_hi b_hi (int8
//   values are exact in TF32, so only x is split). One TF32 pass would
//   round every product at about 2^-11. A stage's products are summed in
//   a partial accumulator that is added to the f32 accumulator once a
//   stage: the tensor core's own accumulation does not round to nearest,
//   and over thousands of additions its bias grows toward the f32
//   tolerance.
// * Writeback: the f32 accumulator (times its column's scale once, with
//   __fmul_rn, for the int8 family) is cast to x's dtype into shared
//   memory, then stored to y[M, N] in 16-byte row segments.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace nmk {

enum PrefillPath { kDensePath = 0, kSparsePath = 1 };
// dense K rows of one stage: 64 on the sparse path (two mma.sp steps), 32
// on the dense one (an f32 stage of 64 would not fit the ring)
template <int PATH>
constexpr int pf_krows() { return PATH == kSparsePath ? 64 : 32; }
constexpr int PF_STAGES = 5;  // ring slots of copied stages
constexpr int PF_WORK = 3;    // work buffers of transformed stages
constexpr int PF_AHEAD = PF_STAGES + 1 - PF_WORK;  // stages copied ahead
constexpr int PF_SMEM_MAX = 227 * 1024;

// BN rows of y^T (output columns n) x BM columns (output rows m) per
// block; WN x WM consumer warps (the MMAs) and PW producer warps (the
// copies and the per-stage transform of the compressed tile).
template <int BN_, int BM_, int WN_, int WM_, int PW_>
struct PfTile {
  static constexpr int BN = BN_, BM = BM_, WN = WN_, WM = WM_, PW = PW_;
  static constexpr int CW = WN * WM;             // consumer warps
  static constexpr int PT = 32 * PW;             // producer threads
  static constexpr int THREADS = 32 * (CW + PW);
  static constexpr int MT = BN / WN / 16;  // 16-row A tiles per warp
  static constexpr int NT = BM / WM / 8;   // 8-column B tiles per warp
};
using PfTileBig = PfTile<128, 128, 2, 4, 8>;
using PfTileSmall = PfTile<32, 128, 1, 4, 4>;

// ---------------------------------------------------------------------------
// staging copies
// ---------------------------------------------------------------------------

// named barrier ID of THREADS threads, all waiting (0 is __syncthreads)
template <int ID, int THREADS>
__device__ __forceinline__ void group_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(ID), "n"(THREADS));
}
// named barrier `id` of `threads` threads: wait for all, or arrive only
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// rows x COLS elements of E into dst (row stride dld) from src (row stride
// ld): rows below vrows take their first vcols elements from global memory,
// everything else is zero. BYTES per copy; 0 = element by element.
template <typename E, int BYTES, int COLS>
__device__ __forceinline__ void stage_tile(E* dst, int dld, const E* src,
                                           size_t ld, int rows, int vrows,
                                           int vcols, int tid, int nthreads) {
  if constexpr (BYTES == 0) {
    for (int e = tid; e < rows * COLS; e += nthreads) {
      const int r = e / COLS, c = e % COLS;
      dst[r * dld + c] = (r < vrows && c < vcols) ? src[r * ld + c] : E{};
    }
  } else {
    constexpr int EPC = BYTES / static_cast<int>(sizeof(E));
    constexpr int SEGS = COLS / EPC;
    for (int e = tid; e < rows * SEGS; e += nthreads) {
      const int r = e / SEGS, c = (e % SEGS) * EPC;
      const int have = r < vrows ? min(max(vcols - c, 0), EPC) : 0;
      const E* s = have ? src + r * ld + c : src;
      cp_async<BYTES>(dst + r * dld + c, s,
                      have * static_cast<int>(sizeof(E)));
    }
  }
}

// stage_tile with the copy width chosen at run time (every E is at most 4
// bytes wide)
template <typename E, int COLS>
__device__ __forceinline__ void stage_any(int bytes, E* dst, int dld,
                                          const E* src, size_t ld, int rows,
                                          int vrows, int vcols, int tid,
                                          int nthreads) {
  if (bytes == 16)
    stage_tile<E, 16, COLS>(dst, dld, src, ld, rows, vrows, vcols, tid,
                            nthreads);
  else if (bytes == 8)
    stage_tile<E, 8, COLS>(dst, dld, src, ld, rows, vrows, vcols, tid,
                           nthreads);
  else if (bytes == 4)
    stage_tile<E, 4, COLS>(dst, dld, src, ld, rows, vrows, vcols, tid,
                           nthreads);
  else
    stage_tile<E, 0, COLS>(dst, dld, src, ld, rows, vrows, vcols, tid,
                           nthreads);
}

// ---------------------------------------------------------------------------
// tensor-core instructions
// ---------------------------------------------------------------------------

// d += A(16x32, 2:4 compressed to 16x16) * B(32x8); metadata from the
// lanes with threadID_in_group 0 and 1 (sparsity selector 0)
__device__ __forceinline__ void mma_sp_bf16(float (&d)[4], const uint4& a,
                                            const uint32_t (&b)[4],
                                            uint32_t e) {
  asm volatile(
      "mma.sp::ordered_metadata.sync.aligned.m16n8k32.row.col.f32.bf16.bf16."
      "f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9,%10,%11}, {%0,%1,%2,%3}, "
      "%12, 0x0;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b[0]), "r"(b[1]),
        "r"(b[2]), "r"(b[3]), "r"(e));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// a = hi + lo, both TF32 (rounded to nearest, ties away)
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

// the bf16 bit pattern of a value (int8 values are exact in bf16)
__device__ __forceinline__ uint32_t bf16_bits(__nv_bfloat16 v) {
  return __bfloat16_as_ushort(v);
}
__device__ __forceinline__ uint32_t bf16_bits(int8_t v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(static_cast<float>(v)));
}

// One group of four in the form mma.sp takes, on bf16 bit patterns: two
// distinct ascending indices. An index outside [0, 4) marks an entry that
// adds nothing; values sharing an index are added (in f32, rounded once);
// a free slot holds a zero at an unused index. Branch-free. Returns the
// pair packed lower index first, and the group's 4 bits of metadata.
__device__ __forceinline__ uint32_t canonical_group(uint32_t b0, int i0,
                                                    uint32_t b1, int i1,
                                                    uint32_t& nib) {
  const unsigned u0 = static_cast<unsigned>(i0), u1 = static_cast<unsigned>(i1);
  const bool ok0 = u0 < 4u, ok1 = u1 < 4u;
  b0 = ok0 ? b0 : 0u;
  b1 = ok1 ? b1 : 0u;
  const unsigned j0 = ok0 ? u0 : (ok1 ? u1 : 0u);
  const unsigned j1 = ok1 ? u1 : j0;
  const uint32_t sum = __bfloat16_as_ushort(__float2bfloat16_rn(
      __uint_as_float(b0 << 16) + __uint_as_float(b1 << 16)));
  const bool same = j0 == j1, first = j0 == 0u, swap = j0 > j1;
  const uint32_t lo = same ? (first ? sum : 0u) : (swap ? b1 : b0);
  const uint32_t hi = same ? (first ? 0u : sum) : (swap ? b0 : b1);
  const unsigned ilo = same ? 0u : (swap ? j1 : j0);
  const unsigned ihi = same ? (first ? 1u : j0) : (swap ? j0 : j1);
  nib = ilo | (ihi << 2);
  return lo | (hi << 16);
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

struct PfArgs {
  const void* x;
  const void* vals;
  const int8_t* idx;
  const float* scales;
  void* y;
  int M, K, N, n, m;
  int kchunk, vrows;             // dense K rows and compressed rows a stage
  int x_bytes, v_bytes, i_bytes;  // copy width of each operand (0: by element)
  int y_vec;                     // 1: y rows take 16-byte stores
};

template <typename T, typename V, int PATH, class TL>
struct PfLayout {
  static constexpr int KROWS = pf_krows<PATH>();
  using W = typename std::conditional<std::is_same<T, float>::value, float,
                                      __nv_bfloat16>::type;  // dense W^T tile
  // row strides (elements) padded by 16 bytes: conflict-free fragment reads
  static constexpr int XS = KROWS + 16 / static_cast<int>(sizeof(T));
  static constexpr int VS = TL::BN + 16 / static_cast<int>(sizeof(V));
  static constexpr int IS = TL::BN + 16;
  static constexpr int WS = KROWS + 16 / static_cast<int>(sizeof(W));
  static constexpr int YS = TL::BN + 16 / static_cast<int>(sizeof(T));
  __host__ __device__ static constexpr int x_bytes() {
    return TL::BM * XS * static_cast<int>(sizeof(T));
  }
  static __host__ __device__ int i_off(int vrows) {
    return x_bytes() + vrows * VS * static_cast<int>(sizeof(V));
  }
  static __host__ __device__ int stage(int vrows) {
    return round16(i_off(vrows) + vrows * IS);
  }
  // one of the PF_WORK work buffers: the A fragments (16 bytes a lane) and
  // metadata (4 bytes a lane) of every 16-row tile and 32-row K step, or
  // the dense W^T tile
  __host__ __device__ static constexpr int work() {
    return PATH == kSparsePath
               ? TL::BN / 16 * (KROWS / 32) * 32 * 20
               : round16(TL::BN * WS * static_cast<int>(sizeof(W)));
  }
  static __host__ __device__ int smem(int vrows) {
    const int main = PF_STAGES * stage(vrows) + PF_WORK * work();
    const int out = TL::BM * YS * static_cast<int>(sizeof(T));
    return main > out ? main : out;
  }
};

// Four values of V at one row and four adjacent columns, as bf16 bit
// patterns two to a word (columns 0, 1 in the first; int8 values are exact
// in bf16).
__device__ __forceinline__ uint2 bf16x4(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint2*>(p);
}
__device__ __forceinline__ uint2 bf16x4(const int8_t* p) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
  uint32_t h[4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
    h[c] = bf16_bits(static_cast<int8_t>(w >> (8 * c)));
  return make_uint2(h[0] | (h[1] << 16), h[2] | (h[3] << 16));
}

// Sparse path: the compressed tile of one stage (vs, is) -> the A
// fragments and metadata of every 16-row tile of W^T and 32-row K step
// (an item), in the registers' order: lane (a, q) = (lane / 4, lane % 4)
// of the MMA holds in register r group q + 4 (r / 2) of row a + 8 (r % 2);
// the metadata word of lane (a, h), h < 2, holds the four groups of half h
// of rows a (low 16 bits) and a + 8 (high), four bits a group. A producer
// warp takes an item; its lane (gl, cq) = (lane / 4, lane % 4) reads group
// gl of columns 4 cq .. 4 cq + 3 with one 4-byte idx load and one 8-byte
// vals load a row, puts the four groups in canonical form (a whole word
// of four at once when they already are), stores the four registers and
// gathers the metadata from the lanes of the same columns with shuffles.
template <class L, class TL, typename V>
__device__ __forceinline__ void sparse_transform(const V* vs, const int8_t* is,
                                                 unsigned char* work, int n,
                                                 int pwarp, int lane) {
  constexpr int TILES = TL::BN / 16;
  constexpr int ITEMS = TILES * (L::KROWS / 32);  // (k step, tile)
  constexpr int PER = ITEMS / TL::PW;             // items a warp
  static_assert(ITEMS % TL::PW == 0, "items split evenly over producers");
  uint32_t* afr = reinterpret_cast<uint32_t*>(work);
  uint16_t* meta = reinterpret_cast<uint16_t*>(work + ITEMS * 32 * 16);
  const int gl = lane / 4, cq = lane % 4;
  // every load first, then the arithmetic
  uint32_t iw[PER][2];
  uint2 vw[PER][2];
#pragma unroll
  for (int it = 0; it < PER; ++it) {
    const int item = pwarp + it * TL::PW;
    const int tile = item % TILES, ks = item / TILES;
    const int col = tile * 16 + 4 * cq;
    const int r0 = n == 2 ? 2 * (8 * ks + gl) : 8 * ks + gl;
    iw[it][0] = *reinterpret_cast<const uint32_t*>(is + r0 * L::IS + col);
    vw[it][0] = bf16x4(vs + r0 * L::VS + col);
    iw[it][1] = n == 2 ? *reinterpret_cast<const uint32_t*>(
                             is + (r0 + 1) * L::IS + col)
                       : 0xffffffffu;  // 1:4: no second entry
    vw[it][1] = n == 2 ? bf16x4(vs + (r0 + 1) * L::VS + col) : make_uint2(0, 0);
  }
#pragma unroll
  for (int it = 0; it < PER; ++it) {
    const int item = pwarp + it * TL::PW;
    const uint32_t i0 = iw[it][0], i1 = iw[it][1];
    const uint32_t v0[2] = {vw[it][0].x, vw[it][0].y};
    const uint32_t v1[2] = {vw[it][1].x, vw[it][1].y};
    uint32_t reg[4], nib[4];
    // i0 < i1 < 4 in every byte: the four groups are canonical already
    if ((__vcmpltu4(i0, i1) & __vcmpltu4(i1, 0x04040404u)) == 0xffffffffu) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        reg[c] = __byte_perm(v0[c / 2], v1[c / 2], c % 2 ? 0x7632 : 0x5410);
        nib[c] = ((i0 | (i1 << 2)) >> (8 * c)) & 0xfu;
      }
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        reg[c] = canonical_group(
            (v0[c / 2] >> (16 * (c % 2))) & 0xffffu,
            static_cast<int8_t>(i0 >> (8 * c)),
            (v1[c / 2] >> (16 * (c % 2))) & 0xffffu,
            static_cast<int8_t>(i1 >> (8 * c)), nib[c]);
    }
    uint32_t word[2] = {0u, 0u};  // columns (0, 1) and (2, 3)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int nr = 4 * cq + c;  // row of the tile
      const int ln = (nr % 8) * 4 + gl % 4, r = nr / 8 + 2 * (gl / 4);
      afr[(item * 32 + ln) * 4 + r] = reg[c];
      word[c / 2] |= nib[c] << (4 * (gl % 4) + 16 * (c % 2));
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // the four groups of a half: lanes ^ 4, 8
      word[h] |= __shfl_xor_sync(0xffffffffu, word[h], 4);
      word[h] |= __shfl_xor_sync(0xffffffffu, word[h], 8);
    }
    // the lane with gl % 4 == c stores column c's 16 bits
    const int c = gl % 4, nr = 4 * cq + c;
    const uint32_t w = c < 2 ? word[0] : word[1];
    meta[(item * 32 + (nr % 8) * 4 + gl / 4) * 2 + nr / 8] =
        static_cast<uint16_t>(w >> (16 * (c % 2)));
  }
}

// Dense path: the compressed tile of one stage -> the dense W^T tile ws
// (rows n, K-contiguous). A thread owns (m-block, column) pairs; each
// m-block is built four rows at a time in registers (values that share an
// index add up) and stored with one vector store; rows past the stage's
// whole m-blocks are zero.
template <class L, class TL, typename V, typename W>
__device__ __forceinline__ void dense_expand(const V* vs, const int8_t* is,
                                             W* ws, int n, int m, int kchunk,
                                             int ptid) {
  const int gblocks = kchunk / m;
  for (int e = ptid; e < gblocks * TL::BN; e += TL::PT) {
    const int nr = e % TL::BN, blk = e / TL::BN;
    W* wrow = ws + nr * L::WS + blk * m;
    for (int j0 = 0; j0 < m; j0 += 4) {
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      for (int s = 0; s < n; ++s) {
        const int r = blk * n + s;
        const int j = is[r * L::IS + nr] - j0;
        const float v = to_f32(vs[r * L::VS + nr]);
#pragma unroll
        for (int u = 0; u < 4; ++u) d[u] += j == u ? v : 0.f;
      }
      if (m % 4 == 0) {
        if constexpr (std::is_same<W, float>::value) {
          *reinterpret_cast<float4*>(wrow + j0) =
              make_float4(d[0], d[1], d[2], d[3]);
        } else {
          *reinterpret_cast<uint2*>(wrow + j0) =
              make_uint2(pack_bf16(d[0], d[1]), pack_bf16(d[2], d[3]));
        }
      } else {
        for (int u = 0; u < 4 && j0 + u < m; ++u)
          wrow[j0 + u] = from_f32<W>(d[u]);
      }
    }
    if (blk == 0)
      for (int k = kchunk; k < L::KROWS; ++k)
        ws[nr * L::WS + k] = from_f32<W>(0.f);
  }
}

template <typename T, typename V, int PATH, class TL>
__global__ void __launch_bounds__(TL::THREADS, 1)
nm_spmm_kernel(const PfArgs p) {
  using L = PfLayout<T, V, PATH, TL>;
  using W = typename L::W;
  constexpr bool kScaled = std::is_same<V, int8_t>::value;
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int BN = TL::BN, BM = TL::BM, THREADS = TL::THREADS;
  constexpr int MT = TL::MT, NT = TL::NT;
  static_assert(PATH == kDensePath || !kF32, "the sparse path takes bf16 x");
  extern __shared__ __align__(16) unsigned char smem[];

  const T* __restrict__ x = static_cast<const T*>(p.x);
  const V* __restrict__ vals = static_cast<const V*>(p.vals);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const bool producer = warp >= TL::CW;
  const int wn = warp / TL::WM, wm = warp % TL::WM;  // consumers
  const int pwarp = warp - TL::CW, ptid = tid - 32 * TL::CW;  // producers
  // m tiles vary fastest, so the blocks that share a W tile run together
  // and read it from HBM once
  const int row0 = blockIdx.x * BM;  // output rows m
  const int col0 = blockIdx.y * BN;  // output columns n
  const int kc_rows = p.K / p.m * p.n;
  const int gblocks = p.kchunk / p.m;
  const int nchunks = (p.K / p.m + gblocks - 1) / gblocks;
  const int stage_bytes = L::stage(p.vrows);
  unsigned char* work0 = smem + PF_STAGES * stage_bytes;

  auto stage_ptr = [&](int c) { return smem + (c % PF_STAGES) * stage_bytes; };
  // The x tile of stage c is copied by the consumers on the sparse path
  // (its producers are busier than its consumers) and by the producers on
  // the dense one (the reverse: three TF32 products per bf16 one); the
  // stage's vals and idx by the producers.
  constexpr bool kConsumerX = PATH == kSparsePath;
  auto load_x = [&](int c) {
    const int k0 = c * p.kchunk;
    stage_any<T, L::KROWS>(p.x_bytes, reinterpret_cast<T*>(stage_ptr(c)),
                           L::XS, x + static_cast<size_t>(row0) * p.K + k0,
                           p.K, BM, p.M - row0, min(p.kchunk, p.K - k0),
                           kConsumerX ? tid : ptid,
                           kConsumerX ? 32 * TL::CW : TL::PT);
  };
  auto producer_load = [&](int c) {
    unsigned char* s = stage_ptr(c);
    const int r0 = c * p.vrows;
    if constexpr (!kConsumerX) load_x(c);
    stage_any<V, BN>(p.v_bytes, reinterpret_cast<V*>(s + L::x_bytes()),
                     L::VS, vals + static_cast<size_t>(r0) * p.N + col0, p.N,
                     p.vrows, kc_rows - r0, p.N - col0, ptid, TL::PT);
    stage_any<int8_t, BN>(
        p.i_bytes, reinterpret_cast<int8_t*>(s + L::i_off(p.vrows)), L::IS,
        p.idx + static_cast<size_t>(r0) * p.N + col0, p.N, p.vrows,
        kc_rows - r0, p.N - col0, ptid, TL::PT);
  };
  // stage c's compressed tile -> work buffer c % PF_WORK
  auto transform = [&](int c) {
    const unsigned char* s = stage_ptr(c);
    const V* vs = reinterpret_cast<const V*>(s + L::x_bytes());
    const int8_t* is = reinterpret_cast<const int8_t*>(s + L::i_off(p.vrows));
    unsigned char* work = work0 + (c % PF_WORK) * L::work();
    if constexpr (PATH == kSparsePath)
      sparse_transform<L, TL>(vs, is, work, p.n, pwarp, lane);
    else
      dense_expand<L, TL>(vs, is, reinterpret_cast<W*>(work), p.n, p.m,
                          p.kchunk, ptid);
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  // Software pipeline. The producers keep their copies of the stages
  // landing PF_AHEAD ahead and transform stage c + 1 while the consumers
  // multiply stage c; consumers that copy x keep it PF_STAGES - 1 ahead.
  // Named barriers hand work buffer b over: FULL + b (the producers arrive
  // once it holds a transformed stage, the consumers wait) and EMPTY + b
  // (the consumers arrive once they are done with it and with that stage,
  // the producers wait before reusing the buffer and the stage's slot);
  // PRODUCERS and CONSUMERS order each group's own copies.
  constexpr int PRODUCERS = 1, FULL = 2, EMPTY = 2 + PF_WORK,
                CONSUMERS = 2 + 2 * PF_WORK;  // 0 is __syncthreads
  if (producer) {
#pragma unroll
    for (int s = 0; s < PF_AHEAD; ++s) {
      if (s < nchunks) producer_load(s);
      cp_async_commit();
    }
    cp_async_wait<PF_AHEAD - 1>();
    group_sync<PRODUCERS, TL::PT>();
    if (nchunks > 0) {
      transform(0);
      bar_arrive(FULL, THREADS);
    }
    for (int c = 0; c + 1 < nchunks; ++c) {
      // stage c + 1 - PF_WORK is done: its work buffer takes the
      // transform of stage c + 1 (its vals and idx slot, read by the
      // producers' own transform, takes stage c + PF_AHEAD)
      if (c + 1 >= PF_WORK) bar_sync(EMPTY + (c + 1) % PF_WORK, THREADS);
      if (c + PF_AHEAD < nchunks) producer_load(c + PF_AHEAD);
      cp_async_commit();
      cp_async_wait<PF_AHEAD - 1>();    // this thread's copies of c + 1
      group_sync<PRODUCERS, TL::PT>();  // ... and every producer's
      transform(c + 1);
      bar_arrive(FULL + (c + 1) % PF_WORK, THREADS);
    }
    // the hand-backs not yet taken, so every barrier completes
    for (int c = nchunks > PF_WORK ? nchunks - PF_WORK : 0; c < nchunks; ++c)
      bar_sync(EMPTY + c % PF_WORK, THREADS);
    cp_async_wait<0>();
  } else {
    if constexpr (kConsumerX) {
#pragma unroll
      for (int s = 0; s < PF_STAGES - 1; ++s) {
        if (s < nchunks) load_x(s);
        cp_async_commit();
      }
    }
    for (int c = 0; c < nchunks; ++c) {
      if constexpr (kConsumerX) {
        cp_async_wait<PF_STAGES - 2>();  // this thread's x copies of c
        // every consumer's, and every consumer is done with stage c - 1,
        // whose slot takes the x tile of stage c + PF_STAGES - 1
        group_sync<CONSUMERS, 32 * TL::CW>();
        if (c + PF_STAGES - 1 < nchunks) load_x(c + PF_STAGES - 1);
        cp_async_commit();
      }
      bar_sync(FULL + c % PF_WORK, THREADS);
      const T* xs = reinterpret_cast<const T*>(stage_ptr(c));
      const unsigned char* work = work0 + (c % PF_WORK) * L::work();
      if constexpr (PATH == kSparsePath) {
        constexpr int TILES = BN / 16;
        const uint4* a4 = reinterpret_cast<const uint4*>(work);
        const uint32_t* e32 = reinterpret_cast<const uint32_t*>(
            work + TILES * (L::KROWS / 32) * 32 * 16);
#pragma unroll
        for (int ks = 0; ks < L::KROWS / 32; ++ks) {
          uint32_t b[NT][4];
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const int mr = wm * NT * 8 + j * 8 + lane % 8;
            ldmatrix_x4(b[j], xs + mr * L::XS + 32 * ks + 8 * (lane / 8));
          }
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            const int item = ks * TILES + wn * MT + i;
            const uint4 a = a4[item * 32 + lane];
            const uint32_t e = e32[item * 32 + (lane & ~3) + (lane & 1)];
#pragma unroll
            for (int j = 0; j < NT; ++j) mma_sp_bf16(acc[i][j], a, b[j], e);
          }
        }
      } else if constexpr (kF32) {
        // 3xTF32 (2x for int8 values, exact in TF32). The stage's products
        // are summed in a partial accumulator and added to acc in f32 once
        // a stage: the tensor core's own accumulation does not round to
        // nearest, and over thousands of additions into one accumulator its
        // bias would exceed the f32 tolerance. IG A tiles share a pass
        // over the stage, so each split of x serves IG of them.
        const W* ws = reinterpret_cast<const W*>(work);
        constexpr int IG = MT < 2 ? MT : 2;
#pragma unroll
        for (int i0 = 0; i0 < MT; i0 += IG) {
          float part[IG][NT][4];
#pragma unroll
          for (int ii = 0; ii < IG; ++ii)
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
              for (int q = 0; q < 4; ++q) part[ii][j][q] = 0.f;
#pragma unroll 1
          for (int kk = 0; kk < L::KROWS; kk += 8) {
            uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
            for (int j = 0; j < NT; ++j) {
              const T* xr = xs + (wm * NT * 8 + j * 8 + g) * L::XS + kk + t;
              split_tf32(xr[0], bh[j][0], bl[j][0]);
              split_tf32(xr[4], bh[j][1], bl[j][1]);
            }
#pragma unroll
            for (int ii = 0; ii < IG; ++ii) {
              const W* wr =
                  ws + ((wn * MT + i0 + ii) * 16 + g) * L::WS + kk + t;
              uint32_t ah[4], al[4];
              split_tf32(wr[0], ah[0], al[0]);
              split_tf32(wr[8 * L::WS], ah[1], al[1]);
              split_tf32(wr[4], ah[2], al[2]);
              split_tf32(wr[8 * L::WS + 4], ah[3], al[3]);
#pragma unroll
              for (int j = 0; j < NT; ++j) {
                mma_tf32(part[ii][j], ah, bl[j]);
                if (!kScaled) mma_tf32(part[ii][j], al, bh[j]);
                mma_tf32(part[ii][j], ah, bh[j]);
              }
            }
          }
#pragma unroll
          for (int ii = 0; ii < IG; ++ii)
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
              for (int q = 0; q < 4; ++q) acc[i0 + ii][j][q] += part[ii][j][q];
        }
      } else {
        const W* ws = reinterpret_cast<const W*>(work);
        uint32_t b[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int mr = wm * NT * 8 + j * 8 + lane % 8;
          ldmatrix_x4(b[j], xs + mr * L::XS + 8 * (lane / 8));
        }
#pragma unroll
        for (int kh = 0; kh < 2; ++kh)
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            uint32_t a[4];
            const int nr = (wn * MT + i) * 16 + lane % 8 + 8 * ((lane / 8) % 2);
            ldmatrix_x4(a, ws + nr * L::WS + 16 * kh + 8 * (lane / 16));
#pragma unroll
            for (int j = 0; j < NT; ++j)
              mma_bf16(acc[i][j], a, b[j][2 * kh], b[j][2 * kh + 1]);
          }
      }
      bar_arrive(EMPTY + c % PF_WORK, THREADS);
    }
    cp_async_wait<0>();
  }
  __syncthreads();  // the ring is free: stage the output tile there

  // accumulator -> (x scale) -> T, transposed into ys[m][n]
  T* ys = reinterpret_cast<T*>(smem);
  if (!producer) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int nr = (wn * MT + i) * 16 + g + 8 * hr;
        float sc = 1.f;
        if (kScaled) sc = col0 + nr < p.N ? p.scales[col0 + nr] : 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const float v = acc[i][j][2 * hr + q];
            const int mr = wm * NT * 8 + j * 8 + 2 * t + q;
            ys[mr * L::YS + nr] =
                from_f32<T>(kScaled ? __fmul_rn(v, sc) : v);
          }
      }
  }
  __syncthreads();
  T* y = static_cast<T*>(p.y);
  constexpr int EPV = 16 / static_cast<int>(sizeof(T));
  for (int e = tid; e < BM * (BN / EPV); e += THREADS) {
    const int mr = e / (BN / EPV), nr = (e % (BN / EPV)) * EPV;
    const int gm = row0 + mr, gn = col0 + nr;
    if (gm >= p.M || gn >= p.N) continue;
    T* dst = y + static_cast<size_t>(gm) * p.N + gn;
    const T* src = ys + mr * L::YS + nr;
    if (p.y_vec && gn + EPV <= p.N) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int q = 0; q < EPV && gn + q < p.N; ++q) dst[q] = src[q];
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <typename T, typename V, int PATH, class TL>
int nm_spmm_tile_launch(PfArgs p, cudaStream_t stream) {
  using L = PfLayout<T, V, PATH, TL>;
  p.kchunk = L::KROWS / p.m * p.m;
  p.vrows = L::KROWS / p.m * p.n;
  const int smem = L::smem(p.vrows);
  // the host's tile choice keeps every accepted pattern within the limit
  // (kernels/padding.py prefill_smem mirrors PfLayout::smem)
  if (smem > PF_SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {  // above the default limit; set per device
    const cudaError_t e = cudaFuncSetAttribute(
        nm_spmm_kernel<T, V, PATH, TL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  p.x_bytes = copy_bytes(p.x, sizeof(T) * p.K, sizeof(T) * p.kchunk,
                         sizeof(T));
  p.v_bytes = copy_bytes(p.vals, sizeof(V) * p.N, sizeof(V) * TL::BN,
                         sizeof(V));
  p.i_bytes = copy_bytes(p.idx, p.N, TL::BN, 1);
  p.y_vec = copy_bytes(p.y, sizeof(T) * p.N, sizeof(T) * TL::BN,
                       sizeof(T)) == 16;
  const dim3 grid((p.M + TL::BM - 1) / TL::BM, (p.N + TL::BN - 1) / TL::BN);
  nm_spmm_kernel<T, V, PATH, TL><<<grid, TL::THREADS, smem, stream>>>(p);
  return 0;
}

// variant = path + 2 * tile (kernels/padding.py prefill_code): path 0
// dense, 1 sparse; tile 0 = PfTileBig, 1 = PfTileSmall
template <typename T, typename V>
int nm_spmm_launch(const void* x, const void* vals, const void* idx,
                   const void* scales, void* y, int M, int K, int N, int n,
                   int m, int variant, cudaStream_t stream) {
  const int path = variant % 2, tile = variant / 2;
  if (m > pf_krows<kDensePath>() || tile > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  PfArgs p{x, vals, static_cast<const int8_t*>(idx),
           static_cast<const float*>(scales), y, M, K, N, n, m};
  if (path == kSparsePath) {
    if (std::is_same<T, float>::value || m != 4 || n > 2)
      return static_cast<int>(cudaErrorInvalidValue);
    if constexpr (!std::is_same<T, float>::value) {
      using Small = PfTileSmall;
      using Big = PfTileBig;
      return tile ? nm_spmm_tile_launch<T, V, kSparsePath, Small>(p, stream)
                  : nm_spmm_tile_launch<T, V, kSparsePath, Big>(p, stream);
    }
  }
  return tile ? nm_spmm_tile_launch<T, V, kDensePath, PfTileSmall>(p, stream)
              : nm_spmm_tile_launch<T, V, kDensePath, PfTileBig>(p, stream);
}

}  // namespace nmk
