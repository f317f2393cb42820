// nm_spmm_decode: y[M, N] = act(x[M, K] @ W + bias) for skinny M (the
// decode step's one row per slot), W N:M-compressed along K as
// vals[Kc, N] / idx[Kc, N] (int8 in [0, m)), Kc = K * n / m. vals are
// x's dtype (nm_spmm_decode.cu) or int8 with an f32 scale per output
// column (nm_spmm_decode_q.cu: y = act((x @ W8) * scales + bias)).
//
// Replaces the TPU kernels src/repro/kernels/indexmac/decode_kernel.py
// nm_spmm_pallas_decode and nm_spmm_pallas_decode_q (_pallas_decode,
// _decode_kernel, _decode_partial, _writeback): one launch end to end, as
// there.
//
// What bounds it on an H100: bytes. With M <= 8 rows every kept weight
// value is used for at most 8 multiply-adds, far below the ~20 FLOP per
// byte where the f32 cores would take over, so the time floor is vals +
// idx (1.5 bytes per dense position in bf16, 1 in int8) over 3.35 TB/s,
// and what a call must avoid is fixed cost and too few bytes in flight.
//
// Design:
// * One launch a call. The grid is (column tiles, splits of K): the host
//   (kernels/padding.py decode_plan) picks the tile width (8, 16 or 32
//   lanes of VEC columns) and the split depth so that the grid loads the
//   SMs evenly within one wave of CTAs. Each split reduces its rows to an
//   f32 partial of its (M x columns) tile; with one split that is y. With
//   more, each split writes its partial to the workspace, one thread
//   fences (fence.acq_rel.gpu) around an atomicAdd on the tile's arrival
//   counter, and the last CTA of the tile adds the partials in split
//   order (all of a batch's loads in flight first), applies the epilogue,
//   writes y and sets the counter back to 0. Sums run in a fixed order,
//   so y is the same bit for bit from call to call; nothing is
//   allocated, synchronised or cleared per call.
// * An asynchronous weight ring: vals and idx stream exactly once, in
//   stages of (R rows x columns) tiles, R * columns = DC_THREADS * DC_RPT
//   * VEC kept values, into a ring of dc_stages slots, so that all but one
//   stage are in flight while that one is computed. Rows 16 bytes aligned
//   (the served weights): one tensor copy (TMA, cp.async.bulk.tensor) an
//   array a stage, issued by one thread and completing on the slot's
//   mbarrier; the tensor maps are encoded on the host and kept. Other
//   rows (odd N, a view at an offset): cp.async by every thread, 16, 8 or
//   4 bytes at a time, or element by element, into the same slots.
//   Bytes in flight: 36 KB a CTA in bf16 (3 of 4 stages), 40 KB in int8 (5
//   of 6) and in f32 (4 of 5); at the 2 CTAs an SM holds that is 72-80 KB
//   an SM, against the ~25 KB that 3.35 TB/s over about 1 us of latency
//   needs across 132 SMs.
// * x is the stationary operand: each CTA stages its split's dense rows
//   (at most DC_KROWS) once, as f32 in [k][row] order; a lane loads one
//   dense row's M values and stores them as one vector (no bank
//   conflict), the first pass's loads issued just before the ring's first
//   copies. A kept value (r, c) then reads its MR x values with one
//   16-byte shared load (MR <= 4) or two (MR = 8) at ((r / n) * m + idx)
//   * MR and converts nothing in the inner loop: per kept value one index
//   byte, one address, one or two shared loads and MR FMAs on the CUDA
//   cores. A thread holds VEC adjacent columns (8 bf16 or int8, 4 f32) of
//   the tile for every row it computes; int8 values are widened to f32
//   exactly and stay unscaled in the sums.
// * The row groups of a CTA (DC_THREADS / lanes) split each stage's rows;
//   their sums are added in group order in one shared-memory round.
// * Values are accumulated, never stored, so indices that repeat in a
//   block (the zero-padded pairs of pad_compressed_kn) add up as
//   decompress_nm's one-hot sum does; an index outside [0, m) adds
//   nothing (its value is taken as 0).
// * The epilogue is the composition of kernels/epilogue.py, in f32: x
//   scales[col] (int8 only, a rounded product never fused with the bias
//   add), + bias, the activation, then the cast to x's dtype.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only; no link)
#include <dlfcn.h>

#include <type_traits>

#include "mma.cuh"

namespace nmk {

constexpr int DC_THREADS = 256;
constexpr int DC_RPT = 2;       // rows of a stage each thread computes
constexpr int DC_KROWS = 1024;  // dense rows of K a split spans at most

// columns a thread holds: one 16-byte load of float values, or 8 int8
template <typename V>
__host__ __device__ constexpr int dc_vec() {
  return sizeof(V) == 1 ? 8 : 16 / static_cast<int>(sizeof(V));
}

// CTAs an SM holds: 2. The launch bounds give a thread up to 128
// registers (no spills at 8 rows), and every CTA takes about 80 KB of
// shared memory, so no instantiation fits a third. Timed against 3 CTAs
// an SM (80 registers, spills at 4 rows), the plans that filled 2 CTAs an
// SM were as fast or faster (PERF.md).
constexpr int DC_CTAS = 2;

__host__ __device__ constexpr int dc_log2(int v) {
  return v <= 1 ? 0 : 1 + dc_log2(v / 2);
}

// bytes of one ring stage (vals, then idx) for vals of sv bytes
__host__ __device__ constexpr int dc_stage_bytes(int sv) {
  return DC_THREADS * DC_RPT * (sv == 1 ? 8 : 16 / sv) * (sv + 1);
}

// ring slots for vals of sv bytes: about 48 KB (12 KB stages in bf16,
// 8 KB in int8, 10 KB in f32)
__host__ __device__ constexpr int dc_stages(int sv) {
  return sv == 1 ? 6 : sv == 2 ? 4 : 5;
}

// room for x: DC_KROWS dense rows of up to 8 rows as f32, [k][row]
constexpr int DC_XBYTES = DC_KROWS * 8 * 4;

// dynamic shared memory of a CTA (padding.decode_smem mirrors it): 128
// bytes to align the ring's slots for the tensor copies, the ring, then x
__host__ __device__ constexpr int dc_smem(int sv) {
  return 128 + dc_stages(sv) * dc_stage_bytes(sv) + DC_XBYTES;
}

struct DcArgs {
  CUtensorMap tv, ti;   // vals and idx as 2D tensors (tma only)
  const void* x;        // [M][K]
  const void* vals;     // [Kc][N]
  const int8_t* idx;    // [Kc][N]
  const float* scales;  // (N,), int8 kernel only
  const float* bias;    // (N,) or null
  void* y;              // [M][N]
  float* ws;            // (splits, M, N) f32 partials; splits > 1 only
  int* counters;        // (tiles,) zeros; splits > 1 only; left zeroed
  unsigned magic;  // ceil(2^32 / n) for n > 1: j / n = umulhi(j, magic)
  int M, K, N, n, m;
  int lg;   // log2 of the lanes across a tile's columns: 3, 4 or 5
  int per;  // m-blocks of K a split
  int kb;   // m-blocks of K
  int act;  // activation code
  int v_bytes, i_bytes;  // copy widths of vals and idx: 16, 8, 4; 0 by element
  int tma;  // rows 16-byte aligned: a stage is one tensor copy an array
};

// the mbarrier that a ring slot's tensor copies complete, and waiting on it
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}
// the (rows x columns) box of tensor map tm at (column c, row r) into
// shared dst by the tensor memory accelerator, completing on bar; what
// lies outside the tensor arrives as zeros
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* tm,
                                         int c, int r, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(tm)), "r"(c), "r"(r),
      "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ float dc_activate(int act, float v) {
  switch (act) {
    case kRelu: return activate<kRelu>(v);
    case kGelu: return activate<kGelu>(v);
    case kSilu: return activate<kSilu>(v);
    case kReluSq: return activate<kReluSq>(v);
    default: return v;
  }
}

// rows x vcols elements of E from src (row stride ld) to dst (row stride
// 1 << ldl); columns past vcols are not copied (they feed only outputs
// that are never stored). W-byte cp.async chunks (a chunk's tail past
// vcols zero-filled), or element by element (W = 0: loads batched 8 at a
// time, then stored).
template <typename E, int W>
__device__ __forceinline__ void dc_copy(E* dst, int ldl, const E* src,
                                        size_t ld, int rows, int vcols,
                                        int tid) {
  if constexpr (W == 0) {
    const int total = rows << ldl, cmask = (1 << ldl) - 1;
#pragma unroll 1
    for (int e0 = tid; e0 < total; e0 += 8 * DC_THREADS) {
      E v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + u * DC_THREADS;
        if (e < total && (e & cmask) < vcols)
          v[u] = src[(e >> ldl) * ld + (e & cmask)];
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + u * DC_THREADS;
        if (e < total && (e & cmask) < vcols) dst[e] = v[u];
      }
    }
  } else {
    constexpr int EPC = W / static_cast<int>(sizeof(E));
    const int lc = ldl - dc_log2(EPC);  // log2 of the chunks a row
    const int total = rows << lc;
#pragma unroll 1
    for (int e = tid; e < total; e += DC_THREADS) {
      const int r = e >> lc, c = (e & ((1 << lc) - 1)) * EPC;
      if (c >= vcols) continue;
      const int bytes = min(vcols - c, EPC) * static_cast<int>(sizeof(E));
      if constexpr (W == 16)  // rows are read in long runs: 256-byte L2 fills
        asm volatile(
            "cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::"r"(
                smem_addr(dst + (r << ldl) + c)),
            "l"(src + r * ld + c), "r"(bytes));
      else
        cp_async<W>(dst + (r << ldl) + c, src + r * ld + c, bytes);
    }
  }
}

template <typename E>
__device__ __forceinline__ void dc_copy_any(int w, E* dst, int ldl,
                                            const E* src, size_t ld, int rows,
                                            int vcols, int tid) {
  if (w == 16)
    dc_copy<E, 16>(dst, ldl, src, ld, rows, vcols, tid);
  else if (w == 8)
    dc_copy<E, 8>(dst, ldl, src, ld, rows, vcols, tid);
  else if (w == 4)
    dc_copy<E, 4>(dst, ldl, src, ld, rows, vcols, tid);
  else
    dc_copy<E, 0>(dst, ldl, src, ld, rows, vcols, tid);
}

// x staging: each thread takes one dense row k of the split at a time
// (k = tid + 256 i) and loads its M values (coalesced along k across the
// warp), then stores them widened to f32 as one MR-float vector at
// xs[k * MR] (consecutive lanes, consecutive vectors: no bank conflict).
// Rows from M to MR are zeros. A pass holds dc_xp rows (8 values a
// thread: at 8 rows, 16 made ptxas spill); the first pass's loads are
// issued before the ring's first copies, so both are in flight at once.
template <int MR>
__host__ __device__ constexpr int dc_xp() {
  return 8 / MR < DC_KROWS / DC_THREADS ? 8 / MR : DC_KROWS / DC_THREADS;
}

template <typename T, int MR>
__device__ __forceinline__ void dc_load_x(const DcArgs& p, int k0, int kd,
                                          int k, T (&v)[dc_xp<MR>()][MR]) {
  const T* x = static_cast<const T*>(p.x) + k0;
#pragma unroll
  for (int i = 0; i < dc_xp<MR>(); ++i, k += DC_THREADS)
#pragma unroll
    for (int r = 0; r < MR; ++r)
      v[i][r] = (k < kd && r < p.M) ? x[static_cast<size_t>(r) * p.K + k]
                                    : from_f32<T>(0.f);
}

template <typename T, int MR>
__device__ __forceinline__ void dc_store_x(float* xs, int kd, int k,
                                           const T (&v)[dc_xp<MR>()][MR]) {
#pragma unroll
  for (int i = 0; i < dc_xp<MR>(); ++i, k += DC_THREADS) {
    if (k >= kd) continue;
    float f[MR];
#pragma unroll
    for (int r = 0; r < MR; ++r) f[r] = to_f32(v[i][r]);
    float* d = xs + k * MR;
    if constexpr (MR == 1) {
      d[0] = f[0];
    } else if constexpr (MR == 2) {
      *reinterpret_cast<float2*>(d) = make_float2(f[0], f[1]);
    } else {
#pragma unroll
      for (int h = 0; h < MR / 4; ++h)
        *reinterpret_cast<float4*>(d + 4 * h) =
            make_float4(f[4 * h], f[4 * h + 1], f[4 * h + 2], f[4 * h + 3]);
    }
  }
}

// the VEC staged values of a row as raw words (VW of them), one value
// widened to f32, and one value set to 0 (v is a compile-time index)
template <typename V> struct DcVal;
template <> struct DcVal<float> {
  static constexpr int VW = 4;
  static __device__ __forceinline__ void load(const float* p, uint32_t (&w)[VW]) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    w[0] = a.x, w[1] = a.y, w[2] = a.z, w[3] = a.w;
  }
  static __device__ __forceinline__ float get(const uint32_t (&w)[VW], int v) {
    return __uint_as_float(w[v]);
  }
  static __device__ __forceinline__ void zero(uint32_t (&w)[VW], int v) { w[v] = 0; }
};
template <> struct DcVal<__nv_bfloat16> {
  static constexpr int VW = 4;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              uint32_t (&w)[VW]) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    w[0] = a.x, w[1] = a.y, w[2] = a.z, w[3] = a.w;
  }
  static __device__ __forceinline__ float get(const uint32_t (&w)[VW], int v) {
    return __uint_as_float(v & 1 ? w[v / 2] & 0xffff0000u : w[v / 2] << 16);
  }
  static __device__ __forceinline__ void zero(uint32_t (&w)[VW], int v) {
    w[v / 2] &= v & 1 ? 0x0000ffffu : 0xffff0000u;
  }
};
// int8 without a conversion instruction: the words hold the biased bytes
// b + 128, which become the low mantissa byte of 2^23, exact, and
// 2^23 + 128 is taken off
template <> struct DcVal<int8_t> {
  static constexpr int VW = 2;
  static __device__ __forceinline__ void load(const int8_t* p, uint32_t (&w)[VW]) {
    const uint2 a = *reinterpret_cast<const uint2*>(p);
    w[0] = a.x ^ 0x80808080u, w[1] = a.y ^ 0x80808080u;
  }
  static __device__ __forceinline__ float get(const uint32_t (&w)[VW], int v) {
    return __int_as_float(static_cast<int>(
               __byte_perm(w[v / 4], 0x4B000000u, 0x7440 + v % 4))) -
           8388736.f;
  }
  static __device__ __forceinline__ void zero(uint32_t (&w)[VW], int v) {
    const int s = 8 * (v % 4);
    w[v / 4] = (w[v / 4] & ~(0xffu << s)) | (0x80u << s);
  }
};

// the MR staged x values of one dense row
template <int MR>
__device__ __forceinline__ void dc_x(const float* p, float (&xv)[MR]) {
  if constexpr (MR == 1) {
    xv[0] = *p;
  } else if constexpr (MR == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    xv[0] = a.x, xv[1] = a.y;
  } else {
#pragma unroll
    for (int h = 0; h < MR / 4; ++h) {
      const float4 a = *reinterpret_cast<const float4*>(p + 4 * h);
      xv[4 * h] = a.x, xv[4 * h + 1] = a.y, xv[4 * h + 2] = a.z,
      xv[4 * h + 3] = a.w;
    }
  }
}

// The last CTA of a tile: the sum over the splits of each of the tile's
// TOTAL outputs (its own partial from out, the others' from the
// workspace), in split order, through store. A thread takes OUT outputs
// and RED splits at a time (32 loads), all in flight before the adds.
template <int TOTAL, typename Part, typename Live, typename Store>
__device__ __forceinline__ void dc_last(int tid, int total, int splits,
                                        int split, const float* out,
                                        Part part, Live live, Store store) {
  constexpr int OUT = (TOTAL + DC_THREADS - 1) / DC_THREADS;
  constexpr int RED = 32 / OUT > 0 ? 32 / OUT : 1;
  float sum[OUT];
#pragma unroll 1
  for (int s0 = 0; s0 < splits; s0 += RED) {
    float got[RED][OUT];
#pragma unroll
    for (int u = 0; u < RED; ++u)
#pragma unroll
      for (int i = 0; i < OUT; ++i) {
        const int e = tid + i * DC_THREADS;
        got[u][i] = (e >= total || !live(e) || s0 + u >= splits) ? 0.f
                    : (s0 + u == split) ? out[e]
                                        : __ldcg(part(s0 + u, e));
      }
#pragma unroll
    for (int u = 0; u < RED; ++u)
#pragma unroll
      for (int i = 0; i < OUT; ++i)
        if (s0 + u < splits)
          sum[i] = s0 + u == 0 ? got[u][i] : __fadd_rn(sum[i], got[u][i]);
  }
#pragma unroll
  for (int i = 0; i < OUT; ++i) {
    const int e = tid + i * DC_THREADS;
    if (e < total && live(e)) store(e, sum[i]);
  }
}

// T: x and y; V: vals (T, or int8_t with per-column f32 scales); MR: rows
// of x computed (1, 2, 4 or 8; rows past M are zeros)
template <typename T, typename V, int MR>
__global__ void __launch_bounds__(DC_THREADS, DC_CTAS)
nm_spmm_decode_kernel(const __grid_constant__ DcArgs p) {
  constexpr int VEC = dc_vec<V>();
  constexpr int NW = VEC / 4;  // index words a row
  using Val = DcVal<V>;
  constexpr int VW = Val::VW;  // value words a row
  constexpr bool kScaled = std::is_same<V, int8_t>::value;
  constexpr int SB = dc_stage_bytes(static_cast<int>(sizeof(V)));
  constexpr int STAGES = dc_stages(static_cast<int>(sizeof(V)));
  constexpr int VB = DC_THREADS * DC_RPT * VEC * static_cast<int>(sizeof(V));
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((128 - (smem_addr(smem_raw) & 127)) & 127);
  __shared__ int is_last;
  __shared__ uint64_t full[STAGES];  // a slot's tensor copies landed

  const int tid = threadIdx.x;
  const int lanes = 1 << p.lg;
  const int bn = lanes * VEC;  // columns of the tile
  const int lbn = p.lg + dc_log2(VEC);
  const int groups = DC_THREADS >> p.lg;  // row groups
  const int R = groups * DC_RPT;          // rows a stage
  const int cc = tid & (lanes - 1), rg = tid >> p.lg;
  const int tile = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const int col0 = tile * bn;
  const int vcols = min(bn, p.N - col0);
  const int b0 = split * p.per;
  const int nb = max(0, min(p.per, p.kb - b0));  // m-blocks of this split
  const int rows = nb * p.n, kd = nb * p.m;
  const int ns = (rows + R - 1) / R;  // stages
  const size_t g0 = static_cast<size_t>(b0) * p.n * p.N + col0;
  const V* vals = static_cast<const V*>(p.vals) + g0;
  const int8_t* idx = p.idx + g0;
  float* xs = reinterpret_cast<float*>(smem + STAGES * SB);

  // stage t of this split into ring slot t % STAGES: its rows of vals
  // and idx. Aligned rows: thread 0 arms the slot's mbarrier with the
  // stage's bytes and asks for one tensor copy an array (a box that runs
  // past the split or the tensor only adds rows the loop skips, or zeros).
  // Else cp.async by every thread, one commit group a stage (empty past
  // the last).
  auto load_stage = [&](int t) {
    if (p.tma) {
      if (t < ns && tid == 0) {
        unsigned char* st = smem + (t % STAGES) * SB;
        uint64_t* bar = &full[t % STAGES];
        mbar_expect(bar, SB);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        const int r = b0 * p.n + t * R;
        tma_load(st, &p.tv, col0, r, bar);
        tma_load(st + VB, &p.ti, col0, r, bar);
      }
      return;
    }
    if (t < ns) {
      unsigned char* st = smem + (t % STAGES) * SB;
      const int nr = min(R, rows - t * R);
      const size_t off = static_cast<size_t>(t) * R * p.N;
      dc_copy_any<V>(p.v_bytes, reinterpret_cast<V*>(st), lbn, vals + off,
                     p.N, nr, vcols, tid);
      dc_copy_any<int8_t>(p.i_bytes, reinterpret_cast<int8_t*>(st + VB), lbn,
                          idx + off, p.N, nr, vcols, tid);
    }
    cp_async_commit();
  };

  if (p.tma) {
    if (tid == 0) {
#pragma unroll
      for (int s = 0; s < STAGES; ++s) mbar_init(&full[s]);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  {
    constexpr int XP = dc_xp<MR>() * DC_THREADS;  // dense rows a pass
    T xv[dc_xp<MR>()][MR];
    dc_load_x<T, MR>(p, b0 * p.m, kd, tid, xv);
#pragma unroll 1
    for (int t = 0; t < STAGES - 1; ++t) load_stage(t);
    dc_store_x<T, MR>(xs, kd, tid, xv);
#pragma unroll 1
    for (int k = tid + XP; k < kd; k += XP) {
      dc_load_x<T, MR>(p, b0 * p.m, kd, k, xv);
      dc_store_x<T, MR>(xs, kd, k, xv);
    }
  }

  float acc[MR][VEC];
#pragma unroll
  for (int r = 0; r < MR; ++r)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[r][v] = 0.f;

  const unsigned m_u = p.m;
  const unsigned lim = min(m_u, 128u) * 0x01010101u;  // an index byte's bound
  const int mstride = p.m * MR;  // floats of x an m-block
#pragma unroll 1
  for (int t = 0; t < ns; ++t) {
    if (p.tma)
      mbar_wait(&full[t % STAGES], (t / STAGES) & 1);
    else
      cp_async_wait<STAGES - 2>();  // this thread's copies of stage t
    __syncthreads();  // everyone's (and x); stage t - 1's slot is free
    load_stage(t + STAGES - 1);

    const unsigned char* st = smem + (t % STAGES) * SB;
    const V* sv = reinterpret_cast<const V*>(st) + cc * VEC;
    const int8_t* si = reinterpret_cast<const int8_t*>(st + VB) + cc * VEC;
    // at 8 rows the two rows of a stage one after the other (registers)
#pragma unroll(MR == 8 ? 1 : DC_RPT)
    for (int u = 0; u < DC_RPT; ++u) {
      const int lr = rg + u * groups;  // row of the stage
      const int j = t * R + lr;        // row of the split
      if (j >= rows) break;
      uint32_t w[VW], iw[NW];
      Val::load(sv + (lr << lbn), w);
      const int8_t* ip = si + (lr << lbn);
      if constexpr (NW == 2) {
        const uint2 a = *reinterpret_cast<const uint2*>(ip);
        iw[0] = a.x, iw[NW - 1] = a.y;
      } else {
        iw[0] = *reinterpret_cast<const uint32_t*>(ip);
      }
      const float* xk = xs + (p.n == 1 ? j : __umulhi(j, p.magic)) * mstride;
      unsigned bad = 0;
#pragma unroll
      for (int q = 0; q < NW; ++q) bad |= __vcmpgeu4(iw[q], lim);
      if (bad) {  // an index outside [0, m) adds nothing
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          if (((iw[v / 4] >> (8 * (v % 4))) & 0xffu) >= min(m_u, 128u)) {
            Val::zero(w, v);
            iw[v / 4] &= ~(0xffu << (8 * (v % 4)));
          }
      }
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const int i = __byte_perm(iw[v / 4], 0, 0x4440 + v % 4);
        const float wv = Val::get(w, v);
        float xv[MR];
        dc_x<MR>(xk + i * MR, xv);
#pragma unroll
        for (int r = 0; r < MR; ++r) acc[r][v] = fmaf(xv[r], wv, acc[r][v]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the tree below

  // add the row groups in one round: every thread writes its sums to
  // red[e][thread] (rows padded by one word: no bank conflict either way),
  // then each output (e, column chunk) is summed over the groups in group
  // order into out[row][column of the tile], after red
  constexpr int E = MR * VEC;  // sums a thread holds
  constexpr int RLD = DC_THREADS + 1;
  float* red = reinterpret_cast<float*>(smem);
  float* out = red + E * RLD;
#pragma unroll
  for (int e = 0; e < E; ++e) red[e * RLD + tid] = acc[e / VEC][e % VEC];
  __syncthreads();
  for (int o = tid; o < (E << p.lg); o += DC_THREADS) {
    const int e = o >> p.lg, c = o & (lanes - 1);
    float v = red[e * RLD + c];
    for (int g = 1; g < groups; ++g)
      v = __fadd_rn(v, red[e * RLD + (g << p.lg) + c]);
    out[((e / VEC) << lbn) + c * VEC + e % VEC] = v;
  }
  __syncthreads();

  T* y = static_cast<T*>(p.y);
  const int total = MR << lbn, cmask = bn - 1;
  auto live = [&](int e) { return (e >> lbn) < p.M && (e & cmask) < vcols; };
  auto store = [&](int e, float s) {  // the epilogue of one output
    const int col = col0 + (e & cmask);
    if (kScaled) s = __fmul_rn(s, p.scales[col]);
    if (p.bias != nullptr) s = __fadd_rn(s, p.bias[col]);
    y[static_cast<size_t>(e >> lbn) * p.N + col] =
        from_f32<T>(dc_activate(p.act, s));
  };
  if (splits == 1) {
    for (int e = tid; e < total; e += DC_THREADS)
      if (live(e)) store(e, out[e]);
    return;
  }
  // this split's partial, then the tile's counter; the last CTA of the
  // tile adds the partials in split order
  auto part = [&](int s, int e) {
    return p.ws + (static_cast<size_t>(s) * p.M + (e >> lbn)) * p.N + col0 +
           (e & cmask);
  };
  for (int e = tid; e < total; e += DC_THREADS)
    if (live(e)) __stcg(part(split, e), out[e]);
  __syncthreads();  // every partial store of the CTA precedes the release
  if (tid == 0) {
    asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
    is_last = atomicAdd(&p.counters[tile], 1) == splits - 1;
    if (is_last) asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
  }
  __syncthreads();
  if (!is_last) return;
  switch (p.lg) {
    case 3:
      dc_last<MR * VEC * 8>(tid, total, splits, split, out, part, live, store);
      break;
    case 4:
      dc_last<MR * VEC * 16>(tid, total, splits, split, out, part, live,
                             store);
      break;
    default:
      dc_last<MR * VEC * 32>(tid, total, splits, split, out, part, live,
                             store);
  }
  if (tid == 0) p.counters[tile] = 0;  // ready for the next call
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

using DecodeFn = void (*)(DcArgs);

// the kernel computing mr rows (1, 2, 4 or 8) and its shared memory;
// raises the CTA's dynamic shared-memory limit to that once per device
// (every instantiation takes more than 48 KB with its static word)
template <typename T, typename V>
int decode_prepare(int mr, DecodeFn* fn, int* smem) {
  int slot;
  switch (mr) {
    case 1: *fn = nm_spmm_decode_kernel<T, V, 1>, slot = 0; break;
    case 2: *fn = nm_spmm_decode_kernel<T, V, 2>, slot = 1; break;
    case 4: *fn = nm_spmm_decode_kernel<T, V, 4>, slot = 2; break;
    case 8: *fn = nm_spmm_decode_kernel<T, V, 8>, slot = 3; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  *smem = dc_smem(static_cast<int>(sizeof(V)));
  static unsigned long long raised[4];  // devices done, a bit each
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (bit && (raised[slot] & bit)) return 0;
  e = cudaFuncSetAttribute(reinterpret_cast<const void*>(*fn),
                           cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  raised[slot] |= bit;
  return 0;
}

inline int decode_rows(int m) { return m <= 1 ? 1 : m <= 2 ? 2 : m <= 4 ? 4 : 8; }

// cuTensorMapEncodeTiled from libcuda as the process has loaded it (null
// where it cannot be found: the cp.async path serves)
using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);
inline EncodeFn dc_encoder() {
  static EncodeFn fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeFn>(
                                dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// tensor maps of a (rows x cols) row-major array of es-byte elements with
// (box_r x box_c) boxes, kept for the last DC_TMAPS arrays asked for
constexpr int DC_TMAPS = 64;
inline bool dc_tensor_map(CUtensorMap* out, const void* base, int rows,
                          int cols, int es, int box_r, int box_c) {
  struct Entry {
    const void* base;
    int rows, cols, es, box_r, box_c;
    CUtensorMap map;
  };
  static Entry cache[DC_TMAPS];
  static int next = 0;
  for (const Entry& e : cache)
    if (e.base == base && e.rows == rows && e.cols == cols && e.es == es &&
        e.box_r == box_r && e.box_c == box_c) {
      *out = e.map;
      return true;
    }
  const EncodeFn enc = dc_encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * es};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_c),
                             static_cast<cuuint32_t>(box_r)};
  const cuuint32_t step[2] = {1, 1};
  const CUtensorMapDataType type =
      es == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
              : es == 2 ? CU_TENSOR_MAP_DATA_TYPE_UINT16
                        : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  if (enc(out, type, 2, const_cast<void*>(base), dims, strides, box, step,
          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  cache[next] = Entry{base, rows, cols, es, box_r, box_c, *out};
  next = (next + 1) % DC_TMAPS;
  return true;
}

// One launch of at most 8 rows: the tile width (cols), m-blocks a split
// (per) and the split count from the host (padding.decode_plan); the
// split count must be what they give.
template <typename T, typename V>
int decode_launch(int act, const void* x, const void* vals, const void* idx,
                  const void* scales, const void* bias, void* y, void* ws,
                  void* counters, int M, int K, int N, int n, int m, int cols,
                  int per, int splits, cudaStream_t stream) {
  constexpr int VEC = dc_vec<V>();
  int lg = -1;
  for (int l = 3; l <= 5; ++l)
    if (cols == VEC << l) lg = l;
  if (M < 1 || M > 8 || N < 1 || K < 0 || n < 1 || n >= m || m > DC_KROWS ||
      K % m || lg < 0 || per < 1 || per * m > DC_KROWS)
    return static_cast<int>(cudaErrorInvalidValue);
  const int kb = K / m;
  if (splits != (kb == 0 ? 1 : (kb + per - 1) / per) ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  DecodeFn fn = nullptr;
  int smem = 0;
  const int rc = decode_prepare<T, V>(decode_rows(M), &fn, &smem);
  if (rc != 0) return rc;
  DcArgs p{};
  p.x = x, p.vals = vals, p.idx = static_cast<const int8_t*>(idx);
  p.scales = static_cast<const float*>(scales);
  p.bias = static_cast<const float*>(bias);
  p.y = y, p.ws = static_cast<float*>(ws);
  p.counters = static_cast<int*>(counters);
  p.magic = n > 1 ? static_cast<unsigned>(((1ull << 32) + n - 1) / n) : 0;
  p.M = M, p.K = K, p.N = N, p.n = n, p.m = m;
  p.lg = lg, p.per = per, p.kb = kb, p.act = act;
  p.v_bytes = copy_bytes(vals, sizeof(V) * static_cast<size_t>(N),
                         sizeof(V) * cols, sizeof(V));
  p.i_bytes = copy_bytes(idx, static_cast<size_t>(N), cols, 1);
  const int kc = kb * n, box_r = (DC_THREADS >> lg) * DC_RPT;
  p.tma = p.v_bytes == 16 && p.i_bytes == 16 && kc > 0 &&
          dc_tensor_map(&p.tv, vals, kc, N, sizeof(V), box_r, cols) &&
          dc_tensor_map(&p.ti, idx, kc, N, 1, box_r, cols);
  const dim3 grid((N + cols - 1) / cols, splits);
  void* args[] = {&p};
  return static_cast<int>(cudaLaunchKernel(reinterpret_cast<const void*>(fn),
                                           grid, dim3(DC_THREADS), args, smem,
                                           stream));
}

// CTAs per SM (out[0]), threads (out[1]), dynamic shared memory (out[2]),
// registers a thread (out[3]) and local memory a thread (out[4], spills)
// of the kernel computing rows (1, 2, 4 or 8) rows
template <typename T, typename V>
int decode_occupancy(int rows, int* out) {
  DecodeFn fn = nullptr;
  int smem = 0;
  out[0] = out[3] = out[4] = 0;
  int rc = decode_prepare<T, V>(rows, &fn, &smem);
  if (rc == 0)
    rc = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[0], reinterpret_cast<const void*>(fn), DC_THREADS, smem));
  if (rc == 0) {
    cudaFuncAttributes a;
    rc = static_cast<int>(
        cudaFuncGetAttributes(&a, reinterpret_cast<const void*>(fn)));
    out[3] = a.numRegs;
    out[4] = static_cast<int>(a.localSizeBytes);
  }
  out[1] = DC_THREADS;
  out[2] = smem;
  return rc;
}

}  // namespace nmk
