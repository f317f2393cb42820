// bs_attention: block-sparse prefill attention over a MaskPlan's live
// pairs, q/k/v/out f32 or bf16 (one dtype). The kernels and their design
// are in bs_attention.cuh; they replace
// src/repro/kernels/blocksparse_attn/kernel.py _bs_attn_call.
#include <stdint.h>

#include "bs_attention.cuh"

namespace {

// The widest of 16, 8 and 4 bytes that a copy from every row of an
// operand can take: its base address and its (batch, sequence, head)
// strides in bytes are multiples of it; 0 when none is.
int copy_bytes(const void* base, const long long* strides, int esize) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(base);
  for (int w = 16; w >= 4; w /= 2) {
    bool ok = a % w == 0;
    for (int i = 0; i < 3; ++i) ok = ok && (strides[i] * esize) % w == 0;
    if (ok) return w;
  }
  return 0;
}

}  // namespace

// C interface (loaded with ctypes by kernels/blocksparse_attn/kernel.py).
// The wrapper has checked devices, dtypes, shapes, 1 <= dk <= 192,
// 1 <= dv <= 128,
// Hq % Hkv == 0 and the last dimension of q, k, v and out contiguous;
// strides are in elements, (batch, sequence, head) for each operand.
// `group` is the bf16 kernel's q heads per CTA (kernel.py heads_per_cta;
// 1 for f32). Returns the CUDA error of the set-up or launch (0 on
// success).
extern "C" int bs_attention(int dtype, const void* q, const void* k,
                            const void* v, void* out, const void* row_ptr,
                            const void* pair_k, const void* masks,
                            const long long* strides, int batch, int sq,
                            int skv, int hq, int hkv, int dk, int dv, int bq,
                            int bk, int nqb, float scale, int group,
                            void* stream) {
  cudaGetLastError();  // clear a stale error so the result is this launch's
  if (dk < 1 || dv < 1 || dk > nmk::BS_MAXDK || dv > nmk::BS_MAXDV ||
      hkv < 1 || hq % hkv != 0 || bk % 8 != 0 || group < 1 ||
      group > nmk::BM_GROUP_MAX || (hq / hkv) % group != 0 ||
      (dtype == nmk::kF32 && group != 1) ||
      (dtype != nmk::kF32 && dtype != nmk::kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  nmk::BsParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.row_ptr = static_cast<const int*>(row_ptr);
  p.pair_k = static_cast<const int*>(pair_k);
  p.masks = static_cast<const uint8_t*>(masks);
  p.q_sb = strides[0], p.q_ss = strides[1], p.q_sh = strides[2];
  p.k_sb = strides[3], p.k_ss = strides[4], p.k_sh = strides[5];
  p.v_sb = strides[6], p.v_ss = strides[7], p.v_sh = strides[8];
  p.o_sb = strides[9], p.o_ss = strides[10], p.o_sh = strides[11];
  p.batch = batch, p.sq = sq, p.skv = skv, p.hq = hq, p.hkv = hkv;
  p.dk = dk, p.dv = dv;
  p.bq = bq, p.bk = bk;
  p.nsub = (bq + nmk::BS_TQ - 1) / nmk::BS_TQ;
  p.scale = scale;
  const int esize = dtype == nmk::kF32 ? 4 : 2;
  p.group = group;
  p.q_bytes = copy_bytes(q, strides, esize);
  p.k_bytes = copy_bytes(k, strides + 3, esize);
  p.v_bytes = copy_bytes(v, strides + 6, esize);
  p.m_bytes = bk % 16 == 0 ? 16 : 8;
  p.o_bytes = copy_bytes(out, strides + 9, esize);
  p.scale_log2 = scale * nmk::BM_LOG2E;
  nmk::BsLaunch l;
  const int rc = nmk::bs_prepare(dtype, p, l);
  if (rc != 0) return rc;
  const dim3 grid = dtype == nmk::kF32
                        ? dim3(nqb * p.nsub, hq, batch)
                        : dim3(nqb * p.nsub * (hq / group) * batch);
  void* args[] = {&p};
  const cudaError_t e =
      cudaLaunchKernel(l.fn, grid, dim3(l.threads), args, l.smem,
                       static_cast<cudaStream_t>(stream));
  return e != cudaSuccess ? static_cast<int>(e)
                          : static_cast<int>(cudaGetLastError());
}

// Occupancy of the kernel a call with these arguments launches: out[0]
// CTAs per SM, out[1] threads per CTA, out[2] dynamic shared memory per
// CTA in bytes. Returns a CUDA error code (0 on success).
extern "C" int bs_attention_occupancy(int dtype, int group, int dk, int dv,
                                      int* out) {
  cudaGetLastError();
  nmk::BsParams p{};
  p.group = group, p.dk = dk, p.dv = dv;
  nmk::BsLaunch l;
  int rc = nmk::bs_prepare(dtype, p, l);
  if (rc == 0)
    rc = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[0], l.fn, l.threads, l.smem));
  out[1] = l.threads;
  out[2] = l.smem;
  return rc;
}
