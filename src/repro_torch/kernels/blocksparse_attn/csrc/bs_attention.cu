// bs_attention: block-sparse prefill attention over a MaskPlan's live
// pairs, q/k/v/out f32 or bf16 (one dtype). The kernel and its design are
// in bs_attention.cuh; it replaces
// src/repro/kernels/blocksparse_attn/kernel.py _bs_attn_call.
#include "bs_attention.cuh"

// C interface (loaded with ctypes by kernels/blocksparse_attn/kernel.py).
// The wrapper has checked devices, dtypes, shapes, 1 <= dk, dv <= 128,
// Hq % Hkv == 0 and the last dimension of q, k, v and out contiguous;
// strides are in elements, (batch, sequence, head) for each operand.
// Returns the CUDA error of the set-up or launch (0 on success).
extern "C" int bs_attention(int dtype, const void* q, const void* k,
                            const void* v, void* out, const void* row_ptr,
                            const void* pair_k, const void* masks,
                            const long long* strides, int batch, int sq,
                            int skv, int hq, int hkv, int dk, int dv, int bq,
                            int bk, int nqb, float scale, void* stream) {
  cudaGetLastError();  // clear a stale error so the result is this launch's
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
  p.sq = sq, p.skv = skv, p.hq = hq, p.hkv = hkv, p.dk = dk, p.dv = dv;
  p.bq = bq, p.bk = bk;
  p.nsub = (bq + nmk::BS_TQ - 1) / nmk::BS_TQ;
  p.scale = scale;
  if (dk < 1 || dv < 1 || dk > nmk::BS_MAXD || dv > nmk::BS_MAXD ||
      hkv < 1 || hq % hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == nmk::kF32)
    rc = nmk::bs_attention_launch<float>(p, batch, nqb, s);
  else if (dtype == nmk::kBF16)
    rc = nmk::bs_attention_launch<__nv_bfloat16>(p, batch, nqb, s);
  else
    rc = static_cast<int>(cudaErrorInvalidValue);
  return rc != 0 ? rc : static_cast<int>(cudaGetLastError());
}
