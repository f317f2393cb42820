"""Plain PyTorch lowerings of the block-sparse attention families (port
of ``repro.kernels.blocksparse_attn.ref``).

* :func:`masked_reference`: dense attention with the spec's token
  predicate applied through ``torch.where``; the parity oracle every
  sparse path is held to, and the priority-0 implementation.
* :func:`blocksparse_torch`: the block-gather lowering (the counterpart
  of ``blocksparse_xla``): pad both sequence axes to the plan's tile,
  gather each query row's live k-blocks through ``row_idx`` and run a
  masked softmax over the gathered width only. The CPU backend's sparse
  lowering, and the plain version of the Hopper kernel.
* :func:`blocksparse_mma`: the plain twin of the bf16 Hopper kernel's
  arithmetic (its rounding points and online-softmax steps), for the
  tests and ``chip_smoke.py``; no path of the port runs it.
* :func:`masked_decode`: the decode / chunk family's only lowering, the
  spec predicate inside the decode softmax (block skipping buys nothing
  at Sq in {1, chunk} against a cache view).

Every product accumulates in f32 and q is scaled in f32, as in the JAX
package (``q.float() * scale``).
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.dots import acc_einsum
from repro_torch.kernels import capture
from repro_torch.kernels.blocksparse_attn.mask import (
    MaskPlan,
    MaskSpec,
    block_bitmap,
    gather_masks,
    token_mask,
)

NEG_INF = -1e30


def torch_token_mask(spec: MaskSpec, q_pos: torch.Tensor,
                     k_pos: torch.Tensor, *, max_q: int, max_k: int):
    """The token predicate over torch positions (integer tensors on one
    device). ``max_q``/``max_k`` bound the positions: blockwise specs
    size their bitmap by them."""
    bm = None
    if spec.kind == "blockwise":
        bm = _device_bitmap(spec, -(-max_q // spec.block),
                            -(-max_k // spec.block), q_pos.device)
        capture.hold(bm)  # a captured graph outlives the LRU entry
    return token_mask(spec, q_pos, k_pos, bitmap=bm)


@functools.lru_cache(maxsize=64)
def _device_bitmap(spec: MaskSpec, nq: int, nk: int,
                   device: torch.device) -> torch.Tensor:
    """A blockwise spec's (nq, nk) block bitmap on ``device``, uploaded
    once (no host copy inside a step, so a step can be captured)."""
    return torch.as_tensor(block_bitmap(spec, nq, nk), device=device)


def _scaled_q(q: torch.Tensor, hkv: int, scale: Optional[float]):
    """q in f32 times the scale, split as (B, Sq, Hkv, G, Dk)."""
    b, sq, hq, dk = q.shape
    if scale is None:
        scale = dk ** -0.5
    return (q.float() * scale).reshape(b, sq, hkv, hq // hkv, dk)


def _softmax(logits: torch.Tensor) -> torch.Tensor:
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    return p / p.sum(-1, keepdim=True)


def masked_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     spec: MaskSpec, scale: Optional[float] = None
                     ) -> torch.Tensor:
    """Dense ``torch.where``-masked attention, the parity oracle.

    q: (B, Sq, Hq, Dk); k/v: (B, Skv, Hkv, D*) with Hq % Hkv == 0 (GQA).
    Positions are absolute from 0 (prefill semantics).
    """
    b, sq, hq, _ = q.shape
    skv = k.shape[1]
    qf = _scaled_q(q, k.shape[2], scale)
    logits = acc_einsum("bqhgd,bshd->bqhgs", qf, k)
    dev = q.device
    mask = torch_token_mask(
        spec, torch.arange(sq, device=dev)[:, None],
        torch.arange(skv, device=dev)[None, :], max_q=sq, max_k=skv)
    logits = torch.where(mask[None, :, None, None, :], logits, NEG_INF)
    out = acc_einsum("bqhgs,bshd->bqhgd", _softmax(logits), v)
    return out.reshape(b, sq, hq, -1).to(q.dtype)


def _pad_seq(x: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` zero rows appended on the sequence axis of (B, S, H, D)."""
    return F.pad(x, (0, 0, 0, 0, 0, n))


def _gather_kv(k: torch.Tensor, v: torch.Tensor, plan: MaskPlan):
    """k and v gathered along each q-block's ``row_idx``: (B, nqb,
    gather_width, bk, Hkv, D*), live k-blocks first."""
    b, skv, hkv, dk = k.shape
    dv = v.shape[-1]
    nkb, bk, width = plan.nkb, plan.bk, plan.gather_width
    kb = _pad_seq(k, nkb * bk - skv).reshape(b, nkb, bk, hkv, dk)
    vb = _pad_seq(v, nkb * bk - skv).reshape(b, nkb, bk, hkv, dv)
    idx = torch.as_tensor(plan.row_idx.reshape(-1), dtype=torch.long,
                          device=k.device)
    return (kb.index_select(1, idx).reshape(b, plan.nqb, width, bk, hkv, dk),
            vb.index_select(1, idx).reshape(b, plan.nqb, width, bk, hkv, dv))


def blocksparse_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      plan: MaskPlan,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Block-gather lowering: the work scales with the plan's gather
    width (live k-blocks per query row), not the full k length."""
    b, sq, hq, dk = q.shape
    hkv = k.shape[2]
    dv = v.shape[-1]
    g = hq // hkv
    bq, bk = plan.bq, plan.bk
    nqb, width = plan.nqb, plan.gather_width
    dev = q.device

    qb = _scaled_q(_pad_seq(q, nqb * bq - sq), hkv, scale).reshape(
        b, nqb, bq, hkv, g, dk)
    kg, vg = _gather_kv(k, v, plan)

    logits = acc_einsum("bnqhgd,bnwkhd->bnqhgwk", qb, kg)
    gmask = torch.as_tensor(gather_masks(plan), device=dev)  # (n, w, q, k)
    logits = torch.where(
        gmask.permute(0, 2, 1, 3)[None, :, :, None, None, :, :],
        logits, NEG_INF)
    p = _softmax(logits.reshape(b, nqb, bq, hkv, g, width * bk))
    p = p.reshape(b, nqb, bq, hkv, g, width, bk)
    out = acc_einsum("bnqhgwk,bnwkhd->bnqhgd", p, vg)
    out = out.reshape(b, nqb * bq, hq, dv)[:, :sq]
    return out.to(q.dtype)


LOG2E = 1.4426950408889634
MMA_CHUNK = 64  # key slots per online-softmax step of the bf16 kernel


def blocksparse_mma(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    plan: MaskPlan,
                    scale: Optional[float] = None) -> torch.Tensor:
    """What the bf16 tensor-core kernel computes, rounded where it
    rounds: f32 scores from q . k, times the scale after the product (in
    log2 units, ``scale * log2(e)`` in f32); an online softmax over
    64-slot chunks of each q-block's run of live keys (``exp2``); P
    rounded to q's dtype before P V, with the row sums over the rounded
    P; f32 accumulation; out = acc / max(l, 1e-30) in q's dtype."""
    b, sq, hq, dk = q.shape
    hkv, dv = k.shape[2], v.shape[-1]
    g = hq // hkv
    bq, bk = plan.bq, plan.bk
    nqb, width = plan.nqb, plan.gather_width
    dev = q.device
    if scale is None:
        scale = dk ** -0.5
    sl2 = torch.tensor(scale, dtype=torch.float32) * torch.tensor(
        LOG2E, dtype=torch.float32)

    qb = _pad_seq(q, nqb * bq - sq).float().reshape(b, nqb, bq, hkv, g, dk)
    # a q-block's live pairs lead its gather row, so the row's key slots
    # are the kernel's run of live keys, padded with masked slots
    kg, vg = (t.reshape(b, nqb, width * bk, hkv, -1)
              for t in _gather_kv(k, v, plan))
    s = acc_einsum("bnqhgd,bnkhd->bnqhgk", qb, kg) * sl2.to(dev)
    gmask = torch.as_tensor(gather_masks(plan), device=dev)  # (n, w, q, k)
    gmask = gmask.permute(0, 2, 1, 3).reshape(nqb, bq, width * bk)
    s = torch.where(gmask[None, :, :, None, None, :], s, NEG_INF)
    m = torch.full(s.shape[:-1], NEG_INF, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros(*s.shape[:-1], dv, device=dev)
    for c0 in range(0, width * bk, MMA_CHUNK):
        sc = s[..., c0:c0 + MMA_CHUNK]
        m_new = torch.maximum(m, sc.amax(-1))
        p = torch.exp2(sc - m_new[..., None]).to(q.dtype).float()
        corr = torch.exp2(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + acc_einsum(
            "bnqhgk,bnkhd->bnqhgd", p, vg[:, :, c0:c0 + MMA_CHUNK])
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(b, nqb * bq, hq, dv)[:, :sq].to(q.dtype)


def masked_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  spec: MaskSpec, length, q_positions=None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Mask-aware decode / chunk attention over a (possibly overlong)
    cache view: q (B, Sq, Hq, Dk) against k/v (B, S, Hkv, D*).

    ``length`` is the number of valid cache positions (an int, a scalar
    tensor or a (B,) tensor); ``q_positions`` gives each query's absolute
    position ((Sq,) or (B, Sq); chunk mode) and defaults to
    ``length - 1`` (single-step decode). Cache validity (``pos <=
    q_position``) holds on top of the spec predicate, so non-causal specs
    never read unwritten slots either.
    """
    b, sq, _, _ = q.shape
    s, hkv = k.shape[1], k.shape[2]
    dev = q.device
    length = torch.as_tensor(length, dtype=torch.long, device=dev)
    if q_positions is None:
        qp = (length - 1).reshape(-1, 1)                 # (B|1, 1)
        qp = qp.expand(qp.shape[0], sq)
    else:
        qp = torch.as_tensor(q_positions, dtype=torch.long, device=dev)
        if qp.dim() == 1:
            qp = qp[None, :]
    pos = torch.arange(s, device=dev)
    valid = torch_token_mask(
        spec, qp[:, :, None], pos[None, None, :], max_q=s, max_k=s)
    valid = valid & (pos[None, None, :] <= qp[:, :, None])
    qf = _scaled_q(q, hkv, scale)
    logits = acc_einsum("bqhgd,bshd->bqhgs", qf, k)
    logits = torch.where(valid[:, :, None, None, :], logits, NEG_INF)
    out = acc_einsum("bqhgs,bshd->bqhgd", _softmax(logits), v)
    return out.reshape(b, sq, q.shape[2], -1).to(q.dtype)
