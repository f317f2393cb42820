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
* :func:`masked_decode`: the decode / chunk family's only lowering, the
  spec predicate inside the decode softmax (block skipping buys nothing
  at Sq in {1, chunk} against a cache view).

Every product accumulates in f32 and q is scaled in f32, as in the JAX
package (``q.float() * scale``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.dots import acc_einsum
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
        bm = torch.as_tensor(block_bitmap(
            spec, -(-max_q // spec.block), -(-max_k // spec.block)),
            device=q_pos.device)
    return token_mask(spec, q_pos, k_pos, bitmap=bm)


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


def blocksparse_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      plan: MaskPlan,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Block-gather lowering: the work scales with the plan's gather
    width (live k-blocks per query row), not the full k length."""
    b, sq, hq, dk = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = hq // hkv
    bq, bk = plan.bq, plan.bk
    nqb, nkb, width = plan.nqb, plan.nkb, plan.gather_width
    dev = q.device

    def pad(x, n):  # zero rows appended on the sequence axis
        return F.pad(x, (0, 0, 0, 0, 0, n))

    qb = _scaled_q(pad(q, nqb * bq - sq), hkv, scale).reshape(
        b, nqb, bq, hkv, g, dk)
    kb = pad(k, nkb * bk - skv).reshape(b, nkb, bk, hkv, dk)
    vb = pad(v, nkb * bk - skv).reshape(b, nkb, bk, hkv, dv)
    idx = torch.as_tensor(plan.row_idx.reshape(-1), dtype=torch.long,
                          device=dev)
    kg = kb.index_select(1, idx).reshape(b, nqb, width, bk, hkv, dk)
    vg = vb.index_select(1, idx).reshape(b, nqb, width, bk, hkv, dv)

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
