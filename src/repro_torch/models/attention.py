"""GQA attention with RoPE (port of the GQA path of
``repro.models.attention``).

  train/prefill  full-sequence online-softmax attention over KV chunks
                 (:func:`chunked_attention`); prefill also writes the
                 cache from position 0.
  decode/chunk   the new tokens against the cache at offset
                 ``cache_len`` (:func:`decode_attention`).

Dense attention is plain PyTorch, as it is plain jnp in the JAX package;
the four projections are N:M-eligible (target "attn_proj") and go
through the compressed-GEMM kernels. Products accumulate in f32
(:mod:`repro_torch.core.dots`). The JAX package updates the cache
functionally and its serving engine merges back the slots it keeps;
here the new rows of the slots in ``view.write_mask`` are written into
the cache in place, and nothing else is copied.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import AttnConfig, SparsityConfig
from repro_torch.core.dots import acc_einsum
from repro_torch.models.cache import CacheView, cache_write_index
from repro_torch.models.common import (
    Linear,
    RMSNorm,
    apply_rope_tables,
    linear_init,
    rope_tables,
)

NEG_INF = -1e30


class CacheLenError(ValueError):
    """A ``cache_len`` would write outside the cache bounds."""


def _check_cache_len(cache_len: torch.Tensor, s: int, max_seq: int) -> None:
    """Bounds-check offsets held on the host (``LM.forward`` checks them
    before it moves them to the card)."""
    if bool((cache_len < 0).any()) or bool((cache_len + s > max_seq).any()):
        raise CacheLenError(
            f"cache_len={cache_len.tolist()} with a {s}-token write exceeds "
            f"cache bounds [0, {max_seq}]")


def _write_cache(cache_arr: torch.Tensor, new: torch.Tensor,
                 index: tuple) -> None:
    """Write the s-token update ``new`` (B, s, ...) into ``cache_arr``
    (B, S, ...) in place at ``index`` (see ``cache_write_index``)."""
    rows, cols = index
    cache_arr.index_put_((rows[:, None], cols), new[rows].to(cache_arr.dtype))


def _len_mask(length: torch.Tensor, s: int) -> torch.Tensor:
    """valid-position mask; (s,) for a scalar length, (B, s) per slot."""
    pos = torch.arange(s, device=length.device)
    if length.dim() == 0:
        return pos < length
    return pos[None, :] < length[:, None]


def _apply_len_mask(logits: torch.Tensor, valid: torch.Tensor):
    """logits: (b, ..., s); valid: (s,) or (b, s)."""
    if valid.dim() == 1:
        shape = (1,) * (logits.dim() - 1) + (valid.shape[-1],)
    else:
        shape = (valid.shape[0],) + (1,) * (logits.dim() - 2) + (valid.shape[-1],)
    return torch.where(valid.reshape(shape), logits, NEG_INF)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, window: Optional[int], chunk: int,
                      q_offset: int = 0,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Online-softmax attention over KV chunks. q: (B, Sq, Hq, Dk);
    k, v: (B, Skv, Hkv, D). f32 running max, denominator and output."""
    b, sq, hq, dk = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = hq // hkv
    scale = scale if scale is not None else dk ** -0.5
    chunk = min(chunk, skv)
    qf = (q * torch.tensor(scale, dtype=q.dtype)).reshape(b, sq, hkv, g, dk)
    q_pos = q_offset + torch.arange(sq, device=q.device)
    m = torch.full((b, sq, hkv, g), NEG_INF, device=q.device)
    l = torch.zeros((b, sq, hkv, g), device=q.device)
    o = torch.zeros((b, sq, hkv, g, dv), device=q.device)
    for c0 in range(0, skv, chunk):
        kb, vb = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        s = acc_einsum("bqhgd,bchd->bqhgc", qf, kb)
        kv_pos = c0 + torch.arange(kb.shape[1], device=q.device)
        mask = torch.ones((sq, kb.shape[1]), dtype=torch.bool, device=q.device)
        if causal:
            mask &= q_pos[:, None] >= kv_pos[None, :]
        if window is not None:
            mask &= q_pos[:, None] - kv_pos[None, :] < window
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + acc_einsum("bqhgc,bchd->bqhgd",
                                             p.to(v.dtype), vb)
        m = m_new
    out = o / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(b, sq, hq, dv).to(q.dtype)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     length: torch.Tensor, window: Optional[int],
                     scale: Optional[float] = None,
                     q_positions: Optional[torch.Tensor] = None):
    """The new tokens against the whole cache as plain reductions over S.

    q: (B, sq, Hq, Dk); k, v: (B, S, Hkv, D). Without ``q_positions`` the
    valid cache is ``[0, length)``; with them (chunk mode) cache slot j is
    visible to a query at position p iff j <= p.
    """
    b, sq, hq, dk = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else dk ** -0.5
    qf = (q * torch.tensor(scale, dtype=q.dtype)).reshape(b, sq, hkv, g, dk)
    logits = acc_einsum("bqhgd,bshd->bqhgs", qf, k.to(q.dtype))
    pos = torch.arange(s, device=q.device)
    if q_positions is not None:
        qp = q_positions if q_positions.dim() == 2 else q_positions[None, :]
        valid = pos[None, None, :] <= qp[..., None]
        if window is not None:
            valid &= pos[None, None, :] > qp[..., None] - window
        logits = torch.where(valid[:, :, None, None, :], logits, NEG_INF)
    else:
        valid = _len_mask(length, s)
        if window is not None:
            if length.dim() == 0:
                valid &= pos >= length - window
            else:
                valid &= pos[None, :] >= (length - window)[:, None]
        logits = _apply_len_mask(logits, valid)
    p = _softmax(logits)
    out = acc_einsum("bqhgs,bshd->bqhgd", p.to(q.dtype), v.to(q.dtype))
    return out.reshape(b, sq, hq, -1).to(q.dtype)


def _softmax(logits: torch.Tensor) -> torch.Tensor:
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    return p / p.sum(-1, keepdim=True)


class GQA(nn.Module):
    """Grouped-query attention: wq, wk, wv, wo (+ optional q/k norms)."""

    def __init__(self, cfg: AttnConfig, wq, wk, wv, wo, q_norm=None,
                 k_norm=None):
        super().__init__()
        self.cfg = cfg
        self.wq, self.wk, self.wv, self.wo = (Linear(w) for w in
                                              (wq, wk, wv, wo))
        self.q_norm = RMSNorm(q_norm) if q_norm is not None else None
        self.k_norm = RMSNorm(k_norm) if k_norm is not None else None

    @classmethod
    def init(cls, gen: torch.Generator, d_model: int, cfg: AttnConfig, *,
             sp: Optional[SparsityConfig], dtype,
             quantize: Optional[str] = None) -> "GQA":
        def lin(i, o):
            return linear_init(gen, i, o, sp=sp, target="attn_proj",
                               dtype=dtype, quantize=quantize)

        q, kv = cfg.q_heads * cfg.head_dim, cfg.kv_heads * cfg.head_dim
        ws = (lin(d_model, q), lin(d_model, kv), lin(d_model, kv),
              lin(q, d_model))
        norms = (None, None)
        if cfg.qk_norm:
            ones = torch.ones(cfg.head_dim, dtype=dtype, device=gen.device)
            norms = (ones, ones.clone())
        return cls(cfg, *ws, *norms)

    def forward(self, x: torch.Tensor, *, view: CacheView,
                cache: Optional[dict], rope_theta: float, chunk: int,
                rope: Optional[tuple] = None):
        """Returns y; prefill, decode and chunk modes write ``cache`` in
        place. ``view.positions`` is set by LM.forward,
        which also passes the rope tables it made once for all layers
        (``rope``, see :func:`rope_tables`); without them they are made
        here from the positions and ``rope_theta``."""
        cfg = self.cfg
        b, s, _ = x.shape
        positions = view.positions
        if positions is None:
            positions = torch.arange(s, device=x.device)
        q = self.wq(x).reshape(b, s, cfg.q_heads, cfg.head_dim)
        k = self.wk(x).reshape(b, s, cfg.kv_heads, cfg.head_dim)
        v = self.wv(x).reshape(b, s, cfg.kv_heads, cfg.head_dim)
        if self.q_norm is not None:
            q, k = self.q_norm(q), self.k_norm(k)
        if cfg.rope:
            if rope is None:
                rope = rope_tables(positions, cfg.head_dim, rope_theta)
            q = apply_rope_tables(q, *rope)
            k = apply_rope_tables(k, *rope)

        if view.mode != "train":
            if cache is None:
                raise ValueError(f"{view.mode} mode needs a cache")
            index = (view.write_index if view.write_index is not None
                     else cache_write_index(view, b, s, x.device))
            _write_cache(cache["k"], k, index)
            _write_cache(cache["v"], v, index)
        if view.offset_mode:
            out = decode_attention(
                q, cache["k"], cache["v"], length=view.cache_len + s,
                window=cfg.window,
                q_positions=positions if view.mode == "chunk" else None)
        else:
            out = chunked_attention(q, k, v, causal=cfg.causal,
                                    window=cfg.window, chunk=chunk)
        return self.wo(out.reshape(b, s, -1))


def gqa_empty_cache(batch: int, max_seq: int, cfg: AttnConfig, dtype,
                    device) -> dict:
    shape = (batch, max_seq, cfg.kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
