"""Attention mixers with RoPE (port of ``repro.models.attention``): GQA,
and DeepSeek-V2's multi-head latent attention (MLA).

  train/prefill  full-sequence online-softmax attention over KV chunks
                 (:func:`chunked_attention`); prefill also writes the
                 cache from position 0.
  decode/chunk   the new tokens against the cache at offset
                 ``cache_len`` (:func:`decode_attention`).

With ``cfg.mask`` (a ``MaskSpec``) set, train/prefill dispatch the
``bs_attention`` family (the hand-written block-sparse kernel on the
card) and decode/chunk the ``bs_attention_decode`` family.

A view with a ``block_table`` reads and writes the paged cache: the
cache leaves are page pools, :func:`paged_write` scatters the new rows
through the table (slots outside the write mask into the null page) and
:func:`paged_gather` assembles each slot's logical (B, S, ...) view for
decode/chunk attention.

MLA keeps a compressed cache ``{"ckv": (B, S, kv_lora_rank), "kr": (B,
S, rope_head_dim)}``: train and prefill materialise per-head K =
[k_nope | k_rope] and V from the latent and run the paths above (dk =
nope + rope, dv = v_head_dim); decode and chunk run the weight-absorbed
attention over the latent cache, with a mask's token predicate applied
inline (:class:`MLA`).

Dense attention is plain PyTorch, as it is plain jnp in the JAX package;
the projections are N:M-eligible (target "attn_proj") and go through
the compressed-GEMM kernels. Under tensor parallelism the
self-attention's ``wo`` output is summed over the "model" ranks
(``tp_reduce``, tag ``attn_out``), and in training the gradients of the
inputs of the split heads too (``tp_copy``, tags ``attn_in`` /
``kv_in``); the head counts in ``cfg`` are then the rank's own
(``parallel.sharding.serve_local_cfg``). Products
accumulate in f32 (:mod:`repro_torch.core.dots`). The JAX package updates the cache
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
from repro_torch.kernels.blocksparse_attn.ops import (
    bs_attention,
    bs_attention_decode,
)
from repro_torch.kernels.blocksparse_attn.ref import torch_token_mask
from repro_torch.models.cache import (
    CacheView,
    cache_write_index,
    paged_write_index,
)
from repro_torch.models.common import (
    Linear,
    RMSNorm,
    _param,
    apply_rope_tables,
    linear_init,
    rope_tables,
)
from repro_torch.parallel.hints import tp_copy, tp_enabled, tp_reduce

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


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A float8 tensor as its bytes (``uint8``, the same storage), else
    itself: the cache writes and gathers move fp8 entries as bytes,
    which is exact and needs no float8 indexing kernel on the card."""
    return t.view(torch.uint8) if t.dtype in _FLOAT8 else t


_FLOAT8 = (torch.float8_e4m3fn, torch.float8_e5m2)


def _write_cache(cache_arr: torch.Tensor, new: torch.Tensor,
                 index: tuple) -> None:
    """Write the s-token update ``new`` (B, s, ...) into ``cache_arr``
    (B, S, ...) in place at ``index`` (see ``cache_write_index``); a slot
    outside ``keep`` writes back the rows it holds there."""
    rows, cols, keep = index
    new = _bytes(new.to(cache_arr.dtype))
    cache_arr = _bytes(cache_arr)
    if keep is not None:
        old = cache_arr[rows[:, None], cols]
        new = torch.where(keep.view((-1,) + (1,) * (new.dim() - 1)), new,
                          old)
    cache_arr.index_put_((rows[:, None], cols), new)


def paged_write(pool: torch.Tensor, new: torch.Tensor,
                cache_len: torch.Tensor, table: torch.Tensor,
                write_mask: torch.Tensor,
                index: Optional[torch.Tensor] = None) -> None:
    """Scatter the s-token update ``new`` (B, s, ...) into the page pool
    (rows, page_size, ...) in place through the block table.

    ``table`` is (B, pages_per_slot) of global page ids (``% rows`` gives
    the local row); ``cache_len`` the (B,) or scalar write offsets.
    Slots outside ``write_mask`` and positions past the table write the
    null page (local row 0), never page 0 of their table row, which may
    be a shared prefix page. ``index`` is :func:`paged_write_index` of
    these operands where the caller made it once for every layer."""
    rows, ps = pool.shape[0], pool.shape[1]
    b, s = new.shape[:2]
    if index is None:
        index = paged_write_index(cache_len, table, write_mask, s, rows, ps)
    _bytes(pool).view((rows * ps,) + pool.shape[2:]).index_put_(
        (index,), _bytes(new.reshape((b * s,) + new.shape[2:])
                         .to(pool.dtype)))


def paged_gather(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Each slot's logical cache view from its pages: the pool (rows,
    page_size, ...) gathered through (B, pages_per_slot) -> (B,
    pages_per_slot * page_size, ...). Positions past a slot's length read
    unwritten or null pages, which the length masks drop."""
    rows = pool.shape[0]
    b, n_pages = table.shape
    g = _bytes(pool)[table.to(pool.device, torch.long) % rows]
    g = g.view(pool.dtype)  # (B, P, ps, ...)
    return g.reshape((b, n_pages * pool.shape[1]) + pool.shape[2:])


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
                rope: Optional[tuple] = None,
                cross_kv: Optional[tuple] = None):
        """Returns y; prefill, decode and chunk modes write ``cache`` in
        place. ``view.positions`` is set by LM.forward,
        which also passes the rope tables it made once for all layers
        (``rope``, see :func:`rope_tables`); without them they are made
        here from the positions and ``rope_theta``.

        ``cross_kv`` (k, v), each (B, S_enc, kv_heads, head_dim), makes
        this cross-attention over them: q from x with no rope and no
        norm on k, nothing written to a cache; train and prefill attend
        to every frame (not causal), decode to all ``S_enc`` with no
        window."""
        if cross_kv is not None:
            return self._cross(x, *cross_kv, view=view, chunk=chunk)
        cfg = self.cfg
        b, s, _ = x.shape
        positions = view.positions
        if positions is None:
            positions = torch.arange(s, device=x.device)
        # tensor-parallel training: the gradient of the input of each
        # split projection is summed over the "model" ranks (tp_copy); KV
        # replicated beside split q heads (MQA) is summed where it enters
        # the rank's heads
        kv_split = tp_enabled("kv_in")
        xq = tp_copy(x, "attn_in")
        xkv = xq if kv_split else x
        q = self.wq(xq).reshape(b, s, cfg.q_heads, cfg.head_dim)
        k = self.wk(xkv).reshape(b, s, cfg.kv_heads, cfg.head_dim)
        v = self.wv(xkv).reshape(b, s, cfg.kv_heads, cfg.head_dim)
        if self.q_norm is not None:
            q, k = self.q_norm(q), self.k_norm(k)
        if cfg.rope:
            if rope is None:
                rope = rope_tables(positions, cfg.head_dim, rope_theta)
            q = apply_rope_tables(q, *rope)
            k = apply_rope_tables(k, *rope)
        if not kv_split:
            k, v = tp_copy(k, "attn_in"), tp_copy(v, "attn_in")

        k_view = v_view = None
        if view.mode != "train":
            if cache is None:
                raise ValueError(f"{view.mode} mode needs a cache")
            kv = _write_kv(cache, {"k": k, "v": v}, view, b, s, x.device)
            k_view, v_view = kv["k"], kv["v"]
        chunk_pos = positions if view.mode == "chunk" else None
        if view.offset_mode and cfg.mask is not None:
            out = bs_attention_decode(
                q, k_view, v_view, spec=cfg.mask,
                length=view.cache_len + s, q_positions=chunk_pos)
        elif view.offset_mode:
            out = decode_attention(
                q, k_view, v_view, length=view.cache_len + s,
                window=cfg.window, q_positions=chunk_pos)
        elif cfg.mask is not None:
            out = bs_attention(q, k, v, spec=cfg.mask)
        else:
            out = chunked_attention(q, k, v, causal=cfg.causal,
                                    window=cfg.window, chunk=chunk)
        return tp_reduce(self.wo(out.reshape(b, s, -1)), "attn_out")

    def _cross(self, x, k, v, *, view: CacheView, chunk: int):
        cfg = self.cfg
        b, s, _ = x.shape
        # tensor-parallel training, as forward: the q input's gradient
        # summed over "model"; split K/V heads come from the encoder's
        # output, summed once where it leaves the encoder ("enc_out"),
        # replicated K/V (MQA) where they enter the rank's heads
        q = self.wq(tp_copy(x, "attn_in")).reshape(b, s, cfg.q_heads,
                                                   cfg.head_dim)
        if self.q_norm is not None:
            q = self.q_norm(q)
        if not tp_enabled("kv_in"):
            k, v = tp_copy(k, "attn_in"), tp_copy(v, "attn_in")
        if view.mode == "decode":
            length = torch.full((), k.shape[1], dtype=torch.long,
                                device=x.device)
            out = decode_attention(q, k, v, length=length, window=None)
        else:
            out = chunked_attention(q, k, v, causal=False, window=None,
                                    chunk=chunk)
        return tp_reduce(self.wo(out.reshape(b, s, -1)), "attn_out")


def gqa_empty_cache(batch: int, max_seq: int, cfg: AttnConfig, dtype,
                    device) -> dict:
    shape = (batch, max_seq, cfg.kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cross_empty_cache(batch: int, enc_seq: int, cfg: AttnConfig, dtype,
                      device) -> dict:
    """A cross-attention block's static K/V of the encoder's frames,
    ``{"cross_k", "cross_v"}`` (B, enc_seq, kv_heads, head_dim): written
    at prefill, read at decode."""
    kv = gqa_empty_cache(batch, enc_seq, cfg, dtype, device)
    return {"cross_k": kv["k"], "cross_v": kv["v"]}


def _write_kv(cache: dict, new: dict, view: CacheView, b: int, s: int,
              device) -> dict:
    """Write the s-token rows ``new`` ({leaf: (B, s, ...)}) into the
    cache in place, through the view's addressing (slot or paged), and
    return each leaf's (B, S, ...) view for decode and chunk attention
    (the fresh rows themselves in prefill)."""
    if view.paged:
        if not view.offset_mode:
            raise ValueError("paged addressing is for decode and chunk, "
                             f"not {view.mode}")
        for name, rows in new.items():
            paged_write(cache[name], rows, view.cache_len, view.block_table,
                        view.write_mask, view.write_index)
        return {name: paged_gather(cache[name], view.block_table)
                for name in new}
    index = (view.write_index if view.write_index is not None
             else cache_write_index(view, b, s, device))
    for name, rows in new.items():
        _write_cache(cache[name], rows, index)
    return {name: cache[name] for name in new}


class MLA(nn.Module):
    """DeepSeek-V2 multi-head latent attention (port of ``mla_init`` /
    ``mla_apply``).

    Projections (N:M-eligible, target "attn_proj"): ``wq`` (or ``wq_a``,
    its norm ``q_a_norm`` and ``wq_b`` when ``q_lora_rank`` is set) to
    the heads' [q_nope | q_rope]; ``wkv_a`` to the latent ckv, normed by
    ``kv_a_norm``; ``wk_rope`` to the rope key shared by the heads;
    ``wo``. The latent's per-head up-projections ``w_uk`` (H, lora,
    nope) and ``w_uv`` (H, lora, v) are dense. The softmax scale is
    (nope + rope)^-0.5.
    """

    def __init__(self, cfg: AttnConfig, wkv_a, kv_a_norm, wk_rope, w_uk,
                 w_uv, wo, *, wq=None, wq_a=None, q_a_norm=None,
                 wq_b=None):
        super().__init__()
        self.cfg = cfg
        if (wq is None) == (wq_a is None):
            raise ValueError("MLA takes wq, or wq_a / q_a_norm / wq_b")
        self.wq = Linear(wq) if wq is not None else None
        self.wq_a = Linear(wq_a) if wq_a is not None else None
        self.q_a_norm = RMSNorm(q_a_norm) if q_a_norm is not None else None
        self.wq_b = Linear(wq_b) if wq_b is not None else None
        self.wkv_a, self.wk_rope, self.wo = (Linear(w) for w in
                                             (wkv_a, wk_rope, wo))
        self.kv_a_norm = RMSNorm(kv_a_norm)
        self.w_uk, self.w_uv = _param(w_uk), _param(w_uv)

    @classmethod
    def init(cls, gen: torch.Generator, d_model: int, cfg: AttnConfig, *,
             sp: Optional[SparsityConfig], dtype,
             quantize: Optional[str] = None) -> "MLA":
        def lin(i, o):
            return linear_init(gen, i, o, sp=sp, target="attn_proj",
                               dtype=dtype, quantize=quantize)

        def ones(n):
            return torch.ones(n, dtype=dtype, device=gen.device)

        def up(d):  # a dense per-head up-projection from the latent
            w = torch.randn(cfg.q_heads, cfg.kv_lora_rank, d, generator=gen,
                            device=gen.device)
            return (w * cfg.kv_lora_rank ** -0.5).to(dtype)

        h, qk = cfg.q_heads, cfg.nope_head_dim + cfg.rope_head_dim
        q = {}
        if cfg.q_lora_rank:
            q = dict(wq_a=lin(d_model, cfg.q_lora_rank),
                     q_a_norm=ones(cfg.q_lora_rank),
                     wq_b=lin(cfg.q_lora_rank, h * qk))
        else:
            q = dict(wq=lin(d_model, h * qk))
        return cls(cfg, lin(d_model, cfg.kv_lora_rank),
                   ones(cfg.kv_lora_rank), lin(d_model, cfg.rope_head_dim),
                   up(cfg.nope_head_dim), up(cfg.v_head_dim),
                   lin(h * cfg.v_head_dim, d_model), **q)

    def _q(self, x: torch.Tensor, rope: tuple):
        cfg = self.cfg
        b, s, _ = x.shape
        if self.wq is not None:
            q = self.wq(tp_copy(x, "attn_in"))
        else:
            q = self.wq_b(tp_copy(self.q_a_norm(self.wq_a(x)), "attn_in"))
        q = q.reshape(b, s, cfg.q_heads, cfg.nope_head_dim + cfg.rope_head_dim)
        return (q[..., :cfg.nope_head_dim],
                apply_rope_tables(q[..., cfg.nope_head_dim:], *rope))

    def forward(self, x: torch.Tensor, *, view: CacheView,
                cache: Optional[dict], rope_theta: float, chunk: int,
                rope: Optional[tuple] = None):
        """Returns y; prefill, decode and chunk modes write ``cache`` in
        place (as :meth:`GQA.forward`). ``rope`` holds the tables of
        ``rope_head_dim``."""
        cfg = self.cfg
        b, s, _ = x.shape
        h = cfg.q_heads
        positions = view.positions
        if positions is None:
            positions = torch.arange(s, device=x.device)
        if rope is None:
            rope = rope_tables(positions, cfg.rope_head_dim, rope_theta)
        q_nope, q_rope = self._q(x, rope)
        # the latent and the rope key are replicated and enter the rank's
        # heads here (tensor-parallel training: tp_copy)
        ckv = tp_copy(self.kv_a_norm(self.wkv_a(x)), "attn_in")
        kr = tp_copy(apply_rope_tables(self.wk_rope(x)[:, :, None, :],
                                       *rope)[:, :, 0], "attn_in")
        dt = x.dtype
        w_uk, w_uv = self.w_uk.to(dt), self.w_uv.to(dt)
        scale = (cfg.nope_head_dim + cfg.rope_head_dim) ** -0.5

        if view.mode != "train" and cache is None:
            raise ValueError(f"{view.mode} mode needs a cache")
        if view.offset_mode:
            cv = _write_kv(cache, {"ckv": ckv, "kr": kr}, view, b, s,
                           x.device)
            ckv_v, kr_v = cv["ckv"].to(dt), cv["kr"].to(dt)
            # absorbed attention over the latent cache:
            #   logits = (q_nope W_uk) . ckv + q_rope . kr
            # operands in the compute dtype, sums in f32 (acc_einsum)
            q_abs = acc_einsum("bqhd,hcd->bqhc", q_nope, w_uk).to(dt)
            logits = acc_einsum("bqhc,bsc->bqhs", q_abs, ckv_v)
            logits = logits + acc_einsum("bqhr,bsr->bqhs", q_rope, kr_v)
            logits = logits * scale
            big_s = ckv_v.shape[1]
            if cfg.mask is not None or view.mode == "chunk":
                # a query at position p sees cache slot j <= p (and, with a
                # mask, what the spec's token predicate lets it see)
                qp = positions if positions.dim() == 2 else positions[None]
                kp = torch.arange(big_s, device=x.device)
                valid = kp[None, None, :] <= qp[..., None]  # (B|1, sq, S)
                if cfg.mask is not None:
                    valid = valid & torch_token_mask(
                        cfg.mask, qp[..., None], kp[None, None, :],
                        max_q=big_s, max_k=big_s)
                logits = torch.where(valid[:, :, None, :], logits, NEG_INF)
            else:
                logits = _apply_len_mask(
                    logits, _len_mask(view.cache_len + s, big_s))
            p = _softmax(logits)
            o_abs = acc_einsum("bqhs,bsc->bqhc", p.to(dt), ckv_v).to(dt)
            out = acc_einsum("bqhc,hcv->bqhv", o_abs, w_uv).to(dt)
        else:
            # train / prefill: per-head K = [k_nope | kr] and V from the
            # latent, then the full-sequence paths
            k_nope = torch.einsum("bsc,hcd->bshd", ckv, w_uk)
            v = torch.einsum("bsc,hcv->bshv", ckv, w_uv)
            k = torch.cat([k_nope, kr[:, :, None, :].expand(
                b, s, h, cfg.rope_head_dim)], -1)
            q = torch.cat([q_nope, q_rope], -1)
            if cfg.mask is not None:
                out = bs_attention(q, k, v, spec=cfg.mask, scale=scale)
            else:
                out = chunked_attention(q, k, v, causal=True,
                                        window=cfg.window, chunk=chunk,
                                        scale=scale)
            if view.mode == "prefill":
                _write_kv(cache, {"ckv": ckv, "kr": kr}, view, b, s,
                          x.device)
        return tp_reduce(self.wo(out.reshape(b, s, h * cfg.v_head_dim)),
                         "attn_out")


def mla_empty_cache(batch: int, max_seq: int, cfg: AttnConfig, dtype,
                    device) -> dict:
    return {"ckv": torch.zeros((batch, max_seq, cfg.kv_lora_rank),
                               dtype=dtype, device=device),
            "kr": torch.zeros((batch, max_seq, cfg.rope_head_dim),
                              dtype=dtype, device=device)}


def attn_empty_cache(batch: int, max_seq: int, cfg: AttnConfig, dtype,
                     device) -> dict:
    """An empty cache of ``cfg.kind``: ``{"k", "v"}`` or ``{"ckv",
    "kr"}``."""
    make = mla_empty_cache if cfg.kind == "mla" else gqa_empty_cache
    return make(batch, max_seq, cfg, dtype, device)
