"""RWKV-6 (Finch) mixer: time-mix with data-dependent decay, and the
channel-mix (port of ``repro.models.rwkv``).

The module holds both sublayers, as the JAX block does: the time-mix
plays attention's role, the channel-mix the FFN's (with its own norm
``cm_norm`` and residual, run by the block after the time-mix), and both
need the token-shift state. Time-mix: the previous token's activation
(``_token_shift``), the 5-way data-dependent lerp with its LoRA
(``_ddlerp``) giving r, k, v, w and g inputs, the decay exp(-exp(.))
from a LoRA in f32, the WKV recurrence per head with the bonus ``u`` on
the current token, a per-head RMSNorm ``wkv_norm``, silu(g) gating and
``w_o``. Channel-mix: relu(k)^2 through ``w_cm_v``, gated by
sigmoid(``w_cm_r``). The recurrence is a loop over time in f32, plain
PyTorch as the JAX package's ``lax.scan`` is plain XLA.

``w_r/k/v/g/o`` are N:M-eligible on the "attn_proj" target, ``w_cm_k/v/r``
on "ffn"; the LoRAs, mixes, decay and bonus are dense vectors and
matrices. The cache ``{"wkv": (B, H, dk, dv) f32, "tm_last": (B, D),
"cm_last": (B, D)}`` (the last two in the model dtype) is O(1) in the
sequence length. Every mode with a cache starts from it (JAX's
semantics); prefill and decode write it, keeping the slots outside the
view's write mask. Chunked and paged views are refused.

Tensor-parallel training (``parallel.sharding.train_tp_plan``): under
``shard_attn`` a rank holds whole heads of the time mix: the out columns
of ``w_r`` / ``w_k`` / ``w_v`` / ``w_g``, ``decay_base`` and
``decay_lora_b``, its rows of ``bonus`` and of ``w_o`` (row-parallel,
summed, tag "attn_out"); the mixes, their LoRA and ``decay_lora_a`` act
on the whole x and stay whole, so the inputs of the split projections
(and the decay LoRA's hidden) take a ``tp_copy`` ("attn_in"); the per
head ``wkv_norm`` is whole and its gradient a partial sum. Under
``shard_ffn`` the channel mix's ``w_cm_k`` is column-parallel and
``w_cm_v`` row-parallel ("ffn_in" on ``xk`` only, "ffn_down"); ``w_cm_r``
stays whole, its output gating the summed ``vv``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import RWKVConfig, SparsityConfig
from repro_torch.core.scan import scan_outputs, scan_steps
from repro_torch.models.cache import (
    CacheView,
    refuse_offset_views,
    write_state,
)
from repro_torch.models.common import Linear, RMSNorm, _param, linear_init
from repro_torch.parallel.hints import tp_copy, tp_reduce


def _token_shift(x: torch.Tensor, last: Optional[torch.Tensor]):
    """The previous token's activation: ``last`` (zeros without one) at
    position 0."""
    first = (last[:, None, :].to(x.dtype) if last is not None
             else torch.zeros_like(x[:, :1]))
    return torch.cat([first, x[:, :-1]], dim=1)


class RWKV(nn.Module):
    def __init__(self, cfg: RWKVConfig, *, mu, mix_lora_a, mix_lora_b, w_r,
                 w_k, w_v, w_g, w_o, decay_base, decay_lora_a, decay_lora_b,
                 bonus, wkv_norm, cm_mu, cm_norm, w_cm_k, w_cm_v, w_cm_r,
                 eps: float = 1e-5):
        super().__init__()
        self.cfg = cfg
        self.mu = _param(mu)
        self.mix_lora_a, self.mix_lora_b = _param(mix_lora_a), \
            _param(mix_lora_b)
        self.w_r, self.w_k, self.w_v, self.w_g, self.w_o = (
            Linear(w) for w in (w_r, w_k, w_v, w_g, w_o))
        self.decay_base = _param(decay_base)
        self.decay_lora_a, self.decay_lora_b = _param(decay_lora_a), \
            _param(decay_lora_b)
        self.bonus = _param(bonus)
        self.wkv_norm = RMSNorm(wkv_norm)  # JAX's default eps, 1e-5
        self.cm_mu = _param(cm_mu)
        self.cm_norm = RMSNorm(cm_norm, eps)
        self.w_cm_k, self.w_cm_v, self.w_cm_r = (
            Linear(w) for w in (w_cm_k, w_cm_v, w_cm_r))

    @classmethod
    def init(cls, gen: torch.Generator, d_model: int, cfg: RWKVConfig, *,
             d_ff: int, sp: Optional[SparsityConfig], dtype,
             quantize: Optional[str] = None, eps: float = 1e-5) -> "RWKV":
        h = d_model // cfg.head_dim
        dev = gen.device

        def lin(i, o, target):
            return linear_init(gen, i, o, sp=sp, target=target, dtype=dtype,
                               quantize=quantize)

        def rand(*shape):
            return torch.rand(*shape, generator=gen, device=dev)

        def randn(*shape, scale):
            return (torch.randn(*shape, generator=gen, device=dev)
                    * scale).to(dtype)

        def zeros(*shape):
            return torch.zeros(*shape, dtype=dtype, device=dev)

        d = d_model
        return cls(
            cfg,
            bonus=(rand(h, cfg.head_dim) * 2 - 1).to(dtype),
            mu=rand(5, d).to(dtype),
            mix_lora_a=randn(d, 5 * cfg.mix_lora, scale=d ** -0.5),
            mix_lora_b=zeros(5, cfg.mix_lora, d),
            w_r=lin(d, d, "attn_proj"), w_k=lin(d, d, "attn_proj"),
            w_v=lin(d, d, "attn_proj"), w_g=lin(d, d, "attn_proj"),
            w_o=lin(d, d, "attn_proj"),
            decay_base=torch.full((d,), -5.0, dtype=dtype, device=dev),
            decay_lora_a=randn(d, cfg.decay_lora, scale=d ** -0.5),
            decay_lora_b=zeros(cfg.decay_lora, d),
            wkv_norm=torch.ones(cfg.head_dim, dtype=dtype, device=dev),
            cm_mu=rand(2, d).to(dtype),
            cm_norm=torch.ones(d, dtype=dtype, device=dev),
            w_cm_k=lin(d, d_ff, "ffn"), w_cm_v=lin(d_ff, d, "ffn"),
            w_cm_r=lin(d, d, "ffn"), eps=eps)

    def _ddlerp(self, x: torch.Tensor, prev: torch.Tensor):
        """The 5 data-dependent mixes of x and the previous token (r, k,
        v, w, g inputs)."""
        xx = prev - x
        mu = self.mu.to(x.dtype)                           # (5, D)
        base = x[:, :, None, :] + xx[:, :, None, :] * mu[None, None]
        lora = torch.tanh(torch.einsum(
            "bsd,dk->bsk", x + xx * mu[0], self.mix_lora_a.to(x.dtype)))
        lora = lora.reshape(*lora.shape[:-1], 5, -1)
        adj = torch.einsum("bsik,ikd->bsid", lora,
                           self.mix_lora_b.to(x.dtype))
        mixed = base + xx[:, :, None, :] * adj
        return [mixed[:, :, i] for i in range(5)]

    def forward(self, x: torch.Tensor, *, view: CacheView,
                cache: Optional[dict], **_) -> torch.Tensor:
        """The time-mix: x (B, S, D), already normed, -> (B, S, D);
        prefill and decode write ``wkv`` and ``tm_last`` in place.
        Attention's keywords (rope, chunk) are ignored."""
        refuse_offset_views(view, "RWKV")
        cfg = self.cfg
        b, s, _ = x.shape
        h, dk = self.bonus.shape[0], cfg.head_dim  # this rank's heads
        if view.mode != "train" and cache is None:
            raise ValueError(f"{view.mode} mode needs a cache")
        state = cache["wkv"] if cache is not None else None
        prev = _token_shift(x, cache["tm_last"] if cache is not None
                            else None)
        xr, xk, xv, xw, xg = self._ddlerp(x, prev)
        # the inputs of the rank's heads (tensor-parallel training)
        xr, xk, xv, xg = (tp_copy(t, "attn_in") for t in (xr, xk, xv, xg))
        r = self.w_r(xr).reshape(b, s, h, dk)
        k = self.w_k(xk).reshape(b, s, h, dk)
        v = self.w_v(xv).reshape(b, s, h, dk)
        g = F.silu(self.w_g(xg))
        dlora = tp_copy(torch.tanh(torch.einsum(
            "bsd,dk->bsk", xw, self.decay_lora_a.to(x.dtype))), "attn_in")
        wraw = self.decay_base.float() + torch.einsum(
            "bsk,kd->bsd", dlora, self.decay_lora_b.to(x.dtype)).float()
        w = torch.exp(-torch.exp(wraw)).reshape(b, s, h, dk)  # in (0, 1)
        u = self.bonus.float()[None, :, :, None]          # (1, h, dk, 1)
        rf, kf, vf = r.float(), k.float(), v.float()
        st = (state if state is not None
              else torch.zeros((b, h, dk, dk), device=x.device))
        ys = []
        with torch.profiler.record_function("rwkv.wkv"):
            for t in scan_steps(s, x):
                kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]
                ys.append(torch.einsum("bhk,bhkv->bhv", rf[:, t],
                                       st + u * kv))
                st = w[:, t, :, :, None] * st + kv
        y = self.wkv_norm(torch.stack(scan_outputs(ys, s), dim=1).to(
            x.dtype))
        out = tp_reduce(self.w_o(y.reshape(b, s, h * dk) * g), "attn_out")
        if view.mode in ("prefill", "decode"):
            write_state(cache["wkv"], st, view.write_mask)
            write_state(cache["tm_last"], x[:, -1], view.write_mask)
        return out

    def channel_mix(self, x: torch.Tensor, *, view: CacheView,
                    cache: Optional[dict]) -> torch.Tensor:
        """The channel-mix of the residual stream x (normed here by
        ``cm_norm``); prefill and decode write ``cm_last``."""
        hm = self.cm_norm(x)
        prev = _token_shift(hm, cache["cm_last"] if cache is not None
                            else None)
        mu = self.cm_mu.to(hm.dtype)
        xk = hm + (prev - hm) * mu[0]
        xr = hm + (prev - hm) * mu[1]
        kk = self.w_cm_k(tp_copy(xk, "ffn_in"))
        vv = tp_reduce(self.w_cm_v(torch.square(F.relu(kk))), "ffn_down")
        out = torch.sigmoid(self.w_cm_r(xr)) * vv
        if view.mode in ("prefill", "decode"):
            write_state(cache["cm_last"], hm[:, -1], view.write_mask)
        return out


def rwkv_empty_cache(batch: int, d_model: int, cfg: RWKVConfig, dtype,
                     device) -> dict:
    """The f32 WKV state and the two token shifts' last tokens (in
    ``dtype``) of ``batch`` slots, zeroed."""
    h = d_model // cfg.head_dim
    return {"wkv": torch.zeros((batch, h, cfg.head_dim, cfg.head_dim),
                               device=device),
            "tm_last": torch.zeros((batch, d_model), dtype=dtype,
                                   device=device),
            "cm_last": torch.zeros((batch, d_model), dtype=dtype,
                                   device=device)}
