"""Mamba-1 selective state-space mixer (port of ``repro.models.mamba``:
jamba's SSM layers).

Train and prefill run the causal depthwise conv over the sequence and
the selective scan as a loop over time, the state (B, d_inner, d_state)
in f32; decode is one conv tap and one state update against the cache.
The JAX package scans with ``lax.scan`` outside any Pallas kernel, so
the scan here is plain PyTorch, op for op as JAX computes it (a fused
scan kernel is later performance work). ``w_in``, ``w_x`` and ``w_out``
are N:M-eligible (target "attn_proj") and go through the compressed-GEMM
kernels; ``w_dt`` is dense.

The cache ``{"conv": (B, d_conv - 1, d_inner), "ssm": (B, d_inner,
d_state)}`` is f32 whatever the model dtype. Prefill starts the scan
from the cache's state (as JAX does) and writes the conv history (the
last ``d_conv - 1`` inputs, zeros before the first) and the final state;
decode reads and writes both. Every write keeps the slots outside the
view's write mask as they were. Chunked and paged views need an
attention mixer's offset writes and are refused.

Tensor-parallel training (the training plan's ``shard_ssm``,
``parallel.sharding.train_tp_plan``): a rank holds a slice of
``d_inner``: ``w_in``'s columns of its slice of the x half and of the z
half side by side, ``w_dt``'s out columns,
``w_x``'s and ``w_out``'s rows, and its entries of ``conv_w``,
``conv_b``, ``dt_bias``, ``a_log`` and ``d_skip``; the conv and the scan
then run per channel on that slice. ``w_x``'s output is a partial sum,
and dt, B and C mix every channel while each rank's channels use them:
it is summed over "model" forward and backward (tag "ssm_x", a
``tp_reduce`` then a ``tp_copy``). ``w_out``'s output is summed
("ssm_out") and ``w_in``'s input gradient too ("ssm_in").
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import MambaConfig, SparsityConfig
from repro_torch.core.scan import scan_outputs, scan_steps
from repro_torch.models.cache import (
    CacheView,
    refuse_offset_views,
    write_state,
)
from repro_torch.models.common import Linear, _param, linear_init
from repro_torch.parallel.hints import tp_copy, tp_reduce


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as ``jax.nn.softplus`` computes it (logaddexp(x, 0),
    no threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


class Mamba(nn.Module):
    def __init__(self, cfg: MambaConfig, w_in, conv_w, conv_b, w_x, w_dt,
                 dt_bias, a_log, d_skip, w_out):
        super().__init__()
        self.cfg = cfg
        self.w_in, self.w_x, self.w_dt, self.w_out = (
            Linear(w) for w in (w_in, w_x, w_dt, w_out))
        self.conv_w, self.conv_b = _param(conv_w), _param(conv_b)
        self.dt_bias, self.a_log = _param(dt_bias), _param(a_log)
        self.d_skip = _param(d_skip)

    @classmethod
    def init(cls, gen: torch.Generator, d_model: int, cfg: MambaConfig, *,
             sp: Optional[SparsityConfig], dtype,
             quantize: Optional[str] = None) -> "Mamba":
        d_in = cfg.expand * d_model
        dev = gen.device

        def lin(i, o):
            return linear_init(gen, i, o, sp=sp, target="attn_proj",
                               dtype=dtype, quantize=quantize)

        w_in = lin(d_model, 2 * d_in)
        conv_w = torch.randn(cfg.d_conv, d_in, generator=gen, device=dev)
        w_x = lin(d_in, cfg.dt_rank + 2 * cfg.d_state)
        w_dt = linear_init(gen, cfg.dt_rank, d_in, dtype=dtype)
        a = torch.arange(1, cfg.d_state + 1, dtype=torch.float32,
                         device=dev).expand(d_in, -1)
        return cls(cfg, w_in, (conv_w * cfg.d_conv ** -0.5).to(dtype),
                   torch.zeros(d_in, dtype=dtype, device=dev), w_x, w_dt,
                   torch.zeros(d_in, dtype=dtype, device=dev),
                   torch.log(a).to(dtype), torch.ones(d_in, dtype=dtype,
                                                      device=dev),
                   lin(d_in, d_model))

    def _ssm_params(self, xc: torch.Tensor):
        """xc (..., d_inner) after the conv -> (dt, b, c)."""
        cfg = self.cfg
        h = tp_copy(tp_reduce(self.w_x(xc), "ssm_x"), "ssm_x")
        dt_raw, b, c = h.split([cfg.dt_rank, cfg.d_state, cfg.d_state],
                               dim=-1)
        dt = softplus(self.w_dt(dt_raw) + self.dt_bias.to(dt_raw.dtype))
        return dt, b, c

    def forward(self, x: torch.Tensor, *, view: CacheView,
                cache: Optional[dict], **_) -> torch.Tensor:
        """x (B, S, D) -> (B, S, D); prefill and decode write ``cache``
        in place. Attention's keywords (rope, chunk) are ignored."""
        refuse_offset_views(view, "Mamba")
        cfg = self.cfg
        b, s, _ = x.shape
        d_in = self.d_skip.shape[0]  # this rank's channels
        xin, z = self.w_in(tp_copy(x, "ssm_in")).chunk(2, dim=-1)
        conv_w = self.conv_w.to(xin.dtype)
        conv_b = self.conv_b.to(xin.dtype)
        a = -torch.exp(self.a_log.float())                 # (d_in, n)
        d_skip = self.d_skip.float()
        if view.mode != "train" and cache is None:
            raise ValueError(f"{view.mode} mode needs a cache")

        if view.mode == "decode":
            hist = torch.cat([cache["conv"].to(xin.dtype), xin], dim=1)
            xc = F.silu(torch.einsum("bkd,kd->bd", hist, conv_w) + conv_b)
            dt, bb, c = self._ssm_params(xc)
            dtf = dt.float()
            da = torch.exp(dtf[:, :, None] * a[None])     # (B, d_in, n)
            dbx = (dtf * xc.float())[:, :, None] * bb.float()[:, None, :]
            with torch.profiler.record_function("mamba.scan"):
                ssm = cache["ssm"] * da + dbx
                y = torch.einsum("bdn,bn->bd", ssm, c.float())
            y = y + d_skip * xc.float()
            y = (y.to(x.dtype) * F.silu(z[:, 0])).reshape(b, 1, d_in)
            write_state(cache["conv"], hist[:, 1:], view.write_mask)
            write_state(cache["ssm"], ssm, view.write_mask)
            return tp_reduce(self.w_out(y), "ssm_out")

        # causal depthwise conv over time: the sum from the first tap, as
        # JAX's Python sum adds them
        pad = torch.zeros((b, cfg.d_conv - 1, d_in), dtype=xin.dtype,
                          device=x.device)
        xin_p = torch.cat([pad, xin], dim=1)
        xc = sum(xin_p[:, i:i + s] * conv_w[i] for i in range(cfg.d_conv))
        xc = F.silu(xc + conv_b)
        dt, bb, c = self._ssm_params(xc)
        dtf = dt.float()
        da = torch.exp(dtf[..., None] * a[None, None])    # (B, S, d_in, n)
        dbx = (dtf * xc.float())[..., None] * bb.float()[:, :, None, :]
        cf = c.float()
        h = (cache["ssm"] if view.mode == "prefill"
             else torch.zeros((b, d_in, cfg.d_state), device=x.device))
        ys = []
        with torch.profiler.record_function("mamba.scan"):
            for t in scan_steps(s, x):
                h = h * da[:, t] + dbx[:, t]
                ys.append(torch.einsum("bdn,bn->bd", h, cf[:, t]))
        y = torch.stack(scan_outputs(ys, s), dim=1) + d_skip * xc.float()
        y = y.to(x.dtype) * F.silu(z)
        if view.mode == "prefill":
            hist = torch.cat([pad.float(), xin.float()], dim=1)
            write_state(cache["conv"], hist[:, hist.shape[1]
                                             - (cfg.d_conv - 1):],
                        view.write_mask)
            write_state(cache["ssm"], h, view.write_mask)
        return tp_reduce(self.w_out(y), "ssm_out")


def mamba_empty_cache(batch: int, d_model: int, cfg: MambaConfig,
                      device) -> dict:
    """The f32 conv history and state of ``batch`` slots, zeroed."""
    d_in = cfg.expand * d_model
    return {"conv": torch.zeros((batch, cfg.d_conv - 1, d_in),
                                device=device),
            "ssm": torch.zeros((batch, d_in, cfg.d_state), device=device)}
