"""Feed-forward blocks (port of ``repro.models.ffn``): swiglu, gelu and
relu_sq, with the activation passed as the epilogue of its projection.
Decode-shaped compressed GEMMs fuse it into the kernel (one launch);
every other path applies the same f32 composition after the GEMM.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import FFNConfig, SparsityConfig
from repro_torch.kernels.epilogue import Epilogue
from repro_torch.models.common import Linear, linear_init


class FFN(nn.Module):
    def __init__(self, cfg: FFNConfig, w_up, w_down, w_gate=None):
        super().__init__()
        self.cfg = cfg
        self.w_up, self.w_down = Linear(w_up), Linear(w_down)
        self.w_gate = Linear(w_gate) if w_gate is not None else None

    @classmethod
    def init(cls, gen: torch.Generator, d_model: int, cfg: FFNConfig, *,
             sp: Optional[SparsityConfig], dtype,
             target: str = "ffn", quantize: Optional[str] = None) -> "FFN":
        def lin(i, o):
            return linear_init(gen, i, o, sp=sp, target=target, dtype=dtype,
                               quantize=quantize)

        up, down = lin(d_model, cfg.d_ff), lin(cfg.d_ff, d_model)
        gate = lin(d_model, cfg.d_ff) if cfg.act == "swiglu" else None
        return cls(cfg, up, down, gate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act = self.cfg.act
        if act == "swiglu":
            up = self.w_up(x)
            gate = self.w_gate(x, epilogue=Epilogue(activation="silu"))
            h = gate * up
        elif act in ("gelu", "relu_sq"):
            h = self.w_up(x, epilogue=Epilogue(activation=act))
        else:
            raise ValueError(act)
        return self.w_down(h)
