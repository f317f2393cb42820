"""AdamW with a cosine schedule and global-norm clipping (port of
``repro.optim.optimizer``), written out in plain tensor ops.

``torch.optim.AdamW`` is not a counterpart: it applies the decay before
the moment step and takes its rate from a scheduler outside the update.
Here every leaf follows the JAX package's ``upd_leaf`` in f32: the clip
scale first, the moments, the bias corrections, and the decoupled
weight decay inside the same expression as the Adam step, the result
cast back to the parameter's dtype.

What trains is what a model lists in ``named_parameters()``: every
float weight (compressed values, dense and masked weights, norm scales,
the embedding and the head). A compressed weight's ``idx`` and every
tensor of an int8 ``QNMWeight`` are buffers, so they get no moments and
no update: the JAX package's structural exclusion of ``idx`` and of
quantized weights falls out of the module's storage. The state is
``{"step": int32 scalar, "m": {name: tensor}, "v": {name: tensor}}``,
keyed by parameter name, on the parameters' device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def cosine_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """The rate at ``step`` (f32): linear warm-up to ``lr``, then a cosine
    down to ``min_lr_frac * lr`` at ``total_steps``, flat after."""
    step = torch.as_tensor(step).float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(
        cfg.total_steps - cfg.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init(params: Mapping[str, torch.Tensor]) -> dict:
    """Zero f32 moments for every float parameter, and step 0 (the JAX
    package's moments take the parameter's dtype at init and are f32
    from the first update on)."""
    dev = next(iter(params.values())).device if params else None
    trained = {n: p for n, p in params.items() if p.is_floating_point()}
    return {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "m": {n: torch.zeros_like(p, dtype=torch.float32)
              for n, p in trained.items()},
        "v": {n: torch.zeros_like(p, dtype=torch.float32)
              for n, p in trained.items()},
    }


def global_norm(grads: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """L2 norm over the gradients that will be applied: float tensors
    only (an int8 weight has none; it is a buffer)."""
    sq = [torch.sum(torch.square(g.float())) for g in grads.values()
          if g is not None and g.is_floating_point()]
    return torch.sqrt(sum(sq))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Mapping[str, torch.Tensor],
                 grads: Mapping[str, torch.Tensor], state: dict, *,
                 grad_norm: Optional[torch.Tensor] = None):
    """One AdamW step. Updates ``params`` and the moments in place and
    returns (params, state, {"lr", "grad_norm"}); the state's step is a
    new tensor. A parameter without a gradient (or a non-float one)
    keeps its value and its moments. ``grad_norm`` is the clip's global
    norm where the caller holds only slices of the gradient (a sharded
    step); by default ``global_norm(grads)``."""
    step = state["step"] + 1
    lr = cosine_schedule(cfg, step)
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.float()
    bc1 = 1 - torch.pow(b1, stepf)
    bc2 = 1 - torch.pow(b2, stepf)
    for name, p in params.items():
        g = grads.get(name)
        if g is None or not p.is_floating_point():
            continue
        m, v = state["m"][name], state["v"][name]
        n = p.numel()
        if n > CHUNK and all(t.is_contiguous() for t in (p, m, v)):
            # elementwise, so a large tensor goes in pieces: its
            # temporaries stay small (ranks sharing one card)
            g = g.reshape(-1)
            for i in range(0, n, CHUNK):
                sl = slice(i, min(i + CHUNK, n))
                _update(p.view(-1)[sl], g[sl], m.view(-1)[sl],
                        v.view(-1)[sl], cfg, lr, scale, bc1, bc2)
        else:
            _update(p, g, m, v, cfg, lr, scale, bc1, bc2)
    return params, {"step": step, "m": state["m"], "v": state["v"]}, {
        "lr": lr, "grad_norm": gnorm}


CHUNK = 1 << 24  # entries of an update's piece


def _update(p, g, m, v, cfg, lr, scale, bc1, bc2) -> None:
    g = g.float() * scale
    pf = p.float()
    m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
    v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
    mh = m / bc1
    vh = v / bc2
    pf = pf - lr * (mh / (torch.sqrt(vh) + cfg.eps)
                    + cfg.weight_decay * pf)
    p.copy_(pf.to(p.dtype))
