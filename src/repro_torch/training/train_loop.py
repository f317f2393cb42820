"""Training step: loss -> grads -> AdamW, with microbatch gradient
accumulation, remat, and optional int8 error-feedback gradient
compression (port of ``repro.training.train_loop``).

``make_train_step(lm, tcfg)`` returns ``train_step(lm, opt_state, batch
[, compress_err])`` -> ``(lm, opt_state[, err], metrics)``: the JAX
signature, with the model's parameters and the moments updated in place
(the same objects come back). The step runs whatever model of ``lm``'s
config it is given (a restarted run makes a new one). ``batch`` holds
``tokens`` and ``labels`` as numpy arrays or tensors. Metrics are f32 scalar tensors on the
model's device (``loss``, ``nll``, ``aux``, ``lr``, ``grad_norm``): a
step reads nothing back to the host.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.models.transformer import LM
from repro_torch.optim.optimizer import AdamWConfig, adamw_init, adamw_update


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: AdamWConfig = AdamWConfig()
    microbatches: int = 1  # gradient accumulation steps per train step
    remat: str = "dots"  # none | dots | full
    grad_compression: bool = False  # int8 error-feedback reduction


def trainable(lm: torch.nn.Module) -> dict:
    """The model's float parameters by name, with ``requires_grad`` on:
    what the optimizer trains (idx and int8 tensors are buffers)."""
    params = {n: p for n, p in lm.named_parameters() if p.is_floating_point()}
    for p in params.values():
        p.requires_grad_(True)
    return params


def _int8_compress(g: torch.Tensor):
    """Error-feedback int8 quantization of a gradient: (q, scale), the
    dequantized value q * scale. The caller keeps the residual."""
    amax = torch.max(torch.abs(g)) + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _compress_tree(grads: dict, err: dict):
    """Quantize grads (+ error feedback): (dequantized grads, new err)."""
    deq, new_err = {}, {}
    for name, g in grads.items():
        if not g.is_floating_point():
            deq[name], new_err[name] = g, err[name]
            continue
        gf = g.float() + err[name]
        q, s = _int8_compress(gf)
        deq[name] = q.float() * s
        new_err[name] = gf - deq[name]
    return deq, new_err


def init_compress_state(params: dict) -> dict:
    """Zero f32 error feedback for every float parameter."""
    return {n: torch.zeros_like(p, dtype=torch.float32)
            for n, p in params.items() if p.is_floating_point()}


def to_device(batch: dict, device) -> dict:
    """A batch of numpy arrays or tensors as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def param_grads(loss: torch.Tensor, params: dict) -> dict:
    """The backward: d loss / d each of ``params``, zeros for a parameter
    the loss does not reach."""
    names = list(params)
    gs = torch.autograd.grad(loss, [params[n] for n in names],
                             allow_unused=True)
    return {n: (g if g is not None else torch.zeros_like(params[n]))
            for n, g in zip(names, gs)}


def grads_of(lm: LM, params: dict, batch: dict, remat: str = "none"):
    """(loss, its parts, grads) of one microbatch: the forward with the
    loss, then ``param_grads``."""
    loss, parts = lm.loss(batch, remat=remat)
    grads = param_grads(loss, params)
    return loss.detach(), {k: v.detach() for k, v in parts.items()}, grads


def make_train_step(lm: LM, tcfg: TrainConfig):
    """Builds ``train_step(lm, opt_state, batch [, compress_err])``."""
    mb = tcfg.microbatches

    def accumulate(lm_, params, batch):
        if mb == 1:
            return grads_of(lm_, params, batch, tcfg.remat)
        rows = next(iter(batch.values())).shape[0]
        if rows % mb:
            raise ValueError(f"batch of {rows} rows does not split into "
                             f"{mb} microbatches")
        acc = {n: torch.zeros_like(p, dtype=torch.float32)
               for n, p in params.items()}
        loss_sum = 0.0
        for i in range(mb):
            part = {k: v[i * rows // mb:(i + 1) * rows // mb]
                    for k, v in batch.items()}
            loss, parts, grads = grads_of(lm_, params, part, tcfg.remat)
            for n, g in grads.items():
                acc[n] += g.float()
            loss_sum = loss_sum + loss
        return loss_sum / mb, parts, {n: a / mb for n, a in acc.items()}

    def train_step(lm_, opt_state, batch, compress_err: Optional[dict] = None):
        if lm_.cfg != lm.cfg:
            raise ValueError("train_step runs models of the config it was "
                             "built for")
        params = trainable(lm_)
        batch = to_device(batch, lm_.device)
        loss, parts, grads = accumulate(lm_, params, batch)
        new_err = compress_err
        if tcfg.grad_compression:
            if compress_err is None:
                raise ValueError("grad_compression needs the error state")
            grads, new_err = _compress_tree(grads, compress_err)
        _, opt_state, om = adamw_update(tcfg.opt, params, grads, opt_state)
        metrics = {"loss": loss, **parts, **om}
        if tcfg.grad_compression:
            return lm_, opt_state, new_err, metrics
        return lm_, opt_state, metrics

    return train_step


def init_train_state(lm: LM, tcfg: TrainConfig):
    """(lm, opt_state[, compress_err]) for a model made by the caller
    (``LM.init`` with ``dtype=torch.float32`` is the JAX package's f32
    params; its weights, not a key, are the initial state here)."""
    params = trainable(lm)
    opt_state = adamw_init(params)
    if tcfg.grad_compression:
        return lm, opt_state, init_compress_state(params)
    return lm, opt_state
