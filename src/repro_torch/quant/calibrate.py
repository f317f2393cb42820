"""Calibration: per-output-channel int8 scales for compressed weights
(port of ``repro.quant.calibrate``).

* :class:`AbsMaxObserver`: scale = max|w| / 127 per channel.
* :class:`PercentileObserver`: scale = percentile(|w|, p) / 127 per
  channel; values beyond the percentile saturate at +-127.

The arithmetic is the JAX package's, step for step in f32:
``max(stat, 1e-12) / 127``, then ``round(vals / scale)`` (half to even,
as ``jnp.round``) clipped to +-127. On f32 values the scales and the
int8 payload are bit-equal to the JAX package's. The percentile is
taken by sorting (``torch.quantile`` refuses inputs over 2**24
elements, and a full-width yi-9b ``w_up`` keeps 22.5 M values) with
``jnp.percentile``'s linear interpolation.

``quantize_tree`` / ``dequantize_tree`` act on the port's modules (every
compressed :class:`repro_torch.models.common.Linear`, in place) and on
plain trees of dicts, lists and tuples (a new tree).
"""
from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from repro_torch.core.nmweight import KernelPolicy, NMWeight
from repro_torch.core.sparsity import NMConfig
from repro_torch.quant.qnmweight import QMAX, QNMWeight

__all__ = [
    "AbsMaxObserver",
    "PercentileObserver",
    "dequantize",
    "dequantize_tree",
    "quantize_nm",
    "quantize_tree",
]

_EPS = 1e-12  # an all-zero channel quantizes with a harmless tiny scale


class AbsMaxObserver:
    """Running per-channel absmax; ``axis`` is the reduced (compressed)
    axis, statistics survive per index of the other (output) axis."""

    def __init__(self):
        self._max: Optional[torch.Tensor] = None

    def observe(self, w: torch.Tensor, axis: int = 0) -> "AbsMaxObserver":
        m = w.float().abs().amax(dim=axis)
        self._max = m if self._max is None else torch.maximum(self._max, m)
        return self

    def scales(self, qmax: int = QMAX) -> torch.Tensor:
        if self._max is None:
            raise ValueError("observer has seen no data; call observe first")
        return torch.clamp(self._max, min=_EPS) / qmax


def _percentile(a: torch.Tensor, pct: float, axis: int) -> torch.Tensor:
    """``jnp.percentile(a, pct, axis)`` (linear interpolation), by sorting
    along ``axis``. The position is taken in f32 as the JAX package's
    compiled percentile takes it: XLA folds ``pct / 100 * (n - 1)`` into
    ``pct * ((n - 1) / 100)``, which rounds differently."""
    a = torch.sort(a, dim=axis).values
    f32 = torch.float32
    n1 = torch.tensor(float(a.shape[axis]), dtype=f32) - 1
    pos = torch.tensor(pct, dtype=f32) * (n1 / torch.tensor(100.0, dtype=f32))
    low, high = torch.floor(pos), torch.ceil(pos)
    w_high = pos - low
    w_low = 1 - w_high
    last = int(a.shape[axis]) - 1
    lo = min(max(int(low), 0), last)
    hi = min(max(int(high), 0), last)
    return (a.select(axis, lo) * w_low.to(a.device)
            + a.select(axis, hi) * w_high.to(a.device))


class PercentileObserver:
    """Per-channel |w| percentile over everything observed so far (the
    observed tensors are kept; calibration is offline)."""

    def __init__(self, pct: float = 99.9):
        if not 0.0 < pct <= 100.0:
            raise ValueError(f"pct must be in (0, 100], got {pct}")
        self.pct = pct
        self._seen: list[torch.Tensor] = []
        self._axis: Optional[int] = None

    def observe(self, w: torch.Tensor,
                axis: int = 0) -> "PercentileObserver":
        if self._axis is not None and axis != self._axis:
            raise ValueError(
                f"observer reduction axis changed: {self._axis} -> {axis}")
        self._axis = axis
        self._seen.append(w.float().abs())
        return self

    def scales(self, qmax: int = QMAX) -> torch.Tensor:
        if not self._seen:
            raise ValueError("observer has seen no data; call observe first")
        stacked = torch.cat(self._seen, dim=self._axis)
        p = _percentile(stacked, self.pct, self._axis)
        return torch.clamp(p, min=_EPS) / qmax


_OBSERVERS = {"absmax": AbsMaxObserver, "percentile": PercentileObserver}

Observer = Union[AbsMaxObserver, PercentileObserver]


def _as_observer(method) -> Observer:
    if isinstance(method, (AbsMaxObserver, PercentileObserver)):
        return method
    if isinstance(method, str):
        cls = _OBSERVERS.get(method)
        if cls is None:
            raise ValueError(
                f"unknown calibration method {method!r}; expected one of "
                f"{sorted(_OBSERVERS)} or an observer instance")
        return cls()
    raise TypeError(
        f"method must be a string or observer, got {type(method).__name__}")


def quantize_nm(
    w: Union[torch.Tensor, NMWeight],
    nm: Optional[NMConfig] = None,
    *,
    method: Union[str, Observer] = "absmax",
    axis: int = 0,
    kernel_policy: Optional[Union[KernelPolicy, str]] = None,
) -> QNMWeight:
    """Quantize a weight to int8 compressed form, per output channel.

    ``w`` is a dense 2D tensor (``nm`` required; pruned to top-|w| N:M
    and compressed first) or an :class:`NMWeight` (``nm`` omitted or
    equal to its own). ``method`` names an observer or passes one that
    already holds statistics. ``kernel_policy`` overrides the policy
    (default: the NMWeight's own, or "auto" for a dense input). The
    statistics are taken over the kept values, on their device.
    """
    if isinstance(w, QNMWeight):
        raise TypeError("weight is already quantized")
    if isinstance(w, NMWeight):
        if nm is not None and nm != w.nm:
            raise ValueError(
                f"nm {nm.tag} conflicts with the weight's own {w.nm.tag}")
        sw = w
    else:
        from repro_torch.api import sparsify  # lazy: api imports this module

        if nm is None:
            raise ValueError("nm is required when quantizing a dense array")
        sw = sparsify(torch.as_tensor(w), nm, axis=axis,
                      kernel_policy=kernel_policy or KernelPolicy("auto"))
    if sw.vals.dim() != 2:
        raise ValueError(f"quantize_nm expects a 2D weight, got vals shape "
                         f"{tuple(sw.vals.shape)}")
    obs = _as_observer(method)
    obs.observe(sw.vals, axis=sw.axis)
    scales = obs.scales()
    bcast = scales[None, :] if sw.axis == 0 else scales[:, None]
    q = torch.round(sw.vals.float() / bcast)
    q = torch.clamp(q, -QMAX, QMAX).to(torch.int8)
    policy = sw.kernel_policy
    if kernel_policy is not None:
        policy = (kernel_policy if isinstance(kernel_policy, KernelPolicy)
                  else KernelPolicy(mode=kernel_policy))
    return QNMWeight(vals=q, idx=sw.idx, scales=scales.float().contiguous(),
                     nm=sw.nm, axis=sw.axis, kernel_policy=policy)


def dequantize(qw: QNMWeight, dtype=torch.float32) -> NMWeight:
    """Float :class:`NMWeight` with the same pattern."""
    if not isinstance(qw, QNMWeight):
        raise TypeError(
            f"dequantize expects a QNMWeight, got {type(qw).__name__}")
    return qw.dequantize(dtype=dtype)


def _map_tree(tree, fn, leaf_type):
    if isinstance(tree, leaf_type):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn, leaf_type) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(v, fn, leaf_type) for v in tree)
    return tree


def _linears(module: nn.Module):
    from repro_torch.models.common import Linear  # lazy: models import quant

    return [m for m in module.modules() if isinstance(m, Linear)]


def quantize_tree(params, *, method: str = "absmax"):
    """Quantize every :class:`NMWeight` of ``params`` to int8.

    ``params`` is a module (each compressed ``Linear`` is switched to
    its :class:`QNMWeight` in place and the module is returned; the
    float values are dropped) or a tree of dicts, lists and tuples of 2D
    weights (a new tree; dense leaves pass through; the port keeps one
    module per layer, so nothing is stacked). ``method`` must be a
    *name*: one observer instance would accumulate statistics across
    leaves.
    """
    if not isinstance(method, str):
        raise TypeError(
            "quantize_tree needs a method name ('absmax' | 'percentile'); "
            "an observer instance would accumulate statistics across "
            "leaves - pass it to quantize_nm for the one weight it "
            "calibrates")
    _as_observer(method)  # validates the name before anything changes
    if isinstance(params, nn.Module):
        for lin in _linears(params):
            w = lin.weight
            if isinstance(w, NMWeight):
                lin.hold(quantize_nm(w, method=method))
        return params
    return _map_tree(params, lambda w: quantize_nm(w, method=method),
                     NMWeight)


def dequantize_tree(params, dtype=torch.float32):
    """Inverse of :func:`quantize_tree` (up to quantization error), in
    place on a module, a new tree otherwise."""
    if isinstance(params, nn.Module):
        for lin in _linears(params):
            w = lin.weight
            if isinstance(w, QNMWeight):
                lin.hold(dequantize(w, dtype=dtype))
        return params
    return _map_tree(params, lambda w: dequantize(w, dtype=dtype), QNMWeight)
