"""Shared model building blocks (port of ``repro.models.common``):
linear (dense or N:M-compressed), RMSNorm, rotary embeddings, token
embedding and its tied head, learned positions, and the device rule of
the port's entry points.

Weights are stored in the model dtype once, when they are made or
loaded (the JAX package keeps f32 params and casts them on every call).
The dense ``lm_head`` is the exception: it is computed in f32, so it is
stored in f32. A compressed linear holds an :class:`NMWeight` or an
int8 :class:`QNMWeight` whose policy decides between the hand-written
kernels and the reference; a masked one (the training flow) a
:class:`MaskedNMWeight`.

Training keeps the JAX package's split instead: f32 weights and a bf16
compute dtype. A module's ``compute_dtype`` (None: the weight's own
dtype) is the dtype its weight is cast to for the product and the
embedding's table for the lookup; ``LM.set_compute_dtype`` sets it on
every :class:`Linear` and the :class:`Embedding`. Float weights are
``nn.Parameter``s (frozen until a trainer turns ``requires_grad`` on);
``idx`` and every int8 tensor are buffers, so ``named_parameters()`` is
what an optimizer trains.
"""
from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from repro_torch.configs.base import SparsityConfig
from repro_torch.core.nmweight import KernelPolicy, MaskedNMWeight, NMWeight
from repro_torch.core.sparsity import apply_mask, compress_nm, prune_mask_nm
from repro_torch.kernels.epilogue import (
    Epilogue,
    apply_epilogue_f32,
    resolve_epilogue,
)
from repro_torch.kernels.indexmac.ops import nm_matmul
from repro_torch.quant.calibrate import quantize_nm
from repro_torch.quant.qnmweight import QNMWeight

QUANTIZE = (None, "int8")  # the load-time weight quantization options


def check_quantize(quantize) -> None:
    if quantize not in QUANTIZE:
        raise ValueError(f"quantize must be None or 'int8', got "
                         f"{quantize!r}")


class MetaGenerator(torch.Generator):
    """A CPU generator whose ``device`` is ``meta``: the init functions
    draw with ``device=gen.device``, so a model made from it has the
    shapes and dtypes of a real one and allocates nothing (the dry-run,
    :func:`repro_torch.models.transformer.count_params`). A meta device
    has no generator of its own."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def make_generator(device: torch.device, seed: int) -> torch.Generator:
    """The generator the init functions draw from on ``device``, seeded."""
    gen = (MetaGenerator() if device.type == "meta"
           else torch.Generator(device=device))
    gen.manual_seed(seed)
    return gen


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """The device an entry point runs on. ``cuda`` is the default of
    every entry point; without a card it raises instead of dropping to
    the CPU. Tests pass ``"cpu"`` explicitly."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card unless the caller "
            "asks for device='cpu'")
    return dev


# ---------------------------------------------------------------------------
# linear
# ---------------------------------------------------------------------------


def sparse_applies(sp: Optional[SparsityConfig], target: str,
                   in_dim: int) -> bool:
    return (sp is not None and target in sp.targets
            and in_dim % sp.nm_for(target).m == 0)


def linear_init(gen: torch.Generator, in_dim: int, out_dim: int, *,
                sp: Optional[SparsityConfig] = None, target: str = "dense",
                dtype=torch.float32, scale: Optional[float] = None,
                quantize: Optional[str] = None):
    """A random ``(in_dim, out_dim)`` weight on ``gen``'s device: an
    :class:`NMWeight` (pruned to the target's N:M and compressed, values
    in ``dtype``) when ``sp`` covers ``target``, a
    :class:`MaskedNMWeight` (pruned, stored dense) when ``sp.mode`` is
    ``masked``, else a dense tensor. ``quantize="int8"`` makes the
    compressed weight a :class:`QNMWeight`, quantized from its f32
    values (never from a ``dtype`` copy); dense and masked weights are
    not quantized."""
    check_quantize(quantize)
    scale = scale if scale is not None else in_dim ** -0.5
    w = torch.randn(in_dim, out_dim, generator=gen, device=gen.device) * scale
    if not sparse_applies(sp, target, in_dim):
        return w.to(dtype)
    nm = sp.nm_for(target)
    # a meta weight has a shape and nothing to rank: pruning and
    # compressing one on meta costs ~20 ms of Python a weight, minutes
    # for deepseek-v2-236b's 28,800 expert weights
    pruned = w if w.is_meta else apply_mask(w, prune_mask_nm(w, nm))
    if sp.mode == "masked":
        return MaskedNMWeight(w=pruned.to(dtype), nm=nm, axis=0)
    if w.is_meta:
        vals = w.new_empty(in_dim // nm.m * nm.n, out_dim)
        idx = torch.empty_like(vals, dtype=torch.int8)
    else:
        vals, idx = compress_nm(pruned, nm)
    nw = NMWeight(vals=vals, idx=idx, nm=nm, axis=0,
                  kernel_policy=KernelPolicy(
                      "auto" if sp.use_kernel else "off"))
    if quantize == "int8":
        return quantize_nm(nw)
    return nw.to(dtype=dtype)


def linear_apply(weight, x: torch.Tensor, *, compute_dtype=None,
                 epilogue: Optional[Epilogue] = None) -> torch.Tensor:
    """y = epilogue(x @ W). An :class:`NMWeight` goes through
    ``nm_matmul`` (its own nm and policy; the decode family fuses the
    epilogue; the values are cast to x's dtype there), a
    :class:`QNMWeight` through the int8 families, a
    :class:`MaskedNMWeight` through a plain product on its N:M
    projection (re-derived every call) and a dense tensor through a
    plain product, both with the same f32 epilogue composition.
    ``compute_dtype`` defaults to the weight's value dtype; for an int8
    weight x keeps its own (the model dtype) and the int8 payload is
    never cast."""
    if isinstance(weight, QNMWeight):
        xc = x.to(compute_dtype) if compute_dtype is not None else x
        return nm_matmul(xc, weight, epilogue=epilogue)
    if isinstance(weight, NMWeight):
        xc = x.to(compute_dtype or weight.vals.dtype)
        return nm_matmul(xc, weight, epilogue=epilogue)
    if isinstance(weight, MaskedNMWeight):
        weight = weight.project()
    elif not isinstance(weight, torch.Tensor):
        raise TypeError(f"linear_apply expects an NMWeight, a QNMWeight, "
                        f"a MaskedNMWeight or a dense tensor, got "
                        f"{type(weight).__name__}")
    dt = compute_dtype or weight.dtype
    y = torch.matmul(x.to(dt), weight.to(dt))
    bias, activation = resolve_epilogue(epilogue)
    if bias is None and activation is None:
        return y
    return apply_epilogue_f32(y.float(), bias, activation).to(y.dtype)


def linear_weight_dense(weight) -> torch.Tensor:
    """The effective dense weight (tests / export): what the forward
    multiplies by; for a masked weight its N:M projection (its raw
    training storage is ``weight.w``)."""
    if isinstance(weight, (NMWeight, QNMWeight, MaskedNMWeight)):
        return weight.to_dense()
    return weight


def _param(t: torch.Tensor) -> nn.Parameter:
    """A float weight as a frozen parameter (a trainer unfreezes it)."""
    return nn.Parameter(t, requires_grad=False)


class Linear(nn.Module):
    """A linear layer holding a dense weight, an :class:`NMWeight`, an
    int8 :class:`QNMWeight` or a :class:`MaskedNMWeight`. Float values
    (``w``, ``vals``) are parameters; ``idx`` and the int8 tensors are
    buffers. ``nm`` is the compressed weight's pattern (None for a dense
    or masked weight: only a compressed weight has a kernel policy);
    ``mask_nm`` the masked weight's."""

    compute_dtype = None  # see the module docstring

    def __init__(self, weight):
        super().__init__()
        self.hold(weight)

    def hold(self, weight) -> None:
        """Hold ``weight`` in place of the current one (its tensors are
        dropped: quantizing a model in place frees the float values)."""
        for name in ("w", "vals", "idx", "scales"):
            self._buffers.pop(name, None)
            self._parameters.pop(name, None)
        self.quantized = isinstance(weight, QNMWeight)
        self.nm = self.mask_nm = None
        if isinstance(weight, (NMWeight, QNMWeight)):
            if self.quantized:
                self.register_buffer("vals", weight.vals)
            else:
                self.vals = _param(weight.vals)
            self.register_buffer("idx", weight.idx)
            if self.quantized:
                self.register_buffer("scales", weight.scales)
            self.nm, self.axis = weight.nm, weight.axis
            self.kernel_policy = weight.kernel_policy
        elif isinstance(weight, MaskedNMWeight):
            self.w = _param(weight.w)
            self.mask_nm, self.axis = weight.nm, weight.axis
        else:
            self.w = _param(weight)

    @property
    def weight(self):
        if self.mask_nm is not None:
            return MaskedNMWeight(self.w, self.mask_nm, self.axis)
        if self.nm is None:
            return self.w
        if self.quantized:
            return QNMWeight(self.vals, self.idx, self.scales, self.nm,
                             self.axis, self.kernel_policy)
        return NMWeight(self.vals, self.idx, self.nm, self.axis,
                        self.kernel_policy)

    def forward(self, x, *, compute_dtype=None, epilogue=None):
        return linear_apply(self.weight, x,
                            compute_dtype=compute_dtype or self.compute_dtype,
                            epilogue=epilogue)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-5):
    """f32 statistics, cast back to x's dtype, then the scale."""
    x32 = x.float()
    rms = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (x32 * rms).to(x.dtype) * scale.to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, scale: torch.Tensor, eps: float = 1e-5):
        super().__init__()
        self.scale = _param(scale)
        self.eps = eps

    def forward(self, x):
        return rmsnorm(self.scale, x, self.eps)


# ---------------------------------------------------------------------------
# rotary position embedding (llama-style half rotation)
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """(cos, sin) for :func:`apply_rope_tables`, f32, shaped
    (..., seq, 1, head_dim): cos repeated over both halves, sin negated
    on the first. ``LM.forward`` makes them once for all layers."""
    freqs = rope_freqs(head_dim, theta, positions.device)
    angles = positions[..., :, None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    return (torch.cat([cos, cos], -1)[..., :, None, :],
            torch.cat([-sin, sin], -1)[..., :, None, :])


def apply_rope_tables(x: torch.Tensor, cos: torch.Tensor,
                      sin: torch.Tensor) -> torch.Tensor:
    """The half rotation [x1 cos - x2 sin, x2 cos + x1 sin] in f32 (the
    same products and sums as the JAX package: a + (-b) is a - b)."""
    xf = x.float()
    half = x.shape[-1] // 2
    rot = torch.cat([xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * cos + rot * sin).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq). f32 math."""
    return apply_rope_tables(x, *rope_tables(positions, x.shape[-1], theta))


# ---------------------------------------------------------------------------
# embedding
# ---------------------------------------------------------------------------


class Embedding(nn.Module):
    compute_dtype = None  # the lookup's dtype; None: the table's

    def __init__(self, table: torch.Tensor):
        super().__init__()
        self.table = _param(table)

    @classmethod
    def init(cls, gen: torch.Generator, vocab: int, d: int, dtype):
        e = torch.randn(vocab, d, generator=gen, device=gen.device)
        return cls((e * d ** -0.5).to(dtype))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """The rows of ``tokens``; with a compute dtype, rows of the table
        cast to it (the JAX package casts the table, then gathers: its
        backward sums the rows' gradients in the compute dtype)."""
        if self.compute_dtype is None:
            return self.table[tokens]
        return self.table.to(self.compute_dtype)[tokens]

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        """Tied output head: f32 logits = x @ E^T, x and the table in
        f32 (the JAX package's ``embedding_attend``), never through an
        f32 copy of the whole table (5.6 GB at gemma3's 262,144 x 5376).

        On the card, with x and the table in bf16 and no gradient, one
        bf16 product with f32 accumulation and f32 output (``torch.mm``'s
        ``out_dtype``): each product of two bf16 values is exact in f32,
        only the order of the sum differs, and the logits are the only
        temporary. Otherwise the vocabulary in chunks of
        :func:`head_rows` rows: the temporaries besides the logits are
        the f32 copy of one chunk of the table (at most
        ``HEAD_TEMP_BYTES``) and the chunks' logits, concatenated."""
        vocab, d = self.table.shape
        grad = torch.is_grad_enabled() and (x.requires_grad
                                            or self.table.requires_grad)
        if (x.is_cuda and x.dtype == self.table.dtype == torch.bfloat16
                and not grad):
            return torch.mm(x.reshape(-1, d), self.table.t(),
                            out_dtype=torch.float32).reshape(
                                x.shape[:-1] + (vocab,))
        rows, xf = head_rows(vocab, d), x.float()
        return torch.cat([torch.matmul(xf, self.table[v:v + rows].float().t())
                          for v in range(0, vocab, rows)], -1)


HEAD_TEMP_BYTES = 256 * 2**20  # the tied head's f32 table chunk


def head_rows(vocab: int, d: int) -> int:
    """Vocabulary rows of one chunk of the tied head: its f32 copy fits
    ``HEAD_TEMP_BYTES``."""
    return max(1, min(vocab, HEAD_TEMP_BYTES // (4 * d)))


class LearnedPositions(nn.Module):
    """A learned position table (``max_seq`` or ``encoder_seq``, d): adds
    the rows of the given positions to x, cast to x's dtype (the JAX
    package's ``pos`` / ``enc_pos``)."""

    def __init__(self, table: torch.Tensor):
        super().__init__()
        self.table = _param(table)

    @classmethod
    def init(cls, gen: torch.Generator, rows: int, d: int, dtype):
        e = torch.randn(rows, d, generator=gen, device=gen.device)
        return cls((e * 0.02).to(dtype))

    def forward(self, x: torch.Tensor, positions: torch.Tensor):
        """x (B, s, d) plus the rows of ``positions``, (s,) or (B, s)."""
        return x + self.table[positions].to(x.dtype)
