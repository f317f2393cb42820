"""Sparse 2D convolution on the N:M kernel path, via im2col (port of
``repro.models.conv``).

The paper's evaluation (section IV) is structured-sparse *CNN* layers
mapped to sparse-dense GEMMs: a conv with HWIO weights ``(kh, kw, C_in,
C_out)`` becomes ``A(M=C_out, K=C_in*kh*kw) x B(K, N=H_out*W_out)``.

* :func:`im2col` lowers NHWC activations to patch rows whose feature
  layout ``(kh, kw, C_in)`` matches ``w_hwio.reshape(K, C_out)``, so a
  conv is exactly ``patches @ W2d``. (``F.unfold`` orders the features
  ``(C_in, kh, kw)`` and pads symmetrically, so it is not used.)
* :class:`SparseConv2D` is a :class:`Linear` over the K = C_in*kh*kw
  axis: it holds an :class:`NMWeight`, an int8 :class:`QNMWeight` or a
  dense weight, and its forward is ``linear_apply`` on the patches, so
  convs run the ``nm_matmul`` / ``nm_matmul_q`` families unchanged and
  ``quantize_tree`` quantizes them in place.
* :class:`SparseCNN` runs a whole backbone (ResNet bottlenecks or
  DenseNet dense blocks, from a :class:`CNNConfig`); on the card
  :meth:`SparseCNN.graphed` runs its forward as a CUDA graph captured
  once per input signature and replayed. And
  :func:`cnn_layer_specs` / :func:`cnn_layer_gemms` derive the per-layer
  conv list and the paper's im2col GEMM table from the same config.

Activations stay NHWC, the JAX package's layout, at every public
function. SAME padding splits as XLA does (the odd pad goes after), and
the pools pad explicitly for the same reason. Inference only: training
comes with the training slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch
from torch import nn

from repro_torch.configs.base import (
    BottleneckStage,
    CNNConfig,
    ConvSpec,
    DenseStage,
)
from repro_torch.core.cost_model import conv_gemm_dims
from repro_torch.kernels import capture
from repro_torch.models.common import (
    Linear,
    check_quantize,
    linear_apply,
    linear_init,
    resolve_device,
)

__all__ = [
    "ConvLayer",
    "SparseCNN",
    "SparseConv2D",
    "cnn_final_channels",
    "cnn_layer_gemms",
    "cnn_layer_specs",
    "conv2d",
    "im2col",
]


# ---------------------------------------------------------------------------
# im2col lowering
# ---------------------------------------------------------------------------


def _same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """XLA's SAME split: total = max((ceil(size/s)-1)*s + k - size, 0),
    ``total // 2`` before and the rest after."""
    out = -(-size // s)
    pad = max((out - 1) * s + k - size, 0)
    return pad // 2, pad - pad // 2


def _out_dim(size: int, k: int, s: int, padding: str) -> int:
    if padding == "SAME":
        return -(-size // s)
    return (size - k) // s + 1


def _windows(x: torch.Tensor, kh: int, kw: int, sh: int, sw: int,
             padding: str, value: float = 0.0) -> list[torch.Tensor]:
    """The kh*kw strided views of NHWC ``x`` (SAME-padded with ``value``),
    in (i, j) order: window element (i, j) of every output position."""
    *_, h, w, _c = x.shape
    ho = _out_dim(h, kh, sh, padding)
    wo = _out_dim(w, kw, sw, padding)
    if ho <= 0 or wo <= 0:
        raise ValueError(
            f"window ({kh}x{kw}, stride {sh}x{sw}, {padding}) does not fit "
            f"the {h}x{w} input")
    if padding == "SAME":
        pt, pb = _same_pads(h, kh, sh)
        pl, pr = _same_pads(w, kw, sw)
        if pt or pb or pl or pr:
            x = torch.nn.functional.pad(x, (0, 0, pl, pr, pt, pb),
                                        value=value)
    return [x[..., i: i + (ho - 1) * sh + 1: sh,
              j: j + (wo - 1) * sw + 1: sw, :]
            for i in range(kh) for j in range(kw)]


def im2col(x: torch.Tensor, kh: int, kw: int, *,
           stride: Union[int, tuple[int, int]] = 1,
           padding: str = "SAME") -> torch.Tensor:
    """NHWC activations -> im2col patch rows.

    x: (..., H, W, C) -> (..., H_out, W_out, kh*kw*C). The patch feature
    layout is ``(kh, kw, C)``, exactly ``w_hwio.reshape(kh*kw*C, C_out)``.
    """
    sh, sw = (stride, stride) if isinstance(stride, int) else stride
    if padding not in ("SAME", "VALID"):
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    cols = _windows(x, kh, kw, sh, sw, padding)
    return cols[0] if len(cols) == 1 else torch.cat(cols, dim=-1)


def conv2d(x: torch.Tensor, w, *, kh: int, kw: int,
           stride: Union[int, tuple[int, int]] = 1, padding: str = "SAME",
           compute_dtype=None) -> torch.Tensor:
    """y = conv(x, W) through the im2col GEMM on the kernel path.

    ``w`` is any linear weight over the flattened contraction axis: an
    :class:`NMWeight` / :class:`QNMWeight` compressed along
    K = C_in*kh*kw (axis 0), or a dense (K, C_out) tensor. Dispatch
    follows the weight's own type and policy, as for a linear layer.
    """
    patches = im2col(x, kh, kw, stride=stride, padding=padding)
    return linear_apply(w, patches, compute_dtype=compute_dtype)


# ---------------------------------------------------------------------------
# SparseConv2D layer
# ---------------------------------------------------------------------------


class SparseConv2D(Linear):
    """A conv layer whose weight is held as a :class:`Linear` holds it,
    over the K = C_in*kh*kw axis; the forward is im2col + linear_apply."""

    def __init__(self, spec: ConvSpec, weight):
        super().__init__(weight)
        self.spec = spec

    @classmethod
    def init(cls, spec: ConvSpec, gen: torch.Generator, *, sp=None,
             dtype=torch.float32,
             quantize: Optional[str] = None) -> "SparseConv2D":
        return cls(spec, linear_init(gen, spec.k_gemm, spec.c_out, sp=sp,
                                     target=spec.target, dtype=dtype,
                                     quantize=quantize))

    def forward(self, x: torch.Tensor, *, compute_dtype=None):
        s = self.spec
        return conv2d(x, self.weight, kh=s.kh, kw=s.kw, stride=s.stride,
                      padding=s.padding, compute_dtype=compute_dtype)


# ---------------------------------------------------------------------------
# per-layer walker: the conv list / GEMM table of a CNNConfig
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ConvLayer:
    """A :class:`ConvSpec` placed at its resolved input resolution."""

    spec: ConvSpec
    h_in: int
    w_in: int

    @property
    def h_out(self) -> int:
        return self.spec.out_hw(self.h_in, self.w_in)[0]

    @property
    def w_out(self) -> int:
        return self.spec.out_hw(self.h_in, self.w_in)[1]

    @property
    def gemm(self) -> tuple[str, int, int, int]:
        """(name, M=C_out, K=C_in*kh*kw, N=H_out*W_out), paper section IV."""
        s = self.spec
        return (s.name, *conv_gemm_dims(s.c_out, s.c_in, s.kh, s.kw,
                                        self.h_out, self.w_out))


def cnn_layer_specs(cfg: CNNConfig) -> list[ConvLayer]:
    """Every conv of the backbone in execution order, with resolved
    channel counts and spatial resolutions."""
    layers = [ConvLayer(cfg.stem, cfg.input_hw, cfg.input_hw)]
    hw = layers[0].h_out
    if cfg.stem_pool > 1:
        hw = -(-hw // cfg.stem_pool)
    ch = cfg.stem.c_out

    def conv(name, c_in, c_out, k=1, stride=1, at=None, target="conv"):
        layers.append(ConvLayer(
            ConvSpec(name, c_in, c_out, k, k, stride, target=target), at, at))

    if cfg.kind == "resnet":
        for si, st in enumerate(cfg.stages):
            if not isinstance(st, BottleneckStage):
                raise TypeError(f"resnet stage {si} is {st!r}")
            for b in range(st.blocks):
                tag = f"s{si + 2}b{b + 1}"
                stride = st.stride if b == 0 else 1
                conv(f"{tag}_1x1a", ch, st.mid, 1, stride, at=hw)
                hw_out = -(-hw // stride)
                conv(f"{tag}_3x3", st.mid, st.mid, 3, at=hw_out)
                conv(f"{tag}_1x1b", st.mid, st.out, 1, at=hw_out)
                if b == 0:
                    conv(f"{tag}_proj", ch, st.out, 1, stride, at=hw,
                         target="proj")
                ch = st.out
                hw = hw_out
    elif cfg.kind == "densenet":
        for bi, st in enumerate(cfg.stages):
            if not isinstance(st, DenseStage):
                raise TypeError(f"densenet stage {bi} is {st!r}")
            for li in range(st.layers):
                tag = f"d{bi + 1}l{li + 1}"
                conv(f"{tag}_1x1", ch, 4 * st.growth, 1, at=hw)
                conv(f"{tag}_3x3", 4 * st.growth, st.growth, 3, at=hw)
                ch += st.growth
            if bi < len(cfg.stages) - 1:
                conv(f"t{bi + 1}_1x1", ch, ch // 2, 1, at=hw)
                ch //= 2
                hw = -(-hw // 2)  # ceil: matches the SAME-padded avg-pool
    else:
        raise ValueError(f"unknown CNN kind {cfg.kind!r}")
    return layers


def cnn_layer_gemms(cfg: CNNConfig) -> list[tuple[str, int, int, int]]:
    """The paper's im2col GEMM table: (name, M=C_out, K, N=H_out*W_out)."""
    return [layer.gemm for layer in cnn_layer_specs(cfg)]


def cnn_final_channels(cfg: CNNConfig) -> int:
    """Channel count entering the classifier head."""
    if cfg.kind == "resnet":
        return cfg.stages[-1].out
    ch = cfg.stem.c_out
    for bi, st in enumerate(cfg.stages):
        ch += st.layers * st.growth
        if bi < len(cfg.stages) - 1:
            ch //= 2
    return ch


# ---------------------------------------------------------------------------
# SparseCNN forward model
# ---------------------------------------------------------------------------


def _max_pool(x: torch.Tensor, k: int = 3, stride: int = 2) -> torch.Tensor:
    """``reduce_window`` max, SAME, init -inf: the pads are -inf and the
    odd one goes after (112 -> 56 pads (0, 1))."""
    wins = _windows(x, k, k, stride, stride, "SAME", value=float("-inf"))
    out = wins[0]
    for w in wins[1:]:
        out = torch.maximum(out, w)
    return out


def _avg_pool(x: torch.Tensor, k: int = 2, stride: int = 2) -> torch.Tensor:
    """``reduce_window`` sum in f32, SAME with zero pads, divided by k*k
    (padded lanes included), cast back to x's dtype."""
    wins = _windows(x.float(), k, k, stride, stride, "SAME")
    s = wins[0]
    for w in wins[1:]:
        s = s + w
    return (s / (k * k)).to(x.dtype)


class SparseCNN(nn.Module):
    """A CNN backbone running every conv through the sparse GEMM path.

    ``convs`` maps each layer name to its :class:`SparseConv2D` (weights
    as ``linear_init`` makes them over the flattened K axis); the head is
    a dense f32 :class:`Linear`. The topology (residual adds, dense-block
    concats, transitions) comes from the :class:`CNNConfig`.
    """

    def __init__(self, cfg: CNNConfig, convs: dict, head: torch.Tensor):
        super().__init__()
        self.cfg = cfg
        self.layers = cnn_layer_specs(cfg)
        names = [layer.spec.name for layer in self.layers]
        if sorted(convs) != sorted(names):
            raise ValueError(f"conv weights {sorted(convs)} do not match "
                             f"the layers of {cfg.name}")
        self.convs = nn.ModuleDict({n: convs[n] for n in names})
        self.head = Linear(head)
        self._graphs: dict = {}  # compute dtype -> capture.Graphed

    @classmethod
    def init(cls, cfg: CNNConfig, *, seed: int = 0, dtype=torch.float32,
             device="cuda", quantize: Optional[str] = None) -> "SparseCNN":
        """Random weights from ``seed``, made on ``device``: the convs
        pruned to the config's N:M and compressed where its sparsity
        covers them (in ``dtype``, or int8 from their f32 values with
        ``quantize="int8"``), the rest dense; the head dense f32."""
        check_quantize(quantize)
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        convs = {layer.spec.name: SparseConv2D.init(
            layer.spec, gen, sp=cfg.sparsity, dtype=dtype, quantize=quantize)
            for layer in cnn_layer_specs(cfg)}
        head = linear_init(gen, cnn_final_channels(cfg), cfg.num_classes,
                           dtype=torch.float32)
        return cls(cfg, convs, head)

    def _run(self, name: str, x: torch.Tensor, compute_dtype):
        return self.convs[name](x, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor, *, compute_dtype=None) -> torch.Tensor:
        """x: (B, H, W, 3) NHWC -> f32 logits (B, num_classes)."""
        cfg = self.cfg
        relu = torch.relu
        x = relu(self._run(cfg.stem.name, x, compute_dtype))
        if cfg.stem_pool > 1:
            x = _max_pool(x, 3, cfg.stem_pool)
        if cfg.kind == "resnet":
            for si, st in enumerate(cfg.stages):
                for b in range(st.blocks):
                    tag = f"s{si + 2}b{b + 1}"
                    h = relu(self._run(f"{tag}_1x1a", x, compute_dtype))
                    h = relu(self._run(f"{tag}_3x3", h, compute_dtype))
                    h = self._run(f"{tag}_1x1b", h, compute_dtype)
                    short = (self._run(f"{tag}_proj", x, compute_dtype)
                             if b == 0 else x)
                    x = relu(h + short)
        else:
            for bi, st in enumerate(cfg.stages):
                for li in range(st.layers):
                    tag = f"d{bi + 1}l{li + 1}"
                    h = relu(self._run(f"{tag}_1x1", x, compute_dtype))
                    h = self._run(f"{tag}_3x3", h, compute_dtype)
                    x = torch.cat([x, h], dim=-1)
                if bi < len(cfg.stages) - 1:
                    x = self._run(f"t{bi + 1}_1x1", relu(x), compute_dtype)
                    x = _avg_pool(x, 2, 2)
        x = x.float().mean(dim=(-3, -2))  # global average pool, in f32
        return self.head(x, compute_dtype=torch.float32)

    @torch.inference_mode()
    def graphed(self, x: torch.Tensor, *, compute_dtype=None) -> torch.Tensor:
        """:meth:`forward` of ``x`` (B, H, W, 3) on the card as a CUDA
        graph: captured at the first call of each (B, H, W, dtype) over a
        static input buffer (that call runs the forward eagerly, on a side
        stream, then captures it), replayed at later calls after ``x`` is
        copied into the buffer. The logits of a replay are the graph's
        static output, overwritten by the next call of that signature.
        The same kernels run at the same launches as an eager forward, so
        the logits are equal bit for bit. On the CPU the forward runs
        eagerly. ``graphs_captured()`` gives each graph's record (the
        dispatches and launches a replay runs, and its replays)."""
        g = self._graphs.get(compute_dtype)
        if g is None:
            g = self._graphs[compute_dtype] = capture.Graphed(
                lambda x: self.forward(x, compute_dtype=compute_dtype),
                device=x.device)
        return g(x=x)

    def graphs_captured(self) -> list:
        """The :class:`~repro_torch.kernels.capture.CapturedStep` of every
        graph :meth:`graphed` captured."""
        return [r for g in self._graphs.values() for r in g.captured]
