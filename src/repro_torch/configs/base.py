"""Config dataclasses (the part of ``repro.configs.base`` this port
serves): sparsity, the GQA attention and FFN mixers, blocks and the
model. Frozen and hashable, as in the JAX package; a model is a *plan*,
an ordered tuple of ``(Block, repeat)`` groups.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Optional

from repro_torch.core.sparsity import NMConfig


@dataclasses.dataclass(frozen=True)
class SparsityConfig:
    """Which weight GEMMs are N:M-compressed at init, and how they run.

    targets: projection families to sparsify ("ffn", "attn_proj").
    use_kernel: the compressed weights' policy is "auto" (hand-written
      kernels) instead of "off" (plain reference).
    nm_overrides: per-target NMConfig overrides.
    Only the compressed mode is ported; the masked training mode comes
    with the training slice.
    """

    nm: NMConfig = NMConfig(2, 4)
    targets: tuple[str, ...] = ("ffn", "attn_proj", "expert")
    use_kernel: bool = False
    nm_overrides: tuple[tuple[str, NMConfig], ...] = ()

    def nm_for(self, target: str) -> NMConfig:
        return dict(self.nm_overrides).get(target, self.nm)


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    """Grouped-query attention with RoPE (the GQA kind of the JAX config)."""

    q_heads: int = 8
    kv_heads: int = 8
    head_dim: int = 128
    rope: bool = True
    window: Optional[int] = None  # sliding-window size (local attention)
    causal: bool = True
    qk_norm: bool = False
    rope_theta: Optional[float] = None  # overrides ModelConfig.rope_theta


@dataclasses.dataclass(frozen=True)
class FFNConfig:
    d_ff: int = 4096
    act: Literal["swiglu", "gelu", "relu_sq"] = "swiglu"


@dataclasses.dataclass(frozen=True)
class Block:
    mixer: AttnConfig
    mlp: Optional[FFNConfig]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    vocab_size: int
    d_model: int
    plan: tuple[tuple[Block, int], ...]
    max_seq: int = 8192
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    sparsity: Optional[SparsityConfig] = None
    attn_chunk: int = 512  # KV chunk of the online-softmax prefill
    family: str = "dense"

    @property
    def n_layers(self) -> int:
        return sum((len(e) if isinstance(e, tuple) else 1) * r
                   for e, r in self.plan)
