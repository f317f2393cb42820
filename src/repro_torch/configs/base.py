"""Config dataclasses (the part of ``repro.configs.base`` this port
serves): sparsity, the mixers (GQA and DeepSeek-V2's MLA attention,
Mamba-1's selective scan, RWKV-6's time-mix), the FFN and MoE MLPs,
blocks and the model; the CNN backbones of the paper's evaluation
(convs, bottleneck and dense stages), and the input shapes of the
dry-run's cells (``ShapeConfig``, ``SHAPES``). Frozen and hashable, as
in the JAX package; an LM is a *plan*, an ordered tuple of ``(entry,
repeat)`` groups, an entry one ``Block`` or a tuple of Blocks (a
period, such as jamba's 8 layers or gemma3's 5 local + 1 global,
repeated as a whole).
An encoder-decoder model (whisper) also has an ``encoder_plan``, and
its decoder blocks cross-attend to the encoder's output.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Optional, Union

from repro_torch.core.sparsity import NMConfig
from repro_torch.kernels.blocksparse_attn.mask import MaskSpec


@dataclasses.dataclass(frozen=True)
class SparsityConfig:
    """Which weight GEMMs are N:M-compressed at init, and how they run.

    targets: weight families to sparsify ("ffn", "attn_proj"; the CNN
      convs are "conv", their projection shortcuts "proj").
    use_kernel: the compressed weights' policy is "auto" (hand-written
      kernels) instead of "off" (plain reference).
    nm_overrides: per-target NMConfig overrides.
    mode: "compressed" stores (vals, int8 idx) and runs the N:M kernels;
      "masked" stores the weight dense and re-derives its top-N:M mask
      every forward (the prune->fine-tune training flow,
      :class:`repro_torch.core.nmweight.MaskedNMWeight`).
    """

    nm: NMConfig = NMConfig(2, 4)
    targets: tuple[str, ...] = ("ffn", "attn_proj", "expert")
    use_kernel: bool = False
    nm_overrides: tuple[tuple[str, NMConfig], ...] = ()
    mode: Literal["compressed", "masked"] = "compressed"

    def __post_init__(self):
        if self.mode not in ("compressed", "masked"):
            raise ValueError(f"sparsity mode {self.mode!r} not in "
                             "('compressed', 'masked')")

    def nm_for(self, target: str) -> NMConfig:
        return dict(self.nm_overrides).get(target, self.nm)


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    """Attention with RoPE: grouped-query (``kind="gqa"``) or DeepSeek-V2
    multi-head latent attention (``kind="mla"``: K and V come from a
    ``kv_lora_rank`` latent; a head's q and k are ``nope_head_dim``
    dims without rope and ``rope_head_dim`` with it, its v
    ``v_head_dim``)."""

    kind: Literal["gqa", "mla"] = "gqa"
    q_heads: int = 8
    kv_heads: int = 8
    head_dim: int = 128
    rope: bool = True
    window: Optional[int] = None  # sliding-window size (local attention)
    causal: bool = True
    # MLA (DeepSeek-V2) fields
    kv_lora_rank: int = 512
    q_lora_rank: Optional[int] = None
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128
    # carried for equality with the JAX package's config; nothing reads
    # it there or here (the model's logit_softcap is the one applied)
    logit_softcap: Optional[float] = None
    qk_norm: bool = False
    rope_theta: Optional[float] = None  # overrides ModelConfig.rope_theta
    # Block-sparse attention pattern. When set it replaces the dense
    # causal/window masking: train/prefill routes through the
    # ``bs_attention`` family, decode/chunk through
    # ``bs_attention_decode`` (the spec's own causal/window semantics
    # apply; ``window``/``causal`` above are ignored for this mixer).
    mask: Optional[MaskSpec] = None


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    """Mamba-1 selective state-space mixer: the inner width is ``expand *
    d_model``, the state ``d_state`` per channel, the causal depthwise
    conv ``d_conv`` taps, the step size from a ``dt_rank`` projection."""

    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 256


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    """RWKV-6 (Finch) time-mix with data-dependent decay: heads of
    ``head_dim``, the decay's LoRA of rank ``decay_lora``, the 5-way
    token-shift mix's of rank ``mix_lora``. The block's channel-mix
    takes the width of its ``FFNConfig``."""

    head_dim: int = 64
    decay_lora: int = 64
    mix_lora: int = 32


@dataclasses.dataclass(frozen=True)
class FFNConfig:
    d_ff: int = 4096
    act: Literal["swiglu", "geglu", "gelu", "relu_sq"] = "swiglu"


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Routed experts (top-k of ``n_experts``, each an FFN of width
    ``d_expert``) plus ``n_shared`` always-on shared experts, run as one
    FFN of width ``n_shared * d_expert`` (DeepSeek-V2)."""

    n_experts: int = 64
    top_k: int = 6
    d_expert: int = 1408
    n_shared: int = 2
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001
    act: Literal["swiglu", "gelu"] = "swiglu"


Mixer = Union[AttnConfig, MambaConfig, RWKVConfig]


@dataclasses.dataclass(frozen=True)
class Block:
    """One layer: a mixer and an MLP. An RWKV block's MLP is its
    channel-mix (an ``FFNConfig`` giving its width), run by the mixer's
    module with its own norm. ``cross_attn``: an encoder-decoder's
    decoder block, which also attends to the encoder's output (a second
    GQA of the mixer's shape, no rope, not causal)."""

    mixer: Mixer
    mlp: Optional[Union[FFNConfig, MoEConfig]]
    cross_attn: bool = False


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    vocab_size: int
    d_model: int
    plan: tuple[tuple[Block, int], ...]
    max_seq: int = 8192
    rope_theta: float = 10_000.0
    # "none": no position signal outside the attention mixers' rope (the
    # recurrent models carry position in their state); "learned": a
    # (max_seq, d_model) table added to the token embeddings (whisper's)
    pos_embed: Literal["rope", "learned", "none"] = "rope"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    logit_softcap: Optional[float] = None  # logits -> tanh(l / c) * c
    sparsity: Optional[SparsityConfig] = None
    # encoder-decoder (whisper): the encoder's plan over ``encoder_seq``
    # positions of token ids or of (B, encoder_seq, d_model) embeddings
    encoder_plan: Optional[tuple[tuple[Block, int], ...]] = None
    encoder_inputs: Literal["tokens", "embeddings"] = "tokens"
    encoder_seq: int = 1500
    attn_chunk: int = 512  # KV chunk of the online-softmax prefill
    family: str = "dense"

    def __post_init__(self):
        if self.pos_embed not in ("rope", "learned", "none"):
            raise ValueError(
                f"pos_embed {self.pos_embed!r} not in ('rope', 'learned', "
                "'none')")

    @property
    def n_layers(self) -> int:
        """The decoder's layers (an encoder's are not counted)."""
        return sum((len(e) if isinstance(e, tuple) else 1) * r
                   for e, r in self.plan)

    def blocks(self) -> list[Block]:
        """Every decoder layer's Block in order, periods and repeats
        unrolled."""
        return _unroll(self.plan)

    def encoder_blocks(self) -> list[Block]:
        """Every encoder layer's Block in order (none without one)."""
        return _unroll(self.encoder_plan or ())

    def param_count(self) -> int:
        """The parameters of the whole model (float tensors only, as
        :func:`repro_torch.models.transformer.count_params`), counted on
        the meta device without allocating."""
        from repro_torch.models.transformer import count_params  # no cycle

        return count_params(self)

    def active_param_count(self) -> int:
        """:meth:`param_count` with the routed experts at top_k: the
        N_active of an MoE config's model FLOPs."""
        from repro_torch.models.transformer import count_params

        return count_params(self, active_only=True)

    def map_blocks(self, fn) -> "ModelConfig":
        """This config with ``fn`` applied to every Block of its plan, the
        periods and repeats kept."""
        return dataclasses.replace(self, plan=tuple(
            (tuple(fn(b) for b in entry) if isinstance(entry, tuple)
             else fn(entry), rep) for entry, rep in self.plan))


def _unroll(plan) -> list[Block]:
    return [blk for entry, rep in plan for _ in range(rep)
            for blk in (entry if isinstance(entry, tuple) else (entry,))]


# ---------------------------------------------------------------------------
# CNN configs (the paper's evaluation workload: conv layers mapped to
# sparse-dense GEMMs via im2col, paper section IV)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    """One 2D convolution, NHWC activations / HWIO weights.

    The GEMM the paper maps it to is A(M=c_out, K=c_in*kh*kw) x
    B(K, N=h_out*w_out); the sparse weight is compressed along K, so a
    conv runs the ``nm_matmul`` families unchanged.
    """

    name: str
    c_in: int
    c_out: int
    kh: int = 1
    kw: int = 1
    stride: int = 1
    padding: Literal["SAME", "VALID"] = "SAME"
    target: str = "conv"  # sparsity target family (SparsityConfig.targets)

    @property
    def k_gemm(self) -> int:
        """Contraction dim of the im2col GEMM (= C_in * kh * kw)."""
        return self.c_in * self.kh * self.kw

    def out_hw(self, h: int, w: int) -> tuple[int, int]:
        """Output spatial dims for an (h, w) input."""
        if self.padding == "SAME":
            return -(-h // self.stride), -(-w // self.stride)
        return ((h - self.kh) // self.stride + 1,
                (w - self.kw) // self.stride + 1)


@dataclasses.dataclass(frozen=True)
class BottleneckStage:
    """ResNet bottleneck stage: ``blocks`` x (1x1 mid, 3x3 mid, 1x1 out)
    with a projection shortcut on the first block. ``stride``
    downsamples in the first block, on the leading 1x1 and the
    projection (every conv of a stage runs at the stage's output
    resolution, as in the paper's per-layer GEMM table)."""

    mid: int
    out: int
    blocks: int
    stride: int = 2


@dataclasses.dataclass(frozen=True)
class DenseStage:
    """DenseNet dense block: ``layers`` x (1x1 bottleneck to 4*growth,
    3x3 to growth, concat). A transition (1x1 halving channels + 2x2
    avg-pool) follows every stage except the last."""

    layers: int
    growth: int = 32


CNNStage = Union[BottleneckStage, DenseStage]


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    """A CNN backbone as a stem + stage stack (resnet or densenet kind).

    ``kind`` picks the block topology of
    :class:`repro_torch.models.conv.SparseCNN`; the per-layer conv list
    and the paper's im2col GEMM table come from
    ``repro_torch.models.conv.cnn_layer_specs`` / ``cnn_layer_gemms``.
    """

    name: str
    kind: Literal["resnet", "densenet"]
    stem: ConvSpec
    stages: tuple[CNNStage, ...]
    input_hw: int = 224
    stem_pool: int = 2  # 3x3 max-pool stride after the stem (1 = none)
    num_classes: int = 1000
    sparsity: Optional[SparsityConfig] = None


# ---------------------------------------------------------------------------
# input shapes of the dry-run cells (the JAX package's assigned shape set)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """A cell's input: ``global_batch`` sequences of ``seq_len`` tokens;
    a decode shape is one token a sequence against a cache of
    ``seq_len`` positions."""

    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
