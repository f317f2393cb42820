"""chameleon-34b [vlm] - early-fusion multimodal LM [arXiv:2405.09818].

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536, qk-norm. The VQ
image frontend is not modelled: images come as tokens of the shared
vocabulary.
"""
from repro_torch.configs.base import (
    AttnConfig,
    Block,
    FFNConfig,
    ModelConfig,
    SparsityConfig,
)


def _plan(layers, q, kv, hd, ff):
    attn = AttnConfig(q_heads=q, kv_heads=kv, head_dim=hd, qk_norm=True)
    return ((Block(attn, FFNConfig(d_ff=ff, act="swiglu")), layers),)


def _sparsity(sparse: bool):
    return SparsityConfig() if sparse else None


def config(sparse: bool = True) -> ModelConfig:
    return ModelConfig(
        name="chameleon-34b",
        vocab_size=65_536,
        d_model=8_192,
        plan=_plan(48, 64, 8, 128, 22_016),
        max_seq=32_768,
        rope_theta=10_000.0,
        sparsity=_sparsity(sparse),
        family="vlm",
    )


def reduced(sparse: bool = True) -> ModelConfig:
    return ModelConfig(
        name="chameleon-34b-reduced",
        vocab_size=512,
        d_model=128,
        plan=_plan(2, 8, 2, 16, 256),
        max_seq=128,
        sparsity=_sparsity(sparse),
        family="vlm",
    )
