"""yi-9b [dense] - llama-arch GQA [arXiv:2403.04652].

48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
"""
from repro_torch.configs.base import (
    AttnConfig,
    Block,
    FFNConfig,
    ModelConfig,
    SparsityConfig,
)


def _plan(layers, q, kv, hd, ff):
    attn = AttnConfig(q_heads=q, kv_heads=kv, head_dim=hd)
    return ((Block(attn, FFNConfig(d_ff=ff, act="swiglu")), layers),)


def _sparsity(sparse: bool):
    return SparsityConfig() if sparse else None


def config(sparse: bool = True) -> ModelConfig:
    return ModelConfig(
        name="yi-9b",
        vocab_size=64_000,
        d_model=4_096,
        plan=_plan(48, 32, 4, 128, 11_008),
        max_seq=32_768,
        rope_theta=10_000.0,
        sparsity=_sparsity(sparse),
        family="dense",
    )


def reduced(sparse: bool = True) -> ModelConfig:
    return ModelConfig(
        name="yi-9b-reduced",
        vocab_size=512,
        d_model=128,
        plan=_plan(2, 8, 1, 16, 256),
        max_seq=128,
        sparsity=_sparsity(sparse),
        family="dense",
    )
