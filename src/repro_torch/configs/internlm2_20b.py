"""internlm2-20b [dense] - GQA [arXiv:2403.17297].

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92544, rope theta 1e6.
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
        name="internlm2-20b",
        vocab_size=92_544,
        d_model=6_144,
        plan=_plan(48, 48, 8, 128, 16_384),
        max_seq=32_768,
        rope_theta=1_000_000.0,
        sparsity=_sparsity(sparse),
        family="dense",
    )


def reduced(sparse: bool = True) -> ModelConfig:
    return ModelConfig(
        name="internlm2-20b-reduced",
        vocab_size=512,
        d_model=128,
        plan=_plan(2, 8, 2, 16, 256),
        max_seq=128,
        sparsity=_sparsity(sparse),
        family="dense",
    )
