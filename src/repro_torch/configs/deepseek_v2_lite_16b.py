"""deepseek-v2-lite-16b [moe] - MLA + MoE [arXiv:2405.04434].

27L d_model=2048 16H MLA (kv_lora=512, no q compression), layer 0 dense
FFN (10944), layers 1-26 MoE: 64 routed top-6 (d_expert=1408) + 2 shared.
vocab=102400.
"""
from repro_torch.configs.base import (
    AttnConfig,
    Block,
    FFNConfig,
    ModelConfig,
    MoEConfig,
    SparsityConfig,
)


def _blocks(q_heads, kv_lora, d_ff_dense, n_exp, top_k, d_expert, n_shared,
            rope_hd=64, nope_hd=128, v_hd=128):
    mla = AttnConfig(kind="mla", q_heads=q_heads, kv_lora_rank=kv_lora,
                     q_lora_rank=None, rope_head_dim=rope_hd,
                     nope_head_dim=nope_hd, v_head_dim=v_hd)
    dense = Block(mla, FFNConfig(d_ff=d_ff_dense, act="swiglu"))
    moe = Block(mla, MoEConfig(n_experts=n_exp, top_k=top_k,
                               d_expert=d_expert, n_shared=n_shared))
    return dense, moe


def _sparsity(sparse: bool):
    return SparsityConfig() if sparse else None


def config(sparse: bool = True) -> ModelConfig:
    dense, moe = _blocks(16, 512, 10_944, 64, 6, 1_408, 2)
    return ModelConfig(
        name="deepseek-v2-lite-16b",
        vocab_size=102_400,
        d_model=2_048,
        plan=((dense, 1), (moe, 26)),
        max_seq=131_072,
        rope_theta=10_000.0,
        sparsity=_sparsity(sparse),
        family="moe",
    )


def reduced(sparse: bool = True) -> ModelConfig:
    dense, moe = _blocks(4, 32, 256, 8, 2, 64, 1, rope_hd=8, nope_hd=16,
                         v_hd=16)
    return ModelConfig(
        name="deepseek-v2-lite-16b-reduced",
        vocab_size=512,
        d_model=128,
        plan=((dense, 1), (moe, 2)),
        max_seq=128,
        sparsity=_sparsity(sparse),
        family="moe",
    )
