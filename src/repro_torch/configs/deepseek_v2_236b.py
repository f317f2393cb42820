"""deepseek-v2-236b [moe] - MLA + fine-grained MoE [arXiv:2405.04434].

60L d_model=5120 128H MLA (kv_lora=512, q_lora=1536, rope 64 / nope 128 /
v 128), layer 0 dense FFN (12288), layers 1-59 MoE: 160 routed experts
top-6 (d_expert=1536) + 2 shared. vocab=102400. At 2:4 one MoE layer's
experts hold about 5.7 GB in bf16, so no single card holds the whole
model: it is served as a depth cut, or with its experts split over ranks
(``MoE`` under a mesh, :mod:`repro_torch.parallel.hints`).
"""
from repro_torch.configs.base import (
    AttnConfig,
    Block,
    FFNConfig,
    ModelConfig,
    MoEConfig,
    SparsityConfig,
)


def _blocks(q_heads, kv_lora, q_lora, d_ff_dense, n_exp, top_k, d_expert,
            n_shared, rope_hd=64, nope_hd=128, v_hd=128):
    mla = AttnConfig(kind="mla", q_heads=q_heads, kv_lora_rank=kv_lora,
                     q_lora_rank=q_lora, rope_head_dim=rope_hd,
                     nope_head_dim=nope_hd, v_head_dim=v_hd)
    dense = Block(mla, FFNConfig(d_ff=d_ff_dense, act="swiglu"))
    moe = Block(mla, MoEConfig(n_experts=n_exp, top_k=top_k,
                               d_expert=d_expert, n_shared=n_shared))
    return dense, moe


def _sparsity(sparse: bool):
    return SparsityConfig() if sparse else None


def config(sparse: bool = True) -> ModelConfig:
    dense, moe = _blocks(128, 512, 1_536, 12_288, 160, 6, 1_536, 2)
    return ModelConfig(
        name="deepseek-v2-236b",
        vocab_size=102_400,
        d_model=5_120,
        plan=((dense, 1), (moe, 59)),
        max_seq=131_072,
        rope_theta=10_000.0,
        sparsity=_sparsity(sparse),
        family="moe",
    )


def reduced(sparse: bool = True) -> ModelConfig:
    dense, moe = _blocks(4, 32, 48, 256, 8, 2, 64, 1,
                         rope_hd=8, nope_hd=16, v_hd=16)
    return ModelConfig(
        name="deepseek-v2-236b-reduced",
        vocab_size=512,
        d_model=128,
        plan=((dense, 1), (moe, 2)),
        max_seq=128,
        sparsity=_sparsity(sparse),
        family="moe",
    )
