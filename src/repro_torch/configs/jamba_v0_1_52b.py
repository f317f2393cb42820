"""jamba-v0.1-52b [hybrid] - Mamba + attention 1:7, MoE [arXiv:2403.19887].

32L d_model=4096, attention at layer i % 8 == 4 (32 heads, GQA kv=8, no
rope), Mamba elsewhere (d_state=16, conv=4, expand=2, dt_rank=256); MoE
(16 experts top-2, d_expert=14336, no shared expert) on odd layers, a
dense FFN (14336) on even ones. Plan: one 8-layer period repeated 4x. No
positional embedding (the recurrence carries position). vocab=65536.
"""
from repro_torch.configs.base import (
    AttnConfig,
    Block,
    FFNConfig,
    MambaConfig,
    ModelConfig,
    MoEConfig,
    SparsityConfig,
)


def _period(q, kv, hd, ff, n_exp, top_k, d_expert, d_state, dt_rank):
    attn = AttnConfig(q_heads=q, kv_heads=kv, head_dim=hd, rope=False)
    mam = MambaConfig(d_state=d_state, d_conv=4, expand=2, dt_rank=dt_rank)
    ffn = FFNConfig(d_ff=ff, act="swiglu")
    moe = MoEConfig(n_experts=n_exp, top_k=top_k, d_expert=d_expert,
                    n_shared=0)
    # layer i of the period: attention iff i == 4; MoE iff i is odd
    return tuple(Block(attn if i == 4 else mam, moe if i % 2 == 1 else ffn)
                 for i in range(8))


def _sparsity(sparse: bool):
    return SparsityConfig() if sparse else None


def config(sparse: bool = True) -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b",
        vocab_size=65_536,
        d_model=4_096,
        plan=((_period(32, 8, 128, 14_336, 16, 2, 14_336, 16, 256), 4),),
        max_seq=1_048_576,
        pos_embed="none",
        sparsity=_sparsity(sparse),
        family="hybrid",
    )


def reduced(sparse: bool = True) -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b-reduced",
        vocab_size=512,
        d_model=128,
        plan=((_period(4, 2, 16, 256, 4, 2, 256, 8, 16), 1),),
        max_seq=128,
        pos_embed="none",
        sparsity=_sparsity(sparse),
        family="hybrid",
    )
