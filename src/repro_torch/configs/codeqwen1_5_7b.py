"""codeqwen1.5-7b [dense] - qwen1.5 architecture [hf:Qwen/CodeQwen1.5-7B].

32L d_model=4096 32H (MHA, kv=32) d_ff=13440 vocab=92416, rope theta 1e6.
Qwen1.5's QKV biases are left out, as in the JAX package.
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
        name="codeqwen1.5-7b",
        vocab_size=92_416,
        d_model=4_096,
        plan=_plan(32, 32, 32, 128, 13_440),
        max_seq=65_536,
        rope_theta=1_000_000.0,
        sparsity=_sparsity(sparse),
        family="dense",
    )


def reduced(sparse: bool = True) -> ModelConfig:
    return ModelConfig(
        name="codeqwen1.5-7b-reduced",
        vocab_size=512,
        d_model=128,
        plan=_plan(2, 4, 4, 32, 256),
        max_seq=128,
        sparsity=_sparsity(sparse),
        family="dense",
    )
