"""gemma3-27b [dense] - 5:1 local:global interleave, 128k context
[hf:google/gemma-3-*].

62L d_model=5376 32H (GQA kv=16) d_ff=21504 (GeGLU) vocab=262144,
qk-norm, a sliding window of 1024 on the local layers (rope theta 1e4),
full attention on the global layers (theta 1e6). Plan: 10 periods of
(5 local + 1 global) and a tail of 2 local = 62 layers. Tied embeddings.
"""
from repro_torch.configs.base import (
    AttnConfig,
    Block,
    FFNConfig,
    ModelConfig,
    SparsityConfig,
)


def _blocks(q, kv, hd, ff, window):
    local = AttnConfig(q_heads=q, kv_heads=kv, head_dim=hd, qk_norm=True,
                       window=window, rope_theta=10_000.0)
    glob = AttnConfig(q_heads=q, kv_heads=kv, head_dim=hd, qk_norm=True,
                      window=None, rope_theta=1_000_000.0)
    ffn = FFNConfig(d_ff=ff, act="geglu")
    return Block(local, ffn), Block(glob, ffn)


def _sparsity(sparse: bool):
    return SparsityConfig() if sparse else None


def config(sparse: bool = True) -> ModelConfig:
    b_local, b_glob = _blocks(32, 16, 128, 21_504, 1_024)
    period = (b_local,) * 5 + (b_glob,)
    return ModelConfig(
        name="gemma3-27b",
        vocab_size=262_144,
        d_model=5_376,
        plan=((period, 10), (b_local, 2)),
        max_seq=131_072,
        tie_embeddings=True,
        sparsity=_sparsity(sparse),
        family="dense",
    )


def reduced(sparse: bool = True) -> ModelConfig:
    b_local, b_glob = _blocks(4, 2, 16, 256, 16)
    period = (b_local,) * 5 + (b_glob,)
    return ModelConfig(
        name="gemma3-27b-reduced",
        vocab_size=512,
        d_model=128,
        plan=((period, 1), (b_local, 1)),
        max_seq=128,
        tie_embeddings=True,
        sparsity=_sparsity(sparse),
        family="dense",
    )
