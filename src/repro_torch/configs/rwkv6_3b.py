"""rwkv6-3b [ssm] - Finch, data-dependent decay [arXiv:2404.05892].

32L d_model=2560 (attention-free, 40 heads of 64) d_ff=8960 vocab=65536.
O(1) state per layer: the cache is each layer's WKV state and the last
token of its two token shifts. Every r/k/v/g/o and channel-mix GEMM is
N:M-eligible.
"""
from repro_torch.configs.base import (
    Block,
    FFNConfig,
    ModelConfig,
    RWKVConfig,
    SparsityConfig,
)


def _plan(layers, d_ff, head_dim=64, decay_lora=64, mix_lora=32):
    blk = Block(RWKVConfig(head_dim=head_dim, decay_lora=decay_lora,
                           mix_lora=mix_lora), FFNConfig(d_ff=d_ff))
    return ((blk, layers),)


def _sparsity(sparse: bool):
    return SparsityConfig() if sparse else None


def config(sparse: bool = True) -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b",
        vocab_size=65_536,
        d_model=2_560,
        plan=_plan(32, 8_960),
        max_seq=1_048_576,  # the state is O(1); the cap is nominal
        pos_embed="none",
        sparsity=_sparsity(sparse),
        family="ssm",
    )


def reduced(sparse: bool = True) -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b-reduced",
        vocab_size=512,
        d_model=128,
        plan=_plan(2, 256, head_dim=32, decay_lora=16, mix_lora=8),
        max_seq=128,
        pos_embed="none",
        sparsity=_sparsity(sparse),
        family="ssm",
    )
