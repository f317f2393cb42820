"""whisper-medium [audio] - encoder-decoder [arXiv:2212.04356].

24L encoder + 24L decoder, d_model=1024 16H (kv=16) d_ff=4096
vocab=51865. The conv frontend is not modelled: the encoder takes frame
embeddings (B, 1500, 1024). As in the JAX package: RMSNorm for
LayerNorm, learned encoder positions for sinusoidal ones, no biases.
"""
from repro_torch.configs.base import (
    AttnConfig,
    Block,
    FFNConfig,
    ModelConfig,
    SparsityConfig,
)


def _plans(layers, q, kv, hd, ff):
    dec_attn = AttnConfig(q_heads=q, kv_heads=kv, head_dim=hd, rope=False,
                          causal=True)
    enc_attn = AttnConfig(q_heads=q, kv_heads=kv, head_dim=hd, rope=False,
                          causal=False)
    ffn = FFNConfig(d_ff=ff, act="gelu")
    dec = ((Block(dec_attn, ffn, cross_attn=True), layers),)
    enc = ((Block(enc_attn, ffn), layers),)
    return dec, enc


def _sparsity(sparse: bool):
    return SparsityConfig() if sparse else None


def config(sparse: bool = True) -> ModelConfig:
    dec, enc = _plans(24, 16, 16, 64, 4_096)
    return ModelConfig(
        name="whisper-medium",
        vocab_size=51_865,
        d_model=1_024,
        plan=dec,
        encoder_plan=enc,
        encoder_inputs="embeddings",
        encoder_seq=1_500,
        pos_embed="learned",
        max_seq=32_768,  # decoder positions extended, as the JAX config's
        sparsity=_sparsity(sparse),
        family="audio",
    )


def reduced(sparse: bool = True) -> ModelConfig:
    dec, enc = _plans(2, 4, 4, 16, 256)
    return ModelConfig(
        name="whisper-medium-reduced",
        vocab_size=512,
        d_model=64,
        plan=dec,
        encoder_plan=enc,
        encoder_inputs="embeddings",
        encoder_seq=24,
        pos_embed="learned",
        max_seq=128,
        sparsity=_sparsity(sparse),
        family="audio",
    )
