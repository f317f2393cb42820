"""Model assembly (port of ``repro.models.transformer``, attention + FFN
blocks): blocks -> LM.

The JAX package stacks each group's params on a leading layer axis and
scans them; here every layer is its own module in an ``nn.ModuleList``
and the forward is a Python loop. The cache is a list with one
``{"k", "v"}`` dict per layer, written in place.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import Block, FFNConfig, ModelConfig
from repro_torch.models.attention import (
    GQA,
    _check_cache_len,
    gqa_empty_cache,
)
from repro_torch.models.cache import CacheView, cache_write_index
from repro_torch.models.common import (
    Embedding,
    Linear,
    RMSNorm,
    check_quantize,
    linear_init,
    resolve_device,
    rope_tables,
)
from repro_torch.models.ffn import FFN


class TransformerBlock(nn.Module):
    """Pre-norm residual block: x + attn(norm1(x)), then + ffn(norm2(x))."""

    def __init__(self, block: Block, norm1, mixer: GQA, norm2=None,
                 mlp: Optional[FFN] = None, eps: float = 1e-5):
        super().__init__()
        self.block = block
        self.norm1 = RMSNorm(norm1, eps)
        self.mixer = mixer
        self.norm2 = RMSNorm(norm2, eps) if norm2 is not None else None
        self.mlp = mlp

    @classmethod
    def init(cls, gen: torch.Generator, block: Block, cfg: ModelConfig,
             dtype, quantize: Optional[str] = None) -> "TransformerBlock":
        d = cfg.d_model
        ones = torch.ones(d, dtype=dtype, device=gen.device)
        mixer = GQA.init(gen, d, block.mixer, sp=cfg.sparsity, dtype=dtype,
                         quantize=quantize)
        mlp = norm2 = None
        if isinstance(block.mlp, FFNConfig):
            norm2 = ones.clone()
            mlp = FFN.init(gen, d, block.mlp, sp=cfg.sparsity, dtype=dtype,
                           quantize=quantize)
        return cls(block, ones, mixer, norm2, mlp, cfg.norm_eps)

    def forward(self, x, *, view: CacheView, cache: Optional[dict],
                rope_theta: float, chunk: int, rope: Optional[tuple] = None):
        x = x + self.mixer(self.norm1(x), view=view, cache=cache,
                           rope_theta=rope_theta, chunk=chunk, rope=rope)
        if self.mlp is not None:
            x = x + self.mlp(self.norm2(x))
        return x


class LM(nn.Module):
    """Decoder-only language model.

    ``LM.init(cfg, seed=..., dtype=..., device=..., quantize=...)``
    makes random weights on the device from one ``torch.Generator``
    (pruned and compressed layer by layer); ``repro_torch.interop``
    builds one from a JAX param tree. ``dtype`` is the model dtype:
    weights, activations and the cache. ``quantize="int8"`` stores every
    compressed weight as int8 with per-output-channel absmax scales,
    quantized from its f32 values before any cast to ``dtype`` (as
    ``quantize_tree`` does on the JAX package's f32 params), so no copy
    in the model dtype is ever held.
    """

    def __init__(self, cfg: ModelConfig, embed: Embedding,
                 layers: list[TransformerBlock], final_norm: torch.Tensor,
                 lm_head: Optional[torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        self.embed = embed
        self.layers = nn.ModuleList(layers)
        self.final_norm = RMSNorm(final_norm, cfg.norm_eps)
        self.lm_head = Linear(lm_head) if lm_head is not None else None

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.table.dtype

    @classmethod
    def init(cls, cfg: ModelConfig, *, seed: int = 0, dtype=torch.bfloat16,
             device="cuda", quantize: Optional[str] = None) -> "LM":
        check_quantize(quantize)
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        embed = Embedding.init(gen, cfg.vocab_size, cfg.d_model, dtype)
        lm_head = None
        if not cfg.tie_embeddings:  # dense, computed in f32: stored in f32
            lm_head = linear_init(gen, cfg.d_model, cfg.vocab_size,
                                  dtype=torch.float32)
        layers = [TransformerBlock.init(gen, blk, cfg, dtype, quantize)
                  for blk, rep in cfg.plan for _ in range(rep)]
        final_norm = torch.ones(cfg.d_model, dtype=dtype, device=dev)
        return cls(cfg, embed, layers, final_norm, lm_head)

    def init_cache(self, batch: int, max_seq: int, dtype=None) -> list:
        dtype = dtype or self.dtype
        return [gqa_empty_cache(batch, max_seq, layer.block.mixer, dtype,
                                self.device) for layer in self.layers]

    def _positions(self, view: CacheView, b: int, s: int,
                   max_seq: Optional[int]):
        """Checks offsets on the host, then moves them, the positions and
        the cache write index to the device once for all layers."""
        dev = self.device
        pos = view.positions
        if view.offset_mode:
            cl = view.cache_len
            if max_seq is not None:
                _check_cache_len(cl.cpu(), s, max_seq)
            cl = cl.to(dev, torch.long)
            if pos is None:
                ar = torch.arange(s, device=dev)
                pos = cl[:, None] + ar[None, :] if cl.dim() == 1 else ar + cl
            view = view.replace(cache_len=cl)
        elif view.mode == "prefill" and max_seq is not None:
            _check_cache_len(torch.tensor(0), s, max_seq)
        if pos is None:
            pos = torch.arange(s, device=dev)
        view = view.replace(positions=pos.to(dev))
        if view.mode != "train" and max_seq is not None:
            view = view.replace(
                write_index=cache_write_index(view, b, s, dev))
        return view

    def forward(self, tokens: torch.Tensor, *,
                view: Optional[CacheView] = None,
                caches: Optional[list] = None):
        """tokens (B, S) -> (f32 logits (B, S, V), caches). The caches
        are written in place (the slots of ``view.write_mask``) and the
        same list is returned."""
        view = view or CacheView.train()
        cfg = self.cfg
        b, s = tokens.shape
        max_seq = caches[0]["k"].shape[1] if caches else None
        view = self._positions(view, b, s, max_seq)
        x = self.embed(tokens.to(self.device))
        tables = {}  # rope (cos, sin) per (head_dim, theta), shared by layers
        for i, layer in enumerate(self.layers):
            mx = layer.block.mixer
            theta = mx.rope_theta or cfg.rope_theta
            key = (mx.head_dim, theta)
            if mx.rope and key not in tables:
                tables[key] = rope_tables(view.positions, *key)
            x = layer(x, view=view,
                      cache=caches[i] if caches is not None else None,
                      rope_theta=theta, chunk=cfg.attn_chunk,
                      rope=tables.get(key))
        x = self.final_norm(x)
        if self.lm_head is None:
            logits = self.embed.attend(x)
        else:
            logits = self.lm_head(x, compute_dtype=torch.float32)
        return logits, caches
