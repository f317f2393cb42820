"""Model assembly (port of ``repro.models.transformer``: attention,
Mamba or RWKV mixers; FFN or MoE MLPs; an encoder and cross-attention
for an encoder-decoder): blocks -> LM.

The JAX package stacks each group's params on a leading layer axis and
scans them (a group's entry may be a period of several Blocks, as
jamba's 8 layers); here every layer is its own module in an
``nn.ModuleList``, periods and repeats unrolled in order, and the
forward is a Python loop. The cache is a list with one dict per layer,
of its mixer's kind (``{"k", "v"}`` for GQA, ``{"ckv", "kr"}`` for MLA,
``{"conv", "ssm"}`` for Mamba, ``{"wkv", "tm_last", "cm_last"}`` for
RWKV), written in place; a cross-attention block's also holds
``{"cross_k", "cross_v"}``, the projections of the encoder's frames,
written at prefill and read at decode. The attention caches bound the
positions a slot holds; a model without attention has no bound but the
scheduler's.

An encoder-decoder (whisper: ``cfg.encoder_plan``) encodes its
``enc_input`` (token ids, or frame embeddings cast to the compute
dtype) at train and prefill only (:meth:`LM.encode`); each decoder
block then projects the encoder's output through its cross-attention's
``wk`` / ``wv`` and attends to it, and at decode reads those K/V from
its cache.

Training (``LM.loss``) runs the same forward in the train view; with
``remat`` each layer is a ``torch.utils.checkpoint`` region: ``"full"``
keeps only the layer's input, ``"dots"`` also keeps the outputs of the
products without batch dims (``aten.mm`` / ``addmm``: the dense and
masked linears, the router and the head; the JAX package's
``dots_with_no_batch_dims_saveable``). The N:M projections are an
autograd Function around a hand-written kernel, not an aten product, so
under ``"dots"`` they are recomputed, as under ``"full"``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import (
    AttnConfig,
    Block,
    FFNConfig,
    MambaConfig,
    ModelConfig,
    MoEConfig,
    RWKVConfig,
)
from repro_torch.models.attention import (
    GQA,
    MLA,
    _check_cache_len,
    attn_empty_cache,
    cross_empty_cache,
)
from repro_torch.models.cache import (
    CacheView,
    cache_write_index,
    clear_state,
    paged_write_index,
    write_state,
)
from repro_torch.models.common import (
    Embedding,
    LearnedPositions,
    Linear,
    RMSNorm,
    check_quantize,
    linear_init,
    make_generator,
    resolve_device,
    rope_tables,
)
from repro_torch.models.ffn import FFN
from repro_torch.models.mamba import Mamba, mamba_empty_cache
from repro_torch.models.moe import MoE
from repro_torch.models.rwkv import RWKV, rwkv_empty_cache
from repro_torch.parallel.hints import tp_context, tp_copy

# tp_reduce's tags
REDUCE_TAGS = frozenset({"attn_out", "ffn_down", "ssm_x", "ssm_out",
                         "moe_out"})


class TransformerBlock(nn.Module):
    """Pre-norm residual block: x + mixer(norm1(x)), then + mlp(norm2(x))
    where the mixer is attention (GQA or MLA), Mamba or RWKV and the MLP
    an FFN or an MoE. An RWKV block has no ``norm2`` / ``mlp``: its
    channel-mix, normed by its own ``cm_norm``, takes their place. A
    ``cross_attn`` block adds x + cross(norm_cross(x)) between the two,
    ``cross`` a GQA of the mixer's shape over the encoder's output.
    ``forward`` returns (x, aux): the MoE's load-balance loss with
    ``with_aux``, else None."""

    def __init__(self, block: Block, norm1, mixer: nn.Module, norm2=None,
                 mlp: Optional[nn.Module] = None, eps: float = 1e-5, *,
                 norm_cross=None, cross: Optional[GQA] = None):
        super().__init__()
        self.block = block
        self.norm1 = RMSNorm(norm1, eps)
        self.mixer = mixer
        if (norm_cross is None) != (cross is None) or (
                cross is not None) != block.cross_attn:
            raise ValueError("a cross_attn block takes norm_cross and "
                             "cross, any other block neither")
        self.norm_cross = (RMSNorm(norm_cross, eps) if norm_cross is not None
                           else None)
        self.cross = cross
        self.norm2 = RMSNorm(norm2, eps) if norm2 is not None else None
        self.mlp = mlp

    @classmethod
    def init(cls, gen: torch.Generator, block: Block, cfg: ModelConfig,
             dtype, quantize: Optional[str] = None,
             experts: Optional[tuple[int, int]] = None) -> "TransformerBlock":
        """Random weights from ``gen``; ``experts`` (rank, ranks): an MoE
        keeps only that rank's experts (``MoE.init``)."""
        d = cfg.d_model
        ones = torch.ones(d, dtype=dtype, device=gen.device)
        mx, kw = block.mixer, dict(sp=cfg.sparsity, dtype=dtype,
                                   quantize=quantize)
        if isinstance(mx, RWKVConfig):
            mixer = RWKV.init(gen, d, mx, d_ff=block.mlp.d_ff,
                              eps=cfg.norm_eps, **kw)
            return cls(block, ones, mixer, eps=cfg.norm_eps)
        if isinstance(mx, MambaConfig):
            mixer = Mamba.init(gen, d, mx, **kw)
        else:
            mixer = (MLA if mx.kind == "mla" else GQA).init(gen, d, mx, **kw)
        cross = {}
        if block.cross_attn:
            cross = dict(norm_cross=ones.clone(),
                         cross=GQA.init(gen, d, mx, **kw))
        mlp = norm2 = None
        if isinstance(block.mlp, (FFNConfig, MoEConfig)):
            norm2 = ones.clone()
            if isinstance(block.mlp, MoEConfig):
                mlp = MoE.init(gen, d, block.mlp, experts=experts, **kw)
            else:
                mlp = FFN.init(gen, d, block.mlp, **kw)
        return cls(block, ones, mixer, norm2, mlp, cfg.norm_eps, **cross)

    def empty_cache(self, batch: int, max_seq: int, dtype, device,
                    enc_seq: Optional[int] = None) -> dict:
        """This layer's empty cache: attention's rows for ``max_seq``
        positions (and, for a cross block, the K/V of ``enc_seq``
        encoder frames), or a recurrent mixer's state (Mamba's in
        f32)."""
        mx, d = self.block.mixer, self.norm1.scale.shape[0]
        if isinstance(mx, MambaConfig):
            return mamba_empty_cache(batch, d, mx, device)
        if isinstance(mx, RWKVConfig):
            return rwkv_empty_cache(batch, d, mx, dtype, device)
        cache = attn_empty_cache(batch, max_seq, mx, dtype, device)
        if self.cross is not None:
            if enc_seq is None:
                raise ValueError("a cross_attn block's cache needs enc_seq")
            cache.update(cross_empty_cache(batch, enc_seq, mx, dtype,
                                           device))
        return cache

    def forward(self, x, *, view: CacheView, cache: Optional[dict],
                rope_theta: float, chunk: int, rope: Optional[tuple] = None,
                with_aux: bool = False,
                enc_out: Optional[torch.Tensor] = None):
        x = x + self.mixer(self.norm1(x), view=view, cache=cache,
                           rope_theta=rope_theta, chunk=chunk, rope=rope)
        if self.cross is not None:
            x = x + self._cross(x, view, cache, chunk, enc_out)
        aux = None
        if isinstance(self.mixer, RWKV):
            x = x + self.mixer.channel_mix(x, view=view, cache=cache)
        elif isinstance(self.mlp, MoE):
            y, aux = self.mlp(self.norm2(x), with_aux=with_aux)
            x = x + y
        elif self.mlp is not None:
            x = x + self.mlp(self.norm2(x))
        return x, aux

    def _cross(self, x, view: CacheView, cache: Optional[dict], chunk: int,
               enc_out: Optional[torch.Tensor]):
        """Cross-attention: at train and prefill over ``enc_out``'s
        projections (written to the cache at prefill, the slots of the
        view's write mask only), at decode over the cached ones."""
        cross, mx = self.cross, self.block.mixer
        if view.mode in ("train", "prefill"):
            if enc_out is None:
                raise ValueError(f"{view.mode} of a cross-attention block "
                                 "needs the encoder's output (enc_input)")
            b, t = enc_out.shape[:2]
            k = cross.wk(enc_out).reshape(b, t, mx.kv_heads, mx.head_dim)
            v = cross.wv(enc_out).reshape(b, t, mx.kv_heads, mx.head_dim)
            if view.mode == "prefill":
                if cache is None:
                    raise ValueError("prefill mode needs a cache")
                write_state(cache["cross_k"], k, view.write_mask)
                write_state(cache["cross_v"], v, view.write_mask)
        else:
            k, v = cache["cross_k"], cache["cross_v"]
        return cross(self.norm_cross(x), view=view, cache=None,
                     rope_theta=0.0, chunk=chunk, cross_kv=(k, v))


REMAT = ("none", "dots", "full")
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_context():
    return create_selective_checkpoint_contexts(_save_dots)


class LM(nn.Module):
    """Language model: a decoder, and for an encoder-decoder config an
    encoder (``enc_layers``, ``enc_pos``, ``enc_final_norm`` and, for
    token inputs, ``enc_embed``); ``pos`` is the decoder's learned
    position table (``pos_embed="learned"``). A tied config has no
    ``lm_head``: the embedding table is the head (:meth:`Embedding.attend`).

    ``LM.init(cfg, seed=..., dtype=..., device=..., quantize=...)``
    makes random weights on the device from one ``torch.Generator``
    (pruned and compressed layer by layer); ``repro_torch.interop``
    builds one from a JAX param tree. ``dtype`` is the model dtype:
    weights, activations and the cache. ``quantize="int8"`` stores every
    compressed weight as int8 with per-output-channel absmax scales,
    quantized from its f32 values before any cast to ``dtype`` (as
    ``quantize_tree`` does on the JAX package's f32 params), so no copy
    in the model dtype is ever held.

    :meth:`set_compute_dtype` splits the two, as the JAX package trains:
    weights stored in ``dtype`` (f32), activations in the compute dtype
    (bf16), every weight cast to it for its product. ``LM.dtype`` is
    then the compute dtype (activations and cache).
    """

    tp_plan = None  # a tensor-parallel shard's ServeTPPlan (parallel/)

    def __init__(self, cfg: ModelConfig, embed: Embedding,
                 layers: list[TransformerBlock], final_norm: torch.Tensor,
                 lm_head: Optional[torch.Tensor], *,
                 pos: Optional[torch.Tensor] = None,
                 enc_layers: Optional[list[TransformerBlock]] = None,
                 enc_pos: Optional[torch.Tensor] = None,
                 enc_final_norm: Optional[torch.Tensor] = None,
                 enc_embed: Optional[Embedding] = None):
        super().__init__()
        self.cfg = cfg
        self.embed = embed
        if (pos is not None) != (cfg.pos_embed == "learned"):
            raise ValueError("pos (the learned position table) is given "
                             "exactly when cfg.pos_embed is 'learned'")
        self.pos = LearnedPositions(pos) if pos is not None else None
        self.layers = nn.ModuleList(layers)
        self.final_norm = RMSNorm(final_norm, cfg.norm_eps)
        self.lm_head = Linear(lm_head) if lm_head is not None else None
        encoder = cfg.encoder_plan is not None
        if encoder != (enc_layers is not None and enc_pos is not None
                       and enc_final_norm is not None) or (
                (enc_embed is not None)
                != (encoder and cfg.encoder_inputs == "tokens")):
            raise ValueError("an encoder-decoder config takes enc_layers, "
                             "enc_pos, enc_final_norm (and enc_embed for "
                             "token inputs); any other config none")
        self.enc_layers = nn.ModuleList(enc_layers) if encoder else None
        self.enc_pos = LearnedPositions(enc_pos) if encoder else None
        self.enc_final_norm = (RMSNorm(enc_final_norm, cfg.norm_eps)
                               if encoder else None)
        self.enc_embed = enc_embed

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.compute_dtype or self.embed.table.dtype

    def set_compute_dtype(self, dtype) -> "LM":
        """Compute in ``dtype`` (None: each weight's own dtype): the
        embedding lookup and every linear but those computed in f32 by
        design (the router, the head) cast their weight to it. Returns
        the model."""
        for mod in self.modules():
            if isinstance(mod, (Linear, Embedding)):
                mod.compute_dtype = dtype
        return self

    @classmethod
    def init(cls, cfg: ModelConfig, *, seed: int = 0, dtype=torch.bfloat16,
             device="cuda", quantize: Optional[str] = None,
             layer_fn: Optional[Callable] = None,
             enc_layer_fn: Optional[Callable] = None,
             experts: Optional[tuple[int, int]] = None) -> "LM":
        """Random weights from ``seed`` (class docstring). ``layer_fn(i,
        layer)`` takes each decoder layer as it is made and returns the
        layer to keep, before the next is made (a rank slicing its
        shard, :func:`repro_torch.parallel.sharding.init_sharded`);
        ``enc_layer_fn`` does the same for an encoder's layers;
        ``experts`` (rank, ranks) keeps only that rank's experts of each
        MoE layer (``MoE.init``)."""
        check_quantize(quantize)
        dev = resolve_device(device)
        gen = make_generator(dev, seed)
        embed = Embedding.init(gen, cfg.vocab_size, cfg.d_model, dtype)
        d, enc = cfg.d_model, {}
        if cfg.pos_embed == "learned":
            enc["pos"] = LearnedPositions.init(gen, cfg.max_seq, d,
                                               dtype).table.data
        lm_head = None
        if not cfg.tie_embeddings:  # dense, computed in f32: stored in f32
            lm_head = linear_init(gen, cfg.d_model, cfg.vocab_size,
                                  dtype=torch.float32)
        layers = []
        for i, blk in enumerate(cfg.blocks()):
            layer = TransformerBlock.init(gen, blk, cfg, dtype, quantize,
                                          experts)
            layers.append(layer_fn(i, layer) if layer_fn else layer)
        final_norm = torch.ones(cfg.d_model, dtype=dtype, device=dev)
        if cfg.encoder_plan is not None:
            enc_layers = []
            for i, blk in enumerate(cfg.encoder_blocks()):
                layer = TransformerBlock.init(gen, blk, cfg, dtype, quantize)
                enc_layers.append(enc_layer_fn(i, layer) if enc_layer_fn
                                  else layer)
            enc.update(
                enc_layers=enc_layers,
                enc_pos=LearnedPositions.init(gen, cfg.encoder_seq, d,
                                              dtype).table.data,
                enc_final_norm=torch.ones(d, dtype=dtype, device=dev))
            if cfg.encoder_inputs == "tokens":
                enc["enc_embed"] = Embedding.init(gen, cfg.vocab_size, d,
                                                  dtype)
        return cls(cfg, embed, layers, final_norm, lm_head, **enc)

    def init_cache(self, batch: int, max_seq: int, dtype=None) -> list:
        """One empty cache a layer, of its mixer's kind (a cross block's
        with the K/V of ``cfg.encoder_seq`` frames)."""
        dtype = dtype or self.dtype
        return [layer.empty_cache(batch, max_seq, dtype, self.device,
                                  enc_seq=self.cfg.encoder_seq)
                for layer in self.layers]

    def attn_cache(self, caches: Optional[list]) -> Optional[torch.Tensor]:
        """A self-attention leaf of the first attention layer's cache
        (``k`` or MLA's ``ckv``, never a cross block's ``cross_k``), (B,
        S, ...) (a paged pool's (rows, page_size, ...)): its second dim
        bounds the positions a slot holds. None without caches or
        attention."""
        for layer, cache in zip(self.layers, caches or ()):
            if isinstance(layer.block.mixer, AttnConfig):
                return next(v for k, v in cache.items()
                            if not k.startswith("cross_"))
        return None

    def reset_state(self, caches: list, write_mask=None) -> None:
        """Zero the recurrent state (Mamba's conv and ssm, RWKV's wkv,
        tm_last and cm_last) of the slots in ``write_mask`` (every slot
        when None), in place; attention caches are left as they are. A
        serving engine calls it before a from-zero prefill, so a slot's
        new request does not start from its last occupant's state."""
        for layer, cache in zip(self.layers, caches):
            if not isinstance(layer.block.mixer, AttnConfig):
                for leaf in cache.values():
                    clear_state(leaf, write_mask)

    def _positions(self, view: CacheView, b: int, s: int,
                   caches: Optional[list], host_checked: bool):
        """Checks offsets on the host (unless the caller did), then moves
        them, the positions, the write mask, the block table and the
        cache write index to the device once for all layers. The bound
        is the attention caches' length (a paged view's: pages_per_slot
        * page_size) and a learned position table's rows; a model with
        neither has none."""
        dev = self.device
        first = self.attn_cache(caches)
        max_seq = first.shape[1] if first is not None else None
        if view.paged and max_seq is not None:
            max_seq *= view.block_table.shape[1]
        if self.pos is not None:  # the learned table's rows bound it too
            max_seq = min(max_seq or self.cfg.max_seq, self.cfg.max_seq)
        pos = view.positions
        if view.offset_mode:
            cl = view.cache_len
            if max_seq is not None and not host_checked:
                _check_cache_len(cl.cpu(), s, max_seq)
            cl = cl.to(dev, torch.long)
            if pos is None:
                ar = torch.arange(s, device=dev)
                pos = cl[:, None] + ar[None, :] if cl.dim() == 1 else ar + cl
            view = view.replace(cache_len=cl)
        elif max_seq is not None:  # prefill, or train with learned positions
            _check_cache_len(torch.tensor(0), s, max_seq)
        if pos is None:
            pos = torch.arange(s, device=dev)
        view = view.replace(positions=pos.to(dev))
        if view.write_mask is not None:
            view = view.replace(write_mask=view.write_mask.to(dev))
        if view.paged:
            table = view.block_table.to(dev, torch.long)
            view = view.replace(block_table=table)
            if first is not None:
                rows, ps = first.shape[:2]
                view = view.replace(write_index=paged_write_index(
                    view.cache_len, table, view.write_mask, s, rows, ps))
        elif view.mode != "train" and max_seq is not None:
            view = view.replace(
                write_index=cache_write_index(view, b, s, dev))
        return view

    def _run_layers(self, layers, x, view: CacheView, caches, remat: str,
                    with_aux: bool, enc_out=None):
        """x through ``layers`` (each with its cache of ``caches``, or
        none), each layer's rope tables and theta; returns (x, the sum of
        the layers' MoE losses or None)."""
        cfg, aux = self.cfg, None
        tables = {}  # rope (cos, sin) per (rope dims, theta), shared by layers
        for i, layer in enumerate(layers):
            mx = layer.block.mixer
            theta, rope = cfg.rope_theta, None
            if isinstance(mx, AttnConfig):
                theta = mx.rope_theta or cfg.rope_theta
                key = (mx.rope_head_dim if mx.kind == "mla" else mx.head_dim,
                       theta)
                if (mx.rope or mx.kind == "mla") and key not in tables:
                    tables[key] = rope_tables(view.positions, *key)
                rope = tables.get(key)
            run = functools.partial(
                layer, view=view,
                cache=caches[i] if caches is not None else None,
                rope_theta=theta, chunk=cfg.attn_chunk, rope=rope,
                with_aux=with_aux, enc_out=enc_out)
            if (remat != "none" and view.mode == "train"
                    and torch.is_grad_enabled()):
                x, layer_aux = checkpoint(
                    run, x, use_reentrant=False,
                    **({"context_fn": _remat_context} if remat == "dots"
                       else {}))
            else:
                x, layer_aux = run(x)
            if layer_aux is not None:
                aux = layer_aux if aux is None else aux + layer_aux
        return x, aux

    def encode(self, enc_input: torch.Tensor, *,
               remat: str = "none") -> torch.Tensor:
        """The encoder's output (B, encoder_seq', d) of ``enc_input``:
        token ids (B, S') through ``enc_embed``, or frame embeddings (B,
        S', d) cast to the compute dtype; plus the learned positions of
        0..S'-1, the encoder's layers (not causal, no cache) and its
        final norm.

        In tensor-parallel training the output's gradient is summed over
        the "model" ranks here (``tp_copy``, tag "enc_out"): only the
        cross blocks read it, each through its rank's K/V heads, so one
        sum at the output is the sum of every cross block's partial
        gradients."""
        cfg = self.cfg
        if cfg.encoder_plan is None:
            raise ValueError(f"{cfg.name} has no encoder")
        enc_input = enc_input.to(self.device)
        if cfg.encoder_inputs == "tokens":
            x = self.enc_embed(enc_input)
        else:
            x = enc_input.to(self.dtype)
        s = x.shape[1]
        positions = torch.arange(s, device=self.device)
        x = self.enc_pos(x, positions)
        x, _ = self._run_layers(self.enc_layers, x,
                                CacheView.train(positions), None, remat,
                                False)
        return tp_copy(self.enc_final_norm(x), "enc_out")

    def forward(self, tokens: torch.Tensor, *,
                view: Optional[CacheView] = None,
                caches: Optional[list] = None, last_only: bool = False,
                host_checked: bool = False, with_aux: bool = False,
                remat: str = "none",
                enc_input: Optional[torch.Tensor] = None):
        """tokens (B, S) -> (f32 logits (B, S, V), caches). The caches
        are written in place (the slots of ``view.write_mask``) and the
        same list is returned. ``with_aux`` returns (logits, caches, aux)
        instead, aux the sum of the MoE layers' load-balance losses (f32,
        zero without MoE), as the JAX package's ``LM.forward`` does.

        ``last_only`` applies the final norm and the head at the last
        position only: logits (B, 1, V), what a serving step samples.
        ``host_checked`` says the caller has checked ``view.cache_len``
        against the cache bounds on the host (a captured serving step,
        whose offsets are already on the card); otherwise the check runs
        here. ``remat`` checkpoints each layer of a train-view forward
        that records gradients (module docstring).

        An encoder-decoder takes ``enc_input`` at train and prefill (the
        encoder runs there only; decode reads the cross K/V its prefill
        cached). ``cfg.logit_softcap`` c caps the logits at tanh(l / c) *
        c."""
        if remat not in REMAT:
            raise ValueError(f"remat {remat!r} not in {REMAT}")
        plan = self.tp_plan
        if plan is not None and plan.reduce_tags and (
                tp_context() is None
                or tp_context()[1] & REDUCE_TAGS != plan.reduce_tags
                or not tp_context()[1] <= plan.train_tags):
            raise RuntimeError(
                f"a tensor-parallel shard ({plan}) runs only under "
                f"parallel.hints.tp_serving(mesh, "
                f"{sorted(plan.reduce_tags)}) (training: "
                f"{sorted(plan.train_tags)}): its row-parallel outputs "
                "are partial sums")
        view = view or CacheView.train()
        cfg = self.cfg
        b, s = tokens.shape
        view = self._positions(view, b, s, caches, host_checked)
        enc_out = None
        if cfg.encoder_plan is not None and view.mode in ("train",
                                                          "prefill"):
            if enc_input is None:
                raise ValueError(f"{cfg.name}: a {view.mode} forward needs "
                                 "enc_input (the encoder's input)")
            enc_out = self.encode(enc_input, remat=remat)
        x = self.embed(tokens.to(self.device))
        if self.pos is not None:
            x = self.pos(x, view.positions)
        x, layer_aux = self._run_layers(self.layers, x, view, caches, remat,
                                        with_aux, enc_out)
        aux = None
        if with_aux:
            aux = torch.zeros((), dtype=torch.float32, device=self.device)
            if layer_aux is not None:
                aux = aux + layer_aux
        if last_only:
            x = x[:, -1:]
        x = self.final_norm(x)
        if self.lm_head is None:
            logits = self.embed.attend(x)
        else:
            logits = self.lm_head(x, compute_dtype=torch.float32)
        if cfg.logit_softcap:
            c = cfg.logit_softcap
            logits = torch.tanh(logits / c) * c
        if with_aux:
            return logits, caches, aux
        return logits, caches

    def loss(self, batch: dict, *, remat: str = "none",
             count: Optional[torch.Tensor] = None):
        """Masked mean next-token NLL plus the MoE load-balance loss (port
        of the JAX ``LM.loss``). batch: ``tokens`` (B, S) and ``labels``
        (B, S), a label below 0 a padding position, and an
        encoder-decoder's ``enc_input``. Returns (loss, {"nll", "aux"}),
        f32 scalars. ``count`` replaces the batch's own count of labels
        as the divisor (a data-parallel rank holding some rows of a
        batch divides its NLL sum by the whole batch's count)."""
        logits, _, aux = self.forward(batch["tokens"],
                                      view=CacheView.train(), with_aux=True,
                                      remat=remat,
                                      enc_input=batch.get("enc_input"))
        labels = batch["labels"].to(logits.device, torch.long)
        mask = (labels >= 0).float()
        lab = labels.clamp(min=0)
        logz = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, lab[..., None])[..., 0]
        nll = (logz - ll) * mask
        if count is None:
            count = mask.sum()
        loss = nll.sum() / count.clamp(min=1.0)
        return loss + aux, {"nll": loss, "aux": aux}


# ---------------------------------------------------------------------------
# parameter counting (the model FLOPs of the dry-run)
# ---------------------------------------------------------------------------


def _once(plan):
    return tuple((entry, 1) for entry, _ in plan) if plan else plan


def _floats(mod: nn.Module) -> int:
    return sum(p.numel() for p in mod.parameters() if p.is_floating_point())


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """The parameters of ``LM.init(cfg)``, counted on the meta device
    without allocating (port of the JAX ``count_params``). Float tensors
    only: the int8 idx tensors are pattern metadata (no FLOPs, no
    gradients). Every layer of a plan entry repeated r times has the
    shapes of the first, so each entry is made once and counted r times.

    active_only: the routed experts beyond ``top_k`` subtracted by the
    JAX package's formula (3 d d_expert a swiglu expert, 2 a gelu one,
    times the expert pattern's density when compressed): the N_active
    of an MoE config's model FLOPs."""
    once = dataclasses.replace(cfg, plan=_once(cfg.plan),
                               encoder_plan=_once(cfg.encoder_plan))
    lm = LM.init(once, device="meta", dtype=torch.float32)
    total = _floats(lm)
    for layers, plan in ((lm.layers, cfg.plan),
                         (lm.enc_layers or (), cfg.encoder_plan or ())):
        it = iter(layers)
        for entry, rep in plan:
            blocks = entry if isinstance(entry, tuple) else (entry,)
            total += (rep - 1) * sum(_floats(next(it)) for _ in blocks)
    if not active_only:
        return total
    sp, inactive = cfg.sparsity, 0
    for entry, rep in cfg.plan:
        for blk in entry if isinstance(entry, tuple) else (entry,):
            if isinstance(blk.mlp, MoEConfig):
                me = blk.mlp
                per_expert = (2 if me.act == "gelu" else 3) \
                    * cfg.d_model * me.d_expert
                if sp is not None and "expert" in sp.targets \
                        and sp.mode == "compressed":
                    nm = sp.nm_for("expert")
                    per_expert = int(per_expert * (nm.n / nm.m))
                inactive += rep * per_expert * (me.n_experts - me.top_k)
    return total - inactive
