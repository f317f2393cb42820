"""Build the port's modules from a JAX param tree taken as numpy arrays.

The tree has the JAX package's layout, with every array a numpy array
and every ``NMWeight`` leaf replaced by a dict ``{"vals", "idx", "n",
"m", "axis", "mode"}`` (the pair, its N:M pattern, its compressed axis
and its kernel-policy mode); a quantized ``QNMWeight`` leaf carries
``"scales"`` too and becomes a :class:`QNMWeight` with its int8 values
kept int8; a masked ``MaskedNMWeight`` leaf is the dict ``{"w", "n",
"m", "axis"}`` and becomes a :class:`MaskedNMWeight`. The axis is
carried over as it is: a gather-port weight (axis 1, the paper's A
orientation) keeps its rows compressed and its int8 scales per row,
``(Mr,)``. The caller flattens the JAX side;
nothing here imports JAX. Each plan group's params are stacked on a
leading layer axis when the group repeats; they are unstacked here into
one module per layer. An MoE layer's experts are one ``vmap`` tree with a
leading expert axis; they are split into one :class:`FFN` each, the
shared experts become one :class:`FFN` and the router a dense f32
weight. MLA's per-head ``w_uk`` / ``w_uv`` are dense tensors. The JAX
policy's block triples are TPU tiles and are not carried over.

``lm_from_jax`` builds an :class:`LM` from the ``LM.init`` tree, a
period's blocks (jamba's 8, gemma3's 6) unstacked in order; an
encoder-decoder's ``enc_groups`` as its ``groups``, each cross block's
``norm_cross`` and ``cross`` GQA, the learned ``pos`` / ``enc_pos``
tables, ``enc_final_norm`` and ``enc_embed``; a tied config (no
``lm_head``) reads its head from ``embed`` (``mixer_from_jax`` /
``mlp_from_jax`` one layer's mixer, attention, Mamba or RWKV, and MLP;
an RWKV layer's channel-mix lives in its mixer's tree),
``cnn_from_jax`` a :class:`SparseCNN` from the CNN tree
``{"convs": {name: node}, "head": {"w": ...}}``. ``mask_from_jax`` makes
the port's :class:`MaskSpec` from a JAX one's fields; a mask changes no
parameter, so a masked model's weights come through ``lm_from_jax`` as
any other's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import (
    CNNConfig,
    FFNConfig,
    MambaConfig,
    ModelConfig,
    MoEConfig,
    RWKVConfig,
)
from repro_torch.core.nmweight import KernelPolicy, MaskedNMWeight, NMWeight
from repro_torch.core.sparsity import NMConfig
from repro_torch.kernels.blocksparse_attn.mask import MaskSpec
from repro_torch.models.attention import GQA, MLA
from repro_torch.models.common import Embedding, resolve_device
from repro_torch.models.conv import SparseCNN, SparseConv2D, cnn_layer_specs
from repro_torch.models.ffn import FFN
from repro_torch.models.mamba import Mamba
from repro_torch.models.moe import MoE
from repro_torch.models.rwkv import RWKV
from repro_torch.models.transformer import LM, TransformerBlock
from repro_torch.quant.qnmweight import QNMWeight


def _is_nm(node) -> bool:
    return isinstance(node, dict) and "vals" in node and "idx" in node


def _is_masked(node) -> bool:
    return isinstance(node, dict) and "w" in node and "n" in node


def _take(node, i: int):
    """Layer ``i`` of a stacked subtree."""
    if isinstance(node, dict):
        meta = _is_nm(node) or _is_masked(node)
        return {k: (v if k in ("n", "m", "axis", "mode") and meta
                    else _take(v, i)) for k, v in node.items()}
    return node[i]


def _tensor(a, dtype, device) -> torch.Tensor:
    """A copy of ``a`` (the module owns its weights; ``a`` may be a
    read-only view of a JAX array)."""
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def weight_from_jax(node, *, dtype, device):
    """An :class:`NMWeight` from a compressed leaf (values in ``dtype``),
    a :class:`QNMWeight` from a quantized one (int8 values, f32 scales),
    a :class:`MaskedNMWeight` from a masked one, or a dense tensor from
    ``{"w": ...}``; idx kept int8."""
    if _is_nm(node) and "scales" in node:
        return QNMWeight(
            vals=_tensor(node["vals"], torch.int8, device),
            idx=_tensor(node["idx"], torch.int8, device),
            scales=_tensor(node["scales"], torch.float32, device),
            nm=NMConfig(int(node["n"]), int(node["m"])),
            axis=int(node["axis"]),
            kernel_policy=KernelPolicy(str(node["mode"])))
    if _is_nm(node):
        return NMWeight(
            vals=_tensor(node["vals"], dtype, device),
            idx=_tensor(node["idx"], torch.int8, device),
            nm=NMConfig(int(node["n"]), int(node["m"])),
            axis=int(node["axis"]),
            kernel_policy=KernelPolicy(str(node["mode"])))
    if _is_masked(node):
        return MaskedNMWeight(w=_tensor(node["w"], dtype, device),
                              nm=NMConfig(int(node["n"]), int(node["m"])),
                              axis=int(node["axis"]))
    return _tensor(node["w"], dtype, device)


def _ffn(f: dict, cfg: FFNConfig, dtype, device) -> FFN:
    return FFN(cfg, *(weight_from_jax(f[k], dtype=dtype, device=device)
                      for k in ("w_up", "w_down")),
               weight_from_jax(f["w_gate"], dtype=dtype, device=device)
               if "w_gate" in f else None)


def mixer_from_jax(cfg, mx: dict, *, dtype=torch.float32, device="cuda",
                   eps: float = 1e-5):
    """The mixer holding the weights of one layer's JAX mixer tree: a
    :class:`GQA` or :class:`MLA` (by ``cfg.kind``) from ``attn_init``'s,
    a :class:`Mamba` from ``mamba_init``'s (``w_dt`` dense), an
    :class:`RWKV` from ``rwkv_init``'s (time-mix and channel-mix; ``eps``
    is the model's norm eps, its ``cm_norm``'s)."""
    dev = resolve_device(device)

    def w(node):
        return weight_from_jax(node, dtype=dtype, device=dev)

    def t(a):
        return _tensor(a, dtype, dev)

    def scale(node):
        return t(node["scale"])

    if isinstance(cfg, MambaConfig):
        return Mamba(cfg, w(mx["w_in"]), t(mx["conv_w"]), t(mx["conv_b"]),
                     w(mx["w_x"]), w(mx["w_dt"]), t(mx["dt_bias"]),
                     t(mx["a_log"]), t(mx["d_skip"]), w(mx["w_out"]))
    if isinstance(cfg, RWKVConfig):
        vec = ("mu", "mix_lora_a", "mix_lora_b", "decay_base",
               "decay_lora_a", "decay_lora_b", "bonus", "cm_mu")
        lin = ("w_r", "w_k", "w_v", "w_g", "w_o", "w_cm_k", "w_cm_v",
               "w_cm_r")
        return RWKV(cfg, **{k: t(mx[k]) for k in vec},
                    **{k: w(mx[k]) for k in lin},
                    wkv_norm=scale(mx["wkv_norm"]),
                    cm_norm=scale(mx["cm_norm"]), eps=eps)
    if cfg.kind == "mla":
        q = ({"wq": w(mx["wq"])} if "wq" in mx else
             {"wq_a": w(mx["wq_a"]), "q_a_norm": scale(mx["q_a_norm"]),
              "wq_b": w(mx["wq_b"])})
        return MLA(cfg, w(mx["wkv_a"]), scale(mx["kv_a_norm"]),
                   w(mx["wk_rope"]), t(mx["w_uk"]), t(mx["w_uv"]),
                   w(mx["wo"]), **q)
    return GQA(cfg, w(mx["wq"]), w(mx["wk"]), w(mx["wv"]), w(mx["wo"]),
               scale(mx["q_norm"]) if "q_norm" in mx else None,
               scale(mx["k_norm"]) if "k_norm" in mx else None)


def mlp_from_jax(cfg, m: dict, *, dtype=torch.float32, device="cuda"):
    """An :class:`FFN` or an :class:`MoE` (by the config's type) holding
    the weights of one layer's JAX ``ffn_init`` / ``moe_init`` tree: the
    stacked experts split into one FFN each, the router in f32."""
    dev = resolve_device(device)
    if isinstance(cfg, FFNConfig):
        return _ffn(m, cfg, dtype, dev)
    expert = FFNConfig(d_ff=cfg.d_expert, act=cfg.act)
    shared = (_ffn(m["shared"], FFNConfig(d_ff=cfg.n_shared * cfg.d_expert,
                                          act=cfg.act), dtype, dev)
              if "shared" in m else None)
    return MoE(cfg, _tensor(m["router"]["w"], torch.float32, dev),
               [_ffn(_take(m["experts"], e), expert, dtype, dev)
                for e in range(cfg.n_experts)], shared)


def _block(p: dict, blk, cfg: ModelConfig, dtype, device) -> TransformerBlock:
    mixer = mixer_from_jax(blk.mixer, p["mixer"], dtype=dtype, device=device,
                           eps=cfg.norm_eps)
    mlp = norm2 = None
    if (isinstance(blk.mlp, (FFNConfig, MoEConfig))
            and not isinstance(blk.mixer, RWKVConfig)):
        mlp = mlp_from_jax(blk.mlp, p["mlp"], dtype=dtype, device=device)
        norm2 = _tensor(p["norm2"]["scale"], dtype, device)
    cross = {}
    if blk.cross_attn:
        cross = dict(norm_cross=_tensor(p["norm_cross"]["scale"], dtype,
                                        device),
                     cross=mixer_from_jax(blk.mixer, p["cross"], dtype=dtype,
                                          device=device))
    return TransformerBlock(blk, _tensor(p["norm1"]["scale"], dtype, device),
                            mixer, norm2, mlp, cfg.norm_eps, **cross)


def _layers(groups, plan, cfg: ModelConfig, dtype, device) -> list:
    """One TransformerBlock a layer of a plan's groups, stacked groups
    and periods unstacked in order."""
    layers = []
    for group, (entry, rep) in zip(groups, plan):
        blocks = entry if isinstance(entry, tuple) else (entry,)
        for i in range(rep):
            layer_params = [_take(g, i) for g in group] if rep > 1 else group
            layers += [_block(p, b, cfg, dtype, device)
                       for p, b in zip(layer_params, blocks)]
    return layers


def lm_from_jax(cfg: ModelConfig, tree: dict, *, dtype=torch.float32,
                device="cuda") -> LM:
    """An :class:`LM` holding the weights of the JAX ``LM.init`` tree."""
    dev = resolve_device(device)

    def t(a):
        return _tensor(a, dtype, dev)

    layers = _layers(tree["groups"], cfg.plan, cfg, dtype, dev)
    embed = Embedding(t(tree["embed"]["embedding"]))
    lm_head = None
    if not cfg.tie_embeddings:
        lm_head = _tensor(tree["lm_head"]["w"], torch.float32, dev)
    extra = {}
    if cfg.pos_embed == "learned":
        extra["pos"] = t(tree["pos"])
    if cfg.encoder_plan is not None:
        extra.update(
            enc_layers=_layers(tree["enc_groups"], cfg.encoder_plan, cfg,
                               dtype, dev),
            enc_pos=t(tree["enc_pos"]),
            enc_final_norm=t(tree["enc_final_norm"]["scale"]))
        if cfg.encoder_inputs == "tokens":
            extra["enc_embed"] = Embedding(t(tree["enc_embed"]["embedding"]))
    return LM(cfg, embed, layers, t(tree["final_norm"]["scale"]), lm_head,
              **extra)


def cnn_from_jax(tree: dict, cfg: CNNConfig, *, dtype=torch.float32,
                 device="cuda") -> SparseCNN:
    """A :class:`SparseCNN` holding the weights of the JAX
    ``SparseCNN.init`` tree (conv values in ``dtype``, int8 ones kept
    int8; the dense head in f32, as the model computes it)."""
    dev = resolve_device(device)
    convs = {layer.spec.name: SparseConv2D(layer.spec, weight_from_jax(
        tree["convs"][layer.spec.name], dtype=dtype, device=dev))
        for layer in cnn_layer_specs(cfg)}
    return SparseCNN(cfg, convs, _tensor(tree["head"]["w"], torch.float32,
                                         dev))


def mask_from_jax(spec) -> MaskSpec:
    """The port's :class:`MaskSpec` with the fields of a JAX ``MaskSpec``
    (read as attributes; nothing of JAX is imported)."""
    return MaskSpec(kind=spec.kind, block=spec.block, window=spec.window,
                    stride=spec.stride, blocks=spec.blocks,
                    causal=spec.causal)
