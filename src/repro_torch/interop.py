"""Build the port's modules from a JAX param tree taken as numpy arrays.

The tree has the JAX package's layout, with every array a numpy array
and every ``NMWeight`` leaf replaced by a dict ``{"vals", "idx", "n",
"m", "axis", "mode"}`` (the pair, its N:M pattern, its compressed axis
and its kernel-policy mode); a quantized ``QNMWeight`` leaf carries
``"scales"`` too and becomes a :class:`QNMWeight` with its int8 values
kept int8. The caller flattens the JAX side; nothing
here imports JAX. Each plan group's params are stacked on a leading
layer axis when the group repeats; they are unstacked here into one
module per layer. The JAX policy's block triples are TPU tiles and are
not carried over.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import FFNConfig, ModelConfig
from repro_torch.core.nmweight import KernelPolicy, NMWeight
from repro_torch.core.sparsity import NMConfig
from repro_torch.models.attention import GQA
from repro_torch.models.common import Embedding, resolve_device
from repro_torch.models.ffn import FFN
from repro_torch.models.transformer import LM, TransformerBlock
from repro_torch.quant.qnmweight import QNMWeight


def _is_nm(node) -> bool:
    return isinstance(node, dict) and "vals" in node and "idx" in node


def _take(node, i: int):
    """Layer ``i`` of a stacked subtree."""
    if isinstance(node, dict):
        return {k: (v if k in ("n", "m", "axis", "mode") and _is_nm(node)
                    else _take(v, i)) for k, v in node.items()}
    return node[i]


def _tensor(a, dtype, device) -> torch.Tensor:
    """A copy of ``a`` (the module owns its weights; ``a`` may be a
    read-only view of a JAX array)."""
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def weight_from_jax(node, *, dtype, device):
    """An :class:`NMWeight` from a compressed leaf (values in ``dtype``),
    a :class:`QNMWeight` from a quantized one (int8 values, f32 scales),
    or a dense tensor from ``{"w": ...}``; idx kept int8."""
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
    return _tensor(node["w"], dtype, device)


def _block(p: dict, blk, cfg: ModelConfig, dtype, device) -> TransformerBlock:
    def w(node):
        return weight_from_jax(node, dtype=dtype, device=device)

    def scale(node):
        return _tensor(node["scale"], dtype, device)

    mx = p["mixer"]
    mixer = GQA(blk.mixer, w(mx["wq"]), w(mx["wk"]), w(mx["wv"]), w(mx["wo"]),
                scale(mx["q_norm"]) if "q_norm" in mx else None,
                scale(mx["k_norm"]) if "k_norm" in mx else None)
    mlp = norm2 = None
    if isinstance(blk.mlp, FFNConfig):
        f = p["mlp"]
        mlp = FFN(blk.mlp, w(f["w_up"]), w(f["w_down"]),
                  w(f["w_gate"]) if "w_gate" in f else None)
        norm2 = scale(p["norm2"])
    return TransformerBlock(blk, scale(p["norm1"]), mixer, norm2, mlp,
                            cfg.norm_eps)


def lm_from_jax(cfg: ModelConfig, tree: dict, *, dtype=torch.float32,
                device="cuda") -> LM:
    """An :class:`LM` holding the weights of the JAX ``LM.init`` tree."""
    dev = resolve_device(device)
    layers = []
    for group, (entry, rep) in zip(tree["groups"], cfg.plan):
        blocks = entry if isinstance(entry, tuple) else (entry,)
        for i in range(rep):
            layer_params = [_take(g, i) for g in group] if rep > 1 else group
            layers += [_block(p, b, cfg, dtype, dev)
                       for p, b in zip(layer_params, blocks)]
    embed = Embedding(_tensor(tree["embed"]["embedding"], dtype, dev))
    lm_head = None
    if not cfg.tie_embeddings:
        lm_head = _tensor(tree["lm_head"]["w"], torch.float32, dev)
    return LM(cfg, embed, layers, _tensor(tree["final_norm"]["scale"], dtype,
                                          dev), lm_head)
