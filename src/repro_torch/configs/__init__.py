"""Architecture registry of the port: the archs it serves so far.

get_config(name, sparse=True)      -> full-size ModelConfig
get_reduced(name, sparse=True)     -> CPU-sized config of the same structure
get_cnn_config(name, sparse=True)  -> full-size CNNConfig (224x224)
get_cnn_reduced(name, sparse=True) -> CPU-sized CNN of the same topology
runnable_shapes(name)              -> the SHAPES the arch's dry-run cells take
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    AttnConfig,
    Block,
    BottleneckStage,
    CNNConfig,
    ConvSpec,
    DenseStage,
    FFNConfig,
    MambaConfig,
    ModelConfig,
    MoEConfig,
    RWKVConfig,
    ShapeConfig,
    SparsityConfig,
)

ARCHS: tuple[str, ...] = ("yi-9b", "deepseek-v2-lite-16b",
                          "deepseek-v2-236b", "rwkv6-3b", "jamba-v0.1-52b",
                          "whisper-medium", "gemma3-27b", "chameleon-34b",
                          "codeqwen1.5-7b", "internlm2-20b")

_MODULES = {"yi-9b": "yi_9b", "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
            "deepseek-v2-236b": "deepseek_v2_236b",
            "rwkv6-3b": "rwkv6_3b", "jamba-v0.1-52b": "jamba_v0_1_52b",
            "whisper-medium": "whisper_medium", "gemma3-27b": "gemma3_27b",
            "chameleon-34b": "chameleon_34b",
            "codeqwen1.5-7b": "codeqwen1_5_7b",
            "internlm2-20b": "internlm2_20b"}


# the shapes each arch skips, with the reason (the JAX package's)
SHAPE_SKIPS: dict[str, dict[str, str]] = {
    name: {"long_500k": "full attention is quadratic at 524k prefill; "
                        "no sub-quadratic path"}
    for name in ARCHS
    if name not in ("rwkv6-3b", "jamba-v0.1-52b")
}
SHAPE_SKIPS.setdefault("rwkv6-3b", {})
SHAPE_SKIPS.setdefault("jamba-v0.1-52b", {})


def runnable_shapes(name: str) -> list[str]:
    """The names of the SHAPES an arch's dry-run cells take, in order."""
    return [s for s in SHAPES if s not in SHAPE_SKIPS.get(name, {})]


def _mod(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; the port serves {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str, sparse: bool = True) -> ModelConfig:
    return _mod(name).config(sparse=sparse)


def get_reduced(name: str, sparse: bool = True) -> ModelConfig:
    return _mod(name).reduced(sparse=sparse)


# ---------------------------------------------------------------------------
# CNN registry (the paper's evaluation workload: conv layers -> im2col GEMMs)
# ---------------------------------------------------------------------------

CNN_ARCHS: tuple[str, ...] = ("resnet50", "densenet121")

# every conv family is sparsified (the paper prunes all conv layers); the
# stem stays dense: its K = 3*kh*kw contraction is not M-divisible.
DEFAULT_CNN_SPARSITY = SparsityConfig(targets=("conv", "proj"))


def cnn_sparsity_or_none(sparse: bool) -> SparsityConfig | None:
    return DEFAULT_CNN_SPARSITY if sparse else None


def _cnn_mod(name: str):
    if name not in CNN_ARCHS:
        raise KeyError(f"unknown CNN {name!r}; known: {CNN_ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_cnn_config(name: str, sparse: bool = True) -> CNNConfig:
    return _cnn_mod(name).config(sparse=sparse)


def get_cnn_reduced(name: str, sparse: bool = True) -> CNNConfig:
    return _cnn_mod(name).reduced(sparse=sparse)
