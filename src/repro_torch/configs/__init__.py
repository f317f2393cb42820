"""Architecture registry of the port: the archs it serves so far.

get_config(name, sparse=True)  -> full-size ModelConfig
get_reduced(name, sparse=True) -> CPU-sized config of the same structure
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    AttnConfig,
    Block,
    FFNConfig,
    ModelConfig,
    SparsityConfig,
)

ARCHS: tuple[str, ...] = ("yi-9b",)

_MODULES = {"yi-9b": "yi_9b"}


def _mod(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; the port serves {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str, sparse: bool = True) -> ModelConfig:
    return _mod(name).config(sparse=sparse)


def get_reduced(name: str, sparse: bool = True) -> ModelConfig:
    return _mod(name).reduced(sparse=sparse)
