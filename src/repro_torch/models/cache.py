"""CacheView: how one forward call addresses the KV cache (port of
``repro.models.cache``, slot layout only; paged addressing comes with
the paging slice).

Modes:

  train    no cache; positions default to arange(S).
  prefill  positions from 0; the cache is overwritten from position 0.
  decode   one token per slot at offset ``cache_len``.
  chunk    an s-token prompt piece at offset ``cache_len``.

``cache_len`` is a scalar or ``(B,)`` integer tensor. ``LM.forward``
checks it against the cache bounds on the host and then moves it to the
model's device; ``positions`` is derived there when left None.

The cache is written in place. ``write_mask`` ((B,) bool, on the host)
names the slots whose new rows are written; the others keep their cache
as it was (idle slots, or slots mid-decode during another slot's
prefill). None writes every slot. ``write_index``, the ``(rows, cols)``
of the entries written, is derived from it once per forward
(:func:`cache_write_index`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

_MODES = ("train", "prefill", "decode", "chunk")


@dataclasses.dataclass(frozen=True)
class CacheView:
    mode: str = "train"
    cache_len: Optional[torch.Tensor] = None
    positions: Optional[torch.Tensor] = None
    write_mask: Optional[torch.Tensor] = None
    write_index: Optional[tuple] = None

    def __post_init__(self):
        if self.mode not in _MODES:
            raise ValueError(
                f"CacheView.mode must be one of {_MODES}, got {self.mode!r}")

    @classmethod
    def train(cls, positions=None) -> "CacheView":
        return cls(mode="train", positions=positions)

    @classmethod
    def prefill(cls, write_mask=None) -> "CacheView":
        return cls(mode="prefill", write_mask=_mask(write_mask))

    @classmethod
    def decode(cls, cache_len, write_mask=None) -> "CacheView":
        return cls._offset("decode", cache_len, write_mask)

    @classmethod
    def chunk(cls, cache_len, write_mask=None) -> "CacheView":
        return cls._offset("chunk", cache_len, write_mask)

    @classmethod
    def _offset(cls, mode, cache_len, write_mask):
        if cache_len is None:
            raise TypeError(f"CacheView.{mode} needs cache_len (the "
                            "per-slot write offset)")
        return cls(mode=mode, cache_len=torch.as_tensor(cache_len),
                   write_mask=_mask(write_mask))

    @property
    def offset_mode(self) -> bool:
        return self.mode in ("decode", "chunk")

    def replace(self, **kw) -> "CacheView":
        return dataclasses.replace(self, **kw)


def _mask(write_mask) -> Optional[torch.Tensor]:
    return None if write_mask is None else torch.as_tensor(write_mask,
                                                           dtype=torch.bool)


def cache_write_index(view: CacheView, batch: int, s: int, device) -> tuple:
    """``(rows, cols)`` of the cache entries an s-token call writes: the
    slots of ``view.write_mask`` (every slot when None), each at its
    positions (``view.positions``, (s,) or (B, s); arange(s) when None).
    rows is (B',) and cols (B', s), both long on ``device``."""
    mask = view.write_mask
    rows = (torch.arange(batch) if mask is None
            else torch.nonzero(mask.cpu()).flatten()).to(device)
    pos = view.positions
    if pos is None:
        pos = torch.arange(s, device=device)
    cols = pos.to(device, torch.long).expand(batch, s)[rows]
    return rows, cols
