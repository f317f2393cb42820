"""CacheView: how one forward call addresses the KV cache (port of
``repro.models.cache``: the slot layout and the paged layout).

Modes:

  train    no cache; positions default to arange(S).
  prefill  positions from 0; the cache is overwritten from position 0.
  decode   one token per slot at offset ``cache_len``.
  chunk    an s-token prompt piece at offset ``cache_len``.

``cache_len`` is a scalar or ``(B,)`` integer tensor. ``LM.forward``
checks it against the cache bounds on the host and then moves it to the
model's device; ``positions`` is derived there when left None.

The cache is written in place. ``write_mask`` ((B,) bool) names the
slots whose new rows are written; the others keep their cache as it was
(idle slots, or slots mid-decode during another slot's prefill). None
writes every slot. Every write has the same shape whatever the mask:
a slot outside it writes back the rows it already holds (slot layout),
or writes the null page (paged layout). So no write depends on the
mask's values on the host, and a step can be captured as a CUDA graph.

The recurrent mixers (Mamba, RWKV) keep a state a slot instead of rows
a position: :func:`write_state` writes it under the same mask, and
:func:`clear_state` zeroes the slots a from-zero prefill admits;
:func:`refuse_offset_views` refuses the chunk and paged views.

``block_table`` ((B, pages_per_slot) integer page ids; decode and chunk
only) switches to the paged layout: the cache leaves are page pools
(rows, page_size, ...) with row 0 the null page, position ``p`` of slot
``b`` lives in page ``block_table[b, p // page_size]``, and the view
needs a ``write_mask`` too (the slots outside it write the null page).
``write_index`` is then :func:`paged_write_index`'s flat rows.
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
    block_table: Optional[torch.Tensor] = None
    write_index: Optional[tuple | torch.Tensor] = None

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
    def decode(cls, cache_len, write_mask=None, *,
               block_table=None) -> "CacheView":
        return cls._offset("decode", cache_len, write_mask, block_table)

    @classmethod
    def chunk(cls, cache_len, write_mask=None, *,
              block_table=None) -> "CacheView":
        return cls._offset("chunk", cache_len, write_mask, block_table)

    @classmethod
    def _offset(cls, mode, cache_len, write_mask, block_table):
        if cache_len is None:
            raise TypeError(f"CacheView.{mode} needs cache_len (the "
                            "per-slot write offset)")
        if block_table is not None and write_mask is None:
            raise TypeError("paged addressing needs block_table AND "
                            "write_mask (masked slots must write the null "
                            "page)")
        return cls(mode=mode, cache_len=torch.as_tensor(cache_len),
                   write_mask=_mask(write_mask),
                   block_table=(None if block_table is None
                                else torch.as_tensor(block_table)))

    @property
    def offset_mode(self) -> bool:
        return self.mode in ("decode", "chunk")

    @property
    def paged(self) -> bool:
        return self.block_table is not None

    def replace(self, **kw) -> "CacheView":
        return dataclasses.replace(self, **kw)


def _mask(write_mask) -> Optional[torch.Tensor]:
    return None if write_mask is None else torch.as_tensor(write_mask,
                                                           dtype=torch.bool)


def cache_write_index(view: CacheView, batch: int, s: int, device) -> tuple:
    """``(rows, cols, keep)`` of the slot-layout cache entries an s-token
    call writes: every slot (rows (B,)) at its positions (cols (B, s):
    ``view.positions``, (s,) or (B, s), arange(s) when None), long on
    ``device``; ``keep`` is ``view.write_mask`` on ``device`` (None: every
    slot keeps its new rows). The shapes do not depend on the mask."""
    rows = torch.arange(batch, device=device)
    pos = view.positions
    if pos is None:
        pos = torch.arange(s, device=device)
    cols = pos.to(device, torch.long).expand(batch, s)
    keep = view.write_mask
    return rows, cols, None if keep is None else keep.to(device)


def paged_write_index(cache_len: torch.Tensor, table: torch.Tensor,
                      write_mask: torch.Tensor, s: int, rows: int,
                      page_size: int) -> torch.Tensor:
    """Rows of the flat (rows * page_size, ...) view of a page pool that
    an s-token call writes, (B * s,) long on ``table``'s device: slot b's
    position p (from its ``cache_len``) goes to page ``table[b, p //
    page_size]`` (``% rows``: the local row) at ``p % page_size``; slots
    outside ``write_mask`` and positions past the table go to the null
    page (local row 0). The shape does not depend on the mask."""
    b, n_pages = table.shape
    dev = table.device
    cl = cache_len.to(dev, torch.long).expand(b)
    pos = cl[:, None] + torch.arange(s, device=dev)[None, :]      # (B, s)
    page_idx = pos // page_size
    ok = (page_idx < n_pages) & write_mask.to(dev)[:, None]
    local = torch.gather(table.to(dev, torch.long), 1,
                         page_idx.clamp(max=n_pages - 1)) % rows
    local = torch.where(ok, local, torch.zeros_like(local))
    return (local * page_size + pos % page_size).reshape(-1)


def refuse_offset_views(view: CacheView, what: str) -> None:
    """A recurrent mixer has no chunk mode and no paged layout."""
    if view.mode == "chunk" or view.paged:
        raise NotImplementedError(
            f"{what} has no chunked or paged mode: chunked prefill and the "
            "paged cache need attention-mixer blocks")


def write_state(state: torch.Tensor, new: torch.Tensor,
                write_mask: Optional[torch.Tensor]) -> None:
    """Write a recurrent state leaf (B, ...) in place: the slots of
    ``write_mask`` take ``new`` (cast to the leaf's dtype), the others
    keep what they hold (every slot takes it when the mask is None). The
    write has the same shape whatever the mask, as the attention cache's
    writes do."""
    new = new.to(state.dtype)
    if write_mask is not None:
        keep = write_mask.to(state.device).view(
            (-1,) + (1,) * (state.dim() - 1))
        new = torch.where(keep, new, state)
    state.copy_(new)


def clear_state(state: torch.Tensor,
                write_mask: Optional[torch.Tensor]) -> None:
    """Zero the slots of ``write_mask`` (every slot when None) of a
    recurrent state leaf in place."""
    if write_mask is None:
        state.zero_()
        return
    state.masked_fill_(write_mask.to(state.device).view(
        (-1,) + (1,) * (state.dim() - 1)), 0)
