"""Block-sparse attention mask specs and their compiled block plans (port
of ``repro.kernels.blocksparse_attn.mask``; numpy only, like it).

A :class:`MaskSpec` is a small frozen declaration of an attention
pattern (a kind and its static parameters, never a callable) that every
lowering honors identically. It lives on
:class:`repro_torch.configs.base.AttnConfig` (``mask=``) and on the
``api.attention`` call; ``.tag`` names it in dispatch messages.

Two artifacts per spec:

* :func:`token_mask`, the token-level visibility predicate and the
  single source of truth. It uses plain operators only, so the same
  function evaluates on numpy arrays (mask compilation) and on torch
  tensors (the dense reference and the decode path).
* :func:`compile_mask`, which tiles the (sq, skv) token grid at a
  ``(bq, bk)`` tile and returns a :class:`MaskPlan`: the block bitmap,
  the row-major live (q-block, k-block) pair lists the Hopper kernel
  walks, and per-row padded gather lists for the gather lowering. It
  returns ``None`` when the mask does not tile, which a forced (or, on
  the card, automatic) kernel call turns into ``MaskForceError``.

Budgets (they route only on the CPU backend, see ``ops.py``):

  REPRO_BS_DENSITY_LIMIT  (default 0.9)  live blocks / total blocks above
      which the gather lowering declines for the dense reference.
  REPRO_BS_WASTE_LIMIT    (default 4.0)  live block area / live token
      pairs above which it declines (mostly masked live blocks).
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import os
from typing import Optional

import numpy as np

MASK_KINDS = ("causal", "local", "strided", "blockwise")

_DEFAULT_DENSITY_LIMIT = 0.9
_DEFAULT_WASTE_LIMIT = 4.0

# token tiles are multiples of 8, as in the JAX package, so that every
# plan compiles for both packages alike
_SUBLANE = 8


def density_limit() -> float:
    return float(
        os.environ.get("REPRO_BS_DENSITY_LIMIT", _DEFAULT_DENSITY_LIMIT))


def waste_limit() -> float:
    return float(os.environ.get("REPRO_BS_WASTE_LIMIT", _DEFAULT_WASTE_LIMIT))


@dataclasses.dataclass(frozen=True)
class MaskSpec:
    """Frozen declaration of an attention sparsity pattern.

    kind      "causal" | "local" | "strided" | "blockwise"
    block     pattern granularity in tokens (the unit ``strided`` and
              ``blockwise`` are defined over; also the default kernel
              tile). Multiple of 8.
    window    ("local") tokens of lookback: position q sees k iff
              ``q - window < k`` (and ``k <= q`` when causal).
    stride    ("strided") block-diagonal plus every stride-th block
              column: q-block i sees k-block j iff ``i == j`` or
              ``(i - j) % stride == 0``.
    blocks    ("blockwise") explicit live (q_block, k_block) pairs at
              ``block`` granularity.
    causal    AND the causal triangle into the pattern (ignored for
              kind="causal", which is causal by itself). Masks with
              ``causal=False`` may leave a query row with no visible
              token; such masks do not compile (softmax undefined).
    """

    kind: str = "causal"
    block: int = 128
    window: Optional[int] = None
    stride: Optional[int] = None
    blocks: Optional[tuple[tuple[int, int], ...]] = None
    causal: bool = True

    def __post_init__(self):
        if self.kind not in MASK_KINDS:
            raise ValueError(
                f"MaskSpec.kind must be one of {MASK_KINDS}, got "
                f"{self.kind!r}")
        if self.block < _SUBLANE or self.block % _SUBLANE:
            raise ValueError(
                f"MaskSpec.block must be a multiple of {_SUBLANE}, got "
                f"{self.block}")
        if self.kind == "local":
            if self.window is None or self.window < 1:
                raise ValueError(
                    "MaskSpec(kind='local') needs window >= 1, got "
                    f"{self.window!r}")
        elif self.window is not None:
            raise ValueError(f"window is local-only, not {self.kind!r}")
        if self.kind == "strided":
            if self.stride is None or self.stride < 1:
                raise ValueError(
                    "MaskSpec(kind='strided') needs stride >= 1, got "
                    f"{self.stride!r}")
        elif self.stride is not None:
            raise ValueError(f"stride is strided-only, not {self.kind!r}")
        if self.kind == "blockwise":
            if not self.blocks:
                raise ValueError(
                    "MaskSpec(kind='blockwise') needs a non-empty blocks "
                    "tuple of (q_block, k_block) pairs")
            norm = tuple(sorted({(int(i), int(j)) for i, j in self.blocks}))
            if any(i < 0 or j < 0 for i, j in norm):
                raise ValueError("blockwise pairs must be non-negative")
            object.__setattr__(self, "blocks", norm)
        elif self.blocks is not None:
            raise ValueError(f"blocks is blockwise-only, not {self.kind!r}")

    @property
    def tag(self) -> str:
        """Short name of the spec (the ``NMConfig.tag`` duck-type)."""
        c = f"c{int(self.causal)}"
        if self.kind == "causal":
            return f"causal:b{self.block}"
        if self.kind == "local":
            return f"local:w{self.window}:b{self.block}:{c}"
        if self.kind == "strided":
            return f"strided:s{self.stride}:b{self.block}:{c}"
        digest = hashlib.blake2s(
            repr(self.blocks).encode()).hexdigest()[:10]
        return f"blockwise:{len(self.blocks)}p:{digest}:b{self.block}:{c}"


def block_bitmap(spec: MaskSpec, nq: int, nk: int) -> np.ndarray:
    """(nq, nk) bool bitmap of a blockwise spec's live pairs at
    ``spec.block`` granularity (pairs outside the bounds are dropped:
    they address blocks past the sequence)."""
    bm = np.zeros((nq, nk), dtype=bool)
    for i, j in spec.blocks or ():
        if i < nq and j < nk:
            bm[i, j] = True
    return bm


def token_mask(spec: MaskSpec, q_pos, k_pos, *, bitmap=None):
    """Token-level visibility predicate, the single source of truth.

    ``q_pos`` / ``k_pos`` are broadcastable integer arrays, numpy arrays
    or torch tensors (only plain operators are used). ``bitmap`` is
    required for kind="blockwise": the :func:`block_bitmap` covering
    every position, as a numpy array or a torch tensor on the positions'
    device; indexing picks the caller's library.
    """
    if spec.kind == "causal":
        return k_pos <= q_pos
    if spec.kind == "local":
        near = q_pos - k_pos < spec.window
        if spec.causal:
            return (k_pos <= q_pos) & near
        return near & (k_pos - q_pos < spec.window)
    qb = q_pos // spec.block
    kb = k_pos // spec.block
    if spec.kind == "strided":
        live = (qb == kb) | ((qb - kb) % spec.stride == 0)
    else:  # blockwise
        if bitmap is None:
            raise ValueError(
                "token_mask(kind='blockwise') needs the block bitmap")
        live = bitmap[qb, kb]
    if spec.causal:
        live = live & (k_pos <= q_pos)
    return live


@dataclasses.dataclass(frozen=True, eq=False)
class MaskPlan:
    """Compiled form of a MaskSpec for an (sq, skv) problem at a
    ``(bq, bk)`` token tile; every array is host numpy.

    ``pair_q``/``pair_k`` are sorted row-major (q-block monotone
    non-decreasing), so each q-block's live pairs are one contiguous run
    (the Hopper kernel walks them through row pointers). ``row_idx`` /
    ``row_valid`` are the per-q-row live k-block lists padded to the
    widest row (pad index 0, masked out by row_valid). ``tokens`` is the
    full padded token-level mask the tiling was derived from.
    """

    sq: int
    skv: int
    bq: int
    bk: int
    nqb: int
    nkb: int
    bitmap: np.ndarray      # (nqb, nkb) bool
    tokens: np.ndarray      # (nqb*bq, nkb*bk) bool, padded positions False
    pair_q: np.ndarray      # (n_live,) int32
    pair_k: np.ndarray      # (n_live,) int32
    row_idx: np.ndarray     # (nqb, gather_width) int32
    row_valid: np.ndarray   # (nqb, gather_width) bool
    n_live: int
    live_tokens: int

    @property
    def density(self) -> float:
        """Live blocks / total blocks: the share of the block grid the
        sparse lowerings visit."""
        return self.n_live / max(self.nqb * self.nkb, 1)

    @property
    def waste(self) -> float:
        """Live block area / live token pairs (>= 1.0)."""
        return (self.n_live * self.bq * self.bk) / max(self.live_tokens, 1)

    @property
    def gather_width(self) -> int:
        return int(self.row_idx.shape[1])

    # DispatchRecord geometry hooks (the PadPlan duck-type the registry
    # reads for implementations with uses_plan=True)
    @property
    def padded_shape(self) -> tuple:
        return (self.nqb * self.bq, self.nkb * self.bk)

    @property
    def block(self) -> tuple:
        return (self.bq, self.bk)


def _round_up(x: int, to: int) -> int:
    return -(-x // to) * to


def default_tile(spec: MaskSpec, sq: int, skv: int) -> tuple[int, int]:
    """The pattern-granularity tile, clamped to the problem."""
    bq = min(spec.block, _round_up(max(sq, 1), _SUBLANE))
    bk = min(spec.block, _round_up(max(skv, 1), _SUBLANE))
    return bq, bk


@functools.lru_cache(maxsize=512)
def compile_mask(spec: MaskSpec, sq: int, skv: int,
                 tile: Optional[tuple[int, int]] = None
                 ) -> Optional[MaskPlan]:
    """Compile ``spec`` for an (sq, skv) attention problem at ``tile``
    (default: the spec's own block granularity, clamped to the problem).

    Returns None ("mask does not tile") when the problem is empty, the
    tile is not a multiple of 8, or a query row ends up with no visible
    token (softmax undefined; only ``causal=False`` patterns reach it).
    """
    if sq <= 0 or skv <= 0:
        return None
    bq, bk = tile or default_tile(spec, sq, skv)
    if bq < _SUBLANE or bq % _SUBLANE or bk < _SUBLANE or bk % _SUBLANE:
        return None
    nqb = -(-sq // bq)
    nkb = -(-skv // bk)
    q_pos = np.arange(nqb * bq)
    k_pos = np.arange(nkb * bk)
    bm_tok = None
    if spec.kind == "blockwise":
        bm_tok = block_bitmap(spec, -(-(nqb * bq) // spec.block),
                              -(-(nkb * bk) // spec.block))
    tokens = token_mask(spec, q_pos[:, None], k_pos[None, :], bitmap=bm_tok)
    tokens = tokens & (q_pos[:, None] < sq) & (k_pos[None, :] < skv)
    if not tokens[:sq].any(axis=1).all():
        return None  # a query row sees nothing: softmax undefined
    bitmap = tokens.reshape(nqb, bq, nkb, bk).any(axis=(1, 3))
    pair_q, pair_k = np.nonzero(bitmap)  # row-major == sorted by q-block
    counts = bitmap.sum(axis=1)
    width = int(counts.max())
    row_idx = np.zeros((nqb, width), dtype=np.int32)
    row_valid = np.zeros((nqb, width), dtype=bool)
    for r in range(nqb):
        live = np.nonzero(bitmap[r])[0]
        row_idx[r, : live.size] = live
        row_valid[r, : live.size] = True
    return MaskPlan(
        sq=sq, skv=skv, bq=bq, bk=bk, nqb=nqb, nkb=nkb,
        bitmap=bitmap, tokens=tokens,
        pair_q=pair_q.astype(np.int32), pair_k=pair_k.astype(np.int32),
        row_idx=row_idx, row_valid=row_valid,
        n_live=int(pair_q.size), live_tokens=int(tokens.sum()),
    )


def pair_masks(plan: MaskPlan) -> np.ndarray:
    """(n_live, bq, bk) token masks, one tile per live pair: the Hopper
    kernel's mask operand."""
    t4 = plan.tokens.reshape(plan.nqb, plan.bq, plan.nkb, plan.bk)
    return np.ascontiguousarray(
        t4[plan.pair_q, :, plan.pair_k, :])


def gather_masks(plan: MaskPlan) -> np.ndarray:
    """(nqb, gather_width, bq, bk) token masks aligned with ``row_idx``;
    padded gather slots are all-False (row_valid folded in)."""
    t4 = plan.tokens.reshape(plan.nqb, plan.bq, plan.nkb, plan.bk)
    # separated advanced indices: the broadcast (nqb, width) index dims
    # land first, giving (nqb, width, bq, bk) directly
    out = t4[np.arange(plan.nqb)[:, None], :, plan.row_idx, :]
    return out & plan.row_valid[:, :, None, None]


def row_pointers(plan: MaskPlan) -> np.ndarray:
    """(nqb + 1,) int32 CSR row pointers into the row-major pair lists:
    the live pairs of q-block r are ``pair_k[ptr[r]:ptr[r + 1]]``."""
    ptr = np.zeros(plan.nqb + 1, dtype=np.int32)
    np.cumsum(np.bincount(plan.pair_q, minlength=plan.nqb), out=ptr[1:])
    return ptr
