"""Block-sparse attention family (``bs_attention`` /
``bs_attention_decode``), port of ``repro.kernels.blocksparse_attn``:

  mask.py    MaskSpec, the token-level predicate and the block compiler
             (bitmap, live-pair lists, per-row gather lists); numpy only.
  ref.py     plain PyTorch lowerings: the dense masked reference, the
             block-gather lowering and the mask-aware decode path.
  kernel.py  wrapper of the Hopper pair-list kernel
             (``csrc/bs_attention.cu``).
  ops.py     registrations, the shared route, the typed entries and
             ``explain_dispatch_attention``.
"""
from repro_torch.kernels.blocksparse_attn.mask import (  # noqa: F401
    MaskPlan,
    MaskSpec,
    compile_mask,
)
from repro_torch.kernels.blocksparse_attn.ops import (  # noqa: F401
    MaskForceError,
    bs_attention,
    bs_attention_decode,
    explain_dispatch_attention,
)
