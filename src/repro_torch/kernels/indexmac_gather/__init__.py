from repro_torch.kernels.indexmac_gather.ops import (  # noqa: F401
    explain_gather,
    indexmac_gather,
)
