"""Quantized sparse execution: int8 compressed N:M weights (port of
``repro.quant``).

  qnmweight.py - QNMWeight: int8 vals/idx + f32 per-output-channel
                 scales, with the NMConfig, axis and KernelPolicy
  calibrate.py - absmax / percentile observers, quantize_nm /
                 dequantize, quantize_tree / dequantize_tree

The int8 kernels live with their float siblings under
``repro_torch.kernels.indexmac`` (ops ``nm_matmul_q`` /
``nm_matmul_decode_q``); ``repro_torch.api.quantize`` and
``repro_torch.api.nm_matmul`` are the user-facing entry points.
"""
from repro_torch.quant.calibrate import (  # noqa: F401
    AbsMaxObserver,
    PercentileObserver,
    dequantize,
    dequantize_tree,
    quantize_nm,
    quantize_tree,
)
from repro_torch.quant.qnmweight import QMAX, QNMWeight  # noqa: F401
