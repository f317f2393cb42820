"""PyTorch/CUDA port of the IndexMAC N:M sparse system (see ``repro``).

The module tree mirrors ``repro``; the compressed GEMMs run through
hand-written CUDA kernels for Hopper (``kernels/*/csrc``), and so does
the paper's literal vindexmac gather (``kernels/indexmac_gather``). The
package imports torch and numpy only, never jax or ``repro``.
"""
