"""Hand-written CUDA kernels for Hopper (``csrc/``), their plain PyTorch
versions (``ref.py``), the build (``build.py``) and the dispatch
(``ops.py``).

Kernels:
    signature_corr  — memoization correlation engine (replaces
                      repro.kernels.signature_corr)
    fake_quant      — 16/12/8-bit quantize-dequantize (replaces
                      repro.kernels.fake_quant)
    kmeans_coreset  — clustering-coreset engine, 4-round Lloyd (replaces
                      repro.kernels.kmeans_coreset)
    importance_select — hardware importance sampler, top-m selection
                      (replaces repro.kernels.importance_select)
"""
from .ops import (  # noqa: F401
    fake_quant_op, importance_select_op, kmeans_coreset_op, launch_counts,
    reset_launch_counts, signature_corr_op,
)
from . import ref  # noqa: F401
