"""Ops of the port: the attention forms (plain PyTorch and the CUDA
kernels, differentiable), the losses and the metrics.

Nothing here builds or loads a kernel at import time.
"""
