"""Attention ops of the port: plain PyTorch forms and the CUDA kernels.

Nothing here builds or loads a kernel at import time.
"""
