"""Attention ops: plain PyTorch versions and hand-written CUDA kernels."""
