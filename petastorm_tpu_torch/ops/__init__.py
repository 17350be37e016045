"""Attention ops and their hand-written CUDA kernels."""
