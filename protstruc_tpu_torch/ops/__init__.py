"""Featurization ops: plain PyTorch pair maps and the hand-written CUDA kernels."""
