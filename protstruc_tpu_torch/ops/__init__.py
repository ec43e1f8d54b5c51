"""Ops: pair maps (K1) and their backward (K2), model features (K3),
triangle-multiplication kernels (K4-K7), flash attention (K8/K9), distance binning,
and the plain PyTorch version beside each kernel."""
