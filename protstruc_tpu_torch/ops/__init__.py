"""Ops: pair maps (K1) and their backward (K2), model features (K3),
triangle-multiplication kernels (K4-K7), flash attention (K8/K9) and ring
attention over its lse entry point, distance binning,
and the plain PyTorch version beside each kernel; the analysis, batch-API and
design ops (surface, packing, relax, SO(3), chi, grafting, idealization, ...)
in plain PyTorch."""
