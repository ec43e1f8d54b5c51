"""Ops: pair maps (K1), triangle-multiplication kernels (K4-K7), distance binning,
and the plain PyTorch version beside each kernel."""
