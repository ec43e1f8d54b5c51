"""Ported models (``trfold``) and their flax-semantics layers (``_nn``)."""
