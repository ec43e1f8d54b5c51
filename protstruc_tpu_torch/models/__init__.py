"""Ported models (``trfold``, ``ipa``, ``framediff``, ``inverse_fold``) and
their flax-semantics layers (``_nn``)."""
