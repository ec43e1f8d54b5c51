"""Drop-in alias for the reference's ``protstruc.alphabet`` module (port of
``protstruc_tpu/alphabet.py``): the 3<->1 letter maps of vocab.py, so code
written against the reference layout ports with a package rename only."""

from protstruc_tpu_torch.vocab import one2three, three2one

__all__ = ["three2one", "one2three"]
