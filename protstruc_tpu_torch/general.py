"""Drop-in alias for the reference's ``protstruc.general`` module (port of
``protstruc_tpu/general.py``): the vocab.py names under the reference layout,
so ``from protstruc.general import AA, ATOM`` ports with a package rename."""

from protstruc_tpu_torch.vocab import (  # noqa: F401
    AA,
    ATOM,
    CDR_NAMES,
    non_standard_residue_substitutions,
    resindex_to_oneletter,
    ressymb_to_resindex,
    restype_to_heavyatom_names,
    standard_aa_names,
    standard_heavy_atom_names,
)
