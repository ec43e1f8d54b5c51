"""Package-level constants (a copy of ``protstruc_tpu/constants``).

Parity: dohlee/protstruc constants/__init__.py
"""

from protstruc_tpu_torch.constants import ideal  # noqa: F401

#: Number of heavy-atom slots on the per-residue atom axis.
MAX_N_ATOMS_PER_RESIDUE = 15
