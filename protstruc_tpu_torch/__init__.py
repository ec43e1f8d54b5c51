"""protstruc-tpu on PyTorch and CUDA: the port of ``protstruc_tpu`` to an H100.

The JAX package ``protstruc_tpu`` stays the reference.  This package imports
torch and numpy only (never jax, flax or ``protstruc_tpu``), and its kernels
are hand-written CUDA for Hopper, built at first use (``ops/cuda_lib.py``).

The ported slice is geometric featurization: ``StructureBatch.from_pdb`` ->
``inter_residue_geometry`` (trRosetta pair maps through the K1 kernel) /
``backbone_dihedrals`` / ``backbone_orientations``, the bucketed serving
featurizer (``utils/aot.py``) and the JSONL server
(``python -m protstruc_tpu_torch serve``).
"""

from protstruc_tpu_torch import geometry, vocab
from protstruc_tpu_torch.batch import StructureBatch
from protstruc_tpu_torch.constants import MAX_N_ATOMS_PER_RESIDUE
from protstruc_tpu_torch.vocab import AA, ATOM

__all__ = ["StructureBatch", "ATOM", "AA", "geometry", "vocab",
           "MAX_N_ATOMS_PER_RESIDUE"]

__version__ = "0.1.0"
