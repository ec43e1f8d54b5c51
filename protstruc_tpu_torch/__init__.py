"""protstruc-tpu on PyTorch and CUDA: the port of ``protstruc_tpu`` to an H100.

The JAX package ``protstruc_tpu`` stays the reference.  This package imports
torch and numpy only (never jax, flax or ``protstruc_tpu``), and its kernels
are hand-written CUDA for Hopper, built at first use (``ops/cuda_lib.py``).

Ported slices: geometric featurization, ``StructureBatch.from_pdb`` ->
``inter_residue_geometry`` (trRosetta pair maps through the K1 kernel) /
``backbone_dihedrals`` / ``backbone_orientations``, the bucketed serving
featurizer (``utils/aot.py``) and the JSONL server
(``python -m protstruc_tpu_torch serve``); and the TrFold train step
(``models/trfold.py``: ``featurize_for_model`` -> ``make_train_state`` ->
``train_step``), whose triangle updates run through the K4-K7 kernels
(``ops/tri_mul.py``) with ``fused_tri=True``; the FoldModel trainer and
fold; the server and analysis commands; and the rest of the batch API:
constructors from dihedrals (NeRF), frames and sequences, rigid moves and
standardization, selections, diffusion (``ops/diffusion.py``),
reconstruction from the pair maps (``ops/reconstruct.py``), and the
antibody batch (``AntibodyStructureBatch``) with numbering-scheme
conversion (``numbering.py``, the ``renumber`` command); and the host layer:
the C++ PDB scanner (``pdbio/native.py``), cache-first ``from_pdb_id``,
the ``PDB`` wrappers, serialization, checks, profiling, ``compat.py`` and
the reference-layout shims.
"""

from protstruc_tpu_torch import geometry, vocab
from protstruc_tpu_torch.antibody import AntibodyStructureBatch
from protstruc_tpu_torch.batch import StructureBatch
from protstruc_tpu_torch.constants import MAX_N_ATOMS_PER_RESIDUE
from protstruc_tpu_torch.vocab import AA, ATOM, CDR_NAMES

# the reference-layout alias module: `import protstruc_tpu_torch.general`
from protstruc_tpu_torch import general  # noqa: F401

__all__ = ["StructureBatch", "AntibodyStructureBatch", "ATOM", "AA", "CDR_NAMES", "geometry",
           "vocab", "MAX_N_ATOMS_PER_RESIDUE"]

__version__ = "0.1.0"
