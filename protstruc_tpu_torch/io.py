"""Drop-in alias for the reference's ``protstruc.io`` module (port of
``protstruc_tpu/io.py``): ``to_pdb`` has the reference's signature
(io.py:8-43); ``structure_batch_to_pdb`` is the all-atom writer."""

from protstruc_tpu_torch.pdbio.writer import structure_batch_to_pdb, to_pdb

__all__ = ["to_pdb", "structure_batch_to_pdb"]
