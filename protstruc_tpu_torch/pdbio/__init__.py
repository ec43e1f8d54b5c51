"""Host-side PDB/mmCIF parsing (NumPy only), copied from ``protstruc_tpu.pdbio``."""

from protstruc_tpu_torch.pdbio.parser import ParsedStructure, parse_pdb, parse_pdb_files
