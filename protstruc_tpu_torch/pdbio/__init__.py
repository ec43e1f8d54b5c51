"""Host-side PDB I/O (ports of ``protstruc_tpu.pdbio``): parsing (the C++
scanner where ``g++`` can build it, else NumPy), cache-first fetching, the
reference-shaped ``PDB`` wrappers, author SS annotations, the bucketed
dataset and writing."""

from protstruc_tpu_torch.pdbio.parser import ParsedStructure, parse_pdb, parse_pdb_files
from protstruc_tpu_torch.pdbio.pdb import PDB, ChothiaAntibodyPDB
from protstruc_tpu_torch.pdbio.writer import to_pdb, structure_batch_to_pdb
from protstruc_tpu_torch.pdbio.fetch import fetch_pdb
from protstruc_tpu_torch.pdbio.dataset import StructureDataset
from protstruc_tpu_torch.pdbio.annotations import (
    SSRecord, author_ss_classes, parse_ss_records)
