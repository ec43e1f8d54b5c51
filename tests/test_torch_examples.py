"""Each ported example (``protstruc_tpu_torch/examples/``) runs on the CPU at
its smallest step count, in this process (the IGSO3 table and the imports
are shared), from a temporary working directory, and writes what it says.
``train_trfold`` takes a directory: it trains one step at batch 1 over a
directory holding one structure, and its printed loss is finite.

The JAX package's examples have their own runner (tests/test_examples.py);
these are the port's drivers of the same pipelines.
"""

import importlib
import math
import re
import shutil

import numpy as np
import pytest
import torch

from protstruc_tpu_torch import StructureBatch
from tests.conftest import pdb_path

torch.set_num_threads(1)

CASES = {
    "design_pipeline": ("1REX.pdb", ["out/designed.pdb"]),
    "design_cdr": ("6dc4.pdb", ["out/design_cdr.txt"]),
    "framediff_backbones": ("1REX.pdb", [f"out/framediff_sample_{i}.pdb" for i in range(4)]),
    "generate_backbones": ("1REX.pdb", ["out/generated_ca.pdb"]),
    "reconstruct_pipeline": ("1REX.pdb", ["out/reconstructed.pdb"]),
    "train_trfold": ("1REX.pdb", []),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_runs_on_the_cpu(name, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    pdb, files = CASES[name]
    mod = importlib.import_module(f"protstruc_tpu_torch.examples.{name}")
    if name == "train_trfold":
        (tmp_path / "data").mkdir()
        shutil.copy(pdb_path(pdb), tmp_path / "data")
        argv = ["--data", "data", "--steps", "1", "--batch-size", "1", "--device", "cpu"]
    else:
        argv = [pdb_path(pdb), "1", "--device", "cpu"]
    written = mod.main(argv)
    assert written == files
    if name == "train_trfold":
        losses = re.findall(r"loss=(\S+)", capsys.readouterr().out)
        assert len(losses) == 1 and math.isfinite(float(losses[0])), losses
    for f in files:
        path = tmp_path / f
        assert path.stat().st_size > 0, f
        if f.endswith(".pdb"):
            xyz = StructureBatch.from_pdb(str(path), device="cpu").xyz.numpy()
            assert np.isfinite(xyz).any() and not np.isinf(xyz).any(), f
        else:
            text = path.read_text()
            assert "AR H3 redesign (T=1.0)" in text and "recovery" in text


def test_examples_list_is_exhaustive():
    import pathlib

    import protstruc_tpu_torch.examples as ex

    names = {p.stem for p in pathlib.Path(ex.__file__).parent.glob("*.py")} - {"__init__"}
    assert names == set(CASES)
