"""The K1 roofline probes' plain versions vs the JAX probe kernels on the CPU.

``experiments/kernel_probe.py`` (loaded by path, not edited) holds the TPU
probe kernels: ``_write_only_kernel``, ``_write_only_packed_kernel``,
``_full_packed_kernel`` and ``_make_opt_kernel(deg, fdiv, False, False)``
for degrees 9-15 with and without the fast divide.  Each runs here through
``pl.pallas_call(..., interpret=True)`` with ``run_variant``'s or
``run_packed_variant``'s BlockSpecs at B=1, L=128 (one tile), against the
port's plain version of the same probe (``probe_plain``): 1e-5 absolute, NaN
patterns equal.  The CUDA probe kernels run only on the card
(``python3 chip_smoke.py`` phase 17).
"""

import importlib.util
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from protstruc_tpu.ops import pallas_pairwise as pp
from protstruc_tpu_torch.experiments import kernel_probe
from protstruc_tpu_torch.ops.pair_maps import MAP_NAMES
from tests.test_torch_parity import assert_parity

torch.set_num_threads(1)

B, L = 1, 128
_PATH = pathlib.Path(__file__).resolve().parents[1] / "experiments" / "kernel_probe.py"


def _load_jax_probe():
    """The TPU probe module; its import-time ``sweep`` switch reads sys.argv,
    so the argv it sees names no mode."""
    spec = importlib.util.spec_from_file_location("jax_kernel_probe", _PATH)
    mod = importlib.util.module_from_spec(spec)
    argv = sys.argv
    sys.argv = [str(_PATH)]
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.argv = argv
    return mod


jkp = _load_jax_probe()


def _xyz():
    return (np.random.RandomState(0).randn(B, L, 15, 3) * 10).astype(np.float32)


def _pallas(kernel, xyz, packed):
    """``kernel`` over ``run_variant``'s (six ``(B, L, L)`` outputs) or
    ``run_packed_variant``'s (one ``(B, 6, L, L)``) BlockSpecs, one tile."""
    fi, fj = pp._pack_planes(jnp.asarray(xyz))
    in_specs = [pl.BlockSpec((1, L, 12), lambda b, i, j: (b, i, 0), memory_space=pltpu.VMEM),
                pl.BlockSpec((1, 12, L), lambda b, i, j: (b, 0, j), memory_space=pltpu.VMEM)]
    if packed:
        out_specs = pl.BlockSpec((1, 6, L, L), lambda b, i, j: (b, 0, i, j),
                                 memory_space=pltpu.VMEM)
        out_shape = jax.ShapeDtypeStruct((B, 6, L, L), jnp.float32)
    else:
        out_specs = [pl.BlockSpec((1, L, L), lambda b, i, j: (b, i, j),
                                  memory_space=pltpu.VMEM)] * 6
        out_shape = [jax.ShapeDtypeStruct((B, L, L), jnp.float32)] * 6
    out = pl.pallas_call(kernel, grid=(B, 1, 1), in_specs=in_specs, out_specs=out_specs,
                         out_shape=out_shape, interpret=True)(fi, fj)
    if packed:
        return {k: np.asarray(out[:, n]) for n, k in enumerate(MAP_NAMES)}
    return {k: np.asarray(v) for k, v in zip(MAP_NAMES, out)}


CASES = {"write-only": (lambda: jkp._write_only_kernel, "write-only", False),
         "write-only-packed": (lambda: jkp._write_only_packed_kernel, "write-only", True),
         "full-packed": (lambda: jkp._full_packed_kernel, "full", True)}
CASES.update({f"opt-d{d}{'-fdiv' if fd else ''}": (
    lambda d=d, fd=fd: jkp._make_opt_kernel(d, fd, False, False),
    f"opt-d{d}{'-fdiv' if fd else ''}", False) for d in (9, 11, 13, 15) for fd in (False, True)})


@pytest.mark.parametrize("name", sorted(CASES))
def test_probe_plain_matches_jax_probe_kernel(name):
    make, variant, packed = CASES[name]
    xyz = _xyz()
    ref = _pallas(make(), xyz, packed)
    out = kernel_probe.probe_plain(torch.from_numpy(xyz), variant, packed=packed)
    if packed:
        assert out.shape == (B, 6, L, L)
        out = dict(zip(MAP_NAMES, out.unbind(1)))
    for k in MAP_NAMES:
        assert_parity(ref[k], out[k], 1e-5, f"{name} {k}")


def test_probe_dispatch_on_the_cpu():
    xyz = torch.from_numpy(_xyz()[:, :20])
    launches = kernel_probe.LAUNCHES
    got = kernel_probe.probe(xyz, "full", maps=("d_ca", "d_cb", "d_no"), block=(32, 8, 4))
    assert tuple(got) == ("d_ca", "d_cb", "d_no")
    assert kernel_probe.LAUNCHES == launches  # CPU tensors never count as launches
    with pytest.raises(ValueError, match="no block"):
        kernel_probe.probe(xyz, "opt-d9", block=(32, 8, 4))
    with pytest.raises(ValueError, match="unknown probe variant"):
        kernel_probe.probe(xyz, "no-such")
    with pytest.raises(ValueError, match="packed"):
        kernel_probe.probe(xyz, "full", maps=("d_ca",), packed=True)
