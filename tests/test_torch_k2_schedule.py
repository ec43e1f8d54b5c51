"""K2's card schedule (``csrc/pair_maps_bwd.cu``), checked on the CPU.

* The walk: the wrapper hands K2 the plan of ``ops.pair_maps.bwd_plan``
  (the tile shape of K1 and K3, tile counts, grid, no vector stores) with a faked
  library; a batch of 70000 entries, past the 65535 blocks of a grid's y or
  z, is planned whole, and a plan the kernel refuses raises.
* The sums: a torch emulation of the kernel's partial layout (tiles of 32
  rows by 128 columns, lane ``l`` owning columns ``j0 + l + 32 q``; a lane's
  pairs of a row summed in ``q`` order map by map, then an xor butterfly over
  the warp's 32 lanes: one residue-i partial per (tile, i); each pair's
  residue-j terms added to its warp's column sums in row order, the warps
  summed in warp order: one residue-j partial per (tile, j); the partials
  summed in tile-index order) against ``_maps_bwd_pallas`` in interpret mode
  and the plain version on the JAX tests' inputs (a length no tile divides,
  the degenerate probes, a NaN residue): ``max|d| <= 1e-5 max(1,
  max|ref|)``, NaN patterns equal.

The kernel itself runs only on the card (``python3 chip_smoke.py`` phase 14).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from protstruc_tpu.ops import pallas_pairwise as pp
from protstruc_tpu_torch.ops import pair_maps as pm
from tests.test_torch_pair_maps_bwd import INPUTS, _cotangents, assert_grad_parity

torch.set_num_threads(1)

_N, _CA, _O, _CB = pm._N, pm._CA, pm._O, pm._CB


def _emulated_k2(xyz, grads):
    """dxyz as K2 sums it under ``bwd_plan``, in float32 torch."""
    x = xyz.to(torch.float32)
    B, L, A = x.shape[:3]
    plan = pm.bwd_plan(B, L)
    lanes = plan.tile_j // plan.pairs_j
    assert lanes == 32
    Li, Lj = plan.tiles_i * plan.tile_i, plan.tiles_j * plan.tile_j
    rows = plan.tile_i // plan.warps
    per = {("i", s): [] for s in (_N, _CA, _CB)} | {("j", s): [] for s in (_CA, _CB, _O)}
    for side, slot, v in pm._pair_contributions(x, {k: g.to(torch.float32) for k, g in grads.items()}):
        c = torch.stack([t.expand(B, L, L) for t in v], -1)                  # (B, L, L, 3)
        per[(side, slot)].append(F.pad(c, (0, 0, 0, Lj - L, 0, Li - L)))     # no pair past L adds

    part_i = {}   # (B, Li, tiles_j, 3): residue i's side of tile (b, i // 32, tj)
    for slot in (_N, _CA, _CB):
        cs = [c.reshape(B, Li, plan.tiles_j, plan.pairs_j, lanes, 3) for c in per[("i", slot)]]
        s = torch.zeros((B, Li, plan.tiles_j, lanes, 3))
        for q in range(plan.pairs_j):      # the lane's pairs, map by map
            for c in cs:
                s = s + c[:, :, :, q]
        for off in (16, 8, 4, 2, 1):       # the butterfly: lane l adds lane l ^ off
            s = s + s[:, :, :, torch.arange(lanes) ^ off]
        part_i[slot] = s[:, :, :, 0]
    part_j = {}   # (B, tiles_i, Lj, 3): residue j's side of tile (b, ti, j // 128)
    for slot in (_CA, _CB, _O):
        aj = torch.zeros((B, Li, Lj, 3))
        for c in per[("j", slot)]:         # each pair's terms, map by map
            aj = aj + c
        aj = aj.reshape(B, plan.tiles_i, rows, plan.warps, Lj, 3)   # tile row w + warps * r
        acc = torch.zeros((B, plan.tiles_i, plan.warps, Lj, 3))
        for r in range(rows):              # each warp's rows in order
            acc = acc + aj[:, :, r]
        s = acc[:, :, 0]
        for w in range(1, plan.warps):     # the warps in order
            s = s + acc[:, :, w]
        part_j[slot] = s

    def tile_sum(parts, dim):              # the partials in tile-index order
        s = torch.zeros_like(parts.select(dim, 0))
        for t in range(parts.shape[dim]):
            s = s + parts.select(dim, t)
        return s

    si = {slot: tile_sum(p, 2)[:, :L] for slot, p in part_i.items()}
    sj = {slot: tile_sum(p, 1)[:, :L] for slot, p in part_j.items()}
    dxyz = torch.zeros((B, L, A, 3))
    dxyz[:, :, _N] = si[_N]
    dxyz[:, :, _CA] = si[_CA] + sj[_CA]
    dxyz[:, :, _CB] = si[_CB] + sj[_CB]
    dxyz[:, :, _O] = sj[_O]
    return dxyz


@pytest.mark.parametrize("name", ["ragged_L37", "degenerate", "nan_residue"])
def test_emulated_schedule_matches_pallas_and_plain(name):
    make, tile = INPUTS[name]
    xyz = make()
    B, L = xyz.shape[:2]
    g = _cotangents(B, L, seed=0)
    got = _emulated_k2(torch.from_numpy(xyz), {k: torch.from_numpy(v) for k, v in g.items()})
    ref = pp._maps_bwd_pallas(jnp.asarray(xyz), {k: jnp.asarray(v) for k, v in g.items()}, tile, tile,
                              interpret=True)
    assert_grad_parity(ref, got, f"{name} vs Pallas backward")
    assert_grad_parity(pm._maps_bwd_plain(torch.from_numpy(xyz), {k: torch.from_numpy(v) for k, v in g.items()}),
                       got, f"{name} vs plain")
    if name == "nan_residue":
        assert torch.isnan(got[:, 5]).any()


def test_emulated_schedule_takes_map_subsets_and_several_tiles():
    """Two j-tiles and two i-tiles (L = 150), two maps: every residue's
    partials come from tiles of both kinds."""
    xyz = (np.random.RandomState(9).randn(1, 150, 15, 3) * 5).astype(np.float32)
    g = _cotangents(1, 150, seed=1, maps=("d_no", "theta"))
    g = {k: torch.from_numpy(v) for k, v in g.items()}
    got = _emulated_k2(torch.from_numpy(xyz), g)
    assert_grad_parity(pm._maps_bwd_plain(torch.from_numpy(xyz), g), got, "subset vs plain")


def _fake_bwd(monkeypatch, err=0):
    handed = []
    lib = types.SimpleNamespace(ps_pair_maps_bwd_f32=lambda *a: handed.append(a) or err)
    monkeypatch.setattr(pm, "load_bwd_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=0))
    return handed


@pytest.mark.parametrize("B,L", [(3, 37), (3, 512), (70000, 5)])
def test_wrapper_hands_k2_its_plan_for_any_batch(B, L, monkeypatch):
    handed = _fake_bwd(monkeypatch)
    monkeypatch.setattr(pm, "BWD_LAUNCHES", 0)
    x = torch.empty((B, L, 15, 3), device="meta")
    dxyz = pm._maps_bwd_cuda(x, {"d_ca": torch.empty((B, L, L), device="meta")})
    assert dxyz.shape == x.shape and pm.BWD_LAUNCHES == 1
    (args,) = handed
    got = args[-2]
    plan = pm.bwd_plan(B, L)
    assert [getattr(got, f) for f, _ in got._fields_] == [*pm.PAIR_TILE, plan.tiles_j, plan.tiles_i,
                                                          plan.grid, 0]
    assert plan.tiles_j * plan.tile_j >= L and plan.tiles_i * plan.tile_i >= L
    assert plan.n_tiles == B * plan.tiles_i * plan.tiles_j and plan.grid == plan.n_tiles
    assert pm.bwd_scratch(plan) == (B * plan.tiles_j * 9 * L, B * plan.tiles_i * 9 * L)


def test_refused_plan_raises(monkeypatch):
    _fake_bwd(monkeypatch, err=-3)
    with pytest.raises(RuntimeError, match="refused its tile plan"):
        pm._maps_bwd_cuda(torch.zeros((1, 8, 15, 3)), {"phi": torch.zeros((1, 8, 8))})
