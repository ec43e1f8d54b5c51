"""The tile skeleton of K1 and K3 (``csrc/pair_maps.cuh``), checked on the CPU.

* The tile walk: the wrappers hand every K1 and K3 launch the plan of
  ``ops.pair_maps.tile_plan`` (tile counts, grid, store rule; checked here
  with a faked library).  The kernels' index arithmetic over that plan is
  emulated in numpy block by block, warp by warp, lane by lane, for the grid
  the wrappers launch and for one clamped below the tile count (a block then
  walks several tiles, as past 2^31 - 1 tiles): every ``(b, i, j)`` is
  written exactly once, and every vector store (K1's f32 and bf16 planes,
  K3's bins and its f32 and bf16 6-plane runs) falls on an address aligned
  to its width, given 16-byte-aligned bases.
* The i-side split: a plain torch emulation of the kernels' split (the terms
  of residue i built once, then each pair) is bitwise equal to
  ``_pair_maps_plain`` and ``_model_features_plain``.
* K1's bf16 mode: ``pairwise_maps_forward(out_dtype=bfloat16)`` on the CPU
  against ``pairwise_maps_pallas(out_dtype=bfloat16, interpret=True)``:
  within one bf16 ulp of |ref| beyond the f32 planes' own 1e-5 gate
  (tests/test_torch_pair_maps.py; the Pallas kernel's minimax atan2), NaN
  patterns equal, and bit for bit the f32 plain planes cast to bf16.

The CUDA kernels run only on the card (``python3 chip_smoke.py``).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protstruc_tpu.ops.pallas_pairwise import pairwise_maps_pallas
from protstruc_tpu_torch.ops import model_features as mf
from protstruc_tpu_torch.ops import pair_maps as pm
from protstruc_tpu_torch.ops.pair_maps import (
    MAP_NAMES,
    _cross,
    _dot,
    _eq3,
    _pair_maps_plain,
    _sub,
    pairwise_maps_forward,
)
from tests.test_torch_pair_maps import INPUTS

torch.set_num_threads(1)

LENGTHS = (1, 2, 31, 33, 37, 127, 129, 300, 512)   # chip_smoke.py phase 3's list

# bytes of one element and of one vector store, per output the kernels write
OUTPUTS = {  # name: (bytes per pair, vector store bytes)
    "K1 f32 plane": (4, 16),
    "K1 bf16 plane": (2, 8),
    "K3 int32 bins": (4, 16),
    "K3 f32 planes": (24, 16),
    "K3 bf16 planes": (12, 16),
}


def _walk(plan):
    """Every store the kernels make under ``plan`` (pair_maps.cuh
    pair_tiles), as numpy arrays over (tile, warp, row, lane, pair): the flat
    pair index, whether it is written, whether its run is stored by vectors
    (the run's first pair carries the address), and whether its warp's row
    is ``wide`` (vector stores, tile whole: K3's f32 planes then go out as
    the warp's one contiguous stretch)."""
    per_block = [np.arange(k, plan.n_tiles, plan.grid) for k in range(plan.grid)]
    t = np.concatenate(per_block)
    assert len(t) == plan.n_tiles
    tj = t % plan.tiles_j
    bi = t // plan.tiles_j
    ti, b = bi % plan.tiles_i, bi // plan.tiles_i
    rows = plan.tile_i // plan.warps
    w = np.arange(plan.warps)[:, None]
    r = w + plan.warps * np.arange(rows)[None, :]                 # (warps, rows)
    lane, q = np.arange(32)[:, None], np.arange(plan.pairs_j)[None, :]
    assert 32 * plan.pairs_j == plan.tile_j
    i = (ti * plan.tile_i)[:, None, None, None, None] + r[None, :, :, None, None]
    jt = (tj * plan.tile_j)[:, None, None, None, None] + (plan.pairs_j * lane)[None, None, None]
    j = jt + q[None, None, None]
    b = b[:, None, None, None, None]
    L = plan.L
    written = (i < L) & (jt < L) & (j < L)
    vec = np.broadcast_to(plan.vector, written.shape) & (i < L) & (jt < L)
    wide = plan.vector & ((tj * plan.tile_j + plan.tile_j <= L)[:, None, None, None, None]) & (i < L)
    o = (b * L + i) * L + j
    shape = np.broadcast_shapes(o.shape, written.shape, vec.shape, wide.shape)
    return tuple(np.broadcast_to(a, shape) for a in (o, written, vec, wide))


@pytest.mark.parametrize("grid", ["plain", "persistent"])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("L", LENGTHS)
def test_tile_walk_writes_each_pair_once_with_aligned_vectors(L, B, grid, monkeypatch):
    if grid == "persistent":   # tile_plan's clamp, at 7 blocks in place of 2^31 - 1
        monkeypatch.setattr(pm, "_MAX_GRID", 7)
    plan = pm.tile_plan(B, L)
    assert (plan.pairs_j, plan.tile_j, plan.tile_i, plan.warps) == pm.PAIR_TILE
    assert plan.grid == (plan.n_tiles if grid == "plain" else min(7, plan.n_tiles))
    o, written, vec, wide = _walk(plan)
    counts = np.bincount(o[written], minlength=B * L * L)
    assert counts.shape == (B * L * L,) and (counts == 1).all()
    # a vector run is whole: its pairs are all written, and only by it
    assert written[vec].all()
    starts = o[..., 0][vec[..., 0]]
    for name, (elem, width) in OUTPUTS.items():
        addr = starts * elem
        for k in range(4 * elem // width):   # the run's stores, 16 (or 8) bytes apart
            assert ((addr + k * width) % width == 0).all(), name
    # a wide row: every lane's run whole, and the warp's runs one stretch
    # starting 16-byte aligned in K3's f32 planes (24 bytes a pair)
    assert vec[wide].all()
    firsts = o[..., 0, 0][wide[..., 0, 0]]          # lane 0's first pair of each wide warp-row
    assert ((firsts % L) % plan.tile_j == 0).all()         # the tile's first column
    assert ((firsts * 24) % 16 == 0).all()
    # every pair by a vector store where L is a multiple of 4, else none
    assert int(vec.sum()) == (B * L * L if L % 4 == 0 else 0)


def test_tile_plan_grid_is_flat():
    """The flat tile index bounds B by nothing but the grid's 2^31 - 1
    blocks, and past them a block walks several tiles."""
    plan = pm.tile_plan(70000, 512)
    assert plan.n_tiles == 70000 * 4 * 16 and plan.grid == plan.n_tiles
    big = pm.tile_plan(2**26, 512)
    assert big.n_tiles > 2**31 - 1 and big.grid == 2**31 - 1


def test_kernels_take_any_batch_but_k2_keeps_its_limit():
    """All three pair kernels take any batch: K1, K3 and K2 each walk a flat
    tile index, and no wrapper bounds B.  (The name dates from when K2 ran B
    along a grid axis and refused B > 65535; it no longer keeps a limit.)"""
    x = torch.empty((70000, 4, 15, 3), device="meta")
    for what in ("pair_maps", "model_features", "pair_maps_bwd"):
        pm._check_xyz(x, what)
    for plan in (pm.tile_plan(70000, 4), pm.bwd_plan(70000, 4)):
        assert plan.n_tiles == 70000 and plan.grid == plan.n_tiles


def _fake_launch(monkeypatch, module, entry, err=0):
    """Fake ``module``'s library (no card here): its C entry records the
    arguments it is handed and returns ``err``."""
    handed = []

    def fn(*args):
        handed.append(args)
        return err

    lib = types.SimpleNamespace(**{entry: fn})
    monkeypatch.setattr(module, "load_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=0))
    return handed


_ENTRIES = {  # case: (module, C entry, launch through the wrapper, counter)
    "K1 f32": (pm, "ps_pair_maps_f32", lambda x: pm._pair_maps_cuda(x, MAP_NAMES, torch.float32),
               "LAUNCHES"),
    "K1 bf16": (pm, "ps_pair_maps_bf16", lambda x: pm._pair_maps_cuda(x, MAP_NAMES, torch.bfloat16),
                "BF16_LAUNCHES"),
    "K3 f32": (mf, "ps_model_features", lambda x: mf._model_features_cuda(x, 36, 20.0, torch.float32),
               "LAUNCHES"),
    "K3 bf16": (mf, "ps_model_features", lambda x: mf._model_features_cuda(x, 36, 20.0, torch.bfloat16),
                "LAUNCHES"),
}


@pytest.mark.parametrize("L", [1, 37, 512])
@pytest.mark.parametrize("case", sorted(_ENTRIES))
def test_wrappers_launch_the_plan(case, L, monkeypatch):
    """Each K1 and K3 wrapper hands its C entry the plan of ``tile_plan``,
    and counts the launch on its own counter (the library is faked)."""
    module, entry, launch, counter = _ENTRIES[case]
    handed = _fake_launch(monkeypatch, module, entry)
    monkeypatch.setattr(pm, "LAUNCHES", 0)
    monkeypatch.setattr(pm, "BF16_LAUNCHES", 0)
    monkeypatch.setattr(mf, "LAUNCHES", 0)
    launch(torch.zeros((3, L, 15, 3)))
    (args,) = handed
    plan = pm.tile_plan(3, L)
    assert plan.vector == (L % 4 == 0)
    got = args[-2]
    assert [getattr(got, f) for f, _ in got._fields_] == [
        plan.pairs_j, plan.tile_j, plan.tile_i, plan.warps, plan.tiles_j, plan.tiles_i, plan.grid,
        int(plan.vector)]
    counts = {"pm.LAUNCHES": pm.LAUNCHES, "pm.BF16_LAUNCHES": pm.BF16_LAUNCHES, "mf.LAUNCHES": mf.LAUNCHES}
    want = f"{'pm' if module is pm else 'mf'}.{counter}"
    assert counts == {k: int(k == want) for k in counts}


def test_libraries_with_other_tiles_are_refused(monkeypatch):
    """A kernel refuses a plan it cannot take (-3: pair_maps.cuh plan_fits),
    and the wrappers raise rather than return unwritten planes."""
    for case in ("K1 f32", "K3 bf16"):
        module, entry, launch, _ = _ENTRIES[case]
        _fake_launch(monkeypatch, module, entry, err=-3)
        with pytest.raises(RuntimeError, match="refused its tile plan"):
            launch(torch.zeros((1, 8, 15, 3)))


# ---------------------------------------------------------------------------
# the i-side split, emulated in plain torch
# ---------------------------------------------------------------------------


def _sides(xyz):
    x = xyz.to(torch.float32)

    def vi(slot):
        return tuple(x[:, :, slot, k][:, :, None] for k in range(3))

    def vj(slot):
        return tuple(x[:, :, slot, k][:, None, :] for k in range(3))

    n, ca, cb = vi(0), vi(1), vi(4)
    I = {"n": n, "ca": ca, "cb": cb, "cab": _sub(ca, cb), "tb1": _sub(cb, ca),
         "eq_ca_cb": _eq3(ca, cb), "eq_n_cb": _eq3(n, cb), "eq_n_ca": _eq3(n, ca)}
    I["tn0"] = _cross(_sub(n, ca), I["tb1"])
    I["tnh"] = -torch.sqrt(_dot(I["tb1"], I["tb1"]))
    I["ba_zero"] = _dot(I["cab"], I["cab"]) == 0.0
    ca_j, cb_j = vj(1), vj(4)
    J = {"ca": ca_j, "cb": cb_j, "o": vj(3), "ob2": _sub(cb_j, ca_j), "eq_ca_cb": _eq3(ca_j, cb_j)}
    return I, J


def _split_maps(xyz):
    """K1's pair_maps_pair on PairI/PairJ (csrc/pair_maps.cuh), in torch."""
    I, J = _sides(xyz)

    def dihedral_n0(n0, b1, b2, neg_len_b1):
        n1 = _cross(b2, b1)
        return torch.atan2(neg_len_b1 * _dot(n0, b2) + 0.0, _dot(n0, n1) + 0.0)

    def dist(a, b):
        d = _sub(a, b)
        return torch.sqrt(_dot(d, d))

    b1 = _sub(J["ca"], I["cb"])
    deg_o = (_eq3(I["ca"], J["ca"]) & _eq3(I["cb"], J["cb"])) | J["eq_ca_cb"] | I["eq_ca_cb"]
    omega = dihedral_n0(_cross(I["cab"], b1), b1, J["ob2"], -torch.sqrt(_dot(b1, b1)))
    bc = _sub(J["cb"], I["cb"])
    deg_t = (I["eq_n_cb"] & _eq3(I["ca"], J["cb"])) | _eq3(I["cb"], J["cb"]) | I["eq_n_ca"]
    theta = dihedral_n0(I["tn0"], I["tb1"], bc, I["tnh"])
    cr = _cross(I["cab"], bc)
    phi = torch.atan2(torch.sqrt(_dot(cr, cr)), _dot(I["cab"], bc))
    out = {"d_ca": dist(I["ca"], J["ca"]), "d_cb": dist(I["cb"], J["cb"]),
           "d_no": dist(I["n"], J["o"]),
           "omega": torch.where(deg_o, 0.0, omega), "theta": torch.where(deg_t, 0.0, theta),
           "phi": torch.where((_dot(bc, bc) == 0.0) | I["ba_zero"], torch.nan, phi)}
    B, L = xyz.shape[:2]
    return {k: v.expand(B, L, L) for k, v in out.items()}


def _split_features(xyz, n_bins=36, max_dist=20.0):
    """K3's features_pair on PairI/PairJ (csrc/model_features.cu), in torch."""
    I, J = _sides(xyz)

    def sincos_n0(n0, b1, b2, neg_len_b1, deg):
        n1 = _cross(b2, b1)
        x, y = _dot(n0, n1), neg_len_b1 * _dot(n0, b2)
        r2 = x * x + y * y
        pos = r2 > 0.0
        inv = torch.rsqrt(torch.where(pos, r2, 1.0))
        ok = pos & ~deg
        return (torch.where(ok, y * inv, 0.0),
                torch.where(ok, x * inv, torch.where(deg, 1.0, 0.0)))

    dcb = _sub(I["cb"], J["cb"])
    d = torch.sqrt(_dot(dcb, dcb))
    d = torch.where(torch.isnan(d), max_dist, d)
    ratio = torch.tensor(mf._ratio(n_bins, max_dist), dtype=torch.float32)
    bins = torch.clamp_max(d * ratio, float(n_bins - 1)).to(torch.int32)
    b1 = _sub(J["ca"], I["cb"])
    deg_o = (_eq3(I["ca"], J["ca"]) & _eq3(I["cb"], J["cb"])) | J["eq_ca_cb"] | I["eq_ca_cb"]
    o = sincos_n0(_cross(I["cab"], b1), b1, J["ob2"], -torch.sqrt(_dot(b1, b1)), deg_o)
    bc = _sub(J["cb"], I["cb"])
    deg_t = (I["eq_n_cb"] & _eq3(I["ca"], J["cb"])) | _eq3(I["cb"], J["cb"]) | I["eq_n_ca"]
    t = sincos_n0(I["tn0"], I["tb1"], bc, I["tnh"], deg_t)
    cr = _cross(I["cab"], bc)
    s2, dt = _dot(cr, cr), _dot(I["cab"], bc)
    r2 = s2 + dt * dt
    okp = r2 > 0.0
    inv = torch.rsqrt(torch.where(okp, r2, 1.0))
    p = (torch.where(okp, torch.sqrt(torch.where(s2 > 0.0, s2, 0.0)) * inv, 0.0),
         torch.where(okp, dt * inv, 0.0))
    B, L = xyz.shape[:2]
    planes = [v.expand(B, L, L) for v in (*o, *t, *p)]
    return bins.expand(B, L, L), torch.stack(planes, dim=-1)


def _bits_equal(a, b):
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    assert torch.equal(nan_a, nan_b)
    view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return torch.equal(a.masked_fill(nan_a, 0).view(view), b.masked_fill(nan_b, 0).view(view))


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_i_side_split_is_bitwise_the_plain_version(name):
    xyz = torch.from_numpy(INPUTS[name]())
    ref = _pair_maps_plain(xyz)
    got = _split_maps(xyz)
    for k in MAP_NAMES:
        assert _bits_equal(ref[k], got[k].contiguous()), k
    rbins, rang = mf._model_features_plain(xyz, ang_dtype=torch.float32)
    bins, ang = _split_features(xyz)
    assert torch.equal(rbins, bins)
    assert _bits_equal(rang, ang.contiguous())


# ---------------------------------------------------------------------------
# K1's bf16 mode
# ---------------------------------------------------------------------------


def _bf16_ulp(x):
    """The spacing of bf16 values at |x| (one ulp), taken at the smallest
    normal for 0."""
    a = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(a)) - 7)


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_bf16_mode_matches_pallas_interpret(name):
    xyz = INPUTS[name]()
    ref = pairwise_maps_pallas(xyz, tile_i=64, tile_j=128, interpret=True, out_dtype=jnp.bfloat16)
    x = torch.from_numpy(xyz)
    out = pairwise_maps_forward(x, out_dtype=torch.bfloat16)
    f32 = _pair_maps_plain(x)
    assert tuple(out) == MAP_NAMES
    for k in MAP_NAMES:
        assert out[k].dtype == torch.bfloat16 and out[k].shape == f32[k].shape
        assert _bits_equal(out[k], f32[k].to(torch.bfloat16)), k
        r = np.asarray(ref[k]).astype(np.float32)
        got = out[k].float().numpy()
        assert np.array_equal(np.isnan(r), np.isnan(got)), k
        ok = ~np.isnan(r)
        # f32 planes agree within 1e-5 (the Pallas kernel's minimax atan2);
        # each rounds once more to bf16
        assert (np.abs(got - r)[ok] <= _bf16_ulp(r[ok]) + 1e-5).all(), k


def test_forward_entry_checks_and_dispatch():
    x = torch.from_numpy(INPUTS["random_L37"]())
    launches = (pm.LAUNCHES, pm.BF16_LAUNCHES)
    sub = pairwise_maps_forward(x, maps=("phi", "d_ca"), out_dtype=torch.bfloat16)
    assert tuple(sub) == ("phi", "d_ca")
    assert (pm.LAUNCHES, pm.BF16_LAUNCHES) == launches   # CPU tensors never count as launches
    with pytest.raises(TypeError, match="out_dtype"):
        pairwise_maps_forward(x, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="unknown maps"):
        pairwise_maps_forward(x, maps=("chi",))
    with pytest.raises(ValueError, match="no implementation"):
        pairwise_maps_forward(x.to("meta"))
