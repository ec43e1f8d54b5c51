"""FoldModel (TrFold trunk + IPA structure module): the port vs the JAX package.

Tiny widths (node 32, pair 16, 2 heads, 1 trunk block, 2 IPA iterations, one
recycle), float32, on ``B=2`` 40-residue windows of bundled PDBs featurized by
the JAX package (``fused=True``, float32 angle planes).  The flax parameters
are initialised by JAX, the backbone update and point weights then set to
small random values (their zero init would leave every residue at the origin)
and carried across with ``convert.foldmodel_params_from_flax``.

Tolerances: rigid ops, geometry and metrics 1e-5 (coordinates 1e-4 A); the
IPA and structure-module outputs 1e-4; the FoldModel outputs 1e-4 (logits)
and 1e-3 A (coordinates, two IPA iterations of composed frames); the loss
1e-5 relative; each gradient leaf within 1e-4 of its largest entry.  Entries
whose exact gradient is 0 (a per-head constant on every logit of a softmax
row: the trunk's pair-bias bias and ``qkv`` key bias, the IPA's pair-bias
bias and ``k_scalar`` bias) are held to rounding noise instead, as in
tests/test_torch_trfold.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protstruc_tpu import StructureBatch as JaxBatch
from protstruc_tpu import geometry as jgeom
from protstruc_tpu.models import ipa as jipa
from protstruc_tpu.models import trfold as jtrfold
from protstruc_tpu.ops import metrics as jmetrics
from protstruc_tpu.ops import rigid as jrigid
from protstruc_tpu_torch import geometry as geom
from protstruc_tpu_torch.convert import (foldmodel_params_from_flax, foldmodel_params_to_flax,
                                         trfold_params_from_flax)
from protstruc_tpu_torch.models import ipa, trfold
from protstruc_tpu_torch.ops import metrics, rigid
from tests.conftest import pdb_path
from tests.test_torch_parity import DEVICE, as_numpy, assert_parity

torch.set_num_threads(1)

TRUNK = dict(node_dim=32, pair_dim=16, n_heads=2, n_blocks=1)
N_ITER, L_WIN = 2, 40
HEADS = ("distogram_logits", "torsion_sincos", "plddt_logits", "pae_logits")


def _t(x):
    return torch.from_numpy(np.array(x))


def _rng_frames(rng, *lead):
    q = rng.randn(*lead, 4).astype(np.float32)
    r = np.asarray(jrigid.quat_to_rot(jnp.asarray(q)))
    return q, r, (rng.randn(*lead, 3) * 5).astype(np.float32)


# ---------------------------------------------------------------------------
# rigid ops, geometry, metrics
# ---------------------------------------------------------------------------


def test_rigid_ops_match_jax():
    rng = np.random.RandomState(0)
    q, r1, t1 = _rng_frames(rng, 3, 5)
    _, r2, t2 = _rng_frames(rng, 3, 5)
    x = rng.randn(3, 5, 7, 3).astype(np.float32)
    assert_parity(r1, rigid.quat_to_rot(_t(q)), 1e-6, "quat_to_rot")
    for name, a, b in zip(("r", "t"), jrigid.frame_compose(r1, t1, r2, t2),
                          rigid.frame_compose(_t(r1), _t(t1), _t(r2), _t(t2))):
        assert_parity(np.asarray(a), b, 1e-5, f"compose {name}")
    for name, a, b in zip(("r", "t"), jrigid.frame_invert(r1, t1), rigid.frame_invert(_t(r1), _t(t1))):
        assert_parity(np.asarray(a), b, 1e-5, f"invert {name}")
    assert_parity(np.asarray(jrigid.frame_apply(r1, t1, x)), rigid.frame_apply(_t(r1), _t(t1), _t(x)),
                  1e-5, "apply")


def _bb(name="1ad0_DC.pdb"):
    return np.asarray(JaxBatch.from_pdb(pdb_path(name)).xyz)[0, :60]


def test_frames_and_ideal_backbone_match_jax():
    xyz = np.nan_to_num(_bb())
    for name, a, b in zip(("r", "t"), jipa.frames_from_backbone(xyz), ipa.frames_from_backbone(_t(xyz))):
        assert_parity(np.asarray(a), b, 1e-5, name)
    r, t = jipa.frames_from_backbone(xyz)
    for cb in (True, False):
        assert_parity(np.asarray(jipa.backbone_xyz_from_frames(r, t, include_cb=cb)),
                      ipa.backbone_xyz_from_frames(_t(r), _t(t), include_cb=cb), 1e-4, f"cb={cb}")
        assert_parity(np.asarray(jgeom.ideal_backbone_coordinates((2, 3), include_cb=cb)),
                      geom.ideal_backbone_coordinates((2, 3), include_cb=cb, device=DEVICE), 1e-6,
                      "ideal")


def test_ideal_carbonyl_oxygen_matches_jax():
    xyz = np.nan_to_num(_bb())
    chain = np.repeat([0, 1], 30)
    n, ca, c = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    for ci in (None, chain):
        ref = jgeom.ideal_carbonyl_oxygen(n, ca, c, chain_idx=ci)
        got = geom.ideal_carbonyl_oxygen(_t(n), _t(ca), _t(c),
                                         chain_idx=None if ci is None else _t(ci))
        assert_parity(np.asarray(ref), got, 1e-4, f"chain_idx={ci is not None}")


def test_kabsch_and_metrics_match_jax():
    rng = np.random.RandomState(1)
    a = (rng.randn(2, 30, 3) * 8).astype(np.float32)
    _, r, t = _rng_frames(rng)
    b = (a @ r.T + t + rng.randn(2, 30, 3) * 0.7).astype(np.float32)
    w = rng.rand(2, 30) > 0.2
    a_nan = a.copy()
    a_nan[~w] = np.nan
    for name, x, y in zip(("R", "t"), jgeom.masked_kabsch(a_nan, b, w), geom.masked_kabsch(_t(a_nan), _t(b), _t(w))):
        assert_parity(np.asarray(x), y, 1e-4, f"masked_kabsch {name}")
    for name, x, y in zip(("R", "t"), jgeom.kabsch(a, b), geom.kabsch(_t(a), _t(b))):
        assert_parity(np.asarray(x), y, 1e-4, f"kabsch {name}")
    for align in (True, False):
        assert_parity(np.asarray(jmetrics.rmsd(a, b, mask=w, align=align)),
                      metrics.rmsd(_t(a), _t(b), mask=_t(w), align=align), 1e-4, f"rmsd {align}")
    for per_res in (False, True):
        assert_parity(np.asarray(jmetrics.lddt(a, b, mask=w, per_residue=per_res)),
                      metrics.lddt(_t(a), _t(b), mask=_t(w), per_residue=per_res), 1e-5, "lddt")


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


def _ipa_cfgs():
    return (jipa.IPAConfig(node_dim=32, pair_dim=16, n_heads=2, n_iter=N_ITER),
            ipa.IPAConfig(node_dim=32, pair_dim=16, n_heads=2, n_iter=N_ITER))


def _randomise(tree, rng, scale=0.1):
    """Small random values for every leaf of ``tree`` (a flax subtree)."""
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.randn(*x.shape).astype(np.float32) * scale), tree)


def _module_inputs(seed=0, B=2, L=24):
    rng = np.random.RandomState(seed)
    node = rng.randn(B, L, 32).astype(np.float32)
    pair = rng.randn(B, L, L, 16).astype(np.float32)
    mask = np.ones((B, L), bool)
    mask[1, -4:] = False
    return rng, node, pair, mask


def test_invariant_point_attention_matches_jax():
    rng, node, pair, mask = _module_inputs()
    _, r, t = _rng_frames(rng, 2, 24)
    jcfg, tcfg = _ipa_cfgs()
    mod = jipa.InvariantPointAttention(jcfg)
    params = mod.init(jax.random.PRNGKey(0), node, pair, (r, t), mask)["params"]
    params = dict(params, point_weight=jnp.asarray(rng.randn(2).astype(np.float32)))
    ref = mod.apply({"params": params}, node, pair, (r, t), mask)
    port = ipa.InvariantPointAttention(tcfg, device=DEVICE)
    port.load_state_dict(trfold_params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    with torch.no_grad():
        got = port(_t(node), _t(pair), (_t(r), _t(t)), _t(mask))
    assert_parity(np.asarray(ref), got, 1e-4, "ipa")


def test_structure_module_matches_jax():
    rng, node, pair, mask = _module_inputs(seed=1)
    jcfg, tcfg = _ipa_cfgs()
    mod = jipa.StructureModule(jcfg)
    params = mod.init(jax.random.PRNGKey(1), node, pair, mask)["params"]
    params = dict(params, backbone_update=_randomise(params["backbone_update"], rng))
    ref = mod.apply({"params": params}, node, pair, mask)
    port = ipa.StructureModule(tcfg, device=DEVICE)
    port.load_state_dict(trfold_params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    with torch.no_grad():
        got = port(_t(node), _t(pair), _t(mask))
    assert_parity(np.asarray(ref["xyz"]), got["xyz"], 1e-4, "xyz")
    assert_parity(np.asarray(ref["node"]), got["node"], 1e-4, "node")
    for k in (0, 1):
        assert_parity(np.asarray(ref["frames"][k]), got["frames"][k], 1e-4, f"frames {k}")
        assert_parity(np.asarray(ref["traj"][k]), got["traj"][k], 1e-4, f"traj {k}")


# ---------------------------------------------------------------------------
# FoldModel and its losses
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def data():
    """B=2 windows (1REX, 4EOT), the JAX fused features (f32 planes) and the
    ground-truth coordinates, as numpy."""
    sb = JaxBatch.from_pdb([pdb_path("1REX.pdb"), pdb_path("4EOT.pdb")])
    sb = sb.replace(xyz=sb.xyz[:, 10:10 + L_WIN], atom_mask=sb.atom_mask[:, 10:10 + L_WIN],
                    chain_idx=sb.chain_idx[:, 10:10 + L_WIN],
                    residue_idx=sb.residue_idx[:, 10:10 + L_WIN], seq=None)
    feats = jtrfold.featurize_for_model(sb, fused=True, ang_dtype=jnp.float32)
    feats = {k: np.array(v) for k, v in feats.items()}
    feats["residue_mask"][1, -3:] = False
    return feats, np.asarray(sb.xyz)


def _jax_model():
    return jipa.FoldModel(trunk_cfg=jtrfold.TrFoldConfig(**TRUNK),
                          ipa_cfg=jipa.IPAConfig(n_heads=2, n_iter=N_ITER), n_recycle=1)


def _port_model():
    return ipa.FoldModel(trfold.TrFoldConfig(**TRUNK), ipa.IPAConfig(n_heads=2, n_iter=N_ITER),
                         n_recycle=1, device=DEVICE)


@pytest.fixture(scope="module")
def jax_fold(data):
    feats_np, xyz = data
    model = _jax_model()
    feats = {k: jnp.asarray(v) for k, v in feats_np.items()}
    params = jax.jit(model.init)(jax.random.PRNGKey(0), feats)["params"]
    rng = np.random.RandomState(5)
    st = dict(params["structure"])
    st["backbone_update"] = _randomise(st["backbone_update"], rng)
    st["ipa"] = dict(st["ipa"], point_weight=jnp.asarray(rng.randn(2).astype(np.float32)))
    params = dict(params, structure=st)
    apply = jax.jit(lambda p, f, nr: model.apply({"params": p}, f, n_recycle=nr),
                    static_argnums=2)
    outs = {nr: jax.tree_util.tree_map(np.asarray, apply(params, feats, nr)) for nr in (0, 1)}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jipa.fold_loss_fn(p, model, feats, jnp.asarray(xyz))))(params)
    return {"params": jax.tree_util.tree_map(np.asarray, params), "out": outs,
            "loss": float(loss), "grads": trfold_params_from_flax(
                jax.tree_util.tree_map(np.asarray, grads))}


def _loaded(jax_fold):
    model = _port_model()
    model.load_state_dict(foldmodel_params_from_flax(jax_fold["params"]))
    return model


def test_param_tree_matches_flax_and_round_trips(jax_fold):
    model = _port_model()
    sd = foldmodel_params_from_flax(jax_fold["params"])
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {
        k: tuple(v.shape) for k, v in sd.items()}
    back = foldmodel_params_to_flax(sd)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, jax_fold["params"])


@pytest.mark.parametrize("n_recycle", [0, 1])
def test_fold_model_forward_matches_jax(jax_fold, data, n_recycle):
    feats = {k: _t(v) for k, v in data[0].items()}
    ref = jax_fold["out"][n_recycle]
    with torch.no_grad():
        out = _loaded(jax_fold)(feats, n_recycle=n_recycle)
    for k in HEADS:
        assert_parity(ref[k], out[k], 1e-4, k)
    assert_parity(ref["xyz"], out["xyz"], 1e-3, "xyz")
    assert_parity(ref["traj"][1], out["traj"][1], 1e-3, "traj t")


def _zero_grad_entries(key, shape):
    mask = np.zeros(shape, bool)
    if key.endswith(("attn.pair_bias.bias", "ipa.pair_bias.bias", "ipa.k_scalar.bias")):
        mask[...] = True
    elif key.endswith("attn.qkv.bias"):
        mask[1] = True
    return mask


def test_fold_loss_and_gradients_match_jax(jax_fold, data):
    feats_np, xyz = data
    model = _loaded(jax_fold)
    params = dict(model.named_parameters())
    loss = ipa.fold_loss_fn(params, model, {k: _t(v) for k, v in feats_np.items()}, _t(xyz))
    loss.backward()
    assert abs(float(loss) - jax_fold["loss"]) <= 1e-5 * abs(jax_fold["loss"])
    ref = jax_fold["grads"]
    assert sorted(params) == sorted(ref)
    top = max(float(np.abs(as_numpy(r)).max()) for r in ref.values())
    for k, r in ref.items():
        r = as_numpy(r)
        g = as_numpy(params[k].grad) if params[k].grad is not None else np.zeros_like(r)
        zero = _zero_grad_entries(k, r.shape)
        assert max(np.abs(g[zero]).max(initial=0), np.abs(r[zero]).max(initial=0)) <= 1e-5 * top, k
        if zero.all():
            continue
        scale = float(np.abs(r[~zero]).max())
        assert float(np.abs(g - r)[~zero].max(initial=0)) <= 1e-4 * max(scale, 1e-30), k


def test_fape_and_confidence_losses_match_jax(jax_fold, data):
    feats_np, xyz = data
    out = jax_fold["out"][0]
    bb = np.nan_to_num(xyz[:, :, :3])
    ok = np.isfinite(xyz[:, :, :3]).all((-2, -1)) & feats_np["residue_mask"]
    tr, tt = jipa.frames_from_backbone(bb)
    pr, pt = out["frames"]
    pxyz = out["xyz"][:, :, :3]
    ref = jipa.fape_loss((pr, pt), pxyz, (tr, tt), bb, ok)
    got = ipa.fape_loss((_t(pr), _t(pt)), _t(pxyz), (_t(np.asarray(tr)), _t(np.asarray(tt))),
                        _t(bb), _t(ok))
    assert abs(float(got) - float(ref)) <= 1e-5 * abs(float(ref))
    jout = {k: jnp.asarray(out[k]) for k in ("xyz", "plddt_logits", "pae_logits")}
    jout["frames"] = (jnp.asarray(pr), jnp.asarray(pt))
    ref = jipa.confidence_losses(jout, (tr, tt), bb[:, :, 1], ok)
    tout = {k: _t(out[k]) for k in ("xyz", "plddt_logits", "pae_logits")}
    tout["frames"] = (_t(pr), _t(pt))
    got = ipa.confidence_losses(tout, (_t(np.asarray(tr)), _t(np.asarray(tt))), _t(bb[:, :, 1]),
                                _t(ok))
    assert abs(float(got) - float(ref)) <= 1e-5 * abs(float(ref))
    for a, b, f in ((out["plddt_logits"], jipa.plddt_from_logits, ipa.plddt_from_logits),
                    (out["pae_logits"], jipa.pae_from_logits, ipa.pae_from_logits)):
        assert_parity(np.asarray(b(jnp.asarray(a))), f(_t(a)), 1e-4, f.__name__)


def test_fold_model_without_recycle_embedders_refuses_recycling():
    model = ipa.FoldModel(trfold.TrFoldConfig(**TRUNK), ipa.IPAConfig(n_heads=2, n_iter=1),
                          n_recycle=0, device=DEVICE)
    assert not any(k.startswith("recycle_") for k in model.state_dict())
    feats = trfold.featurize_from_sequence(np.zeros((1, 6), np.int32), device=DEVICE)
    with pytest.raises(ValueError, match="n_recycle=0"):
        model(feats, n_recycle=1)
