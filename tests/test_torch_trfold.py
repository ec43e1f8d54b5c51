"""The TrFold train step: the port vs the JAX package on the CPU.

Data: ``tests/data/1ad0_DC.pdb`` featurized by both packages, then two
20-residue windows across its chain break (so the cross-chain relative
position class is used), the second with its last three residues masked out
as padding.  Model: TrFold with ``node_dim=32, pair_dim=16, n_heads=2,
n_blocks=2`` in float32, in three configurations: ``gated_mix``;
``triangle`` unfused; ``triangle`` with ``fused_tri=True`` (the JAX side runs
the Pallas kernels in interpret mode, the port the plain versions of K4-K7
through its autograd functions) and ``remat=True``.  Both packages run one
set of weights: the port's flax-style init, carried to the JAX model with
``convert.trfold_params_to_flax``; the tree's paths and shapes are held to
the flax init's (``jax.eval_shape``).

Compared: ``featurize_for_model`` outputs (masks bitwise, floats 1e-5);
forward outputs (1e-5); the loss (1e-5 relative); gradients per leaf (1e-4
of the leaf's largest gradient); params after one ``train_step`` (optax
``adamw`` against ``torch.optim.AdamW``, 1e-5).  Each JAX reference is
computed once per module.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from protstruc_tpu import StructureBatch as JaxBatch
from protstruc_tpu.models import trfold as jtrfold
from protstruc_tpu.ops.histogram import distogram_bins as jax_distogram_bins
from protstruc_tpu_torch import StructureBatch
from protstruc_tpu_torch.convert import trfold_params_from_flax, trfold_params_to_flax
from protstruc_tpu_torch.models import trfold
from protstruc_tpu_torch.ops import cuda_lib, pair_maps, tri_mul
from protstruc_tpu_torch.ops.histogram import distogram_bins
from tests.conftest import pdb_path
from tests.test_torch_parity import DEVICE, as_numpy, assert_parity

torch.set_num_threads(1)

WINDOWS = ((204, 224), (208, 228))  # 1ad0_DC's chain C ends at residue 213
WIDTHS = dict(node_dim=32, pair_dim=16, n_heads=2, n_blocks=2)
CONFIGS = {
    "gated_mix": dict(),
    "triangle": dict(pair_update="triangle"),
    "triangle_fused_remat": dict(pair_update="triangle", fused_tri=True, remat=True),
}
LR = 1e-3


def _zero_grad_entries(key, shape):
    """Entries whose exact gradient is 0: the pair-bias bias and the key
    bias of ``qkv`` each add a per-head constant to every logit of a softmax
    row.  Both packages return float32 rounding noise for them (~1e-7), which
    one Adam step turns into a step of up to the learning rate either way."""
    mask = np.zeros(shape, bool)
    if key.endswith("attn.pair_bias.bias"):
        mask[...] = True
    elif key.endswith("attn.qkv.bias"):
        mask[1] = True  # (q, k, v) x heads x dh
    return mask
HEADS = ("distogram_logits", "torsion_sincos", "omega_sincos", "theta_sincos", "phi_sincos")


@pytest.fixture(scope="module")
def featurized():
    path = pdb_path("1ad0_DC.pdb")
    ref = jtrfold.featurize_for_model(JaxBatch.from_pdb(path))
    out = trfold.featurize_for_model(StructureBatch.from_pdb(path, device=DEVICE))
    return {k: np.asarray(v) for k, v in ref.items()}, out


@pytest.fixture(scope="module")
def feats_np(featurized):
    """B=2 windows of the JAX featurization, as numpy."""
    full = featurized[0]
    out = {}
    for k, v in full.items():
        parts = [v[:, s:e, s:e] if k in ("d_cb", "omega", "theta", "phi", "pair_mask")
                 else v[:, s:e] for s, e in WINDOWS]
        out[k] = np.concatenate(parts, axis=0)
    out["residue_mask"][1, -3:] = False  # padding at the end of the second window
    return out


def _torch_feats(feats_np):
    return {k: torch.from_numpy(v.copy()) for k, v in feats_np.items()}


def _flat(tree):
    """A flax tree as {dotted path: numpy}."""
    return {k: as_numpy(v) for k, v in trfold_params_from_flax(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


@pytest.fixture(scope="module")
def jax_ref(feats_np):
    """``jax_ref(name)``: params, outputs, loss, gradients and one adamw step
    of the JAX model, computed once per config."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _jax_reference(name, feats_np)
        return cache[name]

    return get


def _jax_reference(name, feats_np):
    # jitted (eager flax, and eager optax over ~50 leaves, cost far more
    # here): the forward, value_and_grad of loss_fn, and train_step's update.
    # The params are the port's init (a jitted flax init would be one more
    # compile per config); eval_shape gives the flax init's tree
    model = jtrfold.TrFold(jtrfold.TrFoldConfig(**WIDTHS, **CONFIGS[name]))
    feats = {k: jnp.asarray(v) for k, v in feats_np.items()}
    port = trfold.TrFold(trfold.TrFoldConfig(**WIDTHS, **CONFIGS[name]), device=DEVICE)
    port.reset_parameters(torch.Generator().manual_seed(0))
    params = jax.tree_util.tree_map(jnp.asarray, trfold_params_to_flax(port.state_dict()))
    tx = optax.adamw(1e-3)
    out = jax.jit(lambda p, f: model.apply({"params": p}, f))(params, feats)
    loss, grads = jax.jit(jax.value_and_grad(lambda p, f: jtrfold.loss_fn(p, model, f)))(
        params, feats)
    new_params = jax.jit(lambda p, g, s: optax.apply_updates(p, tx.update(g, s, p)[0]))(
        params, grads, tx.init(params))
    return {
        "flax_shapes": _flat_shapes(jax.eval_shape(model.init, jax.random.PRNGKey(0), feats)["params"]),
        "params": jax.tree_util.tree_map(np.asarray, params),
        "out": {k: np.asarray(out[k]) for k in HEADS},
        "loss": float(loss),
        "grads": _flat(grads),
        "new_params": _flat(new_params),
    }


def _flat_shapes(tree):
    """A flax tree's leaves as {dotted path: shape}."""
    return {".".join(str(k.key) for k in path): tuple(v.shape)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_model(name, params_tree, **extra):
    cfg = trfold.TrFoldConfig(**WIDTHS, **{**CONFIGS[name], **extra})
    model = trfold.TrFold(cfg, device=DEVICE)
    return model, trfold_params_from_flax(params_tree)


@pytest.mark.parametrize("key", ["seq_idx", "torsions", "torsion_mask", "residue_mask",
                                 "chain_idx", "d_cb", "omega", "theta", "phi", "pair_mask"])
def test_featurize_for_model_matches_jax(featurized, key):
    ref, out = featurized
    assert sorted(out) == sorted(ref)
    assert_parity(ref[key], out[key], 1e-5, key)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def run(request, feats_np, jax_ref):
    """One config through both packages: forward, then one train_step."""
    name = request.param
    ref = jax_ref(name)
    model, sd = _port_model(name, ref["params"])
    feats = _torch_feats(feats_np)
    params, opt_state, tx = trfold.make_train_state(model, feats, torch.Generator().manual_seed(0),
                                                     device=DEVICE)
    model.load_state_dict(sd)
    with torch.no_grad():
        out = {k: v.clone() for k, v in model(feats).items()}
    params, opt_state, loss = trfold.train_step(params, opt_state, feats, model, tx)
    return ref, {"out": out, "loss": float(loss),
                 "grads": {k: p.grad for k, p in params.items()},
                 "new_params": {k: p.detach() for k, p in params.items()}}


def test_forward_matches_jax(run):
    ref, got = run
    for k in HEADS:
        assert got["out"][k].dtype == torch.float32
        assert_parity(ref["out"][k], got["out"][k], 1e-5, k)


def test_loss_matches_jax(run):
    ref, got = run
    assert np.isfinite(got["loss"])
    assert abs(got["loss"] - ref["loss"]) <= 1e-5 * abs(ref["loss"])


def test_gradients_match_jax(run):
    ref, got = run
    assert sorted(got["grads"]) == sorted(ref["grads"])
    top = max(float(np.abs(r).max()) for r in ref["grads"].values())
    for k, r in ref["grads"].items():
        g = as_numpy(got["grads"][k])
        zero = _zero_grad_entries(k, r.shape)
        assert max(np.abs(g[zero]).max(initial=0), np.abs(r[zero]).max(initial=0)) <= 1e-5 * top, k
        if zero.all():
            continue
        scale = float(np.abs(r[~zero]).max())
        err = float(np.abs(g - r)[~zero].max())
        assert err <= 1e-4 * scale, (k, err, scale)


def test_train_step_matches_optax(run):
    ref, got = run
    old = trfold_params_from_flax(ref["params"])
    for k, r in ref["new_params"].items():
        new = as_numpy(got["new_params"][k])
        zero = _zero_grad_entries(k, r.shape)
        for p in (r, new):
            assert np.abs(p - as_numpy(old[k]))[zero].max(initial=0) <= 1.01 * LR, k
        assert_parity(r[~zero], new[~zero], 1e-5, k)


def test_param_tree_matches_flax_and_round_trips(jax_ref):
    """Every config's state_dict has the flax init's paths and shapes, the
    fused and unfused triangle paths share one tree, and the converter
    round-trips exactly."""
    trees = {}
    for name in CONFIGS:
        ref = jax_ref(name)
        model, sd = _port_model(name, ref["params"])
        own = model.state_dict()
        assert {k: tuple(v.shape) for k, v in own.items()} == ref["flax_shapes"], name
        assert all(v.dtype == torch.float32 for v in own.values())
        back = trfold_params_to_flax(trfold_params_from_flax(ref["params"]))
        jax.tree_util.tree_map(np.testing.assert_array_equal, back, ref["params"])
        again = trfold_params_from_flax(trfold_params_to_flax(sd))
        assert all(torch.equal(again[k], sd[k]) for k in sd)
        trees[name] = sorted(own)
    assert trees["triangle"] == trees["triangle_fused_remat"]


def test_remat_gives_the_same_gradients(feats_np, jax_ref):
    """In the port alone: the fused triangle model with and without remat."""
    ref = jax_ref("triangle_fused_remat")
    feats = _torch_feats(feats_np)
    grads = []
    for remat in (True, False):
        model, sd = _port_model("triangle_fused_remat", ref["params"], remat=remat)
        model.load_state_dict(sd)
        params = dict(model.named_parameters())
        trfold.loss_fn(params, model, feats).backward()
        grads.append({k: p.grad for k, p in params.items()})
    for k in grads[0]:
        torch.testing.assert_close(grads[0][k], grads[1][k], rtol=1e-6, atol=1e-7, msg=k)


def test_fused_and_unfused_paths_agree_in_the_port(feats_np, jax_ref):
    """The triangle update through the kernels' plain versions vs the unfused
    module, on the same params (f32; the JAX package's 2e-5 budget)."""
    ref = jax_ref("triangle")
    feats = _torch_feats(feats_np)
    outs = []
    for fused in (True, False):
        model, sd = _port_model("triangle", ref["params"], fused_tri=fused)
        model.load_state_dict(sd)
        with torch.no_grad():
            outs.append(model(feats)["distogram_logits"])
    torch.testing.assert_close(outs[0], outs[1], rtol=2e-5, atol=2e-5)


def test_init_follows_flax():
    """flax's initializers from an explicit generator: reproducible, zero
    biases, LayerNorm ones, lecun-normal kernels truncated at 2 sigma."""
    cfg = trfold.TrFoldConfig(**WIDTHS, pair_update="triangle")
    a, b = trfold.TrFold(cfg, device=DEVICE), trfold.TrFold(cfg, device=DEVICE)
    a.reset_parameters(torch.Generator().manual_seed(3))
    b.reset_parameters(torch.Generator().manual_seed(3))
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    k = sa["block_0.mlp_in.kernel"]  # (32, 128): fan_in 32
    std = (1 / 32) ** 0.5
    assert k.abs().max() <= 2 * std / 0.87962566103423978 + 1e-6
    assert abs(float(k.std()) - std) < 0.1 * std
    assert torch.equal(sa["block_0.tri_out.ln_in.scale"], torch.ones(16))
    assert not sa["block_0.attn.qkv.bias"].any()
    e = sa["seq_embed.embedding"]  # (21, 32): N(0, 1/32)
    assert abs(float(e.std()) - std) < 0.15 * std


@pytest.mark.parametrize("opt,err", [
    (dict(remat=True, remat_policy="tri_dots"), NotImplementedError),
    (dict(moe_experts=2), NotImplementedError),
    (dict(remat=True, remat_policy="dots"), NotImplementedError),
    (dict(ring_mesh=object()), NotImplementedError),
    (dict(remat_policy="bogus"), ValueError),
])
def test_unported_options_raise(opt, err):
    with pytest.raises(err, match="not yet ported|remat_policy must be"):
        trfold.TrFold(trfold.TrFoldConfig(**WIDTHS, **opt), device=DEVICE)


def test_fused_featurization_is_not_yet_ported():
    """The fused featurization (K3) is ported; its chi features are not."""
    sb = StructureBatch.from_xyz(np.random.RandomState(0).randn(1, 5, 15, 3), device=DEVICE)
    assert trfold.featurize_for_model(sb, fused=True)["d_cb_bins"].shape == (1, 5, 5)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        trfold.featurize_for_model(sb, fused=True, include_chi=True)


def test_featurize_from_sequence_matches_jax():
    seq = np.random.RandomState(1).randint(0, 21, size=(2, 9))
    ref = jtrfold.featurize_from_sequence(seq, n_dist_bins=36)
    out = trfold.featurize_from_sequence(seq, n_dist_bins=36, device=DEVICE)
    assert sorted(out) == sorted(ref)
    for k in ref:
        assert as_numpy(out[k]).dtype == np.asarray(ref[k]).dtype, k
        np.testing.assert_array_equal(as_numpy(out[k]), np.asarray(ref[k]), err_msg=k)


@pytest.mark.parametrize("case", ["edges", "random", "nan_inf"])
def test_distogram_bins_matches_jax(case):
    w = 20.0 / 36
    if case == "edges":  # values on and one ulp around every bin edge
        e = (np.arange(40) * w).astype(np.float32)
        d = np.concatenate([e, np.nextafter(e, 0), np.nextafter(e, 100)])
    elif case == "random":
        d = (np.random.RandomState(2).rand(4, 33, 33) * 25).astype(np.float32)
    else:
        d = np.array([np.nan, np.inf, -np.inf, -1.0, 0.0, 19.999, 20.0, 1e30], np.float32)
    ref = np.asarray(jax_distogram_bins(jnp.asarray(d), 36, 20.0))
    out = distogram_bins(torch.from_numpy(d), 36, 20.0)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(as_numpy(out), ref)


def test_nvcc_flags_are_per_library():
    """K1 keeps -fmad=false and its library hash (sha256 of the joined flags,
    then the sources, then the shared headers in name order); the triangle
    kernels build with FMA contraction."""
    k1_flags = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
                "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
    assert cuda_lib.NVCC_FLAGS == k1_flags
    h = hashlib.sha256(" ".join(k1_flags).encode())
    h.update((cuda_lib.CSRC / "pair_maps.cu").read_bytes())
    for header in ("device_scope.cuh", "mma.cuh", "pair_maps.cuh"):
        h.update((cuda_lib.CSRC / header).read_bytes())
    expected = cuda_lib.BUILD_DIR / f"libpair_maps-{h.hexdigest()[:16]}.so"
    assert cuda_lib.library_path("pair_maps", pair_maps._SOURCES) == expected
    assert "-fmad=false" not in cuda_lib.NVCC_FLAGS_FMA
    assert tri_mul.library_path() != cuda_lib.library_path("tri_mul", tri_mul._SOURCES)
