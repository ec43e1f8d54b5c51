"""models/inverse_fold.py and the causal/``kv`` PairBiasAttention: the port vs the JAX package.

The JAX references run their jnp attention path (``use_flash_attn=False``);
the port runs both of its paths on the same weights: the einsum path and
the flash path, whose K8/K9 plain versions run on CPU tensors, with the
causal mask folded into the bias and the rows with no allowed key zeroed
after the kernel.

Randomness is JAX's own, replayed into the port's cores:
``random_decode_order`` splits its key into one permutation a structure
(``_ranks``); ``jax.random.categorical`` is Gumbel-max, ``argmax(logits +
gumbel(key, logits.shape))``, so ``sample_sequence`` hands the port
``gumbel(key, (B, L, V))`` and ``ar_sample_sequence`` splits into (order,
loop) and the loop into one ``gumbel(k, (B, V))`` a step.

Tolerances: features 1e-5 (CLAUDE.md); logits and losses 1e-4; gradient
leaves 1e-3 of their largest entry (the FoldModel precedent, PERF.md §2);
one AdamW step's parameters 1e-4 (the exactly-zero gradient entries
exempt, as in tests/test_torch_trfold.py).  Sampled sequences are compared
for equality where the draw is decided: at each decoding step the top-2
margin of ``logits / T + gumbel`` is recomputed on the port; where it
exceeds twice the logits tolerance over T, the two packages must draw the
same residue.  A step under that margin (a near-tie) ends the comparison
of that sequence there, and is counted and reported.  Tiny widths (node 32,
pair 8, 2 heads, one encoder and one decoder block) on B=2 windows of
24 residues of 1REX and 1ad0_DC (one padded).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protstruc_tpu import StructureBatch as JaxBatch
from protstruc_tpu.models import inverse_fold as jif
from protstruc_tpu.models import trfold as jtrfold
from protstruc_tpu_torch.convert import inverse_fold_params_from_flax, inverse_fold_params_to_flax
from protstruc_tpu_torch.models import inverse_fold as tif
from protstruc_tpu_torch.models import trfold
from tests.conftest import pdb_path
from tests.test_torch_batch_api import port_of
from tests.test_torch_ipa import flat_shapes
from tests.test_torch_parity import DEVICE, as_numpy, assert_parity

torch.set_num_threads(1)

WIDTH = dict(node_dim=32, pair_dim=8, n_heads=2, n_blocks=1)
B, L, V = 2, 24, 21
LOGIT_ATOL = 1e-4


def _t(x):
    return torch.from_numpy(np.array(x))


def _np_feats(f):
    return {k: np.array(v) for k, v in f.items() if v is not None}


@pytest.fixture(scope="module")
def batches():
    jb = JaxBatch.from_pdb([pdb_path("1REX.pdb"), pdb_path("1ad0_DC.pdb")])
    sl = slice(5, 5 + L)
    jb = jb.replace(xyz=jb.xyz[:, sl], atom_mask=jb.atom_mask[:, sl], chain_idx=jb.chain_idx[:, sl],
                    residue_idx=jb.residue_idx[:, sl])
    return jb, port_of(jb)


@pytest.fixture(scope="module")
def feats(batches):
    jf = _np_feats(jif.featurize_backbone(batches[0]))
    jf["residue_mask"][1, -4:] = False  # a padded tail
    return jf


def test_featurize_backbone_matches_jax(batches):
    jb, tb = batches
    ref, got = jif.featurize_backbone(jb), tif.featurize_backbone(tb)
    assert set(ref) == set(got)
    for k, v in ref.items():
        assert_parity(np.asarray(v), got[k], 1e-5, k)


def _cfgs(decoder, flash=False):
    return (jif.InverseFoldConfig(**WIDTH, n_decoder_blocks=decoder),
            tif.InverseFoldConfig(**WIDTH, n_decoder_blocks=decoder, use_flash_attn=flash))


def _ranks_of(perm):
    return np.argsort(perm, axis=1).astype(np.int32)


def _ar_feats(feats, seed=0):
    rng = np.random.RandomState(seed)
    perm = np.stack([rng.permutation(L) for _ in range(B)])
    return dict(feats, prev_seq=feats["target_seq"], decode_rank=_ranks_of(perm))


@pytest.fixture(scope="module")
def setup(feats):
    """JAX models (jitted apply, loss and gradients) and the port's init,
    carried across, for the encoder-only and the AR configuration."""
    out = {}
    for decoder in (0, 1):
        jcfg, tcfg = _cfgs(decoder)
        jmodel = jif.InverseFold(jcfg)
        port = tif.InverseFold(tcfg, device=DEVICE)
        port.reset_parameters(torch.Generator().manual_seed(decoder))
        tree = inverse_fold_params_to_flax(port.state_dict())
        params = jax.tree_util.tree_map(jnp.asarray, tree)
        f = _ar_feats(feats) if decoder else feats
        jf = {k: jnp.asarray(v) for k, v in f.items()}
        shapes = flat_shapes(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jf)["params"])
        apply = jax.jit(lambda p, x, m=jmodel: m.apply({"params": p}, x))
        out[decoder] = dict(jmodel=jmodel, params=params, tree=tree, shapes=shapes, apply=apply,
                            feats=f)
    return out


def _port(setup, decoder, flash=False):
    port = tif.InverseFold(_cfgs(decoder, flash)[1], device=DEVICE)
    port.load_state_dict(inverse_fold_params_from_flax(setup[decoder]["tree"]))
    return port


def _tfeats(f):
    return {k: _t(v) for k, v in f.items()}


@pytest.mark.parametrize("decoder", [0, 1])
def test_param_tree_matches_flax_and_round_trips(setup, decoder):
    s = setup[decoder]
    port = _port(setup, decoder)
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == s["shapes"]
    back = inverse_fold_params_to_flax(inverse_fold_params_from_flax(s["tree"]))
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, s["tree"])


@pytest.mark.parametrize("decoder,flash", [(0, False), (0, True), (1, False), (1, True)])
def test_logits_match_jax(setup, decoder, flash):
    s = setup[decoder]
    ref = s["apply"](s["params"], {k: jnp.asarray(v) for k, v in s["feats"].items()})
    with torch.no_grad():
        got = _port(setup, decoder, flash)(_tfeats(s["feats"]))
    assert_parity(np.asarray(ref), got, LOGIT_ATOL, f"logits decoder={decoder} flash={flash}")


# ---------------------------------------------------------------------------
# PairBiasAttention with a causal mask and a kv stream
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def attention():
    rng = np.random.RandomState(4)
    node = rng.randn(B, L, 32).astype(np.float32)
    kv = rng.randn(B, L, 32).astype(np.float32)
    pair = rng.randn(B, L, L, 8).astype(np.float32)
    mask = np.ones((B, L), bool)
    mask[1, -5:] = False
    rank = _ranks_of(np.stack([rng.permutation(L) for _ in range(B)]))
    causal = rank[:, None, :] < rank[:, :, None]
    # a row whose only allowed key is masked out: no allowed key at all
    causal[1, 0] = False
    causal[1, 0, -1] = True
    jcfg = jtrfold.TrFoldConfig(node_dim=32, pair_dim=8, n_heads=2)
    mod = jtrfold.PairBiasAttention(jcfg)
    tree = jax.tree_util.tree_map(np.asarray, mod.init(jax.random.PRNGKey(3), node, pair, mask,
                                                       causal, kv)["params"])
    tree["pair_bias"]["bias"] = rng.randn(2).astype(np.float32)

    def loss(p, node, kv, pair):
        out = mod.apply({"params": p}, node, pair, mask, extra_mask=causal, kv=kv)
        return jnp.sum(out * jnp.asarray(np.random.RandomState(5).randn(B, L, 32), jnp.float32)), out

    (val, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True))(
        tree, node, kv, pair)
    no_row = ~(causal & mask[:, None, :]).any(-1)
    assert no_row[:, :].sum() >= 3  # the rank-0 rows of both structures and the made-up one
    return dict(node=node, kv=kv, pair=pair, mask=mask, causal=causal, tree=tree, out=np.asarray(out),
                val=float(val), grads=grads, no_row=no_row)


@pytest.mark.parametrize("flash", [False, True])
def test_causal_kv_attention_matches_jax(attention, flash):
    a = attention
    mod = trfold.PairBiasAttention(trfold.TrFoldConfig(node_dim=32, pair_dim=8, n_heads=2,
                                                       use_flash_attn=flash), device=DEVICE)
    mod.load_state_dict(inverse_fold_params_from_flax(a["tree"]))
    x = {k: _t(a[k]).requires_grad_() for k in ("node", "kv", "pair")}
    out = mod(x["node"], x["pair"], _t(a["mask"]), extra_mask=_t(a["causal"]), kv=x["kv"])
    assert_parity(a["out"], out, 1e-5, "out")
    # rows with no allowed key: the output Dense's bias alone
    bias = as_numpy(mod.out.bias)
    np.testing.assert_allclose(as_numpy(out)[a["no_row"]], np.broadcast_to(bias, (a["no_row"].sum(), 32)),
                               rtol=0, atol=1e-6)
    (out * _t(np.random.RandomState(5).randn(B, L, 32).astype(np.float32))).sum().backward()
    gp, gn, gkv, gpair = a["grads"]
    for name, ref, got in (("node", gn, x["node"].grad), ("kv", gkv, x["kv"].grad),
                           ("pair", gpair, x["pair"].grad)):
        assert_parity(np.asarray(ref), got, 1e-4 * max(1.0, float(np.abs(np.asarray(ref)).max())), name)
    ref = inverse_fold_params_from_flax(jax.tree_util.tree_map(np.asarray, gp))
    for k, p in mod.named_parameters():
        r = as_numpy(ref[k])
        zero = np.zeros(r.shape, bool)
        if k == "pair_bias.bias":
            zero[...] = True   # a per-head constant on every logit of a row: exactly 0
        elif k == "qkv.bias":
            zero[1] = True     # the key bias, likewise
        top = float(np.abs(as_numpy(gp["qkv"]["kernel"])).max())
        assert float(np.abs(as_numpy(p.grad)[zero]).max(initial=0)) <= 1e-5 * top, k
        if not zero.all():
            scale = float(np.abs(r[~zero]).max())
            assert float(np.abs(as_numpy(p.grad) - r)[~zero].max()) <= 1e-3 * scale, k


def test_flash_fold_zeroes_the_rows_without_keys(attention):
    """The folded bias hands the plain K8 a row of -1e9 logits; the row's
    output is zeroed after the kernel, so its gradients through the plain K9
    are exactly 0: the q gradient of such a row and the pair-bias gradient
    of its bias row."""
    a = attention
    mod = trfold.PairBiasAttention(trfold.TrFoldConfig(node_dim=32, pair_dim=8, n_heads=2,
                                                       use_flash_attn=True), device=DEVICE)
    mod.load_state_dict(inverse_fold_params_from_flax(a["tree"]))
    bias = mod.pair_bias(_t(a["pair"])).permute(0, 3, 1, 2).detach().requires_grad_()
    node = _t(a["node"])
    qkv = mod.qkv(node).detach().requires_grad_()
    q, k, v = qkv[..., 0, :, :], qkv[..., 1, :, :], qkv[..., 2, :, :]
    causal, mask = _t(a["causal"]), _t(a["mask"])
    fbias = (bias.float() + torch.where(causal[:, None], 0.0, -1e9)).to(bias.dtype)
    out = trfold.flash_pair_bias_attention(q, k, v, fbias, mask)
    row_ok = (causal & mask[:, None, :]).any(-1)
    out = torch.where(row_ok[:, :, None, None], out, 0.0)
    out.sum().backward()
    no_row = torch.from_numpy(a["no_row"])
    assert bool((bias.grad.permute(0, 2, 1, 3)[no_row] == 0).all())
    assert bool((qkv.grad[..., 0, :, :][no_row] == 0).all())


# ---------------------------------------------------------------------------
# losses, the train step and the samplers
# ---------------------------------------------------------------------------


def _jax_perm(key, shape):
    """random_decode_order's draws: one permutation per ``split(key, B)``."""
    return np.stack([np.asarray(jax.random.permutation(k, shape[1]))
                     for k in jax.random.split(key, shape[0])])


def test_random_decode_order_matches_jax():
    key = jax.random.PRNGKey(7)
    ref = jif.random_decode_order(key, (3, 17))
    got = tif._ranks(_t(_jax_perm(key, (3, 17))))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(ref), as_numpy(got))
    g = torch.Generator(device=DEVICE).manual_seed(0)
    r = tif.random_decode_order((3, 17), generator=g)
    assert sorted(as_numpy(r)[0].tolist()) == list(range(17))


def _zero_entries(k, shape):
    """Entries whose exact gradient is 0: per-head constants on every logit
    of a softmax row (the pair-bias bias, the key third of the ``qkv`` bias,
    and ``rbf_embed``'s bias, which reaches the logits only through the
    linear pair-bias Dense)."""
    z = np.zeros(shape, bool)
    if k.endswith(("pair_bias.bias", "rbf_embed.bias")):
        z[...] = True
    elif k.endswith("qkv.bias"):
        z[1] = True
    return z


@pytest.mark.parametrize("flash", [False, True])
def test_ar_loss_and_gradients_match_jax(setup, feats, flash):
    s = setup[1]
    key = jax.random.PRNGKey(12)
    jf = {k: jnp.asarray(v) for k, v in feats.items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jif.if_ar_loss(p, s["jmodel"], jf, key)))(s["params"])
    port = _port(setup, 1, flash)
    rank = tif._ranks(_t(_jax_perm(key, (B, L))))
    got = tif._if_ar_loss(dict(port.named_parameters()), port, _tfeats(feats), rank)
    got.backward()
    assert abs(float(got.detach()) - float(loss)) <= 1e-4 * abs(float(loss))
    ref = inverse_fold_params_from_flax(jax.tree_util.tree_map(np.asarray, grads))
    top = max(float(np.abs(r).max()) for r in ref.values())
    for k, p in port.named_parameters():
        r, g = as_numpy(ref[k]), as_numpy(p.grad)
        zero = _zero_entries(k, r.shape)
        assert float(np.abs(g[zero]).max(initial=0)) <= 1e-5 * top, k
        if not zero.all():
            assert float(np.abs(g - r)[~zero].max()) <= 1e-3 * float(np.abs(r[~zero]).max()), k


def test_train_step_matches_jax(setup, feats):
    """One AdamW step of the encoder model (``if_train_step``) from the same
    weights: the loss and every parameter after the step."""
    s = setup[0]
    jmodel = s["jmodel"]
    jf = {k: jnp.asarray(v) for k, v in feats.items()}
    import optax

    tx = optax.adamw(1e-3)
    p1, _, loss = jax.jit(lambda p: jif.if_train_step(p, tx.init(p), jf, jmodel, tx))(s["params"])
    port = _port(setup, 0)
    params = dict(port.named_parameters())
    opt = trfold.adamw(params.values(), 1e-3)
    _, _, got = tif.if_train_step(params, opt.state, _tfeats(feats), port, opt)
    assert abs(float(got) - float(loss)) <= 1e-4 * abs(float(loss))
    ref = inverse_fold_params_from_flax(jax.tree_util.tree_map(np.asarray, p1))
    for k, p in params.items():
        zero = _zero_entries(k, tuple(p.shape))
        assert_parity(as_numpy(ref[k])[~zero], as_numpy(p)[~zero], 1e-4, k)


def test_if_loss_and_recovery_match_jax(setup, feats):
    for decoder in (0, 1):
        s = setup[decoder]
        jf = {k: jnp.asarray(v) for k, v in feats.items()}
        port = _port(setup, decoder)
        params = dict(port.named_parameters())
        with torch.no_grad():
            if decoder == 0:
                ref = jax.jit(lambda p: jif.if_loss(p, s["jmodel"], jf))(s["params"])
                got = tif.if_loss(params, port, _tfeats(feats))
                assert abs(float(got) - float(ref)) <= 1e-4 * abs(float(ref))
            ref = jax.jit(lambda p: jif.sequence_recovery(p, s["jmodel"], jf))(s["params"])
            got = tif.sequence_recovery(params, port, _tfeats(feats))
        assert abs(float(got) - float(ref)) <= 1e-6, (float(got), float(ref))


def test_sample_sequence_matches_jax(setup, feats):
    s = setup[0]
    key = jax.random.PRNGKey(21)
    jf = {k: jnp.asarray(v) for k, v in feats.items()}
    ref = jax.jit(lambda p: jif.sample_sequence(p, s["jmodel"], jf, key, temperature=1.0))(s["params"])
    port = _port(setup, 0)
    g = _t(jax.random.gumbel(key, (B, L, V)))
    got = tif._sample_sequence(dict(port.named_parameters()), port, _tfeats(feats), g, 1.0)
    # every draw decided by more than the logits' tolerance: equal sequences
    with torch.no_grad():
        z = port(_tfeats(feats)).clone()
    z[..., 20:] = -1e9
    top2 = torch.topk(z + g, 2, dim=-1).values
    assert float((top2[..., 0] - top2[..., 1])[_t(feats["residue_mask"])].min()) > 2 * LOGIT_ATOL
    np.testing.assert_array_equal(np.asarray(ref), as_numpy(got))


def _ar_margins(port, feats, perm, gumbel, temperature, fixed, seq):
    """The top-2 margin of ``logits / T + gumbel`` at each decoding step,
    replayed on the port along the decoded sequence ``seq``: ``(L, B)``."""
    rank = tif._ranks(perm)
    if fixed is not None:
        rank = torch.where(fixed, rank, rank + L).argsort(1).argsort(1).int()
    order = torch.argsort(rank, dim=1)
    init = torch.full((B, L), 20, dtype=torch.int32)
    if fixed is not None:
        init = torch.where(fixed, feats["target_seq"].int(), init)
    rows = torch.arange(B)
    out = []
    with torch.no_grad():
        for k in range(L):
            ctx = init.clone()
            done = order[:, :k]
            ctx[rows[:, None], done] = seq[rows[:, None], done]
            logits = port(dict(feats, prev_seq=ctx, decode_rank=rank))[rows, order[:, k]]
            logits[:, 20:] = -1e9
            top2 = torch.topk(logits / temperature + gumbel[k], 2, dim=-1).values
            out.append(top2[:, 0] - top2[:, 1])
    return torch.stack(out), order


@pytest.mark.parametrize("fixed", [False, True])
def test_ar_sample_sequence_matches_jax(setup, feats, fixed):
    s = setup[1]
    key, temperature = jax.random.PRNGKey(33), 0.5
    fixed_np = None
    if fixed:
        fixed_np = np.ones((B, L), bool)
        fixed_np[:, 8:16] = False   # redesign one loop, the rest pinned
    jf = {k: jnp.asarray(v) for k, v in feats.items()}
    ref = jax.jit(lambda p: jif.ar_sample_sequence(
        p, s["jmodel"], jf, key, temperature=temperature,
        fixed_mask=None if fixed_np is None else jnp.asarray(fixed_np)))(s["params"])
    korder, kloop = jax.random.split(key)
    perm = _t(_jax_perm(korder, (B, L)))
    gumbel = torch.stack([_t(jax.random.gumbel(k, (B, V))) for k in jax.random.split(kloop, L)])
    port = _port(setup, 1)
    tf = _tfeats(feats)
    fixed_t = None if fixed_np is None else _t(fixed_np)
    got = tif._ar_sample_sequence(dict(port.named_parameters()), port, tf, perm, gumbel, temperature,
                                  fixed_t)
    margins, order = _ar_margins(port, tf, perm, gumbel, temperature, fixed_t, got)
    decided = margins > 2 * LOGIT_ATOL / temperature
    ref_np, got_np = np.asarray(ref), as_numpy(got)
    near_ties = 0
    for b in range(B):
        steps = decided[:, b].numpy()
        upto = L if steps.all() else int(np.argmin(steps))
        near_ties += int(upto < L)
        pos = as_numpy(order[b, :upto])
        np.testing.assert_array_equal(ref_np[b, pos], got_np[b, pos], err_msg=f"structure {b}")
    assert near_ties == 0, f"{near_ties} sequences end in a near-tie"
    if fixed:
        pinned = fixed_np & feats["residue_mask"]
        np.testing.assert_array_equal(got_np[pinned], feats["target_seq"][pinned])
    assert ((got_np < 20) == feats["residue_mask"]).all()


def test_public_samplers_run_from_a_generator(setup, feats):
    port = _port(setup, 1)
    params = dict(port.named_parameters())
    tf = _tfeats(feats)
    runs = []
    for _ in range(2):
        g = torch.Generator(device=DEVICE).manual_seed(4)
        loss = tif.if_ar_loss(params, port, tf, generator=g).detach()
        runs.append((loss, tif.ar_sample_sequence(params, port, tf, generator=g),
                     tif.sample_sequence(params, port, dict(tf, prev_seq=tf["target_seq"],
                                                            decode_rank=tif._ranks(torch.arange(L).expand(B, L))),
                                         generator=g)))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    assert runs[0][1].dtype == torch.int32 and runs[0][1].shape == (B, L)
