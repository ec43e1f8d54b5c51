"""The scale-out slice on one process: the port vs the JAX package on the CPU.

* ``flash_pair_bias_attention_lse`` (K8/K9's plain versions) against the JAX
  entry point in interpret mode: out and lse (2e-5), the gradients for
  cotangents of both outputs (dq, dk, dv 5e-5, the bias's 5e-4, each times
  max(1, max|ref|), the budgets of tests/test_flash_attn.py), with a fully
  masked row (lse exactly -inf, its gradients 0), non-finite lse cotangents
  on it, and a ``None`` cotangent for either output.
* The ring's one step, ``attend_merge``, driven over n blocks in each rank's
  visiting order on one process, against the global attention.
* K1's rectangular mode (``pairwise_maps_forward(xyz_j=...)``, its plain
  version) against ``pairwise_maps_pallas(xyz_j=...)`` in interpret mode at
  ragged Li and Lj (distances 1e-5 + 1e-5 relative, angles 1e-4, NaN
  patterns exact), a row block of it against the square maps' rows, and the
  plan and entry the CUDA wrapper hands a faked library.
* TrFold under each remat policy against JAX TrFold with that policy (loss
  and every gradient leaf at 1e-5 relative); the ``aten.bmm`` calls of a
  train step under a ``TorchDispatchMode``: ``tri_dots`` makes 2 fewer a
  block than ``none`` (the CPU analogue of tests/test_model_features.py's
  cost check).
* ``MoEMLP`` (forward, aux, masked tokens) and TrFold with MoE blocks
  against JAX; ``convert`` carrying a JAX-initialised MoE TrFold and stacked
  stage parameters both ways.
* The mesh helpers against JAX's, and the options still to port.
* ``train`` on a one-rank dp mesh with ZeRO-1 (a gloo group in process):
  its collectives run and its losses and checkpoint equal the plain run's.

The JAX references are jitted and take the port's init as the shared weights.
The multi-rank checks are in tests/test_torch_dist.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from protstruc_tpu import StructureBatch as JaxBatch
from protstruc_tpu.models import moe as jmoe
from protstruc_tpu.models import trfold as jtrfold
from protstruc_tpu.ops.flash_attn import flash_pair_bias_attention_lse as jax_lse
from protstruc_tpu.ops.pallas_pairwise import pairwise_maps_pallas
from protstruc_tpu.parallel import mesh as jmesh
from protstruc_tpu.parallel.pipeline import stack_stage_params as jax_stack
from protstruc_tpu_torch.convert import trfold_params_from_flax, trfold_params_to_flax
from protstruc_tpu_torch.models import moe, trfold
from protstruc_tpu_torch.ops import flash_attn, pair_maps, ring_attn
from protstruc_tpu_torch.parallel import mesh, pipeline
from tests.test_torch_parity import DEVICE, as_numpy, assert_parity

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# the lse entry point of K8/K9
# ---------------------------------------------------------------------------

def _attn_inputs(B=2, L=37, H=2, dh=16, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, L, H, dh).astype(np.float32) for _ in range(3))
    bias = rng.randn(B, H, L, L).astype(np.float32)
    kmask = rng.rand(B, L) > 0.25
    kmask[1] = False          # structure 1: every key masked, every row empty
    kmask[0, :3] = True
    return q, k, v, bias, kmask


def _budget(ref, atol):
    return atol * max(1.0, float(np.abs(ref).max()))


@pytest.fixture(scope="module")
def lse_case():
    q, k, v, bias, kmask = _attn_inputs()
    rng = np.random.RandomState(1)
    g_out = rng.randn(*q.shape).astype(np.float32)
    g_lse = rng.randn(q.shape[0], q.shape[2], q.shape[1]).astype(np.float32)
    g_lse[1, 0, :4] = [np.inf, -np.inf, np.nan, 1e30]   # on masked rows: no effect

    def jfn(*a):
        return jax_lse(*a, jnp.asarray(kmask), interpret=True)

    args = tuple(jnp.asarray(x) for x in (q, k, v, bias))
    (out, lse), vjp = jax.vjp(jfn, *args)
    grads = {}
    for name, ct in (("both", (g_out, g_lse)), ("out_only", (g_out, np.zeros_like(g_lse))),
                     ("lse_only", (np.zeros_like(g_out), g_lse))):
        grads[name] = [np.asarray(g) for g in vjp(tuple(jnp.asarray(c) for c in ct))]
    return (q, k, v, bias, kmask, g_out, g_lse), (np.asarray(out), np.asarray(lse), grads)


def test_lse_entry_forward_matches_jax(lse_case):
    (q, k, v, bias, kmask, *_), (out_r, lse_r, _) = lse_case
    out, lse = flash_attn.flash_pair_bias_attention_lse(
        *(torch.from_numpy(x) for x in (q, k, v, bias, kmask)))
    assert lse.dtype == torch.float32 and lse.shape == lse_r.shape
    assert np.isneginf(lse_r[1]).all() and torch.isneginf(lse[1]).all()
    fin = np.isfinite(lse_r)
    assert (fin == torch.isfinite(lse).numpy()).all()
    assert np.abs(lse.numpy()[fin] - lse_r[fin]).max() <= _budget(lse_r[fin], 2e-5)
    assert np.abs(out.numpy() - out_r).max() <= _budget(out_r, 2e-5)
    assert not out[1].any()


@pytest.mark.parametrize("cotangents", ["both", "out_only", "lse_only"])
def test_lse_entry_gradients_match_jax(lse_case, cotangents):
    (q, k, v, bias, kmask, g_out, g_lse), (_, _, grads) = lse_case
    ins = [torch.from_numpy(x).requires_grad_() for x in (q, k, v, bias)]
    out, lse = flash_attn.flash_pair_bias_attention_lse(*ins, torch.from_numpy(kmask))
    if cotangents == "out_only":   # the lse output unused: its cotangent is None
        torch.autograd.backward([out], [torch.from_numpy(g_out)])
    elif cotangents == "lse_only":  # the out output unused
        torch.autograd.backward([lse], [torch.from_numpy(g_lse)])
    else:
        torch.autograd.backward([out, lse], [torch.from_numpy(g_out), torch.from_numpy(g_lse)])
    for name, t, ref, tol in zip(("dq", "dk", "dv", "dbias"), ins, grads[cotangents],
                                 (5e-5, 5e-5, 5e-5, 5e-4)):
        g = t.grad.numpy()
        assert np.isfinite(g).all(), name
        assert np.abs(g - ref).max() <= _budget(ref, tol), name
    # the fully masked structure: every gradient through it is exactly 0
    assert not any(t.grad[1].any() for t in ins)


def test_lse_entry_takes_a_column_block_of_the_bias(lse_case):
    """The ring's bias: a (B, H, Lq, Lq) column block of (B, H, Lq, L) rows,
    a strided view; values and gradients as from a dense copy."""
    (q, k, v, bias, kmask, g_out, _), _ = lse_case
    wide = torch.from_numpy(np.concatenate([bias, bias[..., :5]], -1)).requires_grad_()
    view = wide[..., :bias.shape[-1]]
    assert not view.is_contiguous()
    dense = torch.from_numpy(bias).requires_grad_()
    qkv = [torch.from_numpy(x) for x in (q, k, v)]
    km = torch.from_numpy(kmask)
    o1, _ = flash_attn.flash_pair_bias_attention_lse(*qkv, view, km)
    o2, _ = flash_attn.flash_pair_bias_attention_lse(*qkv, dense, km)
    (o1 * torch.from_numpy(g_out)).sum().backward()
    (o2 * torch.from_numpy(g_out)).sum().backward()
    assert torch.equal(o1, o2)
    assert torch.equal(wide.grad[..., :bias.shape[-1]], dense.grad)
    assert not wide.grad[..., bias.shape[-1]:].any()


@pytest.mark.parametrize("local", ["plain", "flash"])
def test_attend_merge_over_blocks_matches_global_attention(local):
    """The ring's step over n = 4 blocks, each rank's visiting order, on one
    process (what chip_smoke.py drives on the card): out and gradients as
    the global attention's."""
    q, k, v, bias, kmask = _attn_inputs(B=2, L=32, H=2, dh=16, seed=3)
    kmask[0, 8:16] = False   # one block of structure 0 fully masked
    n, L = 4, 32
    Lq = L // n
    ct = np.random.RandomState(4).randn(*q.shape).astype(np.float32)
    ins = [torch.from_numpy(x).requires_grad_() for x in (q, k, v, bias)]
    ref = flash_attn.flash_pair_bias_attention(*ins, torch.from_numpy(kmask))
    (ref * torch.from_numpy(ct)).sum().backward()
    mine = [torch.from_numpy(x).requires_grad_() for x in (q, k, v, bias)]
    km = torch.from_numpy(kmask)
    for r in range(n):
        rows = slice(r * Lq, (r + 1) * Lq)
        acc = torch.zeros((2, Lq, 2, 16))
        lse = torch.full((2, 2, Lq), -np.inf)
        for t in range(n):
            src = (r + t) % n
            cols = slice(src * Lq, (src + 1) * Lq)
            acc, lse = ring_attn.attend_merge(acc, lse, mine[0][:, rows], mine[1][:, cols],
                                              mine[2][:, cols], mine[3][:, :, rows, cols],
                                              km[:, cols], local)
        out = acc.to(torch.float32)
        assert np.abs(out.detach().numpy() - ref[:, rows].detach().numpy()).max() <= 2e-5
        (out * torch.from_numpy(ct[:, rows])).sum().backward()
    for a, b, tol in zip(mine, ins, (5e-5, 5e-5, 5e-5, 5e-4)):
        r = b.grad.numpy()
        assert np.abs(a.grad.numpy() - r).max() <= _budget(r, tol)


# ---------------------------------------------------------------------------
# K1's rectangular mode
# ---------------------------------------------------------------------------

ANGLES = ("omega", "theta", "phi")


def _xyz(B, L, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(B, L, 15, 3) * 4).astype(np.float32)
    x[0, 2, 4] = np.nan          # a missing CB
    x[1 % B, 3, 1] = x[1 % B, 3, 4]   # CA == CB: a degenerate residue
    return x


@pytest.mark.parametrize("Li,Lj", [(13, 37), (37, 20), (8, 33)])
def test_rect_maps_match_jax_interpret(Li, Lj):
    xi, xj = _xyz(2, Li, 0), _xyz(2, Lj, 1)
    xj[0, 5] = xi[0, 1]          # a shared residue: coordinate-equality pins across the sides
    ref = pairwise_maps_pallas(jnp.asarray(xi), interpret=True, xyz_j=jnp.asarray(xj))
    got = pair_maps.pairwise_maps_forward(torch.from_numpy(xi), xyz_j=torch.from_numpy(xj))
    for k in pair_maps.MAP_NAMES:
        r = np.asarray(ref[k])
        assert got[k].shape == (2, Li, Lj)
        atol = 1e-4 if k in ANGLES else 1e-5 + 1e-5 * float(np.nanmax(np.abs(r)))
        assert_parity(r, got[k], atol, k)


def test_rect_block_equals_square_rows():
    """A row block of the rectangular launch against the square maps' rows:
    distances bitwise; the angles within an ulp of their dtype, because the
    CPU's vectorised atan2 rounds by an element's position in the vector
    (the kernel, with one scalar atan2f a pair, is held bitwise on the card
    by chip_smoke.py)."""
    x = torch.from_numpy(_xyz(2, 40, 2))
    square = pair_maps.pairwise_maps_forward(x)
    for rows in (slice(0, 13), slice(13, 40), slice(5, 6)):
        for dt, ulp in ((torch.float32, 2.4e-7), (torch.bfloat16, 1.6e-2)):
            rect = pair_maps.pairwise_maps_forward(x[:, rows].contiguous(), out_dtype=dt,
                                                   xyz_j=x)
            for k in pair_maps.MAP_NAMES:
                a, b = rect[k].float(), square[k][:, rows].to(dt).float()
                assert rect[k].dtype == dt and a.shape == (2, rows.stop - rows.start, 40)
                assert torch.equal(torch.isnan(a), torch.isnan(b)), k
                d = (torch.nan_to_num(a, 7.0) - torch.nan_to_num(b, 7.0)).abs().max()
                assert d <= (ulp if k in ANGLES else 0.0), (k, dt, float(d))
    sub = pair_maps.pairwise_maps_forward(x[:, :9].contiguous(), ("d_cb", "phi"), xyz_j=x)
    assert sorted(sub) == ["d_cb", "phi"]


def test_rect_mode_is_forward_only():
    x = torch.from_numpy(_xyz(1, 6, 3))
    with pytest.raises(ValueError, match="forward only"):
        pair_maps.pairwise_maps(x, xyz_j=x)
    with pytest.raises(ValueError, match="does not pair"):
        pair_maps.pairwise_maps_forward(x, xyz_j=torch.from_numpy(_xyz(2, 6, 3)))


def test_rect_tile_plan():
    p = pair_maps.tile_plan(3, 40, 300)
    assert (p.tiles_i, p.tiles_j, p.Lj, p.vector) == (2, 3, 300, True)
    assert p.n_tiles == 3 * 2 * 3
    assert not pair_maps.tile_plan(3, 300, 37).vector   # the rule reads Lj
    assert pair_maps.tile_plan(3, 37, 300).vector
    assert pair_maps.tile_plan(2, 64) == pair_maps.tile_plan(2, 64, 64)


def test_rect_wrapper_hands_the_library_its_plan(monkeypatch):
    """The CUDA wrapper's rectangular launch, with a faked library and
    faked CUDA tensors: the C entry, the lengths and tile_plan(B, Li, Lj)."""
    calls = []

    class Lib:
        def ps_pair_maps_rect(self, dev, bf16, xyz, xyz_j, B, Li, Lj, A, bits, *rest):
            calls.append((bf16, B, Li, Lj, A, bits, rest[-2]))
            return 0

    monkeypatch.setattr(pair_maps, "load_library", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: type("S", (), {"cuda_stream": 0}))

    class Dev:
        type, index = "cuda", 0

    xi, xj = torch.zeros(2, 33, 15, 3), torch.zeros(2, 130, 15, 3)
    before = pair_maps.RECT_LAUNCHES
    out = pair_maps._pair_maps_cuda(xi, ("d_ca", "phi"), torch.bfloat16, xj)
    assert out["d_ca"].shape == (2, 33, 130) and out["phi"].dtype == torch.bfloat16
    bf16, B, Li, Lj, A, bits, plan = calls[0]
    assert (bf16, B, Li, Lj, A, bits) == (1, 2, 33, 130, 15, 1 | 32)
    want = pair_maps.plan_arg(pair_maps.tile_plan(2, 33, 130))
    assert [getattr(plan, f) for f, _ in plan._fields_] == [getattr(want, f) for f, _ in want._fields_]
    assert pair_maps.RECT_LAUNCHES == before + 1


# ---------------------------------------------------------------------------
# remat policies, MoE blocks, convert
# ---------------------------------------------------------------------------

WIDTHS = dict(node_dim=32, pair_dim=16, n_heads=2, n_blocks=2)


@pytest.fixture(scope="module")
def feats_np():
    """B=2, L=20 random structures featurized by JAX, the second padded."""
    xyz = (np.random.RandomState(1).randn(2, 20, 15, 3) * 5).astype(np.float32)
    f = jtrfold.featurize_for_model(JaxBatch.from_xyz(xyz))
    out = {k: np.array(v) for k, v in f.items()}
    out["residue_mask"][1, -4:] = False
    return out


def _tfeats(feats_np):
    return {k: torch.from_numpy(v.copy()) for k, v in feats_np.items()}


def _port(cfg_kw):
    model = trfold.TrFold(trfold.TrFoldConfig(**cfg_kw), device=DEVICE)
    model.reset_parameters(torch.Generator().manual_seed(0))
    return model


def _jax_loss_grads(cfg_kw, params_sd, feats_np):
    model = jtrfold.TrFold(jtrfold.TrFoldConfig(**cfg_kw))
    params = jax.tree_util.tree_map(jnp.asarray, trfold_params_to_flax(params_sd))
    feats = {k: jnp.asarray(v) for k, v in feats_np.items()}
    fn = jax.jit(jax.value_and_grad(lambda p, f: jtrfold.loss_fn(p, model, f)))
    loss, grads = fn(params, feats)
    flat = trfold_params_from_flax(jax.tree_util.tree_map(np.asarray, grads))
    return float(loss), {k: v.numpy() for k, v in flat.items()}


def _exact_zero(key, shape):
    """Gradient entries that are exactly 0 (a per-head constant on every logit
    of a softmax row: tests/test_torch_trfold.py) and carry rounding noise."""
    mask = np.zeros(shape, bool)
    if key.endswith("attn.pair_bias.bias"):
        mask[...] = True
    elif key.endswith("attn.qkv.bias"):
        mask[1] = True
    return mask


def _check_grads(ref_loss, ref, model, loss):
    assert abs(float(loss) - ref_loss) <= 1e-5 * abs(ref_loss)
    got = {k: p.grad for k, p in model.named_parameters()}
    assert sorted(got) == sorted(ref)
    top = max(float(np.abs(r).max()) for r in ref.values())
    for k, r in ref.items():
        g = as_numpy(got[k]) if got[k] is not None else np.zeros_like(r)
        zero = _exact_zero(k, r.shape)
        assert np.abs(g[zero]).max(initial=0) <= 1e-5 * top, k
        if not zero.all():
            scale = max(float(np.abs(r[~zero]).max()), 1e-30)
            assert np.abs(g[~zero] - r[~zero]).max() <= 1e-5 * scale + 1e-7 * top, k


@pytest.mark.parametrize("policy", ["none", "tri_dots", "dots"])
def test_remat_policy_matches_jax(feats_np, policy):
    kw = dict(WIDTHS, pair_update="triangle", remat=True, remat_policy=policy)
    model = _port(kw)
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    ref_loss, ref = _jax_loss_grads(kw, sd, feats_np)
    loss = trfold.loss_fn(dict(model.named_parameters()), model, _tfeats(feats_np))
    loss.backward()
    _check_grads(ref_loss, ref, model, loss)


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[func] = self.n.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("fused", [False, True])
def test_tri_dots_skips_the_contraction_recompute(feats_np, fused):
    """One train step's batched products: tri_dots saves the two triangle
    contractions of each block, so its backward issues 2 fewer ``bmm`` a
    block than ``none``; ``dots`` saves the Dense products (``mm``)."""
    counts, grads = {}, {}
    for policy in ("none", "tri_dots", "dots"):
        model = _port(dict(WIDTHS, pair_update="triangle", remat=True, remat_policy=policy,
                           fused_tri=fused))
        params, opt_state, tx = trfold.make_train_state(
            model, _tfeats(feats_np), torch.Generator().manual_seed(0), device=DEVICE)
        with _CountOps() as c:
            trfold.train_step(params, opt_state, _tfeats(feats_np), model, tx)
        counts[policy] = c.n
        grads[policy] = {k: p.grad for k, p in params.items()}
    bmm, mm = torch.ops.aten.bmm.default, torch.ops.aten.mm.default
    assert counts["none"][bmm] - counts["tri_dots"][bmm] == 2 * WIDTHS["n_blocks"]
    assert counts["dots"][mm] < counts["none"][mm]
    assert counts["dots"][bmm] == counts["none"][bmm]
    for policy in ("tri_dots", "dots"):  # the policy changes no value
        for k, g in grads["none"].items():
            assert torch.equal(g, grads[policy][k]), (policy, k)


def test_moe_mlp_matches_jax():
    rng = np.random.RandomState(5)
    x = rng.randn(2, 10, 16).astype(np.float32)
    mask = rng.rand(2, 10) > 0.3
    m = moe.MoEMLP(16, n_experts=4, hidden_dim=24, device=DEVICE)
    m.reset_parameters(torch.Generator().manual_seed(2))
    tree = trfold_params_to_flax(m.state_dict())
    ref_out, ref_aux = jmoe.MoEMLP(n_experts=4, hidden_dim=24).apply(
        {"params": jax.tree_util.tree_map(jnp.asarray, tree)}, jnp.asarray(x), jnp.asarray(mask))
    out, aux = m(torch.from_numpy(x), torch.from_numpy(mask))
    assert_parity(np.asarray(ref_out), out.detach(), 1e-5, "moe out")
    assert abs(float(aux) - float(ref_aux)) <= 1e-6 * max(1.0, abs(float(ref_aux)))
    assert not out[torch.from_numpy(~mask)].any()     # masked tokens are never routed
    # capacity: T = 20 tokens over E = 4 experts, C = max(int(1.25 * 20 / 4), 1) = 6
    shapes = jax.eval_shape(jmoe.MoEMLP(n_experts=4, hidden_dim=24).init, jax.random.PRNGKey(0),
                            jnp.asarray(x), jnp.asarray(mask))["params"]
    flat = {".".join(str(p.key) for p in path): tuple(v.shape)
            for path, v in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    assert flat == {k: tuple(v.shape) for k, v in m.state_dict().items()}


def test_moe_trfold_matches_jax(feats_np):
    kw = dict(WIDTHS, moe_experts=4)
    model = _port(kw)
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    assert "block_1.moe.router.kernel" in sd and sd["block_0.moe.w1"].shape == (4, 32, 128)
    ref_loss, ref = _jax_loss_grads(kw, sd, feats_np)
    out = model(_tfeats(feats_np))
    assert float(out["moe_aux_loss"]) > 0.0
    loss = trfold.loss_fn(dict(model.named_parameters()), model, _tfeats(feats_np))
    loss.backward()
    _check_grads(ref_loss, ref, model, loss)


def test_convert_carries_moe_and_stage_params(feats_np):
    """A JAX-initialised TrFold(moe_experts=4) into the port and back, and
    the stacked stage trees of both pipelines."""
    cfg = dict(WIDTHS, moe_experts=4)
    jparams = jtrfold.TrFold(jtrfold.TrFoldConfig(**cfg)).init(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in feats_np.items()})["params"]
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    sd = trfold_params_from_flax(tree)
    model = trfold.TrFold(trfold.TrFoldConfig(**cfg), device=DEVICE)
    model.load_state_dict(sd)   # every leaf, MoE's included, by name and shape
    back = trfold_params_to_flax(model.state_dict())
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, leaf)
    assert back["block_0"]["moe"]["w2"].shape == (4, 128, 32)
    stacked_j = jax_stack([tree["block_0"], tree["block_1"]])
    stacked_t = pipeline.stack_stage_params(
        [trfold_params_from_flax(tree["block_0"]), trfold_params_from_flax(tree["block_1"])])
    from_j = trfold_params_from_flax(jax.tree_util.tree_map(np.asarray, stacked_j))
    assert sorted(from_j) == sorted(stacked_t)
    for k, v in stacked_t.items():
        assert torch.equal(v, from_j[k]), k


# ---------------------------------------------------------------------------
# mesh helpers and what is still to port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 4, 6, 8, 16, 32])
def test_factor3_matches_jax(n):
    assert mesh._factor3(n) == jmesh._factor3(n)


def test_batch_pspecs_match_jax():
    for axes in (("dp",), ("dcn", "dp")):
        ref = jmesh.batch_pspecs(axes)
        got = mesh.batch_pspecs(axes)
        assert sorted(ref) == sorted(got)
        for k, spec in ref.items():
            assert tuple(spec) == got[k], k


def test_still_to_port_raises():
    # A.8 is ported: the MoE rule splits the experts, and a ring_mesh must be
    # a (dp, sp, tp) mesh (tests/test_torch_model_parallel.py)
    assert moe.moe_param_shardings({}, None) == {}
    with pytest.raises(ValueError, match=r"\(dp, sp, tp\) mesh"):
        trfold.TrFold(trfold.TrFoldConfig(**WIDTHS, ring_mesh=object()), device=DEVICE)
    with pytest.raises(RuntimeError, match="initialised process group"):
        mesh.make_mesh()


def test_pipeline_apply_validates_config(feats_np):
    class OneStage:   # a mesh of pp = 1 without a process group
        mesh_dim_names = ("pp",)

        def get_local_rank(self, name):
            return 0

        def size(self, i):
            return 1

    model = _port(dict(WIDTHS))
    params = dict(model.named_parameters())
    feats = _tfeats(feats_np)
    with pytest.raises(ValueError, match="n_blocks 2 != pp axis size 1"):
        trfold.pipeline_apply(params, model, feats, OneStage())
    one = _port(dict(WIDTHS, n_blocks=1))
    with pytest.raises(ValueError, match="not divisible into 3 microbatches"):
        trfold.pipeline_apply(dict(one.named_parameters()), one, feats, OneStage(), 3)
    moe1 = _port(dict(WIDTHS, n_blocks=1, moe_experts=2))
    with pytest.raises(ValueError, match="dense blocks only"):
        trfold.pipeline_apply(dict(moe1.named_parameters()), moe1, feats, OneStage())
    out = trfold.pipeline_apply(dict(one.named_parameters()), one, feats, OneStage(), 2)
    ref = one(feats)
    for k in ref:
        assert torch.allclose(out[k], ref[k], atol=1e-6, rtol=0), k


def test_one_rank_dp_mesh_runs_its_collectives(tmp_path):
    """``train`` with ``mesh_shape=(1, 1, 1)`` and ZeRO-1 on a one-rank gloo
    group: the trainer builds its dp group at any size, so the gradient and
    loss all-reduces, the owners' broadcasts and the moments' gather run;
    the losses and the checkpoint's moments equal the run without a mesh."""
    import os

    import torch.distributed as dist

    from protstruc_tpu_torch import train
    from protstruc_tpu_torch.models.checkpoint import restore_train_state

    data = os.path.join(os.path.dirname(__file__), "data")
    paths = [os.path.join(data, p) for p in ("1REX.pdb", "4EOT.pdb")]
    kw = dict(batch_size=2, crop_len=24, node_dim=32, pair_dim=16, n_blocks=1, n_recycle=0,
              steps=2, save_every=2)
    names = ("all_reduce", "broadcast", "all_gather_object")
    counts, saved = dict.fromkeys(names, 0), {n: getattr(dist, n) for n in names}

    def counted(name):
        def call(*a, **k):
            counts[name] += 1
            return saved[name](*a, **k)
        return call

    res = {}
    mesh.init_distributed("cpu", rank=0, world_size=1)
    try:
        for n in names:
            setattr(dist, n, counted(n))
        for mesh_shape in (None, (1, 1, 1)):
            ck = str(tmp_path / f"ck_{mesh_shape is not None}")
            cfg = train.TrainConfig(**kw, mesh_shape=mesh_shape, zero1=mesh_shape is not None)
            out = train.train(paths, ck, cfg, log_fn=lambda *a: None, device="cpu")
            res[mesh_shape is not None] = (out["final_loss"],
                                           restore_train_state(ck)[1]["adamw"]["state"],
                                           dict(counts))
    finally:
        for n in names:
            setattr(dist, n, saved[n])
        dist.destroy_process_group()
    (loss0, mom0, calls0), (loss1, mom1, calls1) = res[False], res[True]
    assert calls0 == dict.fromkeys(names, 0)
    assert all(calls1[n] > 0 for n in names), calls1
    assert loss1 == loss0
    assert sorted(mom1) == sorted(mom0)
    for i, st in mom0.items():
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(mom1[i][key], st[key]), (i, key)
