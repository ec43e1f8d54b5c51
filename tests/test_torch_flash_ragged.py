"""K8/K9 at head dims other than 16, 32, 64 and 128, checked on the CPU.

The Pallas kernels take any dh as one block.  The port's kernels take any
dh on two routes: "whole", built for dh 16, 32, 64, 128 and 256, where a dh
between them runs the next one up; "chunked", every dh above 256 at dh
rounded up to 128.  A dh that is not its route's width has its q, k, v (and
dO) staged into zero-padded copies, with ``scale = 1 / sqrt(dh)`` of the
logical dh, and out, dk, dv cut back.  Here:

* the port's flash op on the CPU (K8's and K9's plain versions) against the
  JAX package's ``flash_pair_bias_attention`` in interpret mode (forward,
  ``jax.vjp`` for dq, dk, dv and the bias gradient) and its lse entry, at
  dh 8, 12, 24, 96, 256 (whole) and 320, 512, 1024 (chunked);
* the padded schedule: the CUDA wrappers on CPU tensors with each launch
  replaced by the plain formulas on the staged tensors at the logical
  scale, against the plain version at dh; the staged widths and zeros, and
  no copy at a width of the route's own, up to dh 2048;
* the dh -> (width, route) table, dh 0 refused, the widths a faked library
  is handed and the launches counted by route;
* the TrFold train step at pair 40, node 96 over 4 heads (dh 24), and at
  node 320 over one head (dh 320, the chunked route), with fused_tri and
  flash, against the JAX package's: loss 1e-5 relative, gradients 1e-3 of
  each leaf's largest.

Budgets (tests/test_flash_attn.py, BASELINE.md:31-37): out and lse 2e-5,
bias gradient 5e-4, dq/dk/dv 5e-5, each times max(1, max|ref|); bf16 2e-2.
The kernels themselves run only on the card (``chip_smoke.py`` phase 24).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protstruc_tpu.models import trfold as jtrfold
from protstruc_tpu.ops.flash_attn import flash_pair_bias_attention as jflash
from protstruc_tpu.ops.flash_attn import flash_pair_bias_attention_lse as jflash_lse
from protstruc_tpu_torch.convert import trfold_params_to_flax
from protstruc_tpu_torch.models import trfold
from protstruc_tpu_torch.ops import flash_attn as fa
from tests.test_torch_parity import DEVICE, as_numpy, assert_parity
from tests.test_torch_trfold import _flat, _torch_feats, _zero_grad_entries, featurized, feats_np  # noqa: F401

torch.set_num_threads(1)

HEAD_DIMS = (8, 12, 24, 96, 256)
CHUNKED_DIMS = (320, 512, 1024)              # the chunked route, against the JAX package
SCHEDULE_DIMS = HEAD_DIMS + (32, 257, 320, 512, 2048)


def _inputs(B=2, L=29, H=2, dh=16, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, L, H, dh).astype(np.float32) for _ in range(3))
    bias = rng.randn(B, H, L, L).astype(np.float32)
    kmask = np.ones((B, L), bool)
    kmask[0, L // 3] = False
    kmask[0, -4:] = False
    kmask[-1] = False  # a batch row with no key
    do = rng.randn(B, L, H, dh).astype(np.float32)
    return q, k, v, bias, kmask, do


@pytest.mark.parametrize("dh", HEAD_DIMS + CHUNKED_DIMS)
def test_forward_lse_and_gradients_match_jax_flash(dh):
    q, k, v, bias, kmask, do = _inputs(dh=dh, seed=dh)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v, bias)]
    out = fa.flash_pair_bias_attention(*leaves, torch.from_numpy(kmask))
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    args = [jnp.asarray(x) for x in (q, k, v, bias)]
    rout, vjp = jax.vjp(lambda *a: jflash(*a, jnp.asarray(kmask), interpret=True), *args)
    assert_parity(np.asarray(rout), out.detach(), 2e-5, "out")
    for name, r, g, tol in zip(("dq", "dk", "dv", "dbias"), vjp(jnp.asarray(do)), grads,
                               (5e-5, 5e-5, 5e-5, 5e-4)):
        assert_parity(np.asarray(r), g, tol, name)
    with torch.no_grad():
        lout, lse = fa.flash_pair_bias_attention_lse(*(torch.from_numpy(x) for x in (q, k, v, bias, kmask)))
    rlout, rlse = jflash_lse(*args, jnp.asarray(kmask), interpret=True)
    rlse = np.asarray(rlse)
    dead = np.isneginf(rlse)
    assert dead[-1].all() and (as_numpy(lse)[dead] == -np.inf).all()
    assert_parity(np.asarray(rlout), lout, 2e-5, "lse entry out")
    np.testing.assert_allclose(as_numpy(lse)[~dead], rlse[~dead], rtol=0, atol=2e-5)


def _bfloat16_matches_jax(dh, seed):
    q, k, v, bias, kmask, do = _inputs(dh=dh, seed=seed)
    leaves = [torch.from_numpy(x).to(torch.bfloat16).requires_grad_() for x in (q, k, v, bias)]
    out = fa.flash_pair_bias_attention(*leaves, torch.from_numpy(kmask))
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(do).to(torch.bfloat16))
    args = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, bias)]
    rout, vjp = jax.vjp(lambda *a: jflash(*a, jnp.asarray(kmask), interpret=True), *args)
    for name, r, g in zip(("out", "dq", "dk", "dv", "dbias"), (rout, *vjp(jnp.asarray(do, jnp.bfloat16))),
                          (out.detach(), *grads)):
        r, g = np.asarray(r, np.float32), as_numpy(g.float())
        assert np.abs(r - g).max() <= 2e-2 * max(1.0, np.abs(r).max()), name


def test_bfloat16_at_a_staged_head_dim_matches_jax():
    _bfloat16_matches_jax(24, 5)


def test_bfloat16_on_the_chunked_route_matches_jax():
    _bfloat16_matches_jax(320, 7)


# -- the padded schedule ------------------------------------------------------


def _emulated_launches(handed, monkeypatch):
    """``_launch_fwd`` and ``_launch_bwd`` replaced by the plain versions on
    the staged tensors at the scale they are handed (the kernels read no
    dh but the built one and take the scale from the wrapper)."""
    def plain(fn, q, scale, *args):
        with monkeypatch.context() as mp:
            mp.setattr(fa, "_scale", lambda _: scale)
            return fn(q, *args)

    def fwd(q, k, v, bias, kmask, scale, out, lse):
        assert out.shape == q.shape  # the kernels write at the width they read
        handed.append(("fwd", q, k, v, scale))
        o, l_ = plain(fa._flash_fwd_plain, q, scale, k, v, bias, kmask)
        out.copy_(o)
        lse.copy_(l_)

    def bwd(q, k, v, bias, kmask, do, lse, delta, scale, ds, dk, dv):
        assert dk.shape == dv.shape == q.shape
        handed.append(("bwd", q, k, v, do, scale))
        for o, g in zip((ds, dk, dv), plain(fa._flash_bwd_plain, q, scale, k, v, bias, kmask, do, lse, delta)):
            o.copy_(g)

    monkeypatch.setattr(fa, "_launch_fwd", fwd)
    monkeypatch.setattr(fa, "_launch_bwd", bwd)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh", SCHEDULE_DIMS)
def test_padded_schedule_matches_the_plain_version(dh, dtype, monkeypatch):
    tdt = getattr(torch, dtype)
    q, k, v, bias, kmask, do = _inputs(dh=dh, seed=3 * dh)
    qkv = torch.from_numpy(np.stack([q, k, v], axis=2)).to(tdt)  # q, k, v as views of one tensor
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    bias, km, do = torch.from_numpy(bias).to(tdt), torch.from_numpy(kmask), torch.from_numpy(do).to(tdt)
    handed = []
    _emulated_launches(handed, monkeypatch)
    out, lse = fa._flash_fwd_cuda(q, k, v, bias, km)
    r_out, r_lse = fa._flash_fwd_plain(q, k, v, bias, km)
    delta = (do.float() * r_out.float()).sum(-1).permute(0, 2, 1).contiguous()
    got = fa._flash_bwd_cuda(q, k, v, bias, km, do, r_lse, delta)
    ref = fa._flash_bwd_plain(q, k, v, bias, km, do, r_lse, delta)
    budgets = {"out": 2e-5, "ds": 5e-4, "dk": 5e-5, "dv": 5e-5}
    for name, r, g in zip(("out", "ds", "dk", "dv"), (r_out, *ref), (out, *got)):
        assert g.shape == r.shape and g.dtype == r.dtype, name
        r, g = r.float().numpy(), g.float().numpy()
        top = max(1.0, float(np.abs(r).max()))
        tol = budgets[name] * top if dtype == "float32" else 2e-2 * top
        assert float(np.abs(r - g).max()) <= tol, name
    live = km.any(-1)
    assert_parity(as_numpy(r_lse[live]), lse[live], 2e-5, "lse")
    width = fa.kernel_head_dim(dh)
    assert width >= dh
    assert fa.head_dim_route(dh) == ("chunked" if dh > 256 else "whole")
    if dh > 256:  # the chunked route's widths: multiples of 128, the columns a block owns
        assert width % 128 == 0 and width - dh < 128
    assert [call[0] for call in handed] == ["fwd", "bwd"]
    for call in handed:
        tensors, scale = call[1:-1], call[-1]
        assert scale == pytest.approx(dh ** -0.5, rel=1e-12)
        for t in tensors:
            assert t.shape[-1] == width and not t[..., dh:].any()
            if width != dh:
                assert t.is_contiguous()
    if width == dh:  # a width of the route's own: the strided views are read in place
        assert handed[0][1] is q and handed[0][2] is k and handed[0][3] is v
        assert handed[1][1] is q and handed[1][2] is k and handed[1][3] is v


def test_head_dim_table_and_the_limit(monkeypatch):
    """dh -> (width, route): the whole route's built widths up to 256, the
    chunked route's multiples of 128 above; dh 0 refused.  A faked library
    is handed that width, the logical dh's scale, and each launch is counted
    on its route."""
    whole = {1: 16, 8: 16, 12: 16, 16: 16, 17: 32, 24: 32, 32: 32, 48: 64, 64: 64, 96: 128,
             128: 128, 129: 256, 160: 256, 200: 256, 256: 256}
    chunked = {257: 384, 320: 384, 384: 384, 385: 512, 512: 512, 1000: 1024, 2048: 2048}
    table = {**{dh: (w, "whole") for dh, w in whole.items()},
             **{dh: (w, "chunked") for dh, w in chunked.items()}}
    assert {dh: (fa.kernel_head_dim(dh), fa.head_dim_route(dh)) for dh in table} == table
    assert not hasattr(fa, "MAX_HEAD_DIM") and fa.ROUTES == ("whole", "chunked")
    for dh in (0, -1):
        with pytest.raises(ValueError, match="1 or more"):
            fa.kernel_head_dim(dh)
    handed = []
    lib = types.SimpleNamespace(ps_flash_fwd=lambda *a: handed.append(("fwd", a)) or 0,
                                ps_flash_bwd=lambda *a: handed.append(("bwd", a)) or 0)
    monkeypatch.setattr(fa, "load_library", lambda: lib)
    monkeypatch.setattr(fa, "LAUNCHES", {"fwd": 0, "bwd": 0})
    monkeypatch.setattr(fa, "ROUTE_LAUNCHES", {p: dict.fromkeys(fa.ROUTES, 0) for p in ("fwd", "bwd")})
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=0))
    B, H, L = 2, 4, 5
    bias = torch.empty((B, H, L, L), device="meta")
    kmask = torch.ones((B, L), dtype=torch.bool, device="meta")
    lse = torch.empty((B, H, L), device="meta")
    for dh, width in ((0, None), (12, 16), (256, 256), (257, 384), (512, 512), (1000, 1024)):
        q = torch.empty((B, L, H, dh), device="meta")
        if width is None:
            with pytest.raises(ValueError, match="1 or more"):
                fa._flash_fwd_cuda(q, q, q, bias, kmask)
            assert not handed
            continue
        before = {p: dict(c) for p, c in fa.ROUTE_LAUNCHES.items()}
        out, _ = fa._flash_fwd_cuda(q, q, q, bias, kmask)
        ds, dk, dv = fa._flash_bwd_cuda(q, q, q, bias, kmask, q, lse, lse)
        assert out.shape == dk.shape == dv.shape == (B, L, H, dh) and ds.shape == bias.shape
        for part in ("bwd", "fwd"):
            name, args = handed.pop()
            assert name == part
            assert args[2:6] == (B, H, L, width) and args[6] == pytest.approx(dh ** -0.5)
        route = table[dh][1]
        assert {p: {r: n - before[p][r] for r, n in c.items()} for p, c in fa.ROUTE_LAUNCHES.items()} == {
            p: {r: int(r == route) for r in fa.ROUTES} for p in ("fwd", "bwd")}
    assert fa.LAUNCHES == {"fwd": 5, "bwd": 5}


# -- the TrFold step at ragged widths, port against JAX ------------------------

WIDTHS = dict(node_dim=96, pair_dim=40, n_heads=4, n_blocks=1, pair_update="triangle",
              fused_tri=True, use_flash_attn=True)


def _trfold_step_matches_jax(feats_np, widths):  # noqa: F811
    port = trfold.TrFold(trfold.TrFoldConfig(**widths), device=DEVICE)
    port.reset_parameters(torch.Generator().manual_seed(0))
    model = jtrfold.TrFold(jtrfold.TrFoldConfig(**widths))
    params = jax.tree_util.tree_map(jnp.asarray, trfold_params_to_flax(port.state_dict()))
    feats = {k: jnp.asarray(v) for k, v in feats_np.items()}
    loss_ref, grads_ref = jax.jit(jax.value_and_grad(lambda p, f: jtrfold.loss_fn(p, model, f)))(params, feats)
    grads_ref = _flat(grads_ref)
    tfeats = _torch_feats(feats_np)
    tparams = dict(port.named_parameters())
    loss = trfold.loss_fn(tparams, port, tfeats)
    loss.backward()
    assert abs(float(loss) - float(loss_ref)) <= 1e-5 * abs(float(loss_ref))
    assert sorted(grads_ref) == sorted(tparams)
    for key, r in grads_ref.items():
        g = as_numpy(tparams[key].grad)
        zero = _zero_grad_entries(key, r.shape)
        if zero.all():
            continue
        scale = max(float(np.abs(r[~zero]).max()), 1e-30)
        assert float(np.abs(g - r)[~zero].max()) <= 1e-3 * scale, key


def test_trfold_step_at_ragged_widths_matches_jax(feats_np):  # noqa: F811
    """Pair 40 (K4-K7 staged to 48 on the card) and dh 24 (K8/K9 staged to
    32): the loss and every gradient leaf of one TrFold step against the
    JAX model (Pallas kernels in interpret mode) on the same weights."""
    _trfold_step_matches_jax(feats_np, WIDTHS)


def test_trfold_step_over_one_wide_head_matches_jax(feats_np):  # noqa: F811
    """Node 320 over one head: dh 320, which K8/K9 run on the chunked route
    (staged to 384 on the card); the loss and every gradient leaf against
    the JAX model as above."""
    _trfold_step_matches_jax(feats_np, dict(WIDTHS, node_dim=320, n_heads=1, pair_dim=16))
