"""K8/K9, flash pair-bias attention: the port's plain versions vs the JAX package.

The JAX side is ``flash_pair_bias_attention(interpret=True)`` (the Pallas
kernels in interpret mode, with their custom VJP) and
``pair_bias_attention_reference`` on the CPU; the port's side is
``flash_pair_bias_attention`` on CPU tensors, whose forward is K8's plain
version and whose backward is K9's plain version (explicit formulas, not
autograd of the forward) plus ``dq = ds k``.  The CUDA kernels are held to
these plain versions on the card by ``chip_smoke.py`` phase 11.

Inputs: ``randn`` q, k, v, bias and output cotangent (numpy seeds), ragged
``L`` (24-50), ``dh`` 16, 32, 64 and 128, some masked keys, and a batch row whose keys
are all masked.  Budgets (tests/test_flash_attn.py, BASELINE.md:31-37):
forward 2e-5, bias gradient 5e-4, dq/dk/dv 5e-5; bfloat16 inputs 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protstruc_tpu.models import trfold as jtrfold
from protstruc_tpu.ops.flash_attn import (
    flash_pair_bias_attention as jflash, flash_pair_bias_attention_lse as jflash_lse,
    pair_bias_attention_reference as jref)
from protstruc_tpu_torch.convert import trfold_params_from_flax
from protstruc_tpu_torch.models import trfold
from protstruc_tpu_torch.ops import flash_attn as fa
from tests.test_torch_parity import DEVICE, as_numpy, assert_parity

torch.set_num_threads(1)


def _inputs(B=2, L=37, H=2, dh=16, seed=0, dead_row=True):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, L, H, dh).astype(np.float32) for _ in range(3))
    bias = rng.randn(B, H, L, L).astype(np.float32)
    kmask = np.ones((B, L), bool)
    kmask[0, L // 3] = False
    kmask[0, -4:] = False
    if dead_row:
        kmask[-1] = False
    do = rng.randn(B, L, H, dh).astype(np.float32)
    return q, k, v, bias, kmask, do


def _port(q, k, v, bias, kmask, do, dtype=torch.float32):
    leaves = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v, bias)]
    out = fa.flash_pair_bias_attention(*leaves, torch.from_numpy(kmask))
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(do).to(dtype))
    return out.detach(), grads


def _jax(q, k, v, bias, kmask, do, dtype=jnp.float32):
    args = [jnp.asarray(x, dtype) for x in (q, k, v, bias)]
    out, vjp = jax.vjp(lambda *a: jflash(*a, jnp.asarray(kmask), interpret=True), *args)
    return out, vjp(jnp.asarray(do, dtype))


@pytest.mark.parametrize("dh,L", [(16, 37), (32, 50), (64, 40), (128, 24)])
def test_forward_and_gradients_match_jax_flash(dh, L):
    args = _inputs(L=L, dh=dh, seed=dh + L)
    out, grads = _port(*args)
    rout, rgrads = _jax(*args)
    assert_parity(np.asarray(rout), out, 2e-5, "out")
    for name, r, g, tol in zip(("dq", "dk", "dv", "dbias"), rgrads, grads,
                               (5e-5, 5e-5, 5e-5, 5e-4)):
        assert_parity(np.asarray(r), g, tol, name)


@pytest.mark.parametrize("dh", [16, 32, 64, 128])
def test_forward_matches_jnp_reference_and_port_reference(dh):
    q, k, v, bias, kmask, _ = _inputs(L=50, dh=dh, seed=7)
    out, _ = _port(q, k, v, bias, kmask, np.zeros_like(q))
    ref = jref(*(jnp.asarray(x) for x in (q, k, v, bias, kmask)))
    assert_parity(np.asarray(ref), out, 2e-5, "jnp reference")
    mine = fa.pair_bias_attention_reference(*(torch.from_numpy(x) for x in (q, k, v, bias, kmask)))
    assert_parity(np.asarray(ref), mine, 2e-5, "port reference")


def test_lse_matches_jax():
    """K8's second output: the row logsumexp (the JAX entry point gives -inf
    on a fully-masked row, K8 pins +1e30 there)."""
    q, k, v, bias, kmask, _ = _inputs(L=40, dh=16, seed=3)
    _, lse = fa.flash_fwd(*(torch.from_numpy(x) for x in (q, k, v, bias, kmask)))
    _, rlse = jflash_lse(*(jnp.asarray(x) for x in (q, k, v, bias, kmask)), interpret=True)
    rlse = np.asarray(rlse)
    dead = np.isneginf(rlse)
    assert dead[-1].all() and not dead[0].any()
    assert (as_numpy(lse)[dead] == fa.LSE_MASKED).all()
    np.testing.assert_allclose(as_numpy(lse)[~dead], rlse[~dead], rtol=0, atol=2e-5)


def test_fully_masked_rows_give_exact_zeros_and_zero_gradients():
    args = _inputs(L=37, dh=16, seed=11)
    out, (dq, dk, dv, dbias) = _port(*args)
    assert (as_numpy(out)[-1] == 0).all()
    for name, g in (("dq", dq), ("dk", dk), ("dv", dv), ("dbias", dbias)):
        assert (as_numpy(g)[-1] == 0).all(), name
    # masked keys of a live row take no gradient either
    kmask = args[4]
    assert (as_numpy(dk)[0][~kmask[0]] == 0).all() and (as_numpy(dv)[0][~kmask[0]] == 0).all()


def test_backward_is_the_explicit_formulas_of_k9():
    """The plain K9 against autograd of the plain K8 forward (same algebra)."""
    q, k, v, bias, kmask, do = _inputs(L=30, dh=16, seed=5)
    leaves = [torch.from_numpy(x).double().requires_grad_() for x in (q, k, v, bias)]
    out, _ = fa._flash_fwd_plain(*leaves, torch.from_numpy(kmask))
    auto = torch.autograd.grad(out, leaves, torch.from_numpy(do).double())
    _, grads = _port(q, k, v, bias, kmask, do)
    for name, a, g in zip(("dq", "dk", "dv", "dbias"), auto, grads):
        assert_parity(as_numpy(a).astype(np.float32), g, 1e-5, name)


def test_bfloat16_inputs_match_jax():
    args = _inputs(L=50, dh=32, seed=9)
    out, grads = _port(*args, dtype=torch.bfloat16)
    rout, rgrads = _jax(*args, dtype=jnp.bfloat16)
    assert out.dtype == torch.bfloat16
    for name, r, g in zip(("out", "dq", "dk", "dv", "dbias"), (rout, *rgrads), (out, *grads)):
        r, g = np.asarray(r, np.float32), as_numpy(g.float())
        assert np.abs(r - g).max() <= 2e-2 * max(1.0, np.abs(r).max()), name


def test_strided_views_are_read_in_place():
    """q, k, v as slices of one qkv tensor and the bias as a permuted view
    give what contiguous copies give."""
    q, k, v, bias, kmask, _ = _inputs(L=33, dh=16, seed=2)
    qkv = torch.from_numpy(np.stack([q, k, v], axis=2))
    pb = torch.from_numpy(np.ascontiguousarray(bias.transpose(0, 2, 3, 1))).permute(0, 3, 1, 2)
    km = torch.from_numpy(kmask)
    a, lse_a = fa.flash_fwd(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], pb, km)
    b, lse_b = fa.flash_fwd(*(torch.from_numpy(x) for x in (q, k, v, bias)), km)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(lse_a, lse_b, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pair_bias_attention_flash_path_matches_einsum_path(dtype):
    """The module's two paths on one param tree (the JAX package's 1e-4 in
    float32, tests/test_flash_attn.py:171-194; 3e-2 in bfloat16)."""
    cfg = jtrfold.TrFoldConfig(node_dim=32, pair_dim=16, n_heads=2, n_blocks=1)
    rng = np.random.RandomState(4)
    node = rng.randn(2, 21, 32).astype(np.float32)
    pair = rng.randn(2, 21, 21, 16).astype(np.float32)
    mask = np.ones((2, 21), bool)
    mask[1, -5:] = False
    params = jtrfold.PairBiasAttention(cfg).init(jax.random.PRNGKey(0), node, pair, mask)["params"]
    sd = trfold_params_from_flax(jax.tree_util.tree_map(np.asarray, params))
    outs = []
    for flash in (True, False):
        tcfg = trfold.TrFoldConfig(node_dim=32, pair_dim=16, n_heads=2, n_blocks=1,
                                   dtype=getattr(torch, dtype), use_flash_attn=flash)
        mod = trfold.PairBiasAttention(tcfg, device=DEVICE)
        mod.load_state_dict(sd)
        outs.append(mod(torch.from_numpy(node), torch.from_numpy(pair),
                        torch.from_numpy(mask)).float())
    atol = 1e-4 if dtype == "float32" else 3e-2
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=atol)


def test_wrapper_dispatch():
    q, k, v, bias, kmask, _ = _inputs(L=8, dh=16, dead_row=False)
    with pytest.raises(ValueError, match="no implementation for device meta"):
        fa.flash_fwd(*(torch.from_numpy(x).to("meta") for x in (q, k, v, bias, kmask)))
