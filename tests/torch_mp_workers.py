"""Rank programs for the model-parallel tests (tests/test_torch_model_parallel.py).

Run as ``python tests/torch_mp_workers.py <rank> <dir>``: four ranks join one
gloo group through a ``FileStore`` under ``<dir>``, read the inputs the test
wrote to ``<dir>/inputs.pt``, run every check on sub-meshes of that group
and write their results to ``<dir>/rank<r>.pt``.  Imports torch, numpy and
the port only (never jax or the JAX package), so a rank starts in seconds.
"""

import datetime
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from protstruc_tpu_torch.models import checkpoint  # noqa: E402
from protstruc_tpu_torch.models.ipa import (FoldModel, IPAConfig, fold_loss_fn,  # noqa: E402
                                            ipa_param_shardings, tp_partial_grads)
from protstruc_tpu_torch.models.moe import MoEMLP, moe_param_shardings  # noqa: E402
from protstruc_tpu_torch.models.trfold import TrFold, TrFoldConfig  # noqa: E402
from protstruc_tpu_torch.parallel import collectives as col  # noqa: E402
from protstruc_tpu_torch.parallel.mesh import (cut, cut_params, init_distributed,  # noqa: E402
                                               make_mesh, shard_feats)
from protstruc_tpu_torch.parallel.zero import all_reduce_, sum_sharded_grads_  # noqa: E402

WORLD = 4
#: seconds a collective may wait: a rank that hangs fails the run
TIMEOUT = datetime.timedelta(seconds=90)


def _np(t):
    return t.detach().cpu().numpy()


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def whole_grads(model):
    """The sharded model's gradients as the trainer reduces them (summed over
    dp x sp, the tp-partial leaves over tp too), gathered whole."""
    sh = model.shard
    params = dict(model.named_parameters())
    specs = ipa_param_shardings(params)
    grads = {k: p.grad if p.grad is not None else torch.zeros_like(p) for k, p in params.items()}
    sum_sharded_grads_(grads, sh, tp_partial_grads(specs))
    return {k: _np(v) for k, v in checkpoint.gather_tp(grads, specs, sh).items()}


def fold(inp, shape):
    """fold_loss_fn over the mesh ``shape`` for every configuration: the
    global loss (the ranks' shares summed), the whole gradients, and this
    rank's blocks of the forward outputs."""
    mesh = make_mesh(axis_shapes=shape)
    feats, xyz = _t(inp["feats"]), torch.from_numpy(inp["xyz"])
    res = {}
    for name, kw in inp["configs"].items():
        kw = dict(kw)
        nr = kw.pop("n_recycle", 0)
        model = FoldModel(TrFoldConfig(**inp["widths"], **kw), IPAConfig(**inp["ipa"]),
                          n_recycle=nr, device="cpu", mesh=mesh)
        checkpoint.load_whole_state(model, _t(inp["params"][name]))
        params = dict(model.named_parameters())
        local = shard_feats(feats, mesh)
        loss = fold_loss_fn(params, model, local, cut(xyz, ("dp", "sp"), mesh))
        loss.backward()
        total = loss.detach().clone()
        dist.all_reduce(total, group=model.shard.data_group)
        grads = whole_grads(model)   # a collective: every rank
        with torch.no_grad():
            out = model(local)
        res[name] = {"loss": float(total), "share": float(loss.detach()),
                     "aux": float(out["moe_aux_loss"]),
                     "grads": grads if dist.get_rank() == 0 else None,
                     "ring": model.trunk_cfg.ring_mesh is not None,
                     "out": {k: _np(out[k]) for k in ("xyz", "distogram_logits", "omega_sincos",
                                                     "pae_logits", "plddt_logits")}}
    return res


def moe_ep(inp):
    """MoEMLP with its experts over dp on a (4, 1, 1) mesh: this rank's
    output block, the aux, and the gradients of its input block and
    parameters for a fixed cotangent (the loss a rank's share)."""
    mesh = make_mesh(axis_shapes=(WORLD, 1, 1))
    E, D, H = inp["moe_dims"]
    m = MoEMLP(D, n_experts=E, hidden_dim=H, device="cpu", mesh=mesh, ep_axis="dp")
    whole = _t(inp["moe_params"])
    m.load_state_dict(cut_params(whole, moe_param_shardings(whole, mesh), mesh))
    spec = ("dp", None, None)
    x = cut(torch.from_numpy(inp["moe_x"]), spec, mesh).clone().requires_grad_()
    mask = cut(torch.from_numpy(inp["moe_mask"]), spec, mesh)
    out, aux = m(x, mask)
    ct = cut(torch.from_numpy(inp["moe_ct"]), spec, mesh)
    ((out * ct).sum() + aux / WORLD).backward()
    router = [m.router.kernel.grad.clone(), m.router.bias.grad.clone()]
    all_reduce_(router, dist.group.WORLD)
    return {"out": _np(out), "aux": float(aux.detach()), "dx": _np(x.grad),
            "w1": _np(m.w1.grad), "b2": _np(m.b2.grad), "router": [_np(g) for g in router]}


def adjoints(inp):
    """<f(x), y> = <x, f^T(y)> for each collective on the 4-rank group: the
    sp-kind ones with per-rank cotangents (a rank's loss a share, both
    sides summed over the ranks), the tp-kind ones with a replicated
    cotangent (every rank the same loss, counted once)."""
    g = dist.group.WORLD
    r = dist.get_rank()
    gen = torch.Generator().manual_seed(100 + r)
    x = torch.randn(4, 8, 3, generator=gen, dtype=torch.float64)
    rep = torch.randn(4, 8, 3, generator=torch.Generator().manual_seed(7), dtype=torch.float64)
    # name: (f, x replicated over the ranks, cotangent replicated)
    ops = {
        "all_gather": (lambda z: col.all_gather(z, 1, g), False, False),
        "reduce_scatter": (lambda z: col.reduce_scatter(z, 1, g), False, False),
        "all_to_all": (lambda z: col.all_to_all(z, 0, 1, g), False, False),
        "psum": (lambda z: col.psum(z, g), False, False),
        "copy_to": (lambda z: col.copy_to(z, g), True, False),
        "reduce_from": (lambda z: col.reduce_from(z, g), False, True),
        "split_to": (lambda z: col.split_to(z, 1, g), True, False),
    }
    res = {}
    for name, (f, x_rep, ct_rep) in ops.items():
        xin = (rep if x_rep else x).clone().requires_grad_()
        y = f(xin)
        ct = torch.randn(y.shape, generator=torch.Generator().manual_seed(200 + (0 if ct_rep else r)),
                         dtype=torch.float64)
        (y * ct).sum().backward()
        # a replicated value is one value: its inner product counts once
        both = torch.stack([(y.detach() * ct).sum() / (WORLD if ct_rep else 1),
                            (xin.detach() * xin.grad).sum() / (WORLD if x_rep else 1)])
        dist.all_reduce(both)
        res[name] = (float(both[0]), float(both[1]))
    return res


def errors(inp):
    """The ValueErrors a mesh raises: L % sp, n_heads % tp."""
    res = {}
    mesh = make_mesh(axis_shapes=(1, WORLD, 1))
    feats = {k: v[:, :30, :30] if v.dim() > 2 else v[:, :30] for k, v in _t(inp["feats"]).items()}
    try:
        shard_feats(feats, mesh)
    except ValueError as e:
        res["L % sp"] = str(e)
    mesh = make_mesh(axis_shapes=(1, 2, 2))
    try:
        TrFold(TrFoldConfig(node_dim=32, pair_dim=16, n_heads=3), device="cpu", mesh=mesh)
    except ValueError as e:
        res["n_heads % tp"] = str(e)
    return res


def train_cli(inp, tmp):
    """``train --mesh 1,2,2 --zero1`` for 2 steps, then resumed to 3, and
    ``train --mesh 2,2,1`` for 3 steps, on the same data as the test's
    one-process run."""
    from protstruc_tpu_torch.__main__ import main

    ck = os.path.join(tmp, "ck_122")
    argv = ["train", *inp["train_paths"], "--checkpoint-dir", ck, *inp["train_argv"],
            "--mesh", "1,2,2", "--zero1", "--eval", inp["train_paths"][0], "--device", "cpu"]
    assert main(argv + ["--steps", "2"]) == 0
    assert main(argv + ["--steps", "3"]) == 0  # resumes from step 2, cut for the mesh
    ck = os.path.join(tmp, "ck_221")
    argv = ["train", *inp["train_paths"], "--checkpoint-dir", ck, *inp["train_argv"],
            "--mesh", "2,2,1", "--device", "cpu", "--steps", "3"]
    assert main(argv) == 0


def main(rank: int, tmp: str) -> None:
    torch.set_num_threads(1)
    init_distributed("cpu", rank, WORLD, dist.FileStore(os.path.join(tmp, "store"), WORLD),
                     TIMEOUT)
    inp = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    res = {"adjoints": adjoints(inp), "errors": errors(inp), "moe": moe_ep(inp)}
    for shape in inp["meshes"]:
        res[shape] = fold(inp, shape)
    train_cli(inp, tmp)
    torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), sys.argv[2])
