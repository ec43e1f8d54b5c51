"""Rank programs for the multi-rank tests of the port (tests/test_torch_dist.py).

Run as ``python tests/torch_dist_workers.py <world> <rank> <dir>``: each rank
joins a gloo group through a ``FileStore`` under ``<dir>``, reads the
inputs the test wrote to ``<dir>/inputs.pt``, runs every check of its world
size in one process group and writes its blocks to ``<dir>/rank<r>.pt``.
This module imports torch, numpy and the port only (never jax or the JAX
package), so a rank starts in a few seconds.
"""

import datetime
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from protstruc_tpu_torch import StructureBatch  # noqa: E402
from protstruc_tpu_torch.models import trfold  # noqa: E402
from protstruc_tpu_torch.ops.ring_attn import ring_attention_sharded  # noqa: E402
from protstruc_tpu_torch.parallel import pipeline  # noqa: E402
from protstruc_tpu_torch.parallel.mesh import (featurize_sharded, init_distributed,  # noqa: E402
                                               make_mesh, shard_batch)

#: seconds a collective may wait: a rank that hangs fails the run
TIMEOUT = datetime.timedelta(seconds=90)


def _np(t):
    return None if t is None else t.detach().cpu().numpy()


def ring(inp, n):
    """ring_attention_sharded over (1, n, 1): this rank's output block and
    its blocks of the q, k, v and bias gradients."""
    mesh = make_mesh(axis_shapes=(1, n, 1))
    q, k, v, bias = (torch.from_numpy(inp[f"ring_{x}"]).requires_grad_()
                     for x in ("q", "k", "v", "bias"))
    kmask = torch.from_numpy(inp["ring_kmask"])
    out = ring_attention_sharded(q, k, v, bias, kmask, mesh)
    r, L = dist.get_rank(), q.shape[1]
    rows = slice(r * L // n, (r + 1) * L // n)
    (out * torch.from_numpy(inp["ring_ct"])[:, rows]).sum().backward()
    return {"out": _np(out), "dq": _np(q.grad[:, rows]), "dk": _np(k.grad[:, rows]),
            "dv": _np(v.grad[:, rows]), "dbias": _np(bias.grad[:, :, rows]),
            # every other row of the global gradients stays zero on this rank
            "stray": bool(any(_outside(g, rows, 1).any() for g in (q.grad, k.grad, v.grad))
                          or _outside(bias.grad, rows, 2).any())}


def _outside(g, rows, dim):
    """``g`` with its block ``rows`` along ``dim`` set to 0."""
    g = g.clone()
    g.narrow(dim, rows.start, rows.stop - rows.start).zero_()
    return g


def featurize(inp):
    """featurize_sharded over (2, 2, 1), kernel path and plain path."""
    mesh = make_mesh(axis_shapes=(2, 2, 1))
    sb = StructureBatch._from_numpy(inp["feat_xyz"], inp["feat_atom_mask"], inp["feat_chain_idx"],
                                    inp["feat_residue_idx"], None, None, torch.device("cpu"))
    local = shard_batch(sb, mesh)
    res = {"shape": tuple(local.xyz.shape)}
    for use_kernel in (True, False):
        maps, d, m, frames = featurize_sharded(local, mesh, use_kernel=use_kernel)
        res[use_kernel] = ({k: _np(v) for k, v in maps.items()}, _np(d), _np(m), _np(frames))
    return res


def _stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def pipe(inp, n):
    """pipeline_forward of tanh(x w + b) stages, and pipeline_apply of a
    TrFold with n blocks (forward, loss, gradients of this rank's leaves)."""
    mesh = make_mesh(axis_shapes=(n,), axis_names=("pp",))
    group = mesh.get_group("pp")
    res = {}
    stages = {k: torch.from_numpy(inp[f"pipe{n}_{k}"]).requires_grad_() for k in ("w", "b")}
    x = torch.from_numpy(inp[f"pipe{n}_x"])
    out = pipeline.pipeline_forward(_stage, stages, x, group)
    (out ** 2).sum().backward()
    res["generic"] = (_np(out), _np(stages["w"].grad), _np(stages["b"].grad))

    feats = {k[len("tf_feat_"):]: torch.from_numpy(v) for k, v in inp.items()
             if k.startswith("tf_feat_")}
    cfg = trfold.TrFoldConfig(**inp["tf_widths"], n_blocks=n)
    model = trfold.TrFold(cfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in inp[f"tf_params{n}"].items()})
    params = dict(model.named_parameters())
    out = trfold.pipeline_apply(params, model, feats, mesh, n_microbatches=2)
    loss = sum((out[k].float() ** 2).mean() for k in sorted(out) if k != "moe_aux_loss")
    loss.backward()
    res["apply"] = ({k: _np(v) for k, v in out.items()}, float(loss),
                    {k: _np(p.grad) for k, p in params.items() if p.grad is not None})
    return res


def train_dp(inp, tmp):
    """train() over the data-parallel mesh (2, 1, 1), with and without
    ZeRO-1; the moment bytes a rank holds under ZeRO-1; then the train CLI
    with --mesh 2,1,1 --zero1, resumed for one more step."""
    from protstruc_tpu_torch import train
    from protstruc_tpu_torch.__main__ import main

    res = {}
    for zero1 in (False, True):
        ck = os.path.join(tmp, f"ck_dp_zero{int(zero1)}")
        cfg = train.TrainConfig(**inp["train_cfg"], mesh_shape=(2, 1, 1), zero1=zero1)
        res[f"train_zero{int(zero1)}"] = train.train(inp["train_paths"], ck, cfg,
                                                     log_fn=lambda *a: None, device="cpu")

    cfg = train.TrainConfig(**inp["train_cfg"], mesh_shape=(2, 1, 1), zero1=True)
    model = train._build_model(cfg, torch.device("cpu"))
    model.reset_parameters(torch.Generator().manual_seed(0))
    params = dict(model.named_parameters())
    for p in params.values():
        p.grad = torch.ones_like(p)
    opt = train.TrainOptimizer(params, cfg, dp_group=dist.group.WORLD)
    opt.step()
    res["moment_bytes"] = sum(v.numel() * v.element_size() for st in opt.adamw.state.values()
                              for k, v in st.items() if k in ("exp_avg", "exp_avg_sq"))
    res["largest_leaf_bytes"] = 2 * max(p.numel() * p.element_size() for p in params.values())
    res["total_moment_bytes"] = 2 * sum(p.numel() * p.element_size() for p in params.values())

    ck = os.path.join(tmp, "ck_cli")
    argv = ["train", *inp["train_paths"], "--checkpoint-dir", ck, "--batch-size", "2",
            "--node-dim", "32", "--pair-dim", "16", "--blocks", "1", "--recycle", "0",
            "--crop", "24", "--save-every", "1", "--mesh", "2,1,1", "--zero1", "--device", "cpu"]
    assert main(argv + ["--steps", "1"]) == 0
    assert main(argv + ["--steps", "2"]) == 0  # resumes from step 1 on every rank
    return res


def main(world: int, rank: int, tmp: str) -> None:
    torch.set_num_threads(1)
    init_distributed("cpu", rank, world, dist.FileStore(os.path.join(tmp, "store"), world),
                     TIMEOUT)
    inp = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    res = {"ring": ring(inp, world), "pipe": pipe(inp, world)}
    if world == 4:
        res["featurize"] = featurize(inp)
    if world == 2:
        res["train"] = train_dp(inp, tmp)
    torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
