"""Training loop: PDB files -> trained FoldModel checkpoint (port of
``protstruc_tpu/train.py``).

:func:`train` streams bucketed batches (``pdbio/dataset.py``), crops them
(``StructureBatch.random_crop``), featurizes them through the fused K3 kernel
(``featurize_for_model(fused=True)``), and takes one optimizer step of
:func:`~protstruc_tpu_torch.models.ipa.fold_loss_fn` per microbatch, with
checkpoints (``models/checkpoint.py``), ``metrics.jsonl`` records and held-out
evaluation.  :func:`load_fold_model`, :func:`fold_with_model` and
:func:`fold_sequence` fold a sequence with a trained checkpoint.

The optimizer is optax's chain of the JAX package in PyTorch
(:class:`TrainOptimizer`): ``clip_by_global_norm`` (scale by ``max_norm /
norm`` when ``norm >= max_norm``), ``torch.optim.AdamW`` at optax's defaults, the
``warmup_cosine`` schedule counted in optimizer steps, an EMA of the params,
and ``optax.MultiSteps`` gradient accumulation (the running mean of the
microbatch gradients; the schedule, the moments and the EMA advance once per
cycle).  A parameter that gets no gradient (the trunk's angle heads, which
``fold_loss_fn`` does not read) takes a zero gradient, as in JAX.

Everything runs on ``device`` (``"cuda"`` unless the caller names another;
without a card that default raises).  On the card ``load_fold_model`` keeps
``use_flash_attn`` and ``fused_tri`` as trained: the tensors' device decides
between the kernels and their plain versions.

``mesh_shape=(dp, sp, tp)`` trains over a process group of dp * sp * tp
ranks (``parallel/mesh.init_distributed``: NCCL on cards, gloo on the CPU;
under ``torchrun`` one rank a card): every rank draws the same global batch
and crop, keeps its ``B / dp`` structures, divides its losses by the counts
of the whole batch (``fold_loss_fn(count_group=)``) and sums the gradients, so
a step equals the single-process step.  With ``sp > 1`` or ``tp > 1`` the
model is sharded (``FoldModel(mesh=)``, ``models/trfold.py``): K3 featurizes
the dp block's whole crop and each rank keeps its ``L / sp`` rows
(``parallel.mesh.shard_feats``), the heads and MLP hidden dim split over tp,
and flash attention rings over sp.  Gradients are summed over the dp x sp
ranks; the replicated leaves each tp rank uses in part
(``models.ipa.tp_partial_grads``) over tp as well; the clip's global norm
counts each tp-split leaf's chunks once.  ``zero1`` gives each parameter's
AdamW moments to one owner rank of the dp group (within each (sp, tp)
coordinate), which updates it and broadcasts it (``parallel/zero.py``);
checkpoints hold whole parameters and the whole optimizer state in the
single-process format whatever the mesh (the tp chunks gathered on save, cut
again on restore), so a checkpoint trained on a mesh loads and folds in one
process.  Rank 0 alone writes ``metrics.jsonl``, checkpoints and
evaluations, which run unsharded (JAX strips ``ring_mesh`` for eval); every
rank resumes from the checkpoint.
Checkpoints are ``torch.save`` files, not the JAX package's orbax ones;
weights cross over through ``convert.foldmodel_params_from_flax``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
import warnings
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from protstruc_tpu_torch.batch import resolve_device

__all__ = ["TrainConfig", "TrainOptimizer", "train", "evaluate", "eval_batch_metrics",
           "best_eval_step", "load_fold_model", "fold_with_model", "fold_sequence"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The JAX package's ``TrainConfig``, field for field (same JSON); see
    there for what each option does."""

    steps: int = 1000
    batch_size: int = 4
    node_dim: int = 128
    pair_dim: int = 64
    n_heads: int = 4
    n_blocks: int = 4
    n_ipa_iter: int = 6
    n_recycle: int = 1
    sequence_only: bool = False
    learning_rate: float = 3e-4
    grad_clip: float = 1.0
    lr_schedule: str = "constant"
    warmup_steps: int = 0
    lr_min_ratio: float = 0.1
    ema_decay: float = 0.0
    accum_steps: int = 1
    save_every: int = 500
    seed: int = 0
    shuffle: bool = True
    bf16: bool = False
    pair_update: str = "gated_mix"
    remat: bool = False
    remat_policy: str = "none"
    use_flash_attn: bool = False
    fused_tri: bool = False
    metrics_jsonl: bool = True
    profile_dir: Optional[str] = None
    crop_len: Optional[int] = None
    mesh_shape: Optional[tuple] = None
    zero1: bool = False
    eval_max_len: Optional[int] = 1024

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "TrainConfig":
        d = json.loads(text)
        if d.get("mesh_shape") is not None:
            d["mesh_shape"] = tuple(d["mesh_shape"])
        return cls(**d)


# fields that shape the params, the optimizer state or the input pipeline: a
# resume across a change of any of them is refused (train.py:454-457)
_SHAPE_FIELDS = ("node_dim", "pair_dim", "n_heads", "n_blocks", "n_ipa_iter", "n_recycle",
                 "sequence_only", "bf16", "pair_update", "accum_steps", "ema_decay",
                 "lr_schedule")


def _check_config(cfg: TrainConfig) -> None:
    if cfg.zero1 and cfg.mesh_shape is None:
        raise ValueError(
            "zero1=True requires mesh_shape: ZeRO-1 partitions optimizer state over the dp "
            "mesh axis — without a mesh it would be silently ignored")
    if cfg.mesh_shape is not None:
        import torch.distributed as dist

        if len(cfg.mesh_shape) != 3:
            raise ValueError(f"mesh_shape must be (dp, sp, tp), got {cfg.mesh_shape}")
        n = math.prod(cfg.mesh_shape)
        world = (dist.get_world_size() if dist.is_initialized()
                 else int(os.environ.get("WORLD_SIZE", 1)))
        if n != world:
            raise ValueError(f"mesh_shape {tuple(cfg.mesh_shape)} needs dp*sp*tp = {n} ranks, but "
                             f"the world size is {world}")


def _model_mesh(cfg: TrainConfig, mesh):
    """The mesh the model shards over: ``mesh`` when sp > 1 or tp > 1; a
    data-parallel run keeps the model whole."""
    if mesh is None or (cfg.mesh_shape[1] == 1 and cfg.mesh_shape[2] == 1):
        return None
    return mesh


# ---------------------------------------------------------------------------
# optimizer: optax's chain of _build_tx (train.py:179-207)
# ---------------------------------------------------------------------------


def learning_rate_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """The learning rate at optimizer step ``count`` (0 for the first apply),
    as optax's ``constant`` or ``warmup_cosine_decay_schedule`` gives it, both
    durations counted in optimizer steps."""
    if cfg.lr_schedule == "constant":
        return lambda count: cfg.learning_rate
    if cfg.lr_schedule != "warmup_cosine":
        raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r} (constant | warmup_cosine)")
    accum = max(cfg.accum_steps, 1)
    decay = max(cfg.steps // accum, 2)
    warm = min(max(cfg.warmup_steps // accum, 1), decay - 1)
    peak, end = cfg.learning_rate, cfg.lr_min_ratio * cfg.learning_rate
    alpha = 0.0 if peak == 0.0 else end / peak

    def schedule(count: int) -> float:
        if count < warm:  # linear from 0 to peak
            return (0.0 - peak) * (1.0 - count / warm) + peak
        t = min(count - warm, decay - warm)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / (decay - warm)))
        return peak * ((1.0 - alpha) * cosine + alpha)

    return schedule


class TrainOptimizer:
    """``clip_by_global_norm -> adamw(schedule) [-> params EMA]``, wrapped in
    ``MultiSteps`` when ``cfg.accum_steps > 1``: the JAX package's optimizer.
    The AdamW update is ``torch.optim.AdamW`` at optax's defaults
    (:func:`~protstruc_tpu_torch.models.trfold.adamw`, as ``make_train_state``
    builds it), its learning rate set from the schedule before each apply;
    the clip, the accumulation and the EMA wrap it.

    ``params`` are the model's parameters by name; :meth:`step` reads their
    ``.grad`` (None counts as zero) and updates them in place.
    :meth:`state_dict` (ints, tensors and the AdamW state) is what a
    checkpoint holds.

    ``shard``: the ``parallel.mesh.ModelShard`` of a sharded model, whose
    ``params`` are this rank's chunks.  Gradients are then summed over its
    dp x sp group (``count_group``, the losses' too), the tp-partial leaves
    (``models.ipa.tp_partial_grads``) over tp, and ZeRO-1 partitions over its
    dp group; :meth:`state_dict` gathers the tp-split leaves' state whole
    and :meth:`load_state_dict` cuts it.
    """

    def __init__(self, params: Dict[str, torch.Tensor], cfg: TrainConfig, dp_group=None,
                 shard=None):
        from protstruc_tpu_torch.models.ipa import ipa_param_shardings, tp_partial_grads
        from protstruc_tpu_torch.models.trfold import adamw
        from protstruc_tpu_torch.parallel.zero import zero1_owners

        self.params, self.cfg, self.shard = params, cfg, shard
        # data parallelism: gradients summed over count_group (dp, or dp x sp
        # for a sharded model); with cfg.zero1 each parameter's moments live
        # on its owner rank of dp_group alone
        self.specs = self.tp_split = self.tp_partial = None
        if shard is not None:
            dp_group = shard.dp_group
            self.specs = ipa_param_shardings(params)
            self.tp_split = {k for k, sp in self.specs.items() if "tp" in sp}
            self.tp_partial = set(tp_partial_grads(self.specs))
        self.dp_group = dp_group
        self.count_group = shard.data_group if shard is not None else dp_group
        self.owners = None
        if dp_group is not None and cfg.zero1:
            import torch.distributed as dist

            self.owners = zero1_owners(params, dist.get_world_size(dp_group))
            self.rank = dist.get_rank(dp_group)
        self.schedule = learning_rate_schedule(cfg)
        self.adamw = adamw(list(params.values()), self.schedule(0))
        self.state = {
            "count": 0,          # optimizer applies so far (the schedule's count)
            "mini_step": 0,      # microbatches accumulated in this cycle
            "ema": ({k: p.detach().clone() for k, p in params.items()}
                    if cfg.ema_decay > 0.0 else None),
            "acc": ({k: torch.zeros_like(p, memory_format=torch.preserve_format)
                     for k, p in params.items()} if cfg.accum_steps > 1 else None),
        }

    def state_dict(self) -> dict:
        """The state as a single-process run holds it; under ZeRO-1 or a
        sharded model a collective (every rank calls it) that gathers the
        moments, and the tp-split leaves' state whole."""
        sd = self.adamw.state_dict()
        if self.owners is not None:
            import torch.distributed as dist

            parts = [None] * dist.get_world_size(self.dp_group)
            mine = {i: {k: (v.cpu() if torch.is_tensor(v) else v) for k, v in st.items()}
                    for i, st in sd["state"].items()}
            dist.all_gather_object(parts, mine, group=self.dp_group)
            sd = dict(sd, state={i: st for part in parts for i, st in sorted(part.items())})
        state = dict(self.state, adamw=sd)
        if self.shard is None:
            return state
        from protstruc_tpu_torch.models.checkpoint import gather_tp

        names = list(self.params)
        moments = {names[i]: {k: v for k, v in st.items() if k != "step"}
                   for i, st in sd["state"].items()}
        device = next(iter(self.params.values())).device
        whole = gather_tp(moments, self.specs, self.shard, device)
        sd = dict(sd, state={i: dict(st, **whole[names[i]]) for i, st in sd["state"].items()})
        return dict(state, adamw=sd, **{key: (None if state[key] is None else
                                              gather_tp(state[key], self.specs, self.shard))
                                        for key in ("ema", "acc")})

    def load_state_dict(self, state: dict) -> None:
        if self.shard is not None:  # a whole state: this rank's chunks
            state = self._cut(state)
        for key in ("count", "mini_step"):
            self.state[key] = int(state[key])
        for key in ("ema", "acc"):
            if (state[key] is None) != (self.state[key] is None):
                raise ValueError(f"optimizer state {key!r} does not match this config")
            if state[key] is not None:
                with torch.no_grad():
                    for k, t in self.state[key].items():
                        t.copy_(state[key][k])
        self.adamw.load_state_dict(state["adamw"])
        if self.owners is not None:  # keep only the moments this rank owns
            for k, p in self.params.items():
                if self.owners[k] != self.rank:
                    self.adamw.state.pop(p, None)

    def _cut(self, state: dict) -> dict:
        """A whole optimizer state cut to this rank's tp chunks."""
        from protstruc_tpu_torch.parallel.mesh import cut

        mesh, names = self.shard.mesh, list(self.params)

        def cut_leaf(k, v):
            return cut(v, self.specs[k], mesh).clone() if torch.is_tensor(v) and v.dim() else v

        sd = state["adamw"]
        sd = dict(sd, state={i: {k: cut_leaf(names[i], v) for k, v in st.items()}
                             for i, st in sd["state"].items()})
        return dict(state, adamw=sd, **{key: (None if state[key] is None else
                                              {k: cut_leaf(k, v) for k, v in state[key].items()})
                                        for key in ("ema", "acc")})

    @torch.no_grad()
    def step(self) -> bool:
        """One microbatch's gradients in; returns whether the params moved."""
        names = list(self.params)
        grads = [self.params[k].grad if self.params[k].grad is not None
                 else torch.zeros_like(self.params[k]) for k in names]
        if self.shard is not None:
            from protstruc_tpu_torch.parallel.zero import sum_sharded_grads_

            sum_sharded_grads_(dict(zip(names, grads)), self.shard, self.tp_partial)
        elif self.dp_group is not None:
            from protstruc_tpu_torch.parallel.zero import all_reduce_

            all_reduce_(grads, self.dp_group)  # each rank's share of the global loss
        k_steps = self.cfg.accum_steps
        if k_steps > 1:
            acc = [self.state["acc"][k] for k in names]
            n = self.state["mini_step"]
            # optax.MultiSteps' running mean: acc + (g - acc) / (n + 1)
            delta = torch._foreach_sub(grads, acc)
            torch._foreach_div_(delta, float(n + 1))
            torch._foreach_add_(acc, delta)
            if n < k_steps - 1:
                self.state["mini_step"] = n + 1
                return False
            self.state["mini_step"] = 0
            self._apply(names, acc)
            torch._foreach_zero_(acc)
            return True
        self._apply(names, grads)
        return True

    def _apply(self, names, grads) -> None:
        params = [self.params[k] for k in names]
        # clip_by_global_norm: scale by max_norm / norm unless norm < max_norm
        norms = torch.stack(torch._foreach_norm(grads))
        if self.shard is None:
            norm = torch.linalg.vector_norm(norms)
        else:  # a tp-split leaf's chunks are on the tp ranks: count each once
            import torch.distributed as dist

            split = torch.tensor([k in self.tp_split for k in names], device=norms.device)
            tp_sq = torch.where(split, norms ** 2, 0.0).sum()
            dist.all_reduce(tp_sq, group=self.shard.tp_group)
            norm = torch.sqrt(tp_sq + torch.where(split, 0.0, norms ** 2).sum())
        max_norm = self.cfg.grad_clip
        coef = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
        for k, p, g in zip(names, params, torch._foreach_mul(grads, coef)):
            # every leaf, so AdamW decays and moves the moments of all; under
            # ZeRO-1 only this rank's, the rest come from their owners
            p.grad = g if self.owners is None or self.owners[k] == self.rank else None

        self.state["count"] += 1
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.state["count"] - 1)
        self.adamw.step()
        if self.owners is not None:
            from protstruc_tpu_torch.parallel.zero import broadcast_from_owners_

            broadcast_from_owners_(self.params, self.owners, self.dp_group)

        if self.state["ema"] is not None:
            decay = self.cfg.ema_decay
            ema = [self.state["ema"][k] for k in names]
            torch._foreach_mul_(ema, decay)
            torch._foreach_add_(ema, params, alpha=1.0 - decay)


# ---------------------------------------------------------------------------
# model and features
# ---------------------------------------------------------------------------


def _build_model(cfg: TrainConfig, device, mesh=None):
    """FoldModel of ``cfg`` on ``device``, sharded over ``mesh`` when given
    (``cfg.ring_mesh`` is set by the model when flash meets sp > 1)."""
    from protstruc_tpu_torch.models.ipa import FoldModel, IPAConfig
    from protstruc_tpu_torch.models.trfold import TrFoldConfig

    dtype = torch.bfloat16 if cfg.bf16 else torch.float32
    trunk = TrFoldConfig(node_dim=cfg.node_dim, pair_dim=cfg.pair_dim, n_heads=cfg.n_heads,
                         n_blocks=cfg.n_blocks, dtype=dtype, pair_update=cfg.pair_update,
                         remat=cfg.remat, remat_policy=cfg.remat_policy,
                         use_flash_attn=cfg.use_flash_attn, fused_tri=cfg.fused_tri)
    return FoldModel(trunk_cfg=trunk, ipa_cfg=IPAConfig(n_heads=cfg.n_heads, n_iter=cfg.n_ipa_iter),
                     n_recycle=cfg.n_recycle, device=device, mesh=mesh)


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


def _featurize(batch, cfg: TrainConfig, trunk_cfg, generator: Optional[torch.Generator] = None,
               seq_idx_override=None, mesh=None):
    """``(feats, target or None, batch)``: crop (with ``generator``), then the
    fused featurization; ``seq_idx_override`` ``(B, <= L)`` replaces stale
    ``seq`` metadata (eval windows) and is padded with UNK.  With a ``mesh``
    the crop is drawn for the whole batch and this rank keeps its ``B / dp``
    structures (``parallel.mesh.shard_batch``) before the featurization; a
    sharded model's rank then keeps its ``L / sp`` rows of the features, the
    target and the batch (K3 featurizes the whole crop, as an unpartitioned
    kernel does under GSPMD)."""
    from protstruc_tpu_torch.models.trfold import featurize_for_model, featurize_from_sequence
    from protstruc_tpu_torch.vocab import AA

    if seq_idx_override is not None:
        pad = batch.n_residues - seq_idx_override.shape[1]
        sidx = np.pad(np.asarray(seq_idx_override), ((0, 0), (0, pad)),
                      constant_values=int(AA.UNK)) if pad else np.asarray(seq_idx_override)
        seq_idx = torch.as_tensor(sidx, dtype=torch.int32, device=batch.device)
    else:
        seq_idx = batch.get_seq_idx() if batch.seq is not None else None
    if cfg.crop_len and generator is not None and cfg.crop_len < batch.n_residues:
        if seq_idx is None:
            batch = batch.random_crop(cfg.crop_len, generator)
        else:
            batch, (seq_idx,) = batch.random_crop(cfg.crop_len, generator, extras=(seq_idx,))
    if mesh is not None:
        from protstruc_tpu_torch.parallel.mesh import mesh_coords, shard_batch

        bi, nb = mesh_coords(mesh, "dp")
        B = batch.batch_size
        if B % nb:
            raise ValueError(f"a batch of {B} structures does not split over dp={nb}: choose "
                             "batch_size and data whose batches divide by dp")
        batch = shard_batch(batch, mesh, axes=("dp",))
        if seq_idx is not None:
            seq_idx = seq_idx[bi * B // nb:(bi + 1) * B // nb]
    target = featurize_for_model(batch, fused=True, n_dist_bins=trunk_cfg.n_dist_bins,
                                 max_dist=trunk_cfg.max_dist)
    if seq_idx is not None:
        target["seq_idx"] = seq_idx
    feats = None
    if cfg.sequence_only:
        feats = featurize_from_sequence(target["seq_idx"], batch.chain_idx,
                                        n_dist_bins=trunk_cfg.n_dist_bins)
        feats["residue_mask"] = batch.residue_mask
    if mesh is not None and _model_mesh(cfg, mesh) is not None:
        from protstruc_tpu_torch.parallel.mesh import shard_feats

        target = shard_feats(target, mesh, axes=("sp",))
        feats = None if feats is None else shard_feats(feats, mesh, axes=("sp",))
        batch = shard_batch(batch, mesh, axes=("sp",))
    return (target, None, batch) if feats is None else (feats, target, batch)


def train_step(model, params, opt: TrainOptimizer, feats, target, xyz) -> torch.Tensor:
    """One microbatch: ``fold_loss_fn``, its gradients, one optimizer step;
    returns the detached loss (no host synchronisation).  Under data
    parallelism (``opt.dp_group``) the loss is this rank's share of the
    global batch's: its masked means divide by counts summed over dp."""
    from protstruc_tpu_torch.models.ipa import fold_loss_fn

    model.zero_grad(set_to_none=True)
    loss = fold_loss_fn(params, model, feats, xyz, target_feats=target,
                        count_group=opt.count_group)
    loss.backward()
    opt.step()
    return loss.detach()


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------


def eval_batch_metrics(model, params, cfg: TrainConfig, batch):
    """Per-structure ``(ca_lddt (B,), ca_rmsd (B,), n_windows)`` of one batch.

    Structures longer than ``cfg.eval_max_len`` are scored on ``ceil(L /
    cap)`` near-equal contiguous windows, averaged weighted by valid residues
    (cross-window contacts leave the lDDT).  ``params`` are the model's own.
    """
    from protstruc_tpu_torch.models.trfold import _check_params
    from protstruc_tpu_torch.ops.metrics import lddt, rmsd
    from protstruc_tpu_torch.utils.buckets import pad_batch_to_bucket

    _check_params(params, model)
    L = batch.n_residues
    cap = cfg.eval_max_len or L
    n_win = -(-L // cap)
    wins = [(0, L)] if n_win == 1 else [(i * L // n_win, (i + 1) * L // n_win) for i in range(n_win)]
    seq_idx = (batch.get_seq_idx().cpu().numpy()
               if len(wins) > 1 and batch.seq is not None else None)

    num_l = np.zeros(batch.batch_size)
    num_r = np.zeros(batch.batch_size)
    den = np.zeros(batch.batch_size)
    for s, e in wins:
        if len(wins) == 1:
            w, sidx = pad_batch_to_bucket(batch), None
        else:
            w = pad_batch_to_bucket(dataclasses.replace(
                batch, xyz=batch.xyz[:, s:e], atom_mask=batch.atom_mask[:, s:e],
                chain_idx=batch.chain_idx[:, s:e], residue_idx=batch.residue_idx[:, s:e],
                seq=None, chain_ids=None))
            sidx = seq_idx[:, s:e] if seq_idx is not None else None
        feats, _target, w = _featurize(w, cfg, model.trunk_cfg, seq_idx_override=sidx)
        with torch.no_grad():
            out = model(feats)
        ca_true = torch.nan_to_num(w.xyz[:, :, 1], nan=1e6)
        mask = w.residue_mask & torch.isfinite(w.xyz[:, :, 1]).all(-1)
        nv = mask.sum(1).cpu().numpy().astype(float)
        ca = out["xyz"][:, :, 1]
        lv = lddt(ca, ca_true, mask=mask).cpu().numpy()
        rv = rmsd(ca, ca_true, mask=mask, align=True).cpu().numpy()
        num_l += np.where(nv > 0, lv, 0.0) * nv
        num_r += np.where(nv > 0, rv, 0.0) * nv
        den += nv
    den = np.maximum(den, 1.0)
    return num_l / den, num_r / den, len(wins)


def evaluate(model, params, paths: Sequence[str], cfg: TrainConfig) -> dict:
    """Held-out mean CA-lDDT and aligned CA-RMSD (``eval_n_windows``: the
    most windows any structure needed; 1 = every one scored whole)."""
    from protstruc_tpu_torch.pdbio.dataset import StructureDataset

    ls, rs, max_windows = [], [], 1
    for batch in StructureDataset(list(paths), batch_size=cfg.batch_size, shuffle=False,
                                  device=_model_device(model)):
        lv, rv, nw = eval_batch_metrics(model, params, cfg, batch)
        ls.append(lv)
        rs.append(rv)
        max_windows = max(max_windows, nw)
    return {"eval_ca_lddt": float(np.concatenate(ls).mean()),
            "eval_ca_rmsd": float(np.concatenate(rs).mean()),
            "eval_n_windows": max_windows}


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------


def _append_jsonl(checkpoint_dir: str, row: dict) -> None:
    with open(os.path.join(checkpoint_dir, "metrics.jsonl"), "a") as fh:
        fh.write(json.dumps(row) + "\n")


def train(paths: Sequence[str], checkpoint_dir: str, cfg: TrainConfig = TrainConfig(),
          log_fn=print, eval_paths: Sequence[str] = None, device="cuda") -> dict:
    """Train FoldModel over ``paths`` on ``device``; returns the final metrics.

    ``cfg.steps`` is the TOTAL step target: a checkpoint in
    ``checkpoint_dir`` resumes training up to it.  ``eval_paths``: held-out
    structures scored at every save and at the end.
    """
    from protstruc_tpu_torch.models.checkpoint import (
        latest_step, load_whole_state, restore_train_state, save_train_state, whole_state)
    from protstruc_tpu_torch.pdbio.dataset import StructureDataset

    device = resolve_device(device)
    if not paths:
        raise ValueError("train() needs at least one input structure")
    _check_config(cfg)
    mesh = dp_group = None
    lead = True  # this rank writes metrics, checkpoints and evaluations
    if cfg.mesh_shape is not None:
        import torch.distributed as dist

        from protstruc_tpu_torch.parallel.mesh import init_distributed, make_mesh

        device = init_distributed(device)
        mesh = make_mesh(axis_shapes=cfg.mesh_shape)
        dp_group = mesh.get_group("dp")  # a group of one rank too: the same collectives
        lead = dist.get_rank() == 0
        # flash + sequence parallelism = ring attention over sp (JAX's
        # train.py:421-427): neither the bias nor the keys are gathered
        if cfg.use_flash_attn and cfg.mesh_shape[1] > 1:
            log_fn(f"[train] flash attention rings over sp={cfg.mesh_shape[1]}")
        log_fn(f"[train] mesh dp={cfg.mesh_shape[0]} sp={cfg.mesh_shape[1]} "
               f"tp={cfg.mesh_shape[2]} over {dist.get_world_size()} ranks"
               + (", ZeRO-1" if cfg.zero1 else ""))
    model = _build_model(cfg, device, _model_mesh(cfg, mesh))
    shard = model.shard
    ds = StructureDataset(paths, batch_size=cfg.batch_size, shuffle=cfg.shuffle, seed=cfg.seed,
                          device=device)

    os.makedirs(checkpoint_dir, exist_ok=True)
    cfg_path = os.path.join(checkpoint_dir, "config.json")
    if latest_step(checkpoint_dir) is not None and os.path.exists(cfg_path):
        with open(cfg_path) as fh:
            existing = TrainConfig.from_json(fh.read())
        diff = {f: (getattr(existing, f), getattr(cfg, f)) for f in _SHAPE_FIELDS
                if getattr(existing, f) != getattr(cfg, f)}
        if diff:
            raise ValueError(
                f"checkpoint_dir {checkpoint_dir!r} holds a checkpoint trained with a different "
                "model config: "
                + ", ".join(f"{k}={a!r} (checkpoint) vs {b!r} (requested)"
                            for k, (a, b) in diff.items())
                + ". Use a fresh checkpoint_dir or match the saved config.")
    if mesh is not None:
        dist.barrier()  # every rank has checked the saved config
    if lead:
        with open(cfg_path, "w") as fh:
            fh.write(cfg.to_json())

    params = opt = prof = None
    start_step = step = 0
    t0 = time.perf_counter()
    losses = []
    last_eval = None
    while step < cfg.steps or params is None:
        for batch in ds:
            crop_gen = torch.Generator().manual_seed(cfg.seed * 100003 + step)
            feats, target, batch = _featurize(batch, cfg, model.trunk_cfg, generator=crop_gen,
                                              mesh=mesh)
            if params is None:
                model.reset_parameters(torch.Generator().manual_seed(cfg.seed))
                params = dict(model.named_parameters())
                opt = TrainOptimizer(params, cfg, dp_group=dp_group, shard=shard)
                if latest_step(checkpoint_dir) is not None:
                    saved, opt_saved, start_step = restore_train_state(checkpoint_dir)
                    load_whole_state(model, saved)
                    opt.load_state_dict(opt_saved)
                    step = start_step
                    log_fn(f"[train] resumed from step {start_step}")
                    if step >= cfg.steps:
                        log_fn(f"[train] checkpoint already at step {step} >= steps={cfg.steps}; "
                               "nothing to train")
                        break
            if cfg.profile_dir and step - start_step == 3:
                prof = torch.profiler.profile()
                prof.__enter__()
            t_step = time.perf_counter()
            loss = train_step(model, params, opt, feats, target, batch.xyz)
            if opt.count_group is not None:  # the ranks' shares sum to the global loss
                dist.all_reduce(loss, group=opt.count_group)
            step += 1
            losses.append(float(loss))  # synchronises: host-visible step time
            step_ms = (time.perf_counter() - t_step) * 1e3
            if prof is not None and step - start_step == 6:
                prof.__exit__(None, None, None)
                os.makedirs(cfg.profile_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(cfg.profile_dir, "trace.json"))
                prof = None
                log_fn(f"[train] torch.profiler trace (steps 3-6) -> {cfg.profile_dir}")
            if step % max(cfg.steps // 10, 1) == 0:
                log_fn(f"[train] step {step:5d}  loss {losses[-1]:.4f}  {step_ms:.0f} ms")
                if cfg.metrics_jsonl and lead:
                    _append_jsonl(checkpoint_dir, {"step": step, "loss": losses[-1],
                                                   "ms": round(step_ms, 1),
                                                   "t": round(time.perf_counter() - t0, 1)})
            if cfg.save_every and step % cfg.save_every == 0:
                opt_sd = opt.state_dict()  # a collective under ZeRO-1 or a sharded model
                whole = whole_state(model)
                if lead:
                    save_train_state(checkpoint_dir, step, whole, opt_sd)
                if eval_paths and lead:
                    ev = evaluate(*_eval_model(model, params, cfg, whole), eval_paths, cfg)
                    last_eval = (step, ev)
                    log_fn(f"[eval] step {step}: " + " ".join(f"{k}={v:.3f}" for k, v in ev.items()))
                    if cfg.metrics_jsonl:
                        _append_jsonl(checkpoint_dir, dict(ev, step=step))
            if step >= cfg.steps:
                break

    opt_sd = opt.state_dict()
    whole = whole_state(model)
    if lead:
        save_train_state(checkpoint_dir, step, whole, opt_sd)
    if mesh is not None:
        dist.barrier()  # the checkpoint is on disk before any rank returns
    dt = time.perf_counter() - t0
    final_loss = losses[-1] if losses else None
    result = {"steps": step, "final_loss": final_loss, "seconds": dt}
    if eval_paths and lead:
        if last_eval is not None and last_eval[0] == step:
            ev, fresh_eval = last_eval[1], False
        else:
            ev, fresh_eval = evaluate(*_eval_model(model, params, cfg, whole), eval_paths, cfg), True
        result.update(ev)
        log_fn("[eval] final: " + " ".join(
            f"{k}={v:.3f}" for k, v in result.items() if k.startswith("eval")))
        if cfg.metrics_jsonl and fresh_eval:
            _append_jsonl(checkpoint_dir, dict(ev, step=step))
    log_fn(f"[train] done: {step - start_step} steps in {dt:.0f}s "
           f"({dt / max(step - start_step, 1) * 1e3:.0f} ms/step)"
           + (f", final loss {final_loss:.4f}" if losses else ""))
    return result


def _eval_model(model, params, cfg: TrainConfig, whole):
    """``(model, params)`` to evaluate: a sharded model's whole parameters
    ``whole`` in an unsharded copy (evaluation runs on one rank, as JAX
    strips ``ring_mesh`` for eval), else the model itself."""
    if model.shard is None:
        return model, params
    plain = _build_model(cfg, _model_device(model))
    plain.load_state_dict(whole)
    return plain, dict(plain.named_parameters())


# ---------------------------------------------------------------------------
# checkpoints -> folding
# ---------------------------------------------------------------------------


def best_eval_step(checkpoint_dir: str, metric: str = "eval_ca_lddt") -> Optional[int]:
    """The checkpointed step with the best recorded held-out ``metric`` in
    ``metrics.jsonl`` (lower is better for ``*rmsd*``), or None."""
    from protstruc_tpu_torch.models.checkpoint import all_steps

    path = os.path.join(checkpoint_dir, "metrics.jsonl")
    if not os.path.exists(path):
        return None
    saved = set(all_steps(checkpoint_dir))
    best, best_v = None, None
    lower_is_better = "rmsd" in metric
    with open(path) as fh:
        for line in fh:
            try:
                row = json.loads(line)
            except ValueError:
                continue
            v = row.get(metric)
            if v is None or row.get("step") not in saved:
                continue
            if best_v is None or (v < best_v if lower_is_better else v > best_v):
                best, best_v = int(row["step"]), v
    return best


def load_fold_model(checkpoint_dir: str, use_ema: bool = True, step=None, device="cuda"):
    """``(model, params, cfg)`` from a training checkpoint directory, on
    ``device``: the EMA weights when trained with ``ema_decay > 0`` and
    ``use_ema``; ``step`` None (latest), an int, or ``"best"``
    (:func:`best_eval_step`, else the latest with a warning)."""
    from protstruc_tpu_torch.models.checkpoint import restore_train_state

    if step == "best":
        step = best_eval_step(checkpoint_dir)
        if step is None:
            warnings.warn(
                f"load_fold_model(step='best'): no eval metric rows match a saved checkpoint "
                f"under {checkpoint_dir!r} (was training run with eval_paths?); loading the "
                "latest step instead.", stacklevel=2)
    with open(os.path.join(checkpoint_dir, "config.json")) as fh:
        cfg = TrainConfig.from_json(fh.read())
    if not cfg.sequence_only:
        warnings.warn(
            f"checkpoint {checkpoint_dir!r} was trained structure-conditioned "
            "(sequence_only=False): its inputs were ground-truth distogram/angle features, so "
            "folding from a bare sequence is out-of-distribution and the coordinates (and "
            "pLDDT) are unreliable. Train with sequence_only=True (CLI: --sequence-only) for a "
            "checkpoint meant for sequence folding.", stacklevel=2)
    model = _build_model(cfg, resolve_device(device))
    saved, opt_state, _ = restore_train_state(checkpoint_dir, step=step)
    model.load_state_dict(opt_state["ema"] if use_ema and cfg.ema_decay > 0.0 else saved)
    return model, dict(model.named_parameters()), cfg


def fold_with_model(model, params, cfg: TrainConfig, sequence: str,
                    n_recycle: Optional[int] = None, return_confidence: bool = False):
    """Sequence -> predicted backbone ``(L, 5, 3)`` N/CA/C/O/CB with an
    already loaded model; chains separated by ``:``.  With
    ``return_confidence``: ``(coords, plddt (L,), pae (L, L))``."""
    from protstruc_tpu_torch import geometry as geom
    from protstruc_tpu_torch.models.ipa import pae_from_logits, plddt_from_logits
    from protstruc_tpu_torch.models.trfold import _check_params, featurize_from_sequence
    from protstruc_tpu_torch.vocab import ressymb_to_resindex

    _check_params(params, model)
    dev = _model_device(model)
    chains = sequence.upper().split(":")
    seq_idx = torch.tensor([[ressymb_to_resindex.get(c, 20) for ch in chains for c in ch]],
                           dtype=torch.int32, device=dev)
    chain_idx = torch.tensor([[k for k, ch in enumerate(chains) for _ in ch]],
                             dtype=torch.int32, device=dev)
    feats = featurize_from_sequence(seq_idx, chain_idx, n_dist_bins=model.trunk_cfg.n_dist_bins)
    nr = cfg.n_recycle if n_recycle is None else n_recycle
    with torch.no_grad():
        out = model(feats, n_recycle=nr)
    bb = out["xyz"][0]  # (L, 4, 3) N/CA/C/CB
    o = geom.ideal_carbonyl_oxygen(bb[:, 0], bb[:, 1], bb[:, 2], chain_idx=chain_idx[0])
    coords = torch.stack([bb[:, 0], bb[:, 1], bb[:, 2], o, bb[:, 3]], dim=1)
    if not return_confidence:
        return coords
    return (coords, plddt_from_logits(out["plddt_logits"][0]),
            pae_from_logits(out["pae_logits"][0]))


def fold_sequence(checkpoint_dir: str, sequence: str, n_recycle: Optional[int] = None,
                  return_confidence: bool = False, step=None, use_ema: bool = True,
                  device="cuda"):
    """:func:`load_fold_model` then :func:`fold_with_model`."""
    model, params, cfg = load_fold_model(checkpoint_dir, step=step, use_ema=use_ema,
                                         device=device)
    return fold_with_model(model, params, cfg, sequence, n_recycle=n_recycle,
                           return_confidence=return_confidence)
