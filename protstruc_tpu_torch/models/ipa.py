"""FoldModel on PyTorch: port of ``protstruc_tpu/models/ipa.py``.

The TrFold trunk (``models/trfold.py``) feeds an AF2-style structure module:
invariant point attention refines per-residue rigid frames from the (node,
pair) representations and emits backbone coordinates; recycling re-embeds
the previous pass's predicted CB distogram; pLDDT and PAE heads predict the
model's own confidence.  Trained with :func:`fold_loss_fn` (trunk distogram
and torsion losses, trajectory FAPE, confidence CE).

The modules keep the flax parameter tree (``structure.ipa.q_point.kernel``,
``trunk.block_0...``, ``recycle_dist_embed``, ``plddt_head``, ...), float32
storage and flax's layer semantics (``models/_nn.py``), so
``convert.foldmodel_params_from_flax`` carries JAX weights across.  The
recycle embedders exist only when ``n_recycle > 0``, as in flax, where they
materialize only when called.  Frames are ``(r, t)`` tensor pairs with
column-basis rotations, ``x_global = r x_local + t``.

Not ported: ``ipa_param_shardings`` (meshes are not ported).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from protstruc_tpu_torch import geometry as geom
from protstruc_tpu_torch.batch import resolve_device
from protstruc_tpu_torch.models._nn import Dense, LayerNorm, gelu
from protstruc_tpu_torch.models.trfold import TrFold, TrFoldConfig, _check_params
from protstruc_tpu_torch.ops.histogram import distogram_bins
from protstruc_tpu_torch.ops.metrics import lddt
from protstruc_tpu_torch.ops.rigid import frame_apply, frame_compose, frame_invert, quat_to_rot

__all__ = [
    "IPAConfig",
    "InvariantPointAttention",
    "BackboneUpdate",
    "StructureModule",
    "FoldModel",
    "frames_from_backbone",
    "backbone_xyz_from_frames",
    "fape_loss",
    "fold_loss_fn",
    "confidence_losses",
    "plddt_from_logits",
    "pae_from_logits",
    "aligned_error",
    "PLDDT_BINS",
    "PAE_BINS",
    "PAE_MAX",
]

PLDDT_BINS = 50          # 0.02-wide lDDT bins
PAE_BINS = 64
PAE_MAX = 32.0           # angstroms; 0.5 A-wide bins


@dataclasses.dataclass(frozen=True)
class IPAConfig:
    """The JAX package's ``IPAConfig`` with a torch ``dtype``."""

    node_dim: int = 128
    pair_dim: int = 64
    n_heads: int = 4
    scalar_dim: int = 16
    n_qk_points: int = 4
    n_v_points: int = 8
    n_iter: int = 4
    position_scale: float = 10.0
    dtype: torch.dtype = torch.float32


def frames_from_backbone(xyz: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(R = gram_schmidt(N, CA, C), t = CA)`` from ``xyz (..., A>=3, 3)``."""
    r = geom.gram_schmidt(xyz[..., 0, :], xyz[..., 1, :], xyz[..., 2, :])
    return r, xyz[..., 1, :]


def backbone_xyz_from_frames(r: torch.Tensor, t: torch.Tensor,
                             include_cb: bool = True) -> torch.Tensor:
    """Ideal backbone atoms placed in each frame: ``(..., 3|4, 3)`` N/CA/C(/CB)."""
    ideal = geom.ideal_backbone_coordinates(r.shape[:-2], include_cb=include_cb,
                                            device=r.device)
    return frame_apply(r, t, ideal)


class InvariantPointAttention(nn.Module):
    """AF2 IPA: scalar attention + pair bias + squared distances of query and
    key points in global coordinates, each a third of the logit."""

    def __init__(self, cfg: IPAConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        D, P, H, C, dt = cfg.node_dim, cfg.pair_dim, cfg.n_heads, cfg.scalar_dim, cfg.dtype
        Pq, Pv = cfg.n_qk_points, cfg.n_v_points
        self.q_scalar = Dense(D, (H, C), dt, device)
        self.k_scalar = Dense(D, (H, C), dt, device)
        self.v_scalar = Dense(D, (H, C), dt, device)
        self.q_point = Dense(D, (H, Pq, 3), dt, device)
        self.k_point = Dense(D, (H, Pq, 3), dt, device)
        self.v_point = Dense(D, (H, Pv, 3), dt, device)
        self.pair_bias = Dense(P, H, dt, device)
        self.point_weight = nn.Parameter(torch.zeros(H, device=resolve_device(device)))
        self.out = Dense(H * C + H * P + H * Pv * 3 + H * Pv, D, dt, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        nn.init.zeros_(self.point_weight)

    def forward(self, node, pair, frames, mask):
        cfg = self.cfg
        H, C, Pq, Pv, dt = cfg.n_heads, cfg.scalar_dim, cfg.n_qk_points, cfg.n_v_points, cfg.dtype
        r, t = frames
        q, k, v = self.q_scalar(node), self.k_scalar(node), self.v_scalar(node)

        def points(layer, n_pts):  # local points -> global, (B, L, H, n, 3)
            p = layer(node)
            flat = p.reshape(p.shape[:-3] + (H * n_pts, 3))
            return frame_apply(r, t, flat.float()).reshape(p.shape)

        qp, kp, vp = points(self.q_point, Pq), points(self.k_point, Pq), points(self.v_point, Pv)
        bias = self.pair_bias(pair).permute(0, 3, 1, 2)  # (B, H, L, L)

        f32 = dict(dtype=torch.float32, device=node.device)
        w_c = torch.sqrt(torch.tensor(2.0 / (9.0 * Pq), **f32))
        w_l = torch.sqrt(torch.tensor(1.0 / 3.0, **f32))
        gamma = F.softplus(self.point_weight)

        logits = torch.einsum("blhc,bmhc->bhlm", q, k) / torch.sqrt(torch.tensor(float(C), **f32))
        sq = (qp ** 2).sum(-1).sum(-1)  # (B, L, H)
        sk = (kp ** 2).sum(-1).sum(-1)
        cross = torch.einsum("blhpx,bmhpx->bhlm", qp, kp)
        d2 = sq.permute(0, 2, 1)[..., :, None] + sk.permute(0, 2, 1)[..., None, :] - 2.0 * cross
        logits = w_l * (logits + bias.float())
        logits = logits - w_l * gamma[None, :, None, None] * w_c / 2.0 * d2

        allowed = mask[:, None, None, :]
        a = torch.softmax(torch.where(allowed, logits, -1e9), dim=-1)
        # a query row with no allowed key would softmax to uniform weights
        a = torch.where(allowed, a, 0.0)

        o_scalar = torch.einsum("bhlm,bmhc->blhc", a.to(dt), v)
        o_pair = torch.einsum("bhlm,blmp->blhp", a.to(dt), pair)
        o_pt = torch.einsum("bhlm,bmhpx->blhpx", a, vp)

        r_inv, t_inv = frame_invert(r, t)
        o_pt_local = frame_apply(r_inv, t_inv, o_pt.reshape(o_pt.shape[:-3] + (H * Pv, 3)))
        n2 = (o_pt_local ** 2).sum(-1)
        pos = n2 > 0.0
        o_pt_norm = torch.where(pos, torch.sqrt(torch.where(pos, n2, 1.0)), 0.0)

        lead = node.shape[:-1]
        out = torch.cat([o_scalar.reshape(lead + (H * C,)), o_pair.reshape(lead + (-1,)),
                         o_pt_local.reshape(lead + (H * Pv * 3,)).to(dt), o_pt_norm.to(dt)],
                        dim=-1)
        return self.out(out)


class _ZeroDense(Dense):
    """A Dense whose kernel initialiser is zeros."""

    def reset_parameters(self, gen: torch.Generator) -> None:
        nn.init.zeros_(self.kernel)
        nn.init.zeros_(self.bias)


class BackboneUpdate(nn.Module):
    """Node -> rigid update: quaternion (1, b, c, d) and translation, from a
    zero-initialised float32 Dense (flax's ``update``)."""

    def __init__(self, node_dim: int, device="cuda"):
        super().__init__()
        self.update = _ZeroDense(node_dim, 6, torch.float32, device)

    def forward(self, node):
        upd = self.update(node)
        bcd, trans = upd[..., :3], upd[..., 3:]
        quat = torch.cat([torch.ones_like(bcd[..., :1]), bcd], dim=-1)
        return quat_to_rot(quat), trans


class StructureModule(nn.Module):
    """``n_iter`` shared-weight iterations of IPA -> transition -> backbone
    update from identity frames; rotation gradients stop between iterations
    (the AF2 stabiliser).  Returns final frames, backbone ``xyz (B, L, 4, 3)``
    N/CA/C/CB, the node stream and the frame trajectory (in angstroms)."""

    def __init__(self, cfg: IPAConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        D, dt = cfg.node_dim, cfg.dtype
        self.ipa = InvariantPointAttention(cfg, device)
        self.ln_ipa = LayerNorm(D, dt, device)
        self.transition_in = Dense(D, 2 * D, dt, device)
        self.transition_out = Dense(2 * D, D, dt, device)
        self.ln_transition = LayerNorm(D, dt, device)
        self.backbone_update = BackboneUpdate(D, device)
        self.ln_in = LayerNorm(D, dt, device)
        self.ln_pair = LayerNorm(cfg.pair_dim, dt, device)

    def forward(self, node, pair, mask):
        cfg = self.cfg
        B, L = node.shape[:2]
        scale = cfg.position_scale
        r = torch.eye(3, device=node.device).expand(B, L, 3, 3)
        t = torch.zeros((B, L, 3), device=node.device)
        node = self.ln_in(node)
        pair = self.ln_pair(pair)
        traj_r, traj_t = [], []
        for it in range(cfg.n_iter):
            node = self.ln_ipa(node + self.ipa(node, pair, (r, t), mask))
            node = self.ln_transition(node + self.transition_out(gelu(self.transition_in(node))))
            dr, dt = self.backbone_update(node)
            r, t = frame_compose(r, t, dr, dt)
            traj_r.append(r)
            traj_t.append(t * scale)
            if it < cfg.n_iter - 1:
                r = r.detach()
        t = t * scale
        return {
            "frames": (r, t),
            "xyz": backbone_xyz_from_frames(r, t, include_cb=True),
            "node": node,
            "traj": (torch.stack(traj_r, 0), torch.stack(traj_t, 0)),
        }


class FoldModel(nn.Module):
    """TrFold trunk -> StructureModule -> coordinates, with recycling and
    confidence heads.  Parameters are created on ``device`` (default cuda,
    which raises without a card)."""

    def __init__(self, trunk_cfg: TrFoldConfig = TrFoldConfig(), ipa_cfg: IPAConfig = IPAConfig(),
                 n_recycle: int = 0, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.trunk_cfg, self.n_recycle = trunk_cfg, n_recycle
        self.ipa_cfg = dataclasses.replace(ipa_cfg, node_dim=trunk_cfg.node_dim,
                                           pair_dim=trunk_cfg.pair_dim)
        D, P, dt = trunk_cfg.node_dim, trunk_cfg.pair_dim, trunk_cfg.dtype
        self.trunk = TrFold(trunk_cfg, device)
        self.structure = StructureModule(self.ipa_cfg, device)
        if n_recycle > 0:
            self.recycle_node_ln = LayerNorm(D, dt, device)
            self.recycle_pair_ln = LayerNorm(P, dt, device)
            self.recycle_dist_embed = Dense(trunk_cfg.n_dist_bins, P, dt, device)
        self.plddt_head = Dense(self.ipa_cfg.node_dim, PLDDT_BINS, torch.float32, device)
        self.pae_head = Dense(P, PAE_BINS, torch.float32, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initializers, drawn from ``generator`` in module order."""
        for m in self.modules():
            if m is not self and m is not self.trunk and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def forward(self, feats: Dict[str, torch.Tensor],
                n_recycle: Optional[int] = None) -> Dict[str, torch.Tensor]:
        nr = self.n_recycle if n_recycle is None else n_recycle
        if nr > 0 and not hasattr(self, "recycle_dist_embed"):
            raise ValueError("this FoldModel was built with n_recycle=0 and has no recycle embedders")
        prev = None
        for _ in range(nr):  # earlier passes give no gradient
            with torch.no_grad():
                out = self._one_pass(feats, prev)
            prev = (out["node"].detach(), out["pair_repr"].detach(), out["xyz"].detach())
        return self._one_pass(feats, prev)

    def _one_pass(self, feats, prev):
        cfg = self.trunk_cfg
        mask = feats["residue_mask"]
        node, pair = self.trunk.embed(feats)
        if prev is not None:
            prev_node, prev_pair, prev_xyz = prev
            cb = prev_xyz[:, :, 3]
            diff = cb[:, :, None] - cb[:, None, :]
            bins = distogram_bins(torch.sqrt((diff * diff).sum(-1) + 1e-8),
                                  cfg.n_dist_bins, cfg.max_dist)
            onehot = F.one_hot(bins.long(), cfg.n_dist_bins).to(pair.dtype)
            pair = pair + self.recycle_dist_embed(onehot) + self.recycle_pair_ln(prev_pair)
            node = node + self.recycle_node_ln(prev_node)
        node, pair = self.trunk.run_blocks(node, pair, mask)
        out = self.trunk.heads(node, pair)
        out["moe_aux_loss"] = torch.zeros((), dtype=torch.float32, device=node.device)
        out["pair_repr"] = pair
        out.update(self.structure(node, pair, mask))
        out["plddt_logits"] = self.plddt_head(out["node"])
        out["pae_logits"] = self.pae_head(pair)
        return out


def plddt_from_logits(logits: torch.Tensor) -> torch.Tensor:
    """Per-residue predicted lDDT in [0, 100] from ``(..., 50)`` logits."""
    centers = (torch.arange(PLDDT_BINS, device=logits.device) + 0.5) / PLDDT_BINS
    return 100.0 * (torch.softmax(logits, -1) * centers).sum(-1)


def pae_from_logits(logits: torch.Tensor) -> torch.Tensor:
    """Expected aligned error (A) from ``(..., 64)`` logits."""
    centers = (torch.arange(PAE_BINS, device=logits.device) + 0.5) * (PAE_MAX / PAE_BINS)
    return (torch.softmax(logits, -1) * centers).sum(-1)


def _local(frames, points):
    """``r_i^T (x_j - t_i)``: every point in every frame, ``(B, Li, Lj, 3)``."""
    r, t = frames
    r_inv = r.transpose(-2, -1)
    rot = torch.einsum("bixy,bjy->bijx", r_inv, points)
    shift = torch.einsum("bixy,biy->bix", r_inv, t)
    return rot - shift[:, :, None]


def aligned_error(pred_frames, pred_ca, true_frames, true_ca) -> torch.Tensor:
    """Per-pair aligned error ``|T_i^-1 x_j - (T_i^true)^-1 x_j^true|`` ``(B, L, L)``."""
    d2 = ((_local(pred_frames, pred_ca) - _local(true_frames, true_ca)) ** 2).sum(-1)
    return torch.sqrt(d2 + 1e-8)


def confidence_losses(out, true_frames, true_ca, mask) -> torch.Tensor:
    """CE of the pLDDT and PAE heads against the model's own (detached)
    per-residue lDDT and per-pair aligned error."""
    pred_ca = out["xyz"][:, :, 1].detach()
    pred_frames = tuple(x.detach() for x in out["frames"])

    true_per_res = lddt(pred_ca, true_ca, mask=mask, per_residue=True)
    bins = torch.clamp((true_per_res * PLDDT_BINS).to(torch.int32), 0, PLDDT_BINS - 1)
    logp = torch.log_softmax(out["plddt_logits"], -1)
    ce = -torch.gather(logp, -1, bins[..., None].long())[..., 0]
    ce_plddt = torch.where(mask, ce, 0.0).sum() / torch.clamp_min(mask.sum(), 1.0)

    err = aligned_error(pred_frames, pred_ca, true_frames, true_ca)
    ebins = torch.clamp((err / (PAE_MAX / PAE_BINS)).to(torch.int32), 0, PAE_BINS - 1)
    logp = torch.log_softmax(out["pae_logits"], -1)
    ce = -torch.gather(logp, -1, ebins[..., None].long())[..., 0]
    pm = mask[:, :, None] & mask[:, None, :]
    ce_pae = torch.where(pm, ce, 0.0).sum() / torch.clamp_min(pm.sum(), 1.0)
    return ce_plddt + ce_pae


def fape_loss(pred_frames, pred_xyz, true_frames, true_xyz, mask, clamp: float = 10.0,
              eps: float = 1e-8, unclamped_frac: float = 0.1) -> torch.Tensor:
    """Frame-aligned point error (AF2 eq. 28): every atom of ``(B, L, A, 3)``
    in every residue's frame, clamped at ``clamp`` with an ``unclamped_frac``
    share unclamped, masked by ``mask (B, L)`` on both axes."""
    B, L, A, _ = pred_xyz.shape
    lp = _local(pred_frames, pred_xyz.reshape(B, L * A, 3))
    lt = _local(true_frames, true_xyz.reshape(B, L * A, 3))
    d2 = ((lp - lt) ** 2).sum(-1)
    big = d2 > eps  # double where: the gradient of sqrt at 0 is infinite
    d = torch.where(big, torch.sqrt(torch.where(big, d2, 1.0)), 0.0)
    d_cl = torch.clamp_max(d, clamp) / clamp
    if unclamped_frac > 0.0:
        d_cl = (1.0 - unclamped_frac) * d_cl + unclamped_frac * (d / clamp)
    atom_mask = mask.repeat_interleave(A, dim=1)
    w = (mask[:, :, None] & atom_mask[:, None, :]).to(d_cl.dtype)
    return (d_cl * w).sum() / torch.clamp_min(w.sum(), 1.0)


def _trunk_losses(out, feats, cfg) -> torch.Tensor:
    """Distogram CE + torsion sin/cos MSE (+ the MoE term) on ``out``."""
    if "d_cb_bins" in feats:
        target_bins = feats["d_cb_bins"]
    else:
        target_bins = distogram_bins(feats["d_cb"], cfg.n_dist_bins, cfg.max_dist)
    logp = torch.log_softmax(out["distogram_logits"], dim=-1)
    ce = -torch.gather(logp, -1, target_bins[..., None].long())[..., 0]
    pm = feats["pair_mask"]
    ce = torch.where(pm, ce, 0.0).sum() / torch.clamp_min(pm.sum(), 1.0)
    tors = feats["torsions"]
    target_sc = torch.stack([torch.sin(tors), torch.cos(tors)], dim=-1)
    tm = feats["torsion_mask"][..., None]
    mse = torch.where(tm, (out["torsion_sincos"] - target_sc) ** 2, 0.0).sum()
    mse = mse / torch.clamp_min(tm.sum(), 1.0)
    return ce + mse + cfg.moe_aux_weight * out["moe_aux_loss"]


def fold_loss_fn(params, model: FoldModel, feats: Dict[str, torch.Tensor],
                 batch_xyz: torch.Tensor, fape_weight: float = 1.0,
                 target_feats: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """Trunk losses + trajectory-averaged backbone FAPE + 0.01 x confidence CE.

    ``params`` are the model's own parameters (read through the module);
    ``batch_xyz (B, L, A>=3, 3)`` is the ground truth, NaN at missing atoms
    (residues missing a backbone atom leave the FAPE mask);
    ``target_feats`` supervise the trunk heads when ``feats`` are not the
    native structure's (sequence-only training).
    """
    _check_params(params, model)
    out = model(feats)
    trunk_loss = _trunk_losses(out, feats if target_feats is None else target_feats,
                               model.trunk_cfg)

    bb = batch_xyz[:, :, :3]
    bb_ok = torch.isfinite(bb).all(-1).all(-1) & feats["residue_mask"]
    bb = torch.nan_to_num(bb, nan=0.0)
    true_r, true_t = frames_from_backbone(bb)
    eye = torch.eye(3, dtype=true_r.dtype, device=true_r.device)
    true_r = torch.where(bb_ok[..., None, None], true_r, eye)
    true_t = torch.where(bb_ok[..., None], true_t, 0.0)

    traj_r, traj_t = out["traj"]
    fape = torch.stack([
        fape_loss((r_i, t_i), backbone_xyz_from_frames(r_i, t_i, include_cb=False),
                  (true_r, true_t), bb, bb_ok)
        for r_i, t_i in zip(traj_r, traj_t)]).mean()

    conf = confidence_losses(out, (true_r, true_t), bb[:, :, 1], bb_ok)
    return trunk_loss + fape_weight * fape + 0.01 * conf

