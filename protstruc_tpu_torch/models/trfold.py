"""TrFold on PyTorch: port of ``protstruc_tpu/models/trfold.py``.

A trRosetta-style pair-representation model: 6D inter-residue geometry and
backbone torsions in, a distogram over CB-CB distances plus torsion and
inter-residue angle heads out.  The train step goes through the same entry
points as the JAX package's::

    feats = featurize_for_model(batch)                       # dict of tensors
    model = TrFold(TrFoldConfig(...), device="cuda")
    params, opt_state, tx = make_train_state(model, feats, torch.Generator().manual_seed(0))
    params, opt_state, loss = train_step(params, opt_state, feats, model, tx)

The modules keep the flax parameter tree: attribute names are flax's module
names (``block_0.tri_out.a_gate.kernel``, the auto-named ``LayerNorm_0``),
leaves keep flax's shapes and float32 storage, and the layers compute what
flax's do (``models/_nn.py``).  ``convert.trfold_params_from_flax`` carries a
JAX checkpoint across.

With ``fused_tri=True`` each triangle update runs through the K4-K7 kernels
(``ops/tri_mul.py``) on CUDA tensors, and through their plain versions on CPU
tensors; the unfused module computes the same update from the same params in
plain PyTorch.  ``remat=True`` checkpoints each block
(``torch.utils.checkpoint``, non-reentrant).

Not ported yet (constructing a model that needs them raises
``NotImplementedError``): ``remat_policy`` other than ``"none"``, MoE blocks,
flash and ring attention, the fused ``featurize_for_model(fused=True)``
(kernel K3), chi features, ``DiffusionDenoiser``, ``predict_structure``,
``pipeline_apply`` and the sharding rules.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from protstruc_tpu_torch.models._nn import Dense, Embed, LayerNorm, gelu, lecun_normal_
from protstruc_tpu_torch.ops.histogram import distogram_bins
from protstruc_tpu_torch.ops.tri_mul import fused_triangle_multiplication

__all__ = [
    "TrFoldConfig",
    "TrFold",
    "make_train_state",
    "train_step",
    "loss_fn",
    "featurize_for_model",
    "featurize_from_sequence",
]


@dataclasses.dataclass(frozen=True)
class TrFoldConfig:
    """The JAX package's ``TrFoldConfig`` with a torch ``dtype`` (its fields
    and defaults; see the JAX class for what each option does)."""

    vocab: int = 21
    node_dim: int = 128
    pair_dim: int = 64
    n_heads: int = 4
    n_blocks: int = 3
    n_dist_bins: int = 36
    max_dist: float = 20.0
    relpos_clip: int = 32
    dtype: torch.dtype = torch.float32
    moe_experts: int = 0
    moe_aux_weight: float = 1e-2
    pair_pre_norm: bool = True
    remat: bool = False
    remat_policy: str = "none"
    pair_update: str = "gated_mix"
    fused_tri: bool = False
    use_flash_attn: bool = False
    ring_mesh: Any = None


def _check_ported(cfg: TrFoldConfig) -> None:
    """Raise for the options whose code is not ported yet."""
    if cfg.remat_policy in ("tri_dots", "dots"):
        raise NotImplementedError(f"remat_policy={cfg.remat_policy!r} is not yet ported")
    if cfg.remat_policy != "none":
        raise ValueError(f"remat_policy must be 'none', 'tri_dots' or 'dots', got {cfg.remat_policy!r}")
    if cfg.moe_experts > 0:
        raise NotImplementedError("MoE blocks (moe_experts > 0) are not yet ported")
    if cfg.use_flash_attn:
        raise NotImplementedError("flash attention (use_flash_attn=True) is not yet ported")
    if cfg.ring_mesh is not None:
        raise NotImplementedError("ring attention (ring_mesh) is not yet ported")
    if cfg.pair_update not in ("gated_mix", "triangle"):
        raise ValueError(f"pair_update must be 'gated_mix' or 'triangle', got {cfg.pair_update!r}")


# ---------------------------------------------------------------------------
# featurization
# ---------------------------------------------------------------------------


def featurize_for_model(batch, use_kernel: bool = False, fused: bool = False,
                        n_dist_bins: int = 36, max_dist: float = 20.0,
                        ang_dtype: torch.dtype = torch.bfloat16,
                        include_chi: bool = False) -> Dict[str, torch.Tensor]:
    """StructureBatch -> model inputs (seq_idx, torsions, pair maps, masks).

    The torsion mask is tightened to finite torsions and NaN torsions become
    0, as in the JAX package.  ``use_kernel`` is the JAX ``use_pallas``: True
    takes the K1 pair-map kernel on a CUDA batch (its plain version on a CPU
    batch), False (the default, as in JAX) the arccos-form path.
    ``fused=True`` (kernel K3) and ``include_chi`` are not ported yet.
    """
    if fused:
        raise NotImplementedError(
            "featurize_for_model(fused=True) (the K3 model-feature kernel) is not yet ported")
    if include_chi:
        raise NotImplementedError("featurize_for_model(include_chi=True) is not yet ported")
    torsions, torsion_mask = batch.backbone_dihedrals()
    torsion_mask = torsion_mask & torch.isfinite(torsions)
    torsions = torch.nan_to_num(torsions, nan=0.0)
    if batch.seq is not None:
        seq_idx = batch.get_seq_idx()
    else:
        seq_idx = torch.zeros(batch.chain_idx.shape, dtype=torch.int32, device=batch.device)
    g = batch.inter_residue_geometry(use_kernel=use_kernel)
    return {
        "seq_idx": seq_idx,
        "torsions": torsions,
        "torsion_mask": torsion_mask,
        "residue_mask": batch.residue_mask,
        "chain_idx": batch.chain_idx,
        "d_cb": g["d_cb"],
        "omega": g["omega"],
        "theta": g["theta"],
        "phi": g["phi"],
        "pair_mask": g["d_cb_mask"] & torch.isfinite(g["d_cb"]),
    }


def featurize_from_sequence(seq_idx, chain_idx=None, n_dist_bins: int = 36,
                            device=None) -> Dict[str, torch.Tensor]:
    """Sequence-only model inputs: zero torsions under an all-False mask, the
    distogram's last bin everywhere and an all-False pair mask, so the trunk
    sees sequence and relative position only."""
    seq_idx = torch.as_tensor(seq_idx, dtype=torch.int32, device=device)
    dev = seq_idx.device
    B, L = seq_idx.shape
    if chain_idx is None:
        chain_idx = torch.zeros((B, L), dtype=torch.int32, device=dev)
    return {
        "seq_idx": seq_idx,
        "torsions": torch.zeros((B, L, 3), device=dev),
        "torsion_mask": torch.zeros((B, L, 3), dtype=torch.bool, device=dev),
        "residue_mask": torch.ones((B, L), dtype=torch.bool, device=dev),
        "chain_idx": torch.as_tensor(chain_idx, dtype=torch.int32, device=dev),
        "d_cb_bins": torch.full((B, L, L), n_dist_bins - 1, dtype=torch.int32, device=dev),
        "ang_sincos": torch.zeros((B, L, L, 6), device=dev),
        "pair_mask": torch.zeros((B, L, L), dtype=torch.bool, device=dev),
    }


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


class PairBiasAttention(nn.Module):
    """Multi-head node self-attention with an additive pair-derived bias
    (the JAX module's einsum path)."""

    def __init__(self, cfg: TrFoldConfig, device=None):
        super().__init__()
        self.cfg = cfg
        h, dh = cfg.n_heads, cfg.node_dim // cfg.n_heads
        self.qkv = Dense(cfg.node_dim, (3, h, dh), cfg.dtype, device)
        self.pair_bias = Dense(cfg.pair_dim, h, cfg.dtype, device)
        self.out = Dense((h, dh), cfg.node_dim, cfg.dtype, device)

    def forward(self, node, pair, mask):
        dt = self.cfg.dtype
        dh = self.cfg.node_dim // self.cfg.n_heads
        qkv = self.qkv(node)
        q, k, v = qkv[..., 0, :, :], qkv[..., 1, :, :], qkv[..., 2, :, :]
        bias = self.pair_bias(pair).permute(0, 3, 1, 2)  # (B, h, L, L)
        scale = torch.tensor(math.sqrt(dh), dtype=dt, device=node.device)
        logits = torch.einsum("blhd,bmhd->bhlm", q, k) / scale + bias
        allowed = mask[:, None, None, :]
        neg = torch.tensor(-1e9, dtype=dt, device=node.device)
        attn = torch.softmax(torch.where(allowed, logits, neg), dim=-1)
        # a row with no allowed key would softmax to uniform weights over the
        # -1e9 logits and leak every value in: zero it
        attn = torch.where(allowed, attn, torch.zeros((), dtype=dt, device=node.device))
        return self.out(torch.einsum("bhlm,bmhd->blhd", attn, v))


class _SplitDense(nn.Module):
    """Dense over ``concat([a, b], -1)`` without building it:
    ``a @ K[:Ca] + b @ K[Ca:] + bias``, one ``(Ca + Cb, F)`` kernel."""

    def __init__(self, ca: int, cb: int, features: int, dtype, device=None):
        super().__init__()
        self.ca, self.dtype = ca, dtype
        self.kernel = nn.Parameter(torch.empty((ca + cb, features), device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def reset_parameters(self, gen: torch.Generator) -> None:
        lecun_normal_(self.kernel, gen, self.kernel.shape[0])
        nn.init.zeros_(self.bias)

    def forward(self, a, b):
        dt = self.dtype
        k = self.kernel.to(dt)
        return a.to(dt) @ k[:self.ca] + b.to(dt) @ k[self.ca:] + self.bias.to(dt)


class PairUpdate(nn.Module):
    """Outer-product node -> pair update plus gated row/column mixing."""

    def __init__(self, cfg: TrFoldConfig, device=None):
        super().__init__()
        self.cfg = cfg
        D, P, dt = cfg.node_dim, cfg.pair_dim, cfg.dtype
        self.outer_a = Dense(D, P, dt, device)
        self.outer_b = Dense(D, P, dt, device)
        self.LayerNorm_0 = LayerNorm(P, dt, device)  # pre-norm input, or post-norm output
        self.gate_row = Dense(P, P, dt, device)
        self.gate_col = Dense(P, P, dt, device)
        self.mix = _SplitDense(P, P, P, dt, device)

    def forward(self, node, pair, mask):
        cfg, dt = self.cfg, self.cfg.dtype
        a, b = self.outer_a(node), self.outer_b(node)
        pair = pair + a[:, :, None, :] * b[:, None, :, :]
        src = self.LayerNorm_0(pair) if cfg.pair_pre_norm else pair
        g_row = torch.sigmoid(self.gate_row(src))
        g_col = torch.sigmoid(self.gate_col(src))
        m = mask.to(dt)
        pm = src * (m[:, :, None, None] * m[:, None, :, None])
        denom = torch.clamp_min(m.sum(1), 1.0)[:, None, None, None]
        row_ctx = torch.einsum("bikc,bkjc->bijc", g_row * pm, pm) / denom
        col_ctx = torch.einsum("bkic,bkjc->bijc", g_col * pm, pm) / denom
        mix = self.mix(row_ctx, col_ctx)
        if cfg.pair_pre_norm:
            return pair + mix
        return self.LayerNorm_0(pair + mix)


_TRI_DENSE = ("a_gate", "a_proj", "b_gate", "b_proj", "out_gate", "out_proj")


class TriangleMultiplication(nn.Module):
    """AF2 triangle multiplicative update (Algorithms 11/12), outgoing
    (``sum_k a_ik b_jk``) or incoming (``sum_k a_ki b_kj``).

    One param tree, two paths: ``cfg.fused_tri`` runs the K4-K7 kernels
    through ``fused_triangle_multiplication`` with the params cast to the
    compute dtype outside the autograd functions (where flax casts them); the
    unfused path is flax's LayerNorm and Dense layers in plain PyTorch.
    """

    def __init__(self, cfg: TrFoldConfig, outgoing: bool = True, device=None):
        super().__init__()
        self.cfg, self.outgoing = cfg, outgoing
        C, dt = cfg.pair_dim, cfg.dtype
        self.ln_in = LayerNorm(C, dt, device)
        self.ln_out = LayerNorm(C, dt, device)
        for name in _TRI_DENSE:
            setattr(self, name, Dense(C, C, dt, device))

    def forward(self, pair, mask):
        dt = self.cfg.dtype
        if self.cfg.fused_tri:
            params = {n: (getattr(self, n).scale.to(dt), getattr(self, n).bias.to(dt))
                      for n in ("ln_in", "ln_out")}
            params.update({n: (getattr(self, n).kernel.to(dt), getattr(self, n).bias.to(dt))
                           for n in _TRI_DENSE})
            return fused_triangle_multiplication(pair.to(dt), mask, params, self.outgoing)
        src = self.ln_in(pair)
        m = (mask[:, :, None] & mask[:, None, :]).to(dt)[..., None]
        a = torch.sigmoid(self.a_gate(src)) * self.a_proj(src) * m
        b = torch.sigmoid(self.b_gate(src)) * self.b_proj(src) * m
        eq = "bikc,bjkc->bijc" if self.outgoing else "bkic,bkjc->bijc"
        prod = torch.einsum(eq, a, b)
        g = torch.sigmoid(self.out_gate(src))
        return g * self.out_proj(self.ln_out(prod))


class TrFoldBlock(nn.Module):
    """Attention + MLP on the node stream, then the pair update."""

    def __init__(self, cfg: TrFoldConfig, device=None):
        super().__init__()
        _check_ported(cfg)
        self.cfg = cfg
        D, P, dt = cfg.node_dim, cfg.pair_dim, cfg.dtype
        self.LayerNorm_0 = LayerNorm(D, dt, device)  # attention input
        self.attn = PairBiasAttention(cfg, device)
        self.LayerNorm_1 = LayerNorm(D, dt, device)  # MLP input
        self.mlp_in = Dense(D, 4 * D, dt, device)
        self.mlp_out = Dense(4 * D, D, dt, device)
        if cfg.pair_update == "triangle":
            self.outer_a = Dense(D, P, dt, device)
            self.outer_b = Dense(D, P, dt, device)
            self.tri_out = TriangleMultiplication(cfg, True, device)
            self.tri_in = TriangleMultiplication(cfg, False, device)
        else:
            self.pair_update = PairUpdate(cfg, device)

    def forward(self, node, pair, mask):
        node = node + self.attn(self.LayerNorm_0(node), pair, mask)
        node = node + self.mlp_out(gelu(self.mlp_in(self.LayerNorm_1(node))))
        if self.cfg.pair_update == "triangle":
            a, b = self.outer_a(node), self.outer_b(node)
            pair = pair + a[:, :, None, :] * b[:, None, :, :]
            pair = pair + self.tri_out(pair, mask)
            pair = pair + self.tri_in(pair, mask)
        else:
            pair = self.pair_update(node, pair, mask)
        return node, pair


class TrFold(nn.Module):
    """6D geometry + sequence -> distogram logits + torsion and angle heads.

    Parameters are created on ``device`` (float32, flax's names and shapes);
    :func:`make_train_state` or :meth:`reset_parameters` initialises them from
    an explicit generator.
    """

    def __init__(self, cfg: TrFoldConfig = TrFoldConfig(), device=None):
        super().__init__()
        _check_ported(cfg)
        self.cfg = cfg
        D, P, dt = cfg.node_dim, cfg.pair_dim, cfg.dtype
        self.seq_embed = Embed(cfg.vocab, D, dt, device)
        self.torsion_embed = Dense(6, D, dt, device)
        self.dist_embed = Embed(cfg.n_dist_bins, P, dt, device)
        self.ang_embed = Dense(6, P, dt, device)
        self.relpos_embed = Embed(2 * cfg.relpos_clip + 2, P, dt, device)
        for i in range(cfg.n_blocks):
            self.add_module(f"block_{i}", TrFoldBlock(cfg, device))
        if cfg.pair_pre_norm:
            self.final_node_norm = LayerNorm(D, dt, device)
            self.final_pair_norm = LayerNorm(P, dt, device)
        f32 = torch.float32
        self.distogram_head = Dense(P, cfg.n_dist_bins, f32, device)
        self.torsion_head = Dense(D, 6, f32, device)
        self.omega_head = Dense(P, 2, f32, device)
        self.theta_head = Dense(P, 2, f32, device)
        self.phi_head = Dense(P, 2, f32, device)

    @property
    def blocks(self):
        return [getattr(self, f"block_{i}") for i in range(self.cfg.n_blocks)]

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initializers, drawn from ``generator`` in module order."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def embed(self, feats: Dict[str, torch.Tensor]):
        """Feature dict -> initial (node, pair) representations."""
        cfg, dt = self.cfg, self.cfg.dtype
        if "chi" in feats:
            raise NotImplementedError("chi features (include_chi=True) are not yet ported")
        node = self.seq_embed(feats["seq_idx"])
        tor = feats["torsions"]
        tor = torch.cat([torch.sin(tor), torch.cos(tor)], dim=-1)
        tm = feats["torsion_mask"]
        tor = torch.where(torch.cat([tm, tm], dim=-1), tor, 0.0).to(dt)
        node = node + self.torsion_embed(tor)

        if "d_cb_bins" in feats:
            bins = feats["d_cb_bins"]
            ang = feats["ang_sincos"].to(dt)
        else:
            bins = distogram_bins(feats["d_cb"], cfg.n_dist_bins, cfg.max_dist)
            ang = torch.stack([torch.sin(feats["omega"]), torch.cos(feats["omega"]),
                               torch.sin(feats["theta"]), torch.cos(feats["theta"]),
                               torch.sin(feats["phi"]), torch.cos(feats["phi"])], dim=-1)
            ang = torch.nan_to_num(ang, nan=0.0).to(dt)
        pair = self.dist_embed(bins)
        ang = torch.where(feats["pair_mask"][..., None], ang, torch.zeros((), dtype=dt, device=ang.device))
        pair = pair + self.ang_embed(ang)

        # clipped relative position, with a last class for cross-chain pairs
        L = feats["seq_idx"].shape[1]
        ar = torch.arange(L, device=pair.device)
        offset = ar[None, :, None] - ar[None, None, :]
        clipped = offset.clamp(-cfg.relpos_clip, cfg.relpos_clip) + cfg.relpos_clip
        if "chain_idx" in feats:
            ci = feats["chain_idx"]
            cross = ci[:, :, None] != ci[:, None, :]
            clipped = torch.where(cross, 2 * cfg.relpos_clip + 1, clipped)
        return node, pair + self.relpos_embed(clipped)

    def heads(self, node, pair):
        """Final (node, pair) -> prediction heads."""
        if self.cfg.pair_pre_norm:
            node = self.final_node_norm(node)
            pair = self.final_pair_norm(pair)
        pair_sym = pair + pair.transpose(1, 2)
        torsions = self.torsion_head(node)
        return {
            "distogram_logits": self.distogram_head(pair_sym),
            "torsion_sincos": torsions.reshape(torsions.shape[:-1] + (3, 2)),
            "omega_sincos": self.omega_head(pair_sym),
            "theta_sincos": self.theta_head(pair),
            "phi_sincos": self.phi_head(pair),
        }

    def forward(self, feats: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        mask = feats["residue_mask"]
        node, pair = self.embed(feats)
        for block in self.blocks:
            if self.cfg.remat and torch.is_grad_enabled():
                node, pair = checkpoint(block, node, pair, mask, use_reentrant=False)
            else:
                node, pair = block(node, pair, mask)
        out = self.heads(node, pair)
        out["moe_aux_loss"] = torch.zeros((), dtype=torch.float32, device=node.device)
        return out


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def _check_params(params: Dict[str, torch.Tensor], model: TrFold) -> None:
    own = dict(model.named_parameters())
    if params.keys() != own.keys() or any(params[k] is not own[k] for k in own):
        raise ValueError("params must be the model's own parameters (as make_train_state returns "
                         "them); load other weights with model.load_state_dict")


def loss_fn(params: Dict[str, torch.Tensor], model: TrFold,
            feats: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Masked distogram cross-entropy + torsion sin/cos MSE + the three
    inter-residue angle MSEs (targets from the featurization itself).

    ``params`` are the model's own parameters; the forward reads them through
    the module.
    """
    _check_params(params, model)
    out = model(feats)
    cfg = model.cfg
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

    pair_loss = 0.0
    for i, key in enumerate(("omega", "theta", "phi")):
        if "ang_sincos" in feats:
            sc = feats["ang_sincos"][..., 2 * i:2 * i + 2].float()
            # invalid entries were emitted as (0, 0); valid ones are unit
            ok = pm & ((sc ** 2).sum(-1) > 0.5)
        else:
            tgt = feats[key]
            ok = pm & torch.isfinite(tgt)
            t = torch.nan_to_num(tgt, nan=0.0)
            sc = torch.stack([torch.sin(t), torch.cos(t)], dim=-1)
        err = torch.where(ok[..., None], (out[f"{key}_sincos"] - sc) ** 2, 0.0)
        pair_loss = pair_loss + err.sum() / torch.clamp_min(ok.sum(), 1.0)
    return ce + mse + pair_loss + cfg.moe_aux_weight * out["moe_aux_loss"]


def make_train_state(model: TrFold, feats: Dict[str, torch.Tensor], generator: torch.Generator,
                     learning_rate: float = 1e-3
                     ) -> Tuple[Dict[str, torch.Tensor], dict, torch.optim.AdamW]:
    """Initialise ``model`` from ``generator`` and build its optimizer.

    Returns ``(params, opt_state, tx)``: the model's parameters by flax path
    (``block_0.attn.qkv.kernel``), the optimizer's state, and
    ``torch.optim.AdamW`` with optax ``adamw``'s defaults (betas (0.9,
    0.999), eps 1e-8, weight decay 1e-4; torch's default decay is 1e-2).
    ``feats`` is taken for the JAX signature; the shapes come from the config.
    """
    if "chi" in feats:
        raise NotImplementedError("chi features (include_chi=True) are not yet ported")
    model.reset_parameters(generator)
    params = dict(model.named_parameters())
    tx = torch.optim.AdamW(params.values(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                           weight_decay=1e-4)
    return params, tx.state, tx


def train_step(params, opt_state, feats, model: TrFold, tx: torch.optim.Optimizer):
    """One optimizer step: the loss, its gradients, an AdamW update.

    The update is in place (the parameters and the optimizer state are the
    ones passed in, and are returned for the JAX signature).  The loss comes
    back as a detached 0-dim tensor, without a host synchronisation.
    """
    tx.zero_grad(set_to_none=True)
    loss = loss_fn(params, model, feats)
    loss.backward()
    tx.step()
    return params, opt_state, loss.detach()
