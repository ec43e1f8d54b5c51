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
(``torch.utils.checkpoint``, non-reentrant): ``remat_policy="none"`` saves
nothing of the block, ``"tri_dots"`` saves the two triangle contractions
(selective checkpointing: the ``bmm`` issued inside ``ops.tri_mul.tri_prod``,
the JAX package's ``checkpoint_name("tri_prod")``), ``"dots"`` saves every
product without batch dims (``mm``: the Dense layers; JAX's
``dots_with_no_batch_dims_saveable``).  Values and the parameter tree are the
same under every policy.

``moe_experts > 0`` replaces each block's MLP by a top-1 routed
mixture of experts (``models/moe.py``) whose load-balancing loss the forward
sums into ``moe_aux_loss``.  :func:`pipeline_apply` runs the blocks as GPipe
stages over a ``pp`` process group (``parallel/pipeline.py``).

``use_flash_attn=True`` runs the node attention through the K8/K9 kernels
(``ops/flash_attn.py``), and ``featurize_for_model(fused=True)`` the
featurization through K3 (``ops/model_features.py``).

Model parallelism (``TrFold(cfg, mesh=...)``, ``mesh`` a ``(dp, sp, tp)``
``DeviceMesh`` of ``parallel/mesh.make_mesh``) follows the JAX package's
sharding rules, :func:`param_shardings` and :func:`feats_shardings`: each
rank holds its ``B / dp`` structures and ``L / sp`` residue rows of every
feature (``parallel.mesh.shard_feats``), the node stream ``(B, L/sp, D)`` and
the pair rows ``(B, L/sp, L, P)``, and its ``1 / tp`` of the attention heads
and the MLP hidden dim, whose kernels it stores as its chunk (``_nn.Dense``
``split``).  GSPMD's collectives are written out (``parallel/collectives.py``):

* attention: Megatron's ``copy_to``/``reduce_from`` around the local heads,
  the pair bias computed for every head and split (its cotangent gathered);
  under sp the keys and values all-gathered, or with ``use_flash_attn`` the
  ring over sp on K8/K9's lse entry point (``ops/ring_attn.py``;
  ``cfg.ring_mesh`` is set to the mesh then, as JAX's trainer sets it);
* the outer product and the outgoing triangle gather the ``b`` side over sp;
  the incoming triangle and the gated mix's column context take the
  partial sum over the local rows k and reduce-scatter it over i; the gated
  mix's row context gathers ``pm`` and its denominator counts the whole
  mask; K4-K7 run on the local rows (``fused_triangle_multiplication`` with
  a row and a column mask);
* the heads' ``pair + pairᵀ`` is an all-to-all of the column blocks;
* relative positions are taken from global row indices.

A sharded model computes what the unsharded one computes; the losses
(``loss_fn``, ``models/ipa.fold_loss_fn``) are each rank's share of the
global loss, with counts summed over the dp x sp ranks.

``featurize_for_model(include_chi=True)`` adds the sidechain chi angles,
embedded by ``chi_embed``, which ``TrFold(chi=True)`` builds (flax
creates it at init from such features).  ``DiffusionDenoiser`` is the
epsilon-prediction model over noisy CA coordinates, and
``predict_structure`` decodes the heads to a backbone
(distogram expectation, ``ops/reconstruct.py``, ``ops/idealize.py``).

"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from protstruc_tpu_torch.batch import resolve_device
from protstruc_tpu_torch.models._nn import Dense, Embed, LayerNorm, gelu, lecun_normal_
from protstruc_tpu_torch.ops.flash_attn import flash_pair_bias_attention
from protstruc_tpu_torch.ops.histogram import distogram_bins
from protstruc_tpu_torch.ops.model_features import model_inputs
from protstruc_tpu_torch.ops.tri_mul import fused_triangle_multiplication, in_tri_prod, tri_prod
from protstruc_tpu_torch.parallel.collectives import (all_gather, all_to_all, copy_to,
                                                      reduce_scatter, split_to)
from protstruc_tpu_torch.parallel.mesh import UNSHARDED
from protstruc_tpu_torch.parallel.zero import mean_denominator

__all__ = [
    "TrFoldConfig",
    "TrFold",
    "make_train_state",
    "adamw",
    "train_step",
    "loss_fn",
    "featurize_for_model",
    "featurize_from_sequence",
    "DiffusionDenoiser",
    "predict_structure",
    "pipeline_apply",
    "param_shardings",
    "feats_shardings",
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
    """Raise for options that do not exist."""
    if cfg.remat_policy not in _REMAT_POLICIES:
        raise ValueError(f"remat_policy must be 'none', 'tri_dots' or 'dots', got {cfg.remat_policy!r}")
    if cfg.pair_update not in ("gated_mix", "triangle"):
        raise ValueError(f"pair_update must be 'gated_mix' or 'triangle', got {cfg.pair_update!r}")


def _with_mesh(cfg: TrFoldConfig, mesh):
    """``(cfg, shard)`` of a model over ``mesh`` (``cfg.ring_mesh`` names it
    too): ``cfg.ring_mesh`` is the mesh when flash attention meets sp > 1
    (JAX's train.py:424-427) and None otherwise; ``shard`` is this rank's
    ``parallel.mesh.ModelShard``, None without a mesh."""
    if cfg.ring_mesh is not None:
        if mesh is not None and mesh is not cfg.ring_mesh:
            raise ValueError("cfg.ring_mesh and mesh name different meshes")
        mesh = cfg.ring_mesh
    if mesh is None:
        return cfg, None
    from protstruc_tpu_torch.parallel.mesh import model_shard

    shard = model_shard(mesh)
    tp = shard.tp[1]
    for what, n in (("n_heads", cfg.n_heads), ("the MLP hidden dim 4 * node_dim", 4 * cfg.node_dim)):
        if n % tp:
            raise ValueError(f"{what} = {n} does not split over tp={tp}")
    ring = mesh if cfg.use_flash_attn and shard.sp[1] > 1 else None
    return dataclasses.replace(cfg, ring_mesh=ring), shard


def gather_rows(x: torch.Tensor, shard) -> torch.Tensor:
    """``x`` ``(B, L/sp, ...)`` all-gathered over sp along the residue axis
    (``x`` itself without a shard); differentiable (reduce-scatter back)."""
    group = (shard or UNSHARDED).sp_group
    if group is not None and x.dtype == torch.bool:
        return all_gather(x.to(torch.uint8), 1, group).bool()
    return all_gather(x, 1, group)


def scatter_rows(x: torch.Tensor, shard) -> torch.Tensor:
    """``x`` ``(B, L, ...)``, a rank's partial sum over its rows k, summed
    over sp with this rank's block of the residue axis kept (``x`` itself
    without a shard); differentiable (all-gather back)."""
    return reduce_scatter(x, 1, (shard or UNSHARDED).sp_group)


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
    ``fused=True`` is the training ingest's path: the K3 kernel
    (``ops/model_features.py``; its plain version on a CPU batch) emits
    ``d_cb_bins`` and ``ang_sincos (B, L, L, 6)`` in ``ang_dtype`` in place of
    the raw maps.  ``include_chi`` adds ``chi (B, L, 4)`` and ``chi_mask``
    (``StructureBatch.chi_angles``) as node-level torsion features.
    """
    torsions, torsion_mask = batch.backbone_dihedrals()
    torsion_mask = torsion_mask & torch.isfinite(torsions)
    torsions = torch.nan_to_num(torsions, nan=0.0)
    if batch.seq is not None:
        seq_idx = batch.get_seq_idx()
    else:
        seq_idx = torch.zeros(batch.chain_idx.shape, dtype=torch.int32, device=batch.device)
    common = {
        "seq_idx": seq_idx,
        "torsions": torsions,
        "torsion_mask": torsion_mask,
        "residue_mask": batch.residue_mask,
        "chain_idx": batch.chain_idx,
    }
    if include_chi:
        common["chi"], common["chi_mask"] = batch.chi_angles()
    if fused:
        return {**common, **model_inputs(batch.xyz, batch.atom_mask, n_dist_bins, max_dist,
                                         ang_dtype)}
    g = batch.inter_residue_geometry(use_kernel=use_kernel)
    return {
        **common,
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
    sees sequence and relative position only.

    ``device`` defaults to ``seq_idx``'s own for a tensor and to ``"cuda"``
    for anything else (numpy, lists)."""
    if device is None:
        device = seq_idx.device if isinstance(seq_idx, torch.Tensor) else "cuda"
    seq_idx = torch.as_tensor(seq_idx, dtype=torch.int32, device=resolve_device(device))
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


def _sincos(ang, mask, dt):
    """``[sin, cos]`` of the angles, masked by the mask doubled in the same
    (concatenated, not interleaved) layout, cast to ``dt``."""
    sc = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    return torch.where(torch.cat([mask, mask], dim=-1), sc, 0.0).to(dt)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


class PairBiasAttention(nn.Module):
    """Multi-head node self-attention with an additive pair-derived bias.

    ``cfg.use_flash_attn`` takes the K8/K9 flash kernels
    (``ops/flash_attn.py``; their plain versions on CPU tensors), reading q,
    k, v as views of the ``qkv`` projection and the bias as the permuted view
    of the pair-bias Dense output, with no copy; otherwise the einsum path.
    Both give zeros on a query row with no allowed key.

    ``extra_mask`` (optional ``(B, L, L)`` bool, True = attend) composes with
    the key mask: the AR InverseFold decoder's causal decoding-order mask.
    ``kv`` (optional) is a separate key/value stream through the same
    ``qkv`` projection: queries from ``node``, keys and values from ``kv``.
    On the flash path the extra mask is folded into the bias as the einsum
    path's -1e9 (in float32, cast back to the bias dtype: a fresh dense
    ``(B, H, L, L)``) and the kernels run unchanged; rows whose every key is
    disallowed by ``extra_mask`` and the key mask are zeroed after the
    kernel, so their cotangent, and their ``ds``, ``dk`` and ``dv`` through
    K9, are exactly 0.

    Sharded (``shard``): ``node (B, L/sp, D)`` and ``pair (B, L/sp, L, P)``
    are this rank's rows, ``mask`` theirs and ``cols`` every key's ``(B,
    L)``; the rank runs its tp heads (``qkv`` and ``out`` split, the input
    through ``copy_to``) and returns its rows' output summed over tp.  The
    keys and values are all-gathered over sp, or with flash attention and
    ``cfg.ring_mesh`` go round the sp ring.  Without a shard every
    collective is the identity.
    """

    def __init__(self, cfg: TrFoldConfig, device="cuda", shard=None):
        super().__init__()
        self.cfg, self.shard = cfg, shard
        h, dh = cfg.n_heads, cfg.node_dim // cfg.n_heads
        tp = (shard or UNSHARDED).tp_group
        self.qkv = Dense(cfg.node_dim, (3, h, dh), cfg.dtype, device, split=(2, tp))
        self.pair_bias = Dense(cfg.pair_dim, h, cfg.dtype, device)
        self.out = Dense((h, dh), cfg.node_dim, cfg.dtype, device, split=(0, tp))

    def forward(self, node, pair, mask, extra_mask=None, kv=None, cols=None):
        if self.shard is not None and (extra_mask is not None or kv is not None):
            raise ValueError("a sharded PairBiasAttention takes no extra_mask or kv")
        sh, dt = self.shard or UNSHARDED, self.cfg.dtype
        dh = self.cfg.node_dim // self.cfg.n_heads
        qkv = self.qkv(copy_to(node, sh.tp_group))
        q = qkv[..., 0, :, :]
        kv3 = qkv if kv is None else self.qkv(kv)  # same projection, second stream
        k, v = kv3[..., 1, :, :], kv3[..., 2, :, :]
        # every head's bias, this rank's heads kept: the cotangent of the
        # others comes back by an all-gather of (B, L/sp, L, h) instead of an
        # all-reduce of the (B, L/sp, L, P) pair
        bias = split_to(self.pair_bias(pair), 3, sh.tp_group).permute(0, 3, 1, 2)  # (B, h, L, L)
        if self.cfg.use_flash_attn:
            if self.cfg.ring_mesh is not None:
                from protstruc_tpu_torch.ops.ring_attn import ring_pair_bias_attention

                return self.out(ring_pair_bias_attention(q, k, v, bias, mask, group=sh.sp_group))
            if extra_mask is None:
                return self.out(flash_pair_bias_attention(q, k, v, bias, mask))
            fbias = (bias.float() + torch.where(extra_mask[:, None], 0.0, -1e9)).to(bias.dtype)
            out = flash_pair_bias_attention(q, k, v, fbias, mask)
            row_ok = (extra_mask & mask[:, None, :]).any(-1)
            return self.out(torch.where(row_ok[:, :, None, None], out, 0.0))
        k, v = all_gather(k, 1, sh.sp_group), all_gather(v, 1, sh.sp_group)
        scale = torch.tensor(math.sqrt(dh), dtype=dt, device=node.device)
        logits = torch.einsum("blhd,bmhd->bhlm", q, k) / scale + bias
        allowed = (mask if cols is None else cols)[:, None, None, :]
        if extra_mask is not None:
            allowed = allowed & extra_mask[:, None]
        neg = torch.tensor(-1e9, dtype=dt, device=node.device)
        attn = torch.softmax(torch.where(allowed, logits, neg), dim=-1)
        # a row with no allowed key would softmax to uniform weights over the
        # -1e9 logits and leak every value in: zero it
        attn = torch.where(allowed, attn, torch.zeros((), dtype=dt, device=node.device))
        return self.out(torch.einsum("bhlm,bmhd->blhd", attn, v))


class _SplitDense(nn.Module):
    """Dense over ``concat([a, b], -1)`` without building it:
    ``a @ K[:Ca] + b @ K[Ca:] + bias``, one ``(Ca + Cb, F)`` kernel."""

    def __init__(self, ca: int, cb: int, features: int, dtype, device="cuda"):
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
    """Outer-product node -> pair update plus gated row/column mixing.

    Sharded over sp (``shard``, rows i local): the outer product gathers
    ``b``; the row context ``sum_k (g pm)_ik pm_kj`` gathers ``pm``; the
    column context ``sum_k (g pm)_ki pm_kj`` takes the local rows k for every
    (i, j) and reduce-scatters over i; the denominator counts every column.
    """

    def __init__(self, cfg: TrFoldConfig, device="cuda", shard=None):
        super().__init__()
        self.cfg, self.shard = cfg, shard
        D, P, dt = cfg.node_dim, cfg.pair_dim, cfg.dtype
        self.outer_a = Dense(D, P, dt, device)
        self.outer_b = Dense(D, P, dt, device)
        self.LayerNorm_0 = LayerNorm(P, dt, device)  # pre-norm input, or post-norm output
        self.gate_row = Dense(P, P, dt, device)
        self.gate_col = Dense(P, P, dt, device)
        self.mix = _SplitDense(P, P, P, dt, device)

    def forward(self, node, pair, mask, cols=None):
        cfg, dt, sh = self.cfg, self.cfg.dtype, self.shard
        a, b = self.outer_a(node), self.outer_b(node)
        pair = pair + a[:, :, None, :] * gather_rows(b, sh)[:, None, :, :]
        src = self.LayerNorm_0(pair) if cfg.pair_pre_norm else pair
        g_row = torch.sigmoid(self.gate_row(src))
        g_col = torch.sigmoid(self.gate_col(src))
        m = mask.to(dt)
        mc = m if cols is None else cols.to(dt)
        pm = src * (m[:, :, None, None] * mc[:, None, :, None])
        denom = torch.clamp_min(mc.sum(1), 1.0)[:, None, None, None]
        row_ctx = torch.einsum("bikc,bkjc->bijc", g_row * pm, gather_rows(pm, sh)) / denom
        col_ctx = scatter_rows(torch.einsum("bkic,bkjc->bijc", g_col * pm, pm), sh) / denom
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

    def __init__(self, cfg: TrFoldConfig, outgoing: bool = True, device="cuda", shard=None):
        super().__init__()
        self.cfg, self.outgoing, self.shard = cfg, outgoing, shard
        C, dt = cfg.pair_dim, cfg.dtype
        self.ln_in = LayerNorm(C, dt, device)
        self.ln_out = LayerNorm(C, dt, device)
        for name in _TRI_DENSE:
            setattr(self, name, Dense(C, C, dt, device))

    def forward(self, pair, mask, cols=None):
        dt = self.cfg.dtype
        contract = functools.partial(_tri_contract, self.outgoing, self.shard)
        if self.cfg.fused_tri:
            params = {n: (getattr(self, n).scale.to(dt), getattr(self, n).bias.to(dt))
                      for n in ("ln_in", "ln_out")}
            params.update({n: (getattr(self, n).kernel.to(dt), getattr(self, n).bias.to(dt))
                           for n in _TRI_DENSE})
            return fused_triangle_multiplication(pair.to(dt), mask, params, self.outgoing,
                                                 col_mask=cols, contract=contract)
        src = self.ln_in(pair)
        m = (mask[:, :, None] & (mask if cols is None else cols)[:, None, :]).to(dt)[..., None]
        a = torch.sigmoid(self.a_gate(src)) * self.a_proj(src) * m
        b = torch.sigmoid(self.b_gate(src)) * self.b_proj(src) * m
        prod = contract(a, b)
        g = torch.sigmoid(self.out_gate(src))
        return g * self.out_proj(self.ln_out(prod))


def _tri_contract(outgoing: bool, shard, a, b):
    """The triangle contraction of this rank's rows (of every row without a
    shard): outgoing ``sum_k a_ik b_jk`` with ``b`` gathered over sp;
    incoming ``sum_k a_ki b_kj`` over the local rows k for every (i, j),
    reduce-scattered over i."""
    if outgoing:
        return tri_prod(a, gather_rows(b, shard), True)
    return scatter_rows(tri_prod(a, b, False), shard)


class TrFoldBlock(nn.Module):
    """Attention + MLP (or MoE) on the node stream, then the pair update;
    returns ``(node, pair, moe_aux)``.  ``cols``: the key mask ``(B, L)`` of
    a sharded block (``mask`` is its rows')."""

    def __init__(self, cfg: TrFoldConfig, device="cuda", shard=None):
        super().__init__()
        _check_ported(cfg)
        self.cfg, self.shard = cfg, shard
        D, P, dt = cfg.node_dim, cfg.pair_dim, cfg.dtype
        tp = (shard or UNSHARDED).tp_group
        self.LayerNorm_0 = LayerNorm(D, dt, device)  # attention input
        self.attn = PairBiasAttention(cfg, device, shard)
        self.LayerNorm_1 = LayerNorm(D, dt, device)  # MLP input
        if cfg.moe_experts > 0:
            from protstruc_tpu_torch.models.moe import MoEMLP

            self.moe = MoEMLP(D, cfg.moe_experts, 4 * D, device=device,
                              mesh=None if shard is None else shard.mesh)
        else:
            self.mlp_in = Dense(D, 4 * D, dt, device, split=(1, tp))
            self.mlp_out = Dense(4 * D, D, dt, device, split=(0, tp))
        if cfg.pair_update == "triangle":
            self.outer_a = Dense(D, P, dt, device)
            self.outer_b = Dense(D, P, dt, device)
            self.tri_out = TriangleMultiplication(cfg, True, device, shard)
            self.tri_in = TriangleMultiplication(cfg, False, device, shard)
        else:
            self.pair_update = PairUpdate(cfg, device, shard)

    def forward(self, node, pair, mask, cols=None):
        sh = self.shard
        node = node + self.attn(self.LayerNorm_0(node), pair, mask, cols=cols)
        mlp_in = self.LayerNorm_1(node)
        if self.cfg.moe_experts > 0:
            mlp, aux = self.moe(mlp_in, mask)
        else:
            mlp_in = copy_to(mlp_in, (sh or UNSHARDED).tp_group)
            mlp = self.mlp_out(gelu(self.mlp_in(mlp_in)))
            aux = torch.zeros((), dtype=torch.float32, device=node.device)
        node = node + mlp
        if self.cfg.pair_update == "triangle":
            a, b = self.outer_a(node), self.outer_b(node)
            pair = pair + a[:, :, None, :] * gather_rows(b, sh)[:, None, :, :]
            pair = pair + self.tri_out(pair, mask, cols)
            pair = pair + self.tri_in(pair, mask, cols)
        else:
            pair = self.pair_update(node, pair, mask, cols)
        return node, pair, aux


_CHI_NEEDS_FLAG = "chi features need TrFold(chi=True)"


class TrFold(nn.Module):
    """6D geometry + sequence -> distogram logits + torsion and angle heads.

    Parameters are created on ``device`` (float32, flax's names and shapes);
    :func:`make_train_state` or :meth:`reset_parameters` initialises them from
    an explicit generator.  ``chi=True`` adds ``chi_embed``, the embedding of
    the ``include_chi`` features.  ``mesh``: a ``(dp, sp, tp)`` mesh to
    shard over (module docstring); the model then takes this rank's block of
    the features (``parallel.mesh.shard_feats``) and returns its rows.
    """

    def __init__(self, cfg: TrFoldConfig = TrFoldConfig(), device="cuda", chi: bool = False,
                 mesh=None):
        super().__init__()
        _check_ported(cfg)
        device = resolve_device(device)
        cfg, self.shard = _with_mesh(cfg, mesh)
        self.cfg = cfg
        D, P, dt = cfg.node_dim, cfg.pair_dim, cfg.dtype
        self.seq_embed = Embed(cfg.vocab, D, dt, device)
        self.torsion_embed = Dense(6, D, dt, device)
        if chi:
            self.chi_embed = Dense(8, D, dt, device)
        self.dist_embed = Embed(cfg.n_dist_bins, P, dt, device)
        self.ang_embed = Dense(6, P, dt, device)
        self.relpos_embed = Embed(2 * cfg.relpos_clip + 2, P, dt, device)
        for i in range(cfg.n_blocks):
            self.add_module(f"block_{i}", TrFoldBlock(cfg, device, self.shard))
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
        node = self.seq_embed(feats["seq_idx"])
        node = node + self.torsion_embed(_sincos(feats["torsions"], feats["torsion_mask"], dt))
        if "chi" in feats:
            if not hasattr(self, "chi_embed"):
                raise ValueError(_CHI_NEEDS_FLAG)
            node = node + self.chi_embed(_sincos(feats["chi"], feats["chi_mask"], dt))

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

        # clipped relative position, with a last class for cross-chain pairs;
        # a sharded model's rows are global rows row0 .. row0 + L/sp
        L = feats["seq_idx"].shape[1]
        row0, _ = (self.shard or UNSHARDED).rows(L)
        rows = torch.arange(row0, row0 + L, device=pair.device)
        offset = rows[None, :, None] - torch.arange(pair.shape[2], device=pair.device)
        clipped = offset.clamp(-cfg.relpos_clip, cfg.relpos_clip) + cfg.relpos_clip
        if "chain_idx" in feats:
            ci = feats["chain_idx"]
            cross = ci[:, :, None] != gather_rows(ci, self.shard)[:, None, :]
            clipped = torch.where(cross, 2 * cfg.relpos_clip + 1, clipped)
        return node, pair + self.relpos_embed(clipped)

    def heads(self, node, pair):
        """Final (node, pair) -> prediction heads."""
        if self.cfg.pair_pre_norm:
            node = self.final_node_norm(node)
            pair = self.final_pair_norm(pair)
        # the rows of pairᵀ are the column blocks of every sp rank's rows
        sp = (self.shard or UNSHARDED).sp_group
        pair_sym = pair + all_to_all(pair, 2, 1, sp).transpose(1, 2)
        torsions = self.torsion_head(node)
        return {
            "distogram_logits": self.distogram_head(pair_sym),
            "torsion_sincos": torsions.reshape(torsions.shape[:-1] + (3, 2)),
            "omega_sincos": self.omega_head(pair_sym),
            "theta_sincos": self.theta_head(pair),
            "phi_sincos": self.phi_head(pair),
        }

    def key_mask(self, mask):
        """The key mask ``(B, L)``: ``mask``, the rows', gathered over sp
        (``mask`` itself for an unsharded model)."""
        return gather_rows(mask, self.shard)

    def run_blocks(self, node, pair, mask, cols=None):
        """The blocks in order, each checkpointed under ``cfg.remat`` while
        gradients are on; returns ``(node, pair, summed moe_aux)``.  ``cols``
        (:meth:`key_mask`) is gathered here when not given."""
        if cols is None:
            cols = self.key_mask(mask)
        aux = torch.zeros((), dtype=torch.float32, device=node.device)
        for block in self.blocks:
            node, pair, a = run_block(block, self.cfg, node, pair, mask, cols)
            aux = aux + a
        return node, pair, aux

    def forward(self, feats: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        mask = feats["residue_mask"]
        node, pair, aux = self.run_blocks(*self.embed(feats), mask)
        out = self.heads(node, pair)
        out["moe_aux_loss"] = aux
        return out


#: products without batch dims: the Dense layers (``dots`` saves them)
_MM_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _policy_fn(policy: str, ctx, func, *args, **kwargs):
    """Keep the output of aten op ``func`` for the backward (``MUST_SAVE``)
    or recompute it: ``tri_dots`` keeps the ``bmm`` of ``tri_prod``, ``dots``
    every product without batch dims."""
    if policy == "tri_dots":
        save = func is torch.ops.aten.bmm.default and in_tri_prod()
    else:
        save = func in _MM_OPS
    return CheckpointPolicy.MUST_SAVE if save else CheckpointPolicy.PREFER_RECOMPUTE


#: remat_policy -> the selective-checkpoint context of a block (None: save
#: nothing, recompute the whole block)
_REMAT_POLICIES = {
    "none": None,
    "tri_dots": functools.partial(create_selective_checkpoint_contexts,
                                  functools.partial(_policy_fn, "tri_dots")),
    "dots": functools.partial(create_selective_checkpoint_contexts,
                              functools.partial(_policy_fn, "dots")),
}


def run_block(block, cfg: TrFoldConfig, node, pair, mask, cols=None):
    """One block, checkpointed under ``cfg.remat`` (with ``cfg.remat_policy``)
    while gradients are on.  The recompute re-issues a sharded block's
    collectives, on every rank in the same order."""
    args = (node, pair, mask) if cols is None else (node, pair, mask, cols)
    if not (cfg.remat and torch.is_grad_enabled()):
        return block(*args)
    context = _REMAT_POLICIES[cfg.remat_policy]
    if context is None:
        return checkpoint(block, *args, use_reentrant=False)
    return checkpoint(block, *args, use_reentrant=False, context_fn=context)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def _check_params(params: Dict[str, torch.Tensor], model: TrFold) -> None:
    own = dict(model.named_parameters())
    if params.keys() != own.keys() or any(params[k] is not own[k] for k in own):
        raise ValueError("params must be the model's own parameters (as make_train_state returns "
                         "them); load other weights with model.load_state_dict")


def loss_fn(params: Dict[str, torch.Tensor], model: TrFold,
            feats: Dict[str, torch.Tensor], count_group=None) -> torch.Tensor:
    """Masked distogram cross-entropy + torsion sin/cos MSE + the three
    inter-residue angle MSEs (targets from the featurization itself).

    ``params`` are the model's own parameters; the forward reads them through
    the module.  ``count_group``: a data-parallel process group whose ranks
    hold the other shards of the batch, over which every masked mean's count
    is summed (``parallel/zero.mean_denominator``), or None; a sharded
    model's default is its dp x sp group, and its loss is this rank's share.
    """
    _check_params(params, model)
    out = model(feats)
    cfg = model.cfg
    if model.shard is not None and count_group is None:
        count_group = model.shard.data_group
    if "d_cb_bins" in feats:
        target_bins = feats["d_cb_bins"]
    else:
        target_bins = distogram_bins(feats["d_cb"], cfg.n_dist_bins, cfg.max_dist)
    logp = torch.log_softmax(out["distogram_logits"], dim=-1)
    ce = -torch.gather(logp, -1, target_bins[..., None].long())[..., 0]
    pm = feats["pair_mask"]
    ce = torch.where(pm, ce, 0.0).sum() / mean_denominator(pm.sum(), count_group)

    tors = feats["torsions"]
    target_sc = torch.stack([torch.sin(tors), torch.cos(tors)], dim=-1)
    tm = feats["torsion_mask"][..., None]
    mse = torch.where(tm, (out["torsion_sincos"] - target_sc) ** 2, 0.0).sum()
    mse = mse / mean_denominator(tm.sum(), count_group)

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
        pair_loss = pair_loss + err.sum() / mean_denominator(ok.sum(), count_group)
    return ce + mse + pair_loss + cfg.moe_aux_weight * moe_aux_share(out["moe_aux_loss"], model.shard)


def moe_aux_share(aux: torch.Tensor, shard) -> torch.Tensor:
    """This rank's share of the MoE load-balancing loss: a sharded model's
    aux is the global one on every dp x sp rank (``models/moe.py``), so each
    adds ``1 / (dp * sp)`` of it."""
    if shard is None:
        return aux
    return aux / (shard.dp[1] * shard.sp[1])


def pipeline_apply(params, model: TrFold, feats: Dict[str, torch.Tensor], mesh,
                   n_microbatches: int = None) -> Dict[str, torch.Tensor]:
    """The forward of ``model`` with its blocks as GPipe stages over the
    ``pp`` dim of ``mesh`` (a ``DeviceMesh``, ``parallel.mesh.make_mesh(...,
    axis_names=("pp",))``): embeddings and heads run on every rank, block d
    on rank d (``parallel.pipeline.pipeline_forward``), the batch split into
    ``n_microbatches`` (default ``min(pp, B)``).  The outputs are replicated
    on every rank and equal ``model(feats)`` (same blocks, same order; the
    blocks run without remat here, as in the JAX package).

    Requires ``n_blocks == pp``, ``B`` divisible by the microbatch count and
    dense blocks (the MoE aux loss cannot travel with the activations).
    Block d's parameters get their gradients on rank d, the embeddings' on
    rank 0 and the heads' on every rank.
    """
    from protstruc_tpu_torch.parallel.mesh import mesh_coords
    from protstruc_tpu_torch.parallel.pipeline import pipeline_forward, stack_stage_params

    _check_params(params, model)
    cfg = model.cfg
    if model.shard is not None:
        raise ValueError("pipeline_apply runs an unsharded model (its blocks are the stages)")
    _, S = mesh_coords(mesh, "pp")
    if cfg.n_blocks != S:
        raise ValueError(f"n_blocks {cfg.n_blocks} != pp axis size {S}")
    if cfg.moe_experts > 0:
        raise ValueError("pipeline_apply supports dense blocks only")
    B = feats["seq_idx"].shape[0]
    M = n_microbatches or min(S, B)
    if B % M:
        raise ValueError(f"batch {B} not divisible into {M} microbatches")

    node, pair = model.embed(feats)
    mask = feats["residue_mask"]
    blocks = model.blocks
    stages = stack_stage_params([dict(b.named_parameters()) for b in blocks])
    template = blocks[0]

    def stage_fn(p, act):
        n, pr, _ = torch.func.functional_call(template, p, (act["node"], act["pair"],
                                                            act["mask"] > 0.5))
        return {"node": n, "pair": pr, "mask": act["mask"]}

    def mb(x):  # (B, ...) -> (M, B/M, ...)
        return x.reshape((M, B // M) + tuple(x.shape[1:]))

    acts = {"node": mb(node), "pair": mb(pair), "mask": mb(mask.to(node.dtype))}
    group = mesh.get_group("pp") if S > 1 else None
    out = pipeline_forward(stage_fn, stages, acts, group)
    result = model.heads(out["node"].reshape((B,) + tuple(node.shape[1:])),
                         out["pair"].reshape((B,) + tuple(pair.shape[1:])))
    result["moe_aux_loss"] = torch.zeros((), dtype=torch.float32, device=node.device)
    return result


def make_train_state(model: TrFold, feats: Dict[str, torch.Tensor], generator: torch.Generator,
                     learning_rate: float = 1e-3, device="cuda"
                     ) -> Tuple[Dict[str, torch.Tensor], dict, torch.optim.AdamW]:
    """Move ``model`` to ``device``, initialise it from ``generator`` and
    build its optimizer.

    Returns ``(params, opt_state, tx)``: the model's parameters by flax path
    (``block_0.attn.qkv.kernel``), the optimizer's state, and
    ``torch.optim.AdamW`` with optax ``adamw``'s defaults (:func:`adamw`).
    The shapes come from the config; ``feats`` carrying ``chi`` need a
    ``TrFold(chi=True)``.
    """
    device = resolve_device(device)
    if "chi" in feats and not hasattr(model, "chi_embed"):
        raise ValueError(_CHI_NEEDS_FLAG)
    model.to(device)
    model.reset_parameters(generator)
    params = dict(model.named_parameters())
    tx = adamw(params.values(), learning_rate)
    return params, tx.state, tx


def adamw(params, learning_rate: float) -> torch.optim.AdamW:
    """``torch.optim.AdamW`` over ``params`` with optax ``adamw``'s defaults:
    betas (0.9, 0.999), eps 1e-8, weight decay 1e-4 (torch's default decay
    is 1e-2)."""
    return torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


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


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------


def param_shardings(params, mesh=None) -> Dict[str, tuple]:
    """Each leaf's split, by parameter name (the JAX rules,
    ``protstruc_tpu/models/trfold.py:836-862``, as ``PartitionSpec`` tuples:
    per dim the mesh axis it is split over, ``()`` for a replicated leaf):

    * attention ``qkv`` kernels ``(D, 3, h, dh)``: h over tp;
    * attention ``out`` kernels ``(h, dh, D)``: h over tp;
    * ``mlp_in`` kernel ``(D, 4D)``: the output dim over tp;
    * ``mlp_out`` kernel ``(4D, D)``: the input dim over tp;
    * everything else replicated.

    ``params`` maps names to tensors (``dict(model.named_parameters())``);
    ``mesh`` is accepted for the JAX signature and not read.
    """
    def spec_for(name, x):
        names = name.split(".")
        joined = "/".join(names)
        if x.ndim == 4 and "qkv" in joined:
            return (None, None, "tp", None)
        if x.ndim == 3 and joined.endswith("out/kernel"):
            return ("tp", None, None)
        if "mlp_in" in joined and names[-1] == "kernel":
            return (None, "tp")
        if "mlp_out" in joined and names[-1] == "kernel":
            return ("tp", None)
        return ()

    return {k: spec_for(k, v) for k, v in params.items()}


def feats_shardings(mesh=None) -> Dict[str, tuple]:
    """How each feature of ``featurize_for_model`` splits: B over dp, the
    first residue axis over sp (``protstruc_tpu/models/trfold.py:865-886``)."""
    pair, node = ("dp", "sp", None), ("dp", "sp")
    return {
        "seq_idx": node, "torsions": ("dp", "sp", None), "torsion_mask": ("dp", "sp", None),
        "d_cb": pair, "omega": pair, "theta": pair, "phi": pair, "pair_mask": pair,
        "residue_mask": node, "chain_idx": node,
        "d_cb_bins": pair, "ang_sincos": ("dp", "sp", None, None),
        "chi": ("dp", "sp", None), "chi_mask": ("dp", "sp", None),
    }


# ---------------------------------------------------------------------------
# the diffusion denoiser and the structure decode
# ---------------------------------------------------------------------------


class DiffusionDenoiser(nn.Module):
    """Epsilon-prediction denoiser over noisy CA coordinates (pairs with
    ``ops/diffusion.py``): ``(noisy_ca (B, L, 3), t_embed (B, t_dim), seq_idx,
    mask) -> eps_hat (B, L, 3)``.

    Two blocks of pair-bias attention and MLP over the node stream, the bias
    from the noisy CA-CA distances.  flax sizes ``t_in`` from its first
    input; here it is ``t_dim`` wide (8, the examples' embedding).
    """

    def __init__(self, cfg: TrFoldConfig = TrFoldConfig(), device="cuda", t_dim: int = 8):
        super().__init__()
        _check_ported(cfg)
        device = resolve_device(device)
        self.cfg = cfg
        D, P, dt = cfg.node_dim, cfg.pair_dim, cfg.dtype
        self.seq_embed = Embed(cfg.vocab, D, dt, device)
        self.coord_in = Dense(3, D, dt, device)
        self.t_in = Dense(t_dim, D, dt, device)
        self.dist_in = Dense(1, P, dt, device)
        for i in range(2):
            self.add_module(f"LayerNorm_{2 * i}", LayerNorm(D, dt, device))
            self.add_module(f"attn_{i}", PairBiasAttention(cfg, device))
            self.add_module(f"LayerNorm_{2 * i + 1}", LayerNorm(D, dt, device))
            self.add_module(f"mlp_in_{i}", Dense(D, 2 * D, dt, device))
            self.add_module(f"mlp_out_{i}", Dense(2 * D, D, dt, device))
        self.eps_head = Dense(D, 3, torch.float32, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initializers, drawn from ``generator`` in module order."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def forward(self, noisy_ca, t_embed, seq_idx, mask):
        node = self.seq_embed(seq_idx) + self.coord_in(noisy_ca) + self.t_in(t_embed)[:, None, :]
        d = torch.linalg.vector_norm(noisy_ca[:, :, None, :] - noisy_ca[:, None, :, :], dim=-1,
                                     keepdim=True)
        pair = self.dist_in(d.to(self.cfg.dtype))
        for i in range(2):
            ln_a, ln_m = getattr(self, f"LayerNorm_{2 * i}"), getattr(self, f"LayerNorm_{2 * i + 1}")
            node = node + getattr(self, f"attn_{i}")(ln_a(node), pair, mask)
            h = getattr(self, f"mlp_in_{i}")(ln_m(node))
            node = node + getattr(self, f"mlp_out_{i}")(gelu(h))
        return self.eps_head(node)


def predict_structure(params, model: TrFold, feats: Dict[str, torch.Tensor], max_iter: int = 200):
    """Model predictions -> 3D backbone by the trRosetta decode (B = 1).

    The distogram's expectation over bin centres and the angle heads'
    ``atan2(sin, cos)`` feed ``reconstruct_backbone_distmat_from_interresidue_geometry``,
    then MDS (``max_iter`` SMACOF iterations) and 150 steps of
    ``idealize_backbone``.  Returns ``(coords (5, L, 3) N/CA/C/O/CB, the
    predicted 6D dict)``.
    """
    _check_params(params, model)
    with torch.no_grad():
        out = model(feats)
    return _decode_structure(out, feats["pair_mask"], model.cfg, max_iter)


def _decode_structure(out: Dict[str, torch.Tensor], pair_mask: torch.Tensor, cfg: TrFoldConfig,
                      max_iter: int = 200):
    """:func:`predict_structure` after the forward: the heads ``out``
    (``distogram_logits``, ``omega/theta/phi_sincos``) -> ``(coords, pred)``."""
    from protstruc_tpu_torch.ops.idealize import idealize_backbone

    coords, pred = _mds_backbone(out, pair_mask, cfg, max_iter)
    refined, _ = idealize_backbone(coords[:4].transpose(0, 1), n_steps=150)
    return torch.cat([refined.transpose(0, 1), coords[4:]], dim=0), pred


@torch.no_grad()
def _mds_backbone(out: Dict[str, torch.Tensor], pair_mask: torch.Tensor, cfg: TrFoldConfig,
                  max_iter: int = 200):
    """The decode before idealization: the heads -> the predicted 6D dict ->
    the distance matrix -> MDS's ``(5, L, 3)`` N/CA/C/O/CB."""
    from protstruc_tpu_torch.ops.reconstruct import (
        initialize_backbone_with_mds, reconstruct_backbone_distmat_from_interresidue_geometry)

    probs = torch.softmax(out["distogram_logits"], dim=-1)
    centers = ((torch.arange(cfg.n_dist_bins, device=probs.device, dtype=torch.float32) + 0.5)
               * (cfg.max_dist / cfg.n_dist_bins))
    pred = {"d_cb": torch.einsum("blmk,k->blm", probs, centers)}
    for key in ("omega", "theta", "phi"):
        sc = out[f"{key}_sincos"]
        pred[key] = torch.atan2(sc[..., 0], sc[..., 1])
    dist = reconstruct_backbone_distmat_from_interresidue_geometry(
        pred["d_cb"][0], pred["omega"][0], pred["theta"][0], pred["phi"][0], mask=pair_mask[0])
    return initialize_backbone_with_mds(dist, max_iter=max_iter), pred
