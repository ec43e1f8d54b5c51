"""InverseFold: fixed-backbone sequence design (the ProteinMPNN task), port
of ``protstruc_tpu/models/inverse_fold.py``.

Given backbone geometry only, predict the native sequence.  Neighbourhoods
are distance-kernel attention biases over the dense ``(B, L, L)`` CA
distance map, not k-NN gathers.  With ``n_decoder_blocks > 0`` the model
adds ProteinMPNN-style autoregressive decoder blocks: sequence context
enters the keys and values (``PairBiasAttention(kv=...)``) under a causal
mask over a decoding order (``extra_mask``); teacher forcing trains every
conditional in one pass, and ``ar_sample_sequence`` decodes one position a
step.  ``use_flash_attn=True`` runs encoder and decoder attention through
the K8/K9 kernels, the causal mask folded into the bias.

The modules keep the flax parameter tree (``node_in``, ``rbf_embed``,
``attn_0``, ``LayerNorm_0``, ``dec_attn_0``, ``seq_ctx``, ``logits``, ...),
so ``convert.inverse_fold_params_from_flax`` carries JAX weights across.

Randomness: ``random_decode_order`` draws a permutation a structure and
``sample_sequence``/``ar_sample_sequence`` draw Gumbel noise (the JAX
package's ``jax.random.categorical`` is Gumbel-max) from a
``torch.Generator`` on its device; the private cores (``_ranks``,
``_if_ar_loss``, ``_sample_sequence``, ``_ar_sample_sequence``) take the
draws.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from protstruc_tpu_torch.batch import resolve_device
from protstruc_tpu_torch.models._nn import Dense, Embed, LayerNorm, gelu
from protstruc_tpu_torch.models.trfold import (PairBiasAttention, TrFoldConfig, _check_params,
                                               _sincos, adamw)

__all__ = [
    "InverseFoldConfig",
    "InverseFold",
    "featurize_backbone",
    "if_loss",
    "make_if_train_state",
    "if_train_step",
    "sample_sequence",
    "if_ar_loss",
    "ar_sample_sequence",
    "random_decode_order",
    "sequence_recovery",
]

UNK = 20  # the padding / teacher-context class, never designed


@dataclasses.dataclass(frozen=True)
class InverseFoldConfig:
    """The JAX package's ``InverseFoldConfig`` with a torch ``dtype``."""

    vocab: int = 21
    node_dim: int = 128
    pair_dim: int = 32
    n_heads: int = 4
    n_blocks: int = 3
    n_rbf: int = 16
    max_dist: float = 20.0
    dtype: torch.dtype = torch.float32
    n_decoder_blocks: int = 0
    use_flash_attn: bool = False
    ring_mesh: Any = None


def featurize_backbone(batch) -> Dict[str, torch.Tensor]:
    """Backbone-only features (torsions, frames, the CA distance map; no
    sequence identity, the target).  NaN torsions become 0 under a False
    mask, NaN distances 1e6 (past every RBF centre), NaN frames 0."""
    torsions, torsion_mask = batch.backbone_dihedrals()
    torsion_mask = torsion_mask & torch.isfinite(torsions)
    d_ca, d_mask = batch.pairwise_atom_distance("CA", "CA")
    return {
        "torsions": torch.nan_to_num(torsions, nan=0.0),
        "torsion_mask": torsion_mask,
        "d_ca": torch.nan_to_num(d_ca, nan=1e6),
        "d_mask": d_mask,
        "frames": torch.nan_to_num(batch.backbone_orientations(), nan=0.0),
        "residue_mask": batch.residue_mask,
        "target_seq": batch.get_seq_idx() if batch.seq is not None else None,
    }


class InverseFold(nn.Module):
    """Encoder (and optional AR decoder) over dense backbone geometry.

    With ``cfg.n_decoder_blocks > 0`` the features also carry ``prev_seq
    (B, L)`` (identities to condition on) and ``decode_rank (B, L)`` (each
    position's index in the decoding order): decoder attention at position
    i sees only positions of strictly smaller rank, and a position's own
    identity reaches only keys and values, never its own query.
    """

    def __init__(self, cfg: InverseFoldConfig = InverseFoldConfig(), device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        D, P, dt = cfg.node_dim, cfg.pair_dim, cfg.dtype
        tr_cfg = TrFoldConfig(node_dim=D, pair_dim=P, n_heads=cfg.n_heads, dtype=dt,
                              use_flash_attn=cfg.use_flash_attn, ring_mesh=cfg.ring_mesh)
        self.node_in = Dense(6 + 9, D, dt, device)   # torsion sin/cos, flattened frame
        self.rbf_embed = Dense(cfg.n_rbf, P, dt, device)
        for i in range(cfg.n_blocks):
            self.add_module(f"LayerNorm_{2 * i}", LayerNorm(D, dt, device))
            self.add_module(f"attn_{i}", PairBiasAttention(tr_cfg, device))
            self.add_module(f"LayerNorm_{2 * i + 1}", LayerNorm(D, dt, device))
            self.add_module(f"mlp_in_{i}", Dense(D, 2 * D, dt, device))
            self.add_module(f"mlp_out_{i}", Dense(2 * D, D, dt, device))
        if cfg.n_decoder_blocks > 0:
            self.seq_ctx = Embed(cfg.vocab, D, dt, device)
        for i in range(cfg.n_decoder_blocks):
            self.add_module(f"dec_ln_q_{i}", LayerNorm(D, dt, device))
            self.add_module(f"dec_ln_kv_{i}", LayerNorm(D, dt, device))
            self.add_module(f"dec_attn_{i}", PairBiasAttention(tr_cfg, device))
            self.add_module(f"LayerNorm_{2 * cfg.n_blocks + i}", LayerNorm(D, dt, device))
            self.add_module(f"dec_mlp_in_{i}", Dense(D, 2 * D, dt, device))
            self.add_module(f"dec_mlp_out_{i}", Dense(2 * D, D, dt, device))
        self.logits = Dense(D, cfg.vocab, torch.float32, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initializers, drawn from ``generator`` in module order."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def _block(self, i: int, node, pair, mask):
        m = self.get_submodule
        node = node + m(f"attn_{i}")(m(f"LayerNorm_{2 * i}")(node), pair, mask)
        h = m(f"mlp_in_{i}")(m(f"LayerNorm_{2 * i + 1}")(node))
        return node + m(f"mlp_out_{i}")(gelu(h))

    def forward(self, feats: Dict[str, torch.Tensor]) -> torch.Tensor:
        cfg, dt = self.cfg, self.cfg.dtype
        mask = feats["residue_mask"]
        frames = feats["frames"]
        tor = _sincos(feats["torsions"], feats["torsion_mask"], torch.float32)
        node = self.node_in(torch.cat([tor, frames.reshape(frames.shape[:2] + (9,))], dim=-1).to(dt))

        # distance-kernel features -> pair bias (soft k-NN neighbourhoods)
        centers = torch.linspace(0.0, cfg.max_dist, cfg.n_rbf, device=node.device)
        width = cfg.max_dist / cfg.n_rbf
        rbf = torch.exp(-((feats["d_ca"][..., None] - centers) ** 2) / (2 * width ** 2)).to(dt)
        rbf = torch.where(feats["d_mask"][..., None], rbf, torch.zeros((), dtype=dt, device=rbf.device))
        pair = self.rbf_embed(rbf)

        for i in range(cfg.n_blocks):
            node = self._block(i, node, pair, mask)
        if cfg.n_decoder_blocks > 0:
            m = self.get_submodule
            rank = feats["decode_rank"]
            causal = rank[:, None, :] < rank[:, :, None]  # i attends to j decoded before it
            seq_ctx = self.seq_ctx(feats["prev_seq"])
            for i in range(cfg.n_decoder_blocks):
                q_in = m(f"dec_ln_q_{i}")(node)
                kv_in = m(f"dec_ln_kv_{i}")(node + seq_ctx)
                node = node + m(f"dec_attn_{i}")(q_in, pair, mask, extra_mask=causal, kv=kv_in)
                h = m(f"dec_mlp_in_{i}")(m(f"LayerNorm_{2 * cfg.n_blocks + i}")(node))
                node = node + m(f"dec_mlp_out_{i}")(gelu(h))
        return self.logits(node)


def if_loss(params, model: InverseFold, feats) -> torch.Tensor:
    """Masked cross-entropy of the logits against ``feats["target_seq"]``."""
    _check_params(params, model)
    logp = torch.log_softmax(model(feats), dim=-1)
    ce = -torch.gather(logp, -1, feats["target_seq"][..., None].long())[..., 0]
    m = feats["residue_mask"]
    return torch.where(m, ce, 0.0).sum() / torch.clamp_min(m.sum(), 1.0)


def make_if_train_state(model: InverseFold, feats, generator: torch.Generator,
                        learning_rate: float = 1e-3, device="cuda"):
    """Move ``model`` to ``device``, initialise it from ``generator`` and
    build AdamW with optax ``adamw``'s defaults.  Returns ``(params,
    opt_state, tx)``; ``feats`` is taken for the JAX signature."""
    model.to(resolve_device(device))
    model.reset_parameters(generator)
    params = dict(model.named_parameters())
    tx = adamw(params.values(), learning_rate)
    return params, tx.state, tx


def if_train_step(params, opt_state, feats, model: InverseFold, tx: torch.optim.Optimizer):
    """One AdamW step on :func:`if_loss`, in place; returns ``(params,
    opt_state, loss)`` with the loss a detached 0-dim tensor."""
    tx.zero_grad(set_to_none=True)
    loss = if_loss(params, model, feats)
    loss.backward()
    tx.step()
    return params, opt_state, loss.detach()


def _gumbel(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Standard Gumbel noise, ``-log(-log(u))`` with ``u`` uniform in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device)
    u = torch.clamp_min(u, torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def _device_of(generator, feats):
    return generator.device if generator is not None else feats["residue_mask"].device


@torch.no_grad()
def _sample_sequence(params, model: InverseFold, feats, gumbel: torch.Tensor,
                     temperature: float = 1.0) -> torch.Tensor:
    _check_params(params, model)
    logits = model(feats).clone()
    logits[..., UNK:] = -1e9  # never draw UNK at a valid position
    seq = torch.argmax(logits / max(temperature, 1e-4) + gumbel, dim=-1)
    return torch.where(feats["residue_mask"], seq, UNK).int()


def sample_sequence(params, model: InverseFold, feats, temperature: float = 1.0,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Sequences ``(B, L)`` int32 from the design distribution (Gumbel-max at
    ``temperature``; -> 0 approaches argmax).  Positions outside
    ``residue_mask`` come back as UNK (20), which is never drawn."""
    B, L = feats["residue_mask"].shape
    g = _gumbel((B, L, model.cfg.vocab), generator, _device_of(generator, feats))
    return _sample_sequence(params, model, feats, g, temperature)


def _ranks(perm: torch.Tensor) -> torch.Tensor:
    """Decoding ranks from permutations: ``rank[b, perm[b, k]] = k``, int32."""
    B, L = perm.shape
    ar = torch.arange(L, dtype=torch.int32, device=perm.device).expand(B, L)
    return torch.empty((B, L), dtype=torch.int32, device=perm.device).scatter_(1, perm.long(), ar)


def _permutations(shape: Tuple[int, int], generator, device) -> torch.Tensor:
    B, L = shape
    return torch.stack([torch.randperm(L, generator=generator, device=device) for _ in range(B)])


def random_decode_order(shape: Tuple[int, int], generator: Optional[torch.Generator] = None,
                        device=None) -> torch.Tensor:
    """Random per-structure decoding ranks ``(B, L)`` int32 (``rank[b, i] =
    k``: position i is decoded k-th), one permutation a structure from
    ``generator`` on its device (or ``device`` for the global one)."""
    dev = generator.device if generator is not None else resolve_device(device or "cuda")
    return _ranks(_permutations(shape, generator, dev))


def _if_ar_loss(params, model: InverseFold, feats, rank: torch.Tensor) -> torch.Tensor:
    return if_loss(params, model, dict(feats, prev_seq=feats["target_seq"], decode_rank=rank))


def if_ar_loss(params, model: InverseFold, feats,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Teacher-forced autoregressive cross-entropy over a random decoding order."""
    dev = _device_of(generator, feats)
    return _if_ar_loss(params, model, feats,
                       random_decode_order(feats["residue_mask"].shape, generator, dev))


@torch.no_grad()
def _ar_sample_sequence(params, model: InverseFold, feats, perm: torch.Tensor,
                        gumbel: torch.Tensor, temperature: float = 0.1,
                        fixed_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The AR sampler on given draws: ``perm (B, L)`` the decoding-order
    permutations, ``gumbel (L, B, V)`` one block a step."""
    _check_params(params, model)
    mask = feats["residue_mask"]
    B, L = mask.shape
    rank = _ranks(perm)
    if fixed_mask is not None:
        # fixed positions first, each group in its drawn order
        rank = torch.where(fixed_mask, rank, rank + L).argsort(dim=1).argsort(dim=1).int()
    order = torch.argsort(rank, dim=1)  # the position decoded at step k (ranks are distinct)
    seq = torch.full((B, L), UNK, dtype=torch.int32, device=mask.device)
    if fixed_mask is not None:
        seq = torch.where(fixed_mask, feats["target_seq"].int(), seq)
    t = max(temperature, 1e-4)
    rows = torch.arange(B, device=mask.device)
    aa_ok = torch.arange(model.cfg.vocab, device=mask.device) < UNK
    n_kept = fixed_mask.sum(1).min() if fixed_mask is not None else 0
    for k in range(int(n_kept), L):  # the first n_kept steps keep a fixed position everywhere
        pos = order[:, k]
        logits = model(dict(feats, prev_seq=seq, decode_rank=rank))
        row = torch.where(aa_ok, logits[rows, pos], -1e9)
        draw = torch.argmax(row / t + gumbel[k], dim=-1).int()
        keep = fixed_mask[rows, pos] if fixed_mask is not None else torch.zeros_like(pos, dtype=torch.bool)
        seq[rows, pos] = torch.where(keep, seq[rows, pos], draw)
    return torch.where(mask, seq, UNK).int()


def ar_sample_sequence(params, model: InverseFold, feats, temperature: float = 0.1,
                       fixed_mask: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Autoregressive sampling: one position a step in a random decoding
    order, each step rerunning the model on the grown sequence context and
    drawing that position (Gumbel-max at ``temperature``, UNK never drawn).
    ``fixed_mask`` (True = keep) pins positions to ``feats["target_seq"]``
    and decodes them first, so designed regions condition on the fixed
    context (CDR redesign); the steps that decode a fixed position in every
    structure run no model.  Returns ``(B, L)`` int32."""
    B, L = feats["residue_mask"].shape
    dev = _device_of(generator, feats)
    perm = _permutations((B, L), generator, dev)
    gumbel = _gumbel((L, B, model.cfg.vocab), generator, dev)
    return _ar_sample_sequence(params, model, feats, perm, gumbel, temperature, fixed_mask)


@torch.no_grad()
def sequence_recovery(params, model: InverseFold, feats) -> torch.Tensor:
    """Fraction of valid residues whose argmax prediction is the native; an AR
    model without decoding context in ``feats`` is read teacher-forced, left
    to right."""
    _check_params(params, model)
    if model.cfg.n_decoder_blocks > 0 and "prev_seq" not in feats:
        B, L = feats["residue_mask"].shape
        rank = torch.arange(L, dtype=torch.int32, device=feats["residue_mask"].device).expand(B, L)
        feats = dict(feats, prev_seq=feats["target_seq"], decode_rank=rank)
    pred = torch.argmax(model(feats), dim=-1)
    m = feats["residue_mask"]
    hit = (pred == feats["target_seq"]) & m
    return hit.sum() / torch.clamp_min(m.sum(), 1)
