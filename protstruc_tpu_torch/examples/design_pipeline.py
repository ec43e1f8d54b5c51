"""End-to-end de novo design pipeline, every stage on the device.

1. Backbone generation: SE(3) frame diffusion trained on fragments of the
   input structure.
2. Sequence design: the autoregressive InverseFold over the generated
   backbone (ProteinMPNN-style causal decoding).
3. Side chains: template side chains grafted onto the frames, then
   annealed chi packing against the clash energy, then a gradient relax.
4. Validation: clash energy, radius of gyration, secondary structure;
   written to ``out/designed.pdb``.

A toy run; scale steps and widths for real use::

    python -m protstruc_tpu_torch.examples.design_pipeline tests/data/1REX.pdb 150 [--device cpu]
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from protstruc_tpu_torch.examples import adam, fragments, parse

FRAG_LEN = 32


def main(argv=None):
    args = parse(argv, __doc__, "tests/data/1REX.pdb", 150)
    import protstruc_tpu_torch as pt
    from protstruc_tpu_torch import geometry as geom
    from protstruc_tpu_torch.models.framediff import (FrameDenoiser, FrameDiffConfig,
                                                      framediff_loss, framediff_sample)
    from protstruc_tpu_torch.models.inverse_fold import (InverseFold, InverseFoldConfig,
                                                         ar_sample_sequence, featurize_backbone,
                                                         if_ar_loss)
    from protstruc_tpu_torch.models.ipa import backbone_xyz_from_frames, frames_from_backbone
    from protstruc_tpu_torch.ops.graft import build_sidechains, sidechain_library
    from protstruc_tpu_torch.pdbio.writer import structure_batch_to_pdb
    from protstruc_tpu_torch.vocab import AA

    dev = torch.device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    sb = pt.StructureBatch.from_pdb(args.pdb, device=dev)
    frags = torch.from_numpy(fragments(sb.xyz[0, :, :4].cpu().numpy(), FRAG_LEN)).to(dev)
    print(f"[data] {frags.shape[0]} fragments of {FRAG_LEN} residues")

    # -- 1. backbone diffusion --------------------------------------------------
    cfg = FrameDiffConfig(node_dim=48, pair_dim=24, n_heads=4, n_iter=1, T=48)
    ca = frags[:, :, 1]
    center = ca.mean(1, keepdim=True)
    x0 = (ca - center) / cfg.trans_scale
    r0, _ = frames_from_backbone(frags - center[:, :, None])
    mask = torch.ones(x0.shape[:2], dtype=torch.bool, device=dev)
    denoiser = FrameDenoiser(cfg, device=dev)
    denoiser.reset_parameters(gen)
    params = dict(denoiser.named_parameters())
    opt = adam(params.values(), 1e-3)
    for _ in range(args.steps):
        opt.zero_grad(set_to_none=True)
        loss = framediff_loss(params, denoiser, r0, x0, mask, cfg, generator=gen)
        loss.backward()
        opt.step()
    print(f"[diffusion] trained {args.steps} steps, loss {float(loss.detach()):.3f}")
    r, x = framediff_sample(params, denoiser, (1, FRAG_LEN), cfg, generator=gen)
    bb = backbone_xyz_from_frames(r, x * cfg.trans_scale)  # (1, L, 4, 3) N/CA/C/CB
    print(f"[diffusion] sampled backbone, CA span {float(torch.linalg.vector_norm(bb[0, -1, 1] - bb[0, 0, 1])):.1f} A")

    # -- 2. sequence design -------------------------------------------------------
    gen_xyz = torch.full((1, FRAG_LEN, 15, 3), float("nan"), device=dev)
    gen_xyz[0, :, :3] = bb[0, :, :3]
    gen_xyz[0, :, 4] = bb[0, :, 3]
    backbone = pt.StructureBatch.from_xyz(gen_xyz, device=dev)

    if_model = InverseFold(InverseFoldConfig(node_dim=48, pair_dim=24, n_heads=4, n_blocks=1,
                                             n_decoder_blocks=1), device=dev)
    if_model.reset_parameters(gen)
    sel = torch.zeros(sb.chain_idx.shape, dtype=torch.bool, device=dev)
    sel[:, :min(128, sb.n_residues)] = True
    tf = featurize_backbone(sb.residue_masked_select(sel))  # toy training on the native
    if_params = dict(if_model.named_parameters())
    if_opt = adam(if_params.values(), 1e-3)
    for _ in range(args.steps):
        if_opt.zero_grad(set_to_none=True)
        loss = if_ar_loss(if_params, if_model, tf, generator=gen)
        loss.backward()
        if_opt.step()
    print(f"[design] trained {args.steps} steps, CE {float(loss.detach()):.3f}")
    gf = featurize_backbone(backbone)
    gf["target_seq"] = torch.zeros(backbone.chain_idx.shape, dtype=torch.int32, device=dev)
    seq_idx = ar_sample_sequence(if_params, if_model, gf, temperature=0.2, generator=gen)
    seq = "".join(AA(int(a)).oneletter() for a in seq_idx[0].cpu().numpy())
    print(f"[design] sequence: {seq}")

    # -- 3. side chains and validation --------------------------------------------
    lib = sidechain_library(sb)
    o = geom.ideal_carbonyl_oxygen(bb[:, :, 0], bb[:, :, 1], bb[:, :, 2])
    bb5 = torch.cat([bb[:, :, :3], o[:, :, None], bb[:, :, 3:4]], dim=2)  # N/CA/C/O/CB
    all_xyz, all_mask = build_sidechains(bb5, seq_idx, lib)
    full = pt.StructureBatch.from_xyz(all_xyz, atom_mask=all_mask,
                                      chain_idx=np.zeros((1, FRAG_LEN), np.int32),
                                      chain_ids=[["A"]], seq=[{"A": seq}], device=dev)
    e0 = float(full.clash_energy()[0])
    packed = full.pack_sidechains(gen, n_sweeps=10, n_proposals=6)
    print(f"[pack] clash energy {e0:.2f} -> {float(packed.clash_energy()[0]):.2f}")
    packed, er = packed.relax(n_steps=150)
    print(f"[relax] total energy {float(er['initial'][0]):.1f} -> {float(er['final'][0]):.1f} "
          f"(clash {float(er['clash_initial'][0]):.2f} -> {float(er['clash_final'][0]):.2f})")
    print(f"[validate] Rg {float(packed.radius_of_gyration()[0]):.1f} A, SS classes "
          f"{np.unique(packed.secondary_structure().cpu().numpy()).tolist()}")
    os.makedirs("out", exist_ok=True)
    path = "out/designed.pdb"
    structure_batch_to_pdb(packed, path)
    print("wrote", path)
    return [path]


if __name__ == "__main__":
    main(sys.argv[1:])
