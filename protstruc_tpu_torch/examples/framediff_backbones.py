"""SE(3) frame-diffusion backbone generation, end to end.

Trains a FrameDenoiser on fragments of the input structure, samples four
backbones by ancestral SE(3) diffusion and writes them to
``out/framediff_sample_{i}.pdb``::

    python -m protstruc_tpu_torch.examples.framediff_backbones tests/data/1REX.pdb 200 [--device cpu]
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from protstruc_tpu_torch.examples import adam, fragments, parse

FRAG_LEN, N_SAMPLES = 32, 4


def main(argv=None):
    args = parse(argv, __doc__, "tests/data/1REX.pdb", 200)
    import protstruc_tpu_torch as pt
    from protstruc_tpu_torch import geometry as geom
    from protstruc_tpu_torch.models.framediff import (FrameDenoiser, FrameDiffConfig,
                                                      framediff_loss, framediff_sample)
    from protstruc_tpu_torch.models.ipa import backbone_xyz_from_frames, frames_from_backbone
    from protstruc_tpu_torch.pdbio.writer import to_pdb

    dev = torch.device(args.device)
    sb = pt.StructureBatch.from_pdb(args.pdb, device="cpu")
    frags = torch.from_numpy(fragments(sb.xyz[0, :, :4].numpy(), FRAG_LEN)).to(dev)
    print(f"{frags.shape[0]} fragments of length {FRAG_LEN}")

    cfg = FrameDiffConfig(node_dim=64, pair_dim=32, n_heads=4, n_iter=2, T=64)
    ca = frags[:, :, 1]
    center = ca.mean(1, keepdim=True)
    x0 = (ca - center) / cfg.trans_scale
    r0, _ = frames_from_backbone(frags - center[:, :, None])
    mask = torch.ones(x0.shape[:2], dtype=torch.bool, device=dev)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = FrameDenoiser(cfg, device=dev)
    model.reset_parameters(gen)
    params = dict(model.named_parameters())
    opt = adam(params.values(), 1e-3)
    for i in range(args.steps):
        opt.zero_grad(set_to_none=True)
        loss = framediff_loss(params, model, r0, x0, mask, cfg, generator=gen)
        loss.backward()
        opt.step()
        if i % max(args.steps // 10, 1) == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {float(loss.detach()):.4f}")

    r, x = framediff_sample(params, model, (N_SAMPLES, FRAG_LEN), cfg, generator=gen)
    bb = backbone_xyz_from_frames(r, x * cfg.trans_scale)  # (n, L, 4, 3) N/CA/C/CB
    o = geom.ideal_carbonyl_oxygen(bb[:, :, 0], bb[:, :, 1], bb[:, :, 2])
    os.makedirs("out", exist_ok=True)
    written = []
    for i in range(N_SAMPLES):
        coords = torch.stack([bb[i, :, 0], bb[i, :, 1], bb[i, :, 2], o[i], bb[i, :, 3]]).cpu().numpy()
        path = f"out/framediff_sample_{i}.pdb"
        to_pdb(path, np.asarray(coords), ["A" * FRAG_LEN], ["A"])
        print("wrote", path)
        written.append(path)
    return written


if __name__ == "__main__":
    main(sys.argv[1:])
