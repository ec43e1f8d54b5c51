"""Generative loop: train a diffusion denoiser, sample CA backbones.

Forward marginals as training targets, the DiffusionDenoiser model and
ancestral DDPM sampling, all on the device; the sampled CA trace goes to
``out/generated_ca.pdb``::

    python -m protstruc_tpu_torch.examples.generate_backbones tests/data/1REX.pdb 100 [--device cpu]
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from protstruc_tpu_torch.examples import adam, parse

T = 64


def t_embed(t: torch.Tensor) -> torch.Tensor:
    """The example's 8-wide sinusoidal embedding of a step index."""
    f = torch.exp(torch.linspace(0.0, 4.0, 4, device=t.device))
    return torch.cat([torch.sin(t[:, None] * f), torch.cos(t[:, None] * f)], -1)


def main(argv=None):
    args = parse(argv, __doc__, "tests/data/1REX.pdb", 100)
    import protstruc_tpu_torch as pt
    from protstruc_tpu_torch.models.trfold import DiffusionDenoiser, TrFoldConfig
    from protstruc_tpu_torch.ops.diffusion import (cosine_variance_schedule, ddpm_sample,
                                                   forward_marginal)
    from protstruc_tpu_torch.pdbio.writer import to_pdb

    dev = torch.device(args.device)
    sb = pt.StructureBatch.from_pdb(args.pdb, device=dev).standardize()
    ca = torch.nan_to_num(sb.get_xyz()[:, :, 1], nan=0.0)
    seq = sb.get_seq_idx()
    mask = sb.get_residue_mask()
    betas = cosine_variance_schedule(T, device=dev)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = DiffusionDenoiser(TrFoldConfig(node_dim=64, pair_dim=16, n_heads=2), device=dev)
    model.reset_parameters(gen)
    opt = adam(model.parameters(), 1e-3)
    for i in range(args.steps):
        t = torch.randint(0, T, (1,), generator=gen, device=dev)
        x_t, eps = forward_marginal(ca, betas, t, generator=gen)
        opt.zero_grad(set_to_none=True)
        pred = model(x_t, t_embed(t.float()), seq, mask)
        loss = torch.where(mask[..., None], (pred - eps) ** 2, 0.0).mean()
        loss.backward()
        opt.step()
        if i % 20 == 0:
            print(f"step {i}: eps-MSE {float(loss.detach()):.3f} (unit-noise baseline ~1)")

    def denoise(x, t):
        with torch.no_grad():
            return model(x, t_embed(torch.full((1,), float(t), device=dev)), seq, mask)

    sample = ddpm_sample(denoise, tuple(ca.shape), betas, clip_x0=4.0, generator=gen)
    unstd = (sample * sb.std[:, None] + sb.mu[:, None]).cpu().numpy()
    step_d = np.linalg.norm(np.diff(unstd[0], axis=0), axis=-1)
    print(f"sampled CA trace: {tuple(sample.shape)}, consecutive-CA distance "
          f"{step_d.mean():.1f} +- {step_d.std():.1f} A (toy model; train longer to approach "
          f"the native ~3.8 A)")
    os.makedirs("out", exist_ok=True)
    path = "out/generated_ca.pdb"
    to_pdb(path, unstd[0][None], ["A" * unstd.shape[1]], ["A"], atoms=("CA",))
    print("wrote", path)
    return [path]


if __name__ == "__main__":
    main(sys.argv[1:])
