#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Run from the root of a checkout.  It drives ``protstruc_tpu_torch`` on the
card in phases, prints one line per phase, and exits non-zero at the first
failure (no CUDA, a kernel that does not build or launch, a disagreement):

1. device: the card's name and power limit (nvidia-smi);
2. build: K1 (csrc/pair_maps.cu), K3 (csrc/model_features.cu), K4-K7
   (csrc/tri_mul.cu) and K8/K9 (csrc/flash_attn.cu) with nvcc, from the
   checkout's sources, the four builds started together;
3. parity at small sizes: K1 vs its plain PyTorch version on the card, on
   ragged L = 37 and 300 and on degenerate probes;
4. parity at full size: B=256, L=512 on ``randn * 10`` (numpy seed 0);
5. main path: ``StructureBatch.from_pdb`` on bundled PDBs, then
   ``precompile_featurizer(device="cuda")`` and ``serve_loop`` over JSONL
   requests; K1's launch counter is reset just before and must grow;
6. timing (CUDA events, 2 warm-up + 10 timed, plain/kernel/kernel/plain):
   K1 alone vs its plain version, and full featurization at B=256, L=512 on
   the kernel path vs the plain path, as structures/s;
7. triangle kernels: K4-K7 vs their plain versions on the card, f32 and
   bf16, C = 16 and 128 on a ragged N = 2*37*37 with masked rows, and C = 128
   on N = 160*160 (more row tiles than blocks, so each block loops), every
   output and weight gradient; then the whole op (forward and backward,
   outgoing and incoming) vs the plain path on the CPU;
8. train path: TrFold at the ``[mfu-fused]`` width of bench.py (bf16,
   D=256, P=128, 8 heads, 4 blocks, triangle updates, remat, fused_tri) on
   B=4, L=512 (``randn * 5``, numpy seed 0): ``featurize_for_model(
   use_kernel=True)`` (K1), ``make_train_state`` from a seeded generator and
   3 ``train_step``s, every launch counter reset just before and read just
   after (K4-K7 must grow); the same 3 steps from the same init with
   ``fused_tri=False`` (plain PyTorch); then the same at f32, B=1, L=128,
   with gradients compared leaf by leaf;
9. timing: the full-width train step, fused vs unfused (ms/step and peak
   memory; every step from the initial parameters, its loss finite), and each
   of K4-K7 alone vs its plain version at N = 4*512*512, C = 128, bf16, the
   shape the train path gives it, after each output is held against the plain
   version's under the budgets below;
10. K3 vs its plain version on ragged L = 37 and 300, the degenerate probes
    and B=256, L=512 (``randn * 10``, numpy seed 0), f32 and bf16 planes;
11. K8/K9 vs their plain versions (forward, lse, ds, dk, dv and dq = ds k),
    f32 and bf16, at the train shape (B=4, H=4, dh=32, L=256, the bias read
    through the model's permuted layout), ragged L = 37 and 300 with a
    fully-masked batch row, and bench.py's ``[attn]`` shape (B=1, H=8,
    dh=32, L=4096, last 100 keys masked);
12. main path of the FoldModel slice: ``python -m protstruc_tpu_torch train``
    (in process) at ``experiments/fold_loo.py``'s configuration with
    ``--flash-attn`` (f32, B=4, crop 256, D=128, P=64, 4 heads, 4 blocks, 6
    IPA iterations, recycle 1, triangle updates, remat, fused_tri) over its
    training files (1REX held out, the duplicate 1a6v_JN left out), 8 steps,
    a checkpoint every 4 with an eval on 1REX; then ``fold`` of 1REX's
    sequence from that checkpoint into a PDB.  The K3, K4-K7 and K8/K9
    counters are reset just before and must grow.  Then one batch of real
    crops from one init, the kernel path against the plain path (K3's plain
    version, ``use_flash_attn`` and ``fused_tri`` off): loss and every
    gradient leaf;
13. timing: the FoldModel train step (featurization included), kernel path
    vs plain path (ms/step, peak memory, each step from the initial
    parameters); K3 at B=256, L=512; K8 and K9 at the train and ``[attn]``
    shapes, each beside its plain version and
    ``torch.nn.functional.scaled_dot_product_attention`` with the additive
    mask (its forward, and its backward over a kept graph).

Parity tolerances on the card: distance maps atol 1e-5 + rtol 1e-5; omega,
theta, phi atol 1e-4 (the largest error and the count above 1e-5 are
printed); NaN patterns identical; masks bitwise.  K4-K7: the JAX package's
budgets (tests/test_tri_mul.py:49-60), f32 ``max|d| <= 2e-5 max(1,
max|ref|)``, bf16 ``max|d| <= 5e-2 max|ref|``.  Train path: bf16 losses of
the fused and unfused paths within 2e-2 relative per step; f32 within 1e-5
relative, and each gradient leaf within 1e-4 of its largest entry.  K3: bins
equal except where d_cb lies within 1e-3 A of a bin edge (counted), f32
planes within 1e-5, bf16 planes within one bf16 ulp.  K8/K9: f32 out and lse
2e-5, ds 5e-4, dq/dk/dv 5e-5, each times max(1, max|ref|)
(tests/test_flash_attn.py, BASELINE.md:31-37); bf16 2e-2 times each
output's own max|ref|, with no floor (the ratio is printed); lse held on the
rows that have keys, fully-masked rows exact zeros and their lse pinned.
FoldModel kernel vs plain path: loss within
1e-4 relative, each gradient leaf within 1e-3 of its largest entry.

The line before the last is one JSON object describing each kernel: its
launches on its slice's main path (K1 phase 5, K4-K7 phase 8, K3 and K8/K9
phase 12), largest error, card and plain times, its bound (the larger of the
bytes it must move, each input it reads once (of xyz, only the atom slots
K1 and K3 read) and each output once, over 3.35 TB/s, and its operations
over the H100 SXM peak for
their type: 989 TFLOP/s bf16, 67 TFLOP/s f32) and, where one PyTorch call
computes the same function, that call's time.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import concurrent.futures
import contextlib
import copy
import dataclasses
import io
import json
import math
import pathlib
import re
import subprocess
import sys
import tempfile
import time
import warnings

REPO = pathlib.Path(__file__).resolve().parent
DATA = REPO / "tests" / "data"
PDBS = ("1REX.pdb", "1ad0_DC.pdb", "4EOT.pdb")
B_FULL, L_FULL = 256, 512
WARMUP, ITERS = 2, 10
DIST_ATOL = DIST_RTOL = 1e-5
ANGLE_ATOL = 1e-4
DIST_MAPS = ("d_ca", "d_cb", "d_no")
TRAIN_WIDTH = dict(node_dim=256, pair_dim=128, n_heads=8, n_blocks=4, pair_update="triangle",
                   remat=True)  # bench.py:338-345 [mfu-fused], with fused_tri
TRAIN_STEPS = 3


def say(*parts):
    print(*parts, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def compare(ref, out, name):
    """Max |ref - out| of one map pair (or bitwise for masks) under the
    stated tolerance; returns (max_err, count above 1e-5)."""
    import torch

    check(ref.shape == out.shape, f"{name}: shape {tuple(out.shape)} != {tuple(ref.shape)}")
    if ref.dtype == torch.bool:
        check(torch.equal(ref, out), f"{name}: masks differ")
        return 0.0, 0
    nan_r, nan_o = torch.isnan(ref), torch.isnan(out)
    check(torch.equal(nan_r, nan_o),
          f"{name}: NaN patterns differ at {int((nan_r != nan_o).sum())} entries")
    diff = (ref - out).abs().masked_fill(nan_r, 0)
    err = float(diff.max()) if diff.numel() else 0.0
    if name.rsplit(" ", 1)[-1] in DIST_MAPS:
        bad = diff > DIST_ATOL + DIST_RTOL * ref.abs().masked_fill(nan_r, 0)
    else:
        bad = diff > ANGLE_ATOL
    check(not bool(bad.any()), f"{name}: {int(bad.sum())} entries out of tolerance, max {err:.3e}")
    return err, int((diff > 1e-5).sum())


def compare_maps(ref, out, label):
    worst = 0.0
    parts = []
    for k in ref:
        err, n_above = compare(ref[k], out[k], f"{label} {k}")
        worst = max(worst, err)
        parts.append(f"{k} {err:.2e}" + (f" ({n_above} > 1e-5)" if n_above else ""))
    say(f"  {label}: " + ", ".join(parts))
    return worst


def cuda_time_ms(fn):
    import torch

    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def alternate(plain, kernel):
    """Time plain, kernel, kernel, plain; returns the mean ms of each."""
    p1, k1, k2, p2 = cuda_time_ms(plain), cuda_time_ms(kernel), cuda_time_ms(kernel), cuda_time_ms(plain)
    return (p1 + p2) / 2, (k1 + k2) / 2, (p1, k1, k2, p2)


def probes(torch, device):
    """Degenerate configurations: pinned, NaN, padding, and shared atoms."""
    import numpy as np

    xyz = (np.random.RandomState(2).randn(1, 40, 15, 3) * 5).astype(np.float32)
    xyz[0, 3, 4] = xyz[0, 3, 1]          # CB == CA in one residue
    xyz[0, 5] = xyz[0, 9]                # a residue duplicated
    xyz[0, 7, 0] = xyz[0, 7, 1]          # N == CA
    xyz[0, 8, 4:] = np.nan               # GLY: no CB
    xyz[0, 12] = xyz[0, 12, 1]           # a collapsed residue
    xyz[0, 14, 4] = xyz[0, 15, 4]        # two residues share a CB
    xyz[0, 16, 1] = xyz[0, 17, 1]        # two residues share a CA
    xyz[0, 18, 1] = xyz[0, 19, 4]        # CA_i == CB_j
    xyz[0, 32:] = 0.0                    # zero-coordinate padding
    return torch.from_numpy(xyz).to(device)


TRI_KERNELS = ("prologue_fwd", "prologue_bwd", "epilogue_fwd", "epilogue_bwd")
TRI_REPLACES = {"prologue_fwd": "protstruc_tpu/ops/tri_mul.py:107",
                "prologue_bwd": "protstruc_tpu/ops/tri_mul.py:121",
                "epilogue_fwd": "protstruc_tpu/ops/tri_mul.py:267",
                "epilogue_bwd": "protstruc_tpu/ops/tri_mul.py:279"}
TRI_OUTPUTS = {
    "prologue_fwd": ("a", "b"),
    "prologue_bwd": ("dx", "d_lns", "d_lnb", "d_wag", "d_bag", "d_wap", "d_bap",
                     "d_wbg", "d_bbg", "d_wbp", "d_bbp"),
    "epilogue_fwd": ("out",),
    "epilogue_bwd": ("dx", "dp", "d_ln1s", "d_ln1b", "d_wog", "d_bog", "d_ln2s",
                     "d_ln2b", "d_wo", "d_bo"),
}


def tri_budget(torch, ref, out, name):
    """The JAX package's tri_mul budgets (tests/test_tri_mul.py:49-60): f32
    max|d| <= 2e-5 max(1, max|ref|); bf16 max|d| / max|ref| <= 5e-2.
    Returns (max|d|, max|d| / max|ref|)."""
    check(ref.shape == out.shape and ref.dtype == out.dtype,
          f"{name}: {tuple(out.shape)} {out.dtype} vs {tuple(ref.shape)} {ref.dtype}")
    r, o = ref.float(), out.float()
    check(bool(torch.isfinite(o).all()), f"{name}: non-finite output")
    err = float((r - o).abs().max()) if r.numel() else 0.0
    scale = float(r.abs().max()) if r.numel() else 0.0
    if ref.dtype == torch.float32:
        check(err <= 2e-5 * max(1.0, scale), f"{name}: max err {err:.3e} > 2e-5 * max(1, {scale:.3e})")
    else:
        check(err <= 5e-2 * max(scale, 1e-3), f"{name}: max err {err:.3e} > 5e-2 * {scale:.3e}")
    return err, err / scale if scale else 0.0


def tri_inputs(torch, dev, dtype, C, B=2, L=37, seed=0):
    """Random pair rows (N = B*L*L, ragged against every tile) with masked
    residues, product rows, cotangents and weights, drawn on the card from a
    generator seeded with `seed`."""
    gen = torch.Generator(dev).manual_seed(seed)
    N = B * L * L

    def t(*shape, scale=1.0, shift=0.0):
        x = torch.randn(shape, generator=gen, device=dev) * scale + shift
        return x.to(dtype)

    mask = torch.ones((B, L), dtype=torch.bool, device=dev)
    mask[B - 1, L - 5:] = False
    mask[0, 3] = False
    m = (mask[:, :, None] & mask[:, None, :]).reshape(N).to(dtype)
    x, p = t(N, C, shift=0.3), t(N, C, scale=3.0)
    ln = lambda: (t(C, scale=0.2, shift=1.0), t(C, scale=0.2))  # noqa: E731
    lin = lambda: (t(C, C, scale=C ** -0.5), t(C, scale=0.1))   # noqa: E731
    pro_w = [*ln(), *lin(), *lin(), *lin(), *lin()]
    epi_w = [*pro_w[:2], *lin(), *ln(), *lin()]
    return {
        "prologue_fwd": (x, m, *pro_w),
        "prologue_bwd": (x, m, *pro_w, t(N, C), t(N, C)),
        "epilogue_fwd": (x, p, *epi_w),
        "epilogue_bwd": (x, p, *epi_w, t(N, C)),
        "mask": mask,
    }


def tri_kernel_vs_plain(torch, tri_mul, name, args, label):
    """One of K4-K7 and its plain version on the same card tensors, every
    output under tri_budget; prints each output's error (and its ratio to the
    output's largest value), returns the largest error."""
    kernel, plain = tri_mul.KERNELS[name]
    got = kernel(*args)
    torch.cuda.synchronize()
    ref = plain(*args)
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    check(len(got) == len(ref) == len(TRI_OUTPUTS[name]), f"{name}: {len(got)} outputs")
    errs = [tri_budget(torch, r, o, f"{name} {label} {k}")
            for k, r, o in zip(TRI_OUTPUTS[name], ref, got)]
    say(f"  {name} {label} N={args[0].shape[0]}: "
        + ", ".join(f"{k} {e:.2e} ({r:.1e})" for k, (e, r) in zip(TRI_OUTPUTS[name], errs)))
    return max(e for e, _ in errs)


def tri_kernel_parity(torch, dev):
    """K4-K7 against their plain versions on the card, each output compared.
    Returns the largest error of each kernel over all cases."""
    from protstruc_tpu_torch.ops import tri_mul

    worst = {k: 0.0 for k in TRI_KERNELS}
    for dtype in (torch.float32, torch.bfloat16):
        for C, B, L in ((16, 2, 37), (128, 2, 37), (128, 1, 160)):
            cases = tri_inputs(torch, dev, dtype, C, B=B, L=L)
            for name in TRI_KERNELS:
                err = tri_kernel_vs_plain(torch, tri_mul, name, cases[name],
                                          f"{str(dtype)[6:]} C={C}")
                worst[name] = max(worst[name], err)
            # the whole op, forward and backward, outgoing and incoming, against
            # the plain path on the CPU
            x = cases["prologue_fwd"][0]
            w = cases["epilogue_fwd"][2:]
            params = {"ln_in": w[0:2], "out_gate": w[2:4], "ln_out": w[4:6], "out_proj": w[6:8],
                      "a_gate": cases["prologue_fwd"][4:6], "a_proj": cases["prologue_fwd"][6:8],
                      "b_gate": cases["prologue_fwd"][8:10], "b_proj": cases["prologue_fwd"][10:12]}
            pair = x.reshape(B, L, L, C)
            mask = cases["mask"]
            ct = cases["epilogue_bwd"][-1].reshape(pair.shape)
            for outgoing in (True, False):
                outs = []
                for d in (dev, torch.device("cpu")):
                    leaves = [pair.detach().to(d).requires_grad_()] + [
                        v.detach().to(d).requires_grad_() for pair_ in params.values() for v in pair_]
                    it = iter(leaves[1:])
                    prm = {k: (next(it), next(it)) for k in params}
                    y = tri_mul.fused_triangle_multiplication(leaves[0], mask.to(d), prm, outgoing)
                    grads = torch.autograd.grad(y, leaves, ct.to(d))
                    outs.append([y.detach().cpu()] + [g.cpu() for g in grads])
                torch.cuda.synchronize()
                errs = [tri_budget(torch, r, o, f"op outgoing={outgoing} {dtype} C={C} L={L} #{i}")[0]
                        for i, (o, r) in enumerate(zip(*outs))]
                say(f"  fused_triangle_multiplication {str(dtype)[6:]} C={C} L={L} outgoing={outgoing}: "
                    f"out {errs[0]:.2e}, grads max {max(errs[1:]):.2e} over {len(errs) - 1} leaves")
    return worst


def ptxas_lines(log_path):
    """One line per kernel from an ``nvcc -Xptxas -v`` log: its (demangled
    enough) name, registers, stack and spills."""
    if not log_path.is_file():
        return []
    out, name = [], None
    for ln in log_path.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            spill = ""
            k = re.search(r"\d+([a-z_]+_kernel)I(f|13__nv_bfloat16)(?:Li(\d+)E)?E", m.group(1))
            name = (f"{k.group(1)}<{'float' if k.group(2) == 'f' else 'bf16'}"
                    f"{', ' + k.group(3) if k.group(3) else ''}>" if k else m.group(1))
        elif "spill" in ln and name:
            spill = ln.strip()
        elif "registers" in ln and name:
            out.append(f"{name}: {ln.split(':', 1)[1].strip()}; {spill}")
            name = None
    return out


def build_all(cuda_lib, pair_maps, tri_mul, model_features, flash_attn):
    """Build K1, K3, K4-K7 and K8/K9 at once (one nvcc each, started
    together); returns {library: (path, built or loaded, seconds)}."""
    libs = {"pair_maps": (pair_maps.load_library, cuda_lib.library_path("pair_maps", pair_maps._SOURCES)),
            "tri_mul": (tri_mul.load_library, tri_mul.library_path()),
            "model_features": (model_features.load_library, model_features.library_path()),
            "flash_attn": (flash_attn.load_library, flash_attn.library_path())}

    def one(item):
        name, (load, path) = item
        prebuilt = path.is_file()
        t0 = time.perf_counter()
        load()
        return name, (path, "loaded prebuilt" if prebuilt else "built", time.perf_counter() - t0)

    with concurrent.futures.ThreadPoolExecutor(len(libs)) as ex:
        return dict(ex.map(one, libs.items()))


K3_EDGE = 1e-3   # bins may differ only where d_cb lies this close to a bin edge (angstroms)


def bf16_ulp(torch, x):
    """One bf16 ulp at |x| (the spacing of bf16 values around it), taken at
    1e-4 for smaller values, as in tests/test_torch_model_features.py."""
    a = x.float().abs().clamp_min(1e-4)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def k3_compare(torch, mf, x, label, n_bins=36, max_dist=20.0):
    """K3 against its plain version on the same card tensor, f32 and bf16
    planes; returns (largest plane error, bin mismatches, pairs near an edge)."""
    worst, mismatches, near_edge = 0.0, 0, 0
    cb = x[:, :, 4]
    d = torch.sqrt(((cb[:, :, None] - cb[:, None]) ** 2).sum(-1))
    width = max_dist / n_bins
    edge_dist = (d / width - torch.round(d / width)).abs() * width
    near = edge_dist < K3_EDGE
    for dt in (torch.float32, torch.bfloat16):
        bins, ang = mf.model_features(x, n_bins, max_dist, dt)
        torch.cuda.synchronize()
        rbins, rang = mf._model_features_plain(x, n_bins, max_dist, dt)
        check(bins.shape == rbins.shape and ang.shape == rang.shape and ang.dtype == dt,
              f"K3 {label}: shapes {tuple(bins.shape)} {tuple(ang.shape)} {ang.dtype}")
        off = bins != rbins
        check(not bool((off & ~near).any()),
              f"K3 {label} {dt}: {int((off & ~near).sum())} bins differ away from an edge")
        mismatches = max(mismatches, int(off.sum()))
        diff = (ang.float() - rang.float()).abs()
        err = float(diff.max()) if diff.numel() else 0.0
        if dt == torch.float32:
            check(err <= 1e-5, f"K3 {label} f32 planes: max err {err:.3e} > 1e-5")
        else:
            over = diff > bf16_ulp(torch, rang)
            check(not bool(over.any()), f"K3 {label} bf16 planes: {int(over.sum())} entries "
                  f"beyond one bf16 ulp, max err {err:.3e}")
        worst = max(worst, err)
    near_edge = int(near.sum())
    say(f"  K3 {label} B={x.shape[0]} L={x.shape[1]}: planes max err {worst:.2e}; bins differ at "
        f"{mismatches} pairs (all within {K3_EDGE} A of an edge; {near_edge} pairs that close)")
    return worst, mismatches, near_edge


def k3_parity(torch, dev):
    """Phase 10: K3 vs its plain version on ragged L, the degenerate probes and
    the [model-fused] shape B=256, L=512 (in chunks for the plain version)."""
    import numpy as np
    from protstruc_tpu_torch.ops import model_features as mf

    rng = np.random.RandomState(1)
    cases = {f"L{L}": torch.from_numpy((rng.randn(2, L, 15, 3) * 10).astype(np.float32)).to(dev)
             for L in (37, 300)}
    cases["probes"] = probes(torch, dev)
    worst, total_mis = 0.0, 0
    for label, x in cases.items():
        err, mis, _ = k3_compare(torch, mf, x, label)
        worst, total_mis = max(worst, err), total_mis + mis
    xyz = torch.from_numpy(np.random.RandomState(0).randn(B_FULL, L_FULL, 15, 3).astype(np.float32) * 10).to(dev)
    for b0 in range(0, B_FULL, 64):
        err, mis, _ = k3_compare(torch, mf, xyz[b0:b0 + 64].contiguous(), f"full[{b0}:{b0 + 64}]")
        worst, total_mis = max(worst, err), total_mis + mis
    return worst, total_mis


FLASH_SHAPES = (  # (label, B, H, dh, L)
    ("train", 4, 4, 32, 256),     # the FoldModel train step's node attention
    ("ragged", 2, 4, 32, 37),     # batch row 1 fully masked
    ("ragged", 2, 4, 32, 300),
    ("attn", 1, 8, 32, 4096),     # bench.py [attn]: last 100 keys masked
)


def flash_inputs(torch, dev, dtype, label, B, H, dh, L, seed=0):
    """q, k, v as views of one (B, L, 3, H, dh) projection, bias, kmask and
    the output cotangent, drawn on the card.  The train shape's bias is the
    permuted (B, L, L, H) layout the model passes; the others are contiguous."""
    gen = torch.Generator(dev).manual_seed(seed)
    qkv = torch.randn((B, L, 3, H, dh), generator=gen, device=dev).to(dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    if label == "train":
        bias = torch.randn((B, L, L, H), generator=gen, device=dev).to(dtype).permute(0, 3, 1, 2)
    else:
        bias = torch.randn((B, H, L, L), generator=gen, device=dev).to(dtype)
    kmask = torch.ones((B, L), dtype=torch.bool, device=dev)
    if label == "ragged":
        kmask[0, L // 3] = False
        kmask[0, -3:] = False
        kmask[1] = False
    elif label == "attn":
        kmask[:, -100:] = False
    do = torch.randn((B, L, H, dh), generator=gen, device=dev).to(dtype)
    return q, k, v, bias, kmask, do


# f32 budgets (tests/test_flash_attn.py, BASELINE.md:31-37), times max(1, max|ref|);
# bf16 outputs: 2e-2 of the output's own max|ref| (test_bfloat16_inputs' atol,
# without the floor of 1, which would pass a zero ds: |ds| is ~1e-3 at [attn])
FLASH_F32 = {"out": 2e-5, "lse": 2e-5, "ds": 5e-4, "dq": 5e-5, "dk": 5e-5, "dv": 5e-5}
FLASH_BF16 = 2e-2


def flash_budget(torch, ref, out, name, key, live=None):
    """The largest error of ``out`` against ``ref`` over the entries ``live``
    selects (all by default), held to its budget; returns (error, error over
    max|ref|)."""
    check(ref.shape == out.shape and ref.dtype == out.dtype,
          f"{name}: {tuple(out.shape)} {out.dtype} vs {tuple(ref.shape)} {ref.dtype}")
    check(bool(torch.isfinite(out.float()).all()), f"{name}: non-finite output")
    r, o = (ref.float(), out.float()) if live is None else (ref.float()[live], out.float()[live])
    err = float((r - o).abs().max()) if r.numel() else 0.0
    top = float(r.abs().max()) if r.numel() else 0.0
    if out.dtype == torch.float32:
        tol = FLASH_F32[key] * max(1.0, top)
    else:
        tol = FLASH_BF16 * top
    check(err <= tol, f"{name}: max err {err:.3e} > {tol:.3e} (max|ref| {top:.3e})")
    return err, err / max(top, 1e-30)


def flash_vs_plain(torch, fa, args, label):
    """K8 and K9 against their plain versions on the same card tensors (K9
    from the plain forward's lse and delta), plus dq = ds k from each ds;
    fully-masked rows must be exact zeros.  Returns {fwd, bwd: max error}."""
    q, k, v, bias, kmask, do = args
    out, lse = fa.flash_fwd(q, k, v, bias, kmask)
    torch.cuda.synchronize()
    r_out, r_lse = fa._flash_fwd_plain(q, k, v, bias, kmask)
    delta = (do.float() * r_out.float()).sum(-1).permute(0, 2, 1).contiguous()
    got = fa.flash_bwd(q, k, v, bias, kmask, do, r_lse, delta)
    torch.cuda.synchronize()
    ref = fa._flash_bwd_plain(q, k, v, bias, kmask, do, r_lse, delta)
    got = {"out": out, "lse": lse, "ds": got[0], "dk": got[1], "dv": got[2],
           "dq": fa.dq_from_ds(got[0], k)}
    ref = {"out": r_out, "lse": r_lse, "ds": ref[0], "dk": ref[1], "dv": ref[2],
           "dq": fa.dq_from_ds(ref[0], k)}
    dead = ~kmask.any(-1)
    live_rows = (~dead)[:, None, None].expand_as(ref["lse"])  # the pinned lse is checked below
    errs = {key: flash_budget(torch, ref[key], got[key], f"flash {label} {key}", key,
                              live_rows if key == "lse" else None) for key in got}
    if bool(dead.any()):
        for key in ("out", "dq", "dk", "dv"):
            check(bool((got[key][dead] == 0).all()), f"flash {label}: {key} of a fully-masked row not 0")
        check(bool((got["ds"][dead] == 0).all()), f"flash {label}: ds of a fully-masked row not 0")
        check(bool((got["lse"][dead] == fa.LSE_MASKED).all()), f"flash {label}: lse pin")
    say(f"  flash {label}: " + ", ".join(f"{key} {e:.2e} ({rel:.2e} of max|ref|)"
                                         for key, (e, rel) in errs.items()))
    return {"fwd": max(errs["out"][0], errs["lse"][0]),
            "bwd": max(errs[key][0] for key in ("ds", "dk", "dv", "dq"))}


def flash_parity(torch, dev):
    """Phase 11: K8/K9 vs their plain versions, f32 and bf16, at every shape."""
    from protstruc_tpu_torch.ops import flash_attn as fa

    worst = {"fwd": 0.0, "bwd": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for label, B, H, dh, L in FLASH_SHAPES:
            args = flash_inputs(torch, dev, dtype, label, B, H, dh, L)
            errs = flash_vs_plain(torch, fa, args, f"{label} {str(dtype)[6:]} B={B} H={H} dh={dh} L={L}")
            for key in worst:
                worst[key] = max(worst[key], errs[key])
            del args
            torch.cuda.empty_cache()
    return worst


def zero_grad_entries(torch, key, g):
    """Entries whose exact gradient is 0, where both paths return rounding
    noise: the pair-bias biases (trunk and IPA) and the key biases (``qkv``'s
    key third, IPA's ``k_scalar``) each add a per-head constant to every logit
    of a softmax row; and at the FoldModel's init (zero backbone-update
    kernel, so every residue's frame moves alike) the backbone update's bias
    is one rigid motion of the whole chain, which FAPE, lDDT and IPA do not
    see."""
    mask = torch.zeros_like(g, dtype=torch.bool)
    if key.endswith(("attn.pair_bias.bias", "ipa.pair_bias.bias", "ipa.k_scalar.bias",
                     "backbone_update.update.bias")):
        mask[...] = True
    elif key.endswith("attn.qkv.bias"):
        mask[1] = True
    return mask


def grad_error(torch, ref, got):
    """The largest error of ``got`` against ``ref`` (gradients by name) over
    each leaf's largest entry, as ``(leaf, ratio)``; the exact-zero entries of
    zero_grad_entries must stay within 1e-5 of the largest gradient."""
    worst_leaf, worst_rel = None, 0.0
    top = max(float(g.abs().max()) for g in ref.values())
    for k, r in ref.items():
        g, zero = got[k], zero_grad_entries(torch, k, r)
        if zero.any():
            noise = max(float(g[zero].abs().max()), float(r[zero].abs().max()))
            check(noise <= 1e-5 * top, f"{k}: zero-gradient entries {noise:.3e} vs top {top:.3e}")
        if zero.all():
            continue
        rel = float((g - r)[~zero].abs().max()) / max(float(r[~zero].abs().max()), 1e-30)
        if rel > worst_rel:
            worst_leaf, worst_rel = k, rel
    return worst_leaf, worst_rel


def train_models(torch, dev, cfg_kwargs, xyz_np):
    """Featurize ``xyz_np`` on the card through K1, then a fused and an unfused
    TrFold from one seeded init; returns (feats, {fused: (model, params,
    opt_state, tx)}, the initial state_dict)."""
    import protstruc_tpu_torch as pt
    from protstruc_tpu_torch.models.trfold import (
        TrFold, TrFoldConfig, featurize_for_model, make_train_state)

    sb = pt.StructureBatch.from_xyz(xyz_np, device=dev)
    feats = featurize_for_model(sb, use_kernel=True)
    models, init = {}, None
    for fused in (True, False):
        model = TrFold(TrFoldConfig(fused_tri=fused, **cfg_kwargs), device=dev)
        state = make_train_state(model, feats, torch.Generator().manual_seed(0), device=dev)
        if init is None:
            init = {k: v.clone() for k, v in model.state_dict().items()}
        model.load_state_dict(init)
        models[fused] = (model, *state)
    return feats, models, init


def run_steps(feats, entry, n):
    """``n`` train steps of one (model, params, opt_state, tx); their losses."""
    from protstruc_tpu_torch.models.trfold import train_step

    model, params, opt_state, tx = entry
    losses = []
    for _ in range(n):
        params, opt_state, loss = train_step(params, opt_state, feats, model, tx)
        losses.append(float(loss))
    return losses


def compare_losses(fused, plain, rtol, label):
    for i, (a, b) in enumerate(zip(fused, plain)):
        check(abs(a - b) <= rtol * abs(b), f"{label} step {i}: fused loss {a!r} vs unfused {b!r}")


# -- bounds: the least time an H100 SXM could take for a call ------------------
HBM_BYTES_PER_S = 3.35e12                                # HBM3, NVIDIA's data sheet
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}  # f32 outside the tensor cores; bf16 dense
# float32 operations per (b, i, j) pair, counted from the kernel sources (an
# atan2f counted as 15): K1's three distances, two dihedrals and one angle;
# K3's distance and bin, two dihedrals' sin/cos and phi's, each by one rsqrt
K1_OPS_PER_PAIR, K3_OPS_PER_PAIR = 204, 144
# (N, C) x (C, C) products of K4-K7 (2 N C^2 operations each): forward, or
# recompute + input gradient + weight gradient
TRI_PRODUCTS = {"prologue_fwd": 4, "prologue_bwd": 12, "epilogue_fwd": 2, "epilogue_bwd": 6}


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


# the atom slots of xyz (B, L, A, 3) a kernel reads: K1 N, CA, O, CB; K3 N, CA, CB
K1_SLOTS, K3_SLOTS = 4, 3


def slot_bytes(xyz, n_slots):
    """Bytes of ``n_slots`` atom slots of every residue of ``xyz``."""
    return xyz.shape[0] * xyz.shape[1] * n_slots * 3 * xyz.element_size()


def bound(n_bytes, ops, dtype):
    """(ms, "bytes" or "operations"): the larger of the bytes over the HBM
    rate and the operations over the peak rate of ``dtype``."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[str(dtype).rsplit(".", 1)[-1]] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_ops(kmask, H, dh, products):
    """2 L Lk dh operations per (L, Lk, dh) product and (b, h), Lk the keys
    this run's mask allows in row b (masked keys need no work)."""
    L = kmask.shape[1]
    return products * 2 * H * L * dh * int(kmask.sum())


# -- the FoldModel slice ------------------------------------------------------
# experiments/fold_loo.py:36-48: the leave-one-out sweep's structures; its
# run_fold trains on all but the held-out one and the duplicate complex
LOO_FILES = ("1REX.pdb", "4EOT.pdb", "4uuj.pdb", "8dtk.pdb", "8gpi.pdb", "8ilx.pdb", "6dc4.pdb",
             "15c8_HL.pdb", "1a3r_HL.pdb", "1a6v_HL.pdb", "1a6v_JN.pdb", "1ad0_DC.pdb",
             "5cjx_HL.pdb")
HELD_OUT, DUPLICATE = "1REX.pdb", "1a6v_JN.pdb"
# its TrainConfig (fold_loo.py:57-63) with --flash-attn; 4 heads and 6 IPA
# iterations are TrainConfig's defaults, float32 (no --bf16) as there
FOLD_ARGV = ("--batch-size", "4", "--crop", "256", "--node-dim", "128", "--pair-dim", "64",
             "--blocks", "4", "--recycle", "1", "--pair-update", "triangle", "--remat",
             "--fused-tri", "--flash-attn", "--seed", "0")
FOLD_STEPS, FOLD_SAVE_EVERY = 8, 4
BATCH_FILES = ("4uuj.pdb", "8dtk.pdb", "6dc4.pdb", "1ad0_DC.pdb")  # 434-545 residues: all cropped
CROP_SEED = 7


def reset_launches(*modules):
    for m in modules:
        if isinstance(m.LAUNCHES, dict):
            for k in m.LAUNCHES:
                m.LAUNCHES[k] = 0
        else:
            m.LAUNCHES = 0


@contextlib.contextmanager
def plain_k3():
    """Inside, ``featurize_for_model(fused=True)`` takes K3's plain version
    on card tensors too: the plain path of phases 12 and 13."""
    from protstruc_tpu_torch.ops import model_features as mf

    kernel = mf.model_features
    mf.model_features = mf._model_features_plain
    try:
        yield
    finally:
        mf.model_features = kernel


def device_profile(torch, fn, top=6):
    """One call of ``fn`` under torch.profiler: (wall ms, device-busy ms, the
    ``top`` kernels by device time as (name, ms, calls))."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # device events only; a record_function span (AdamW.step's) shows on the
    # device timeline too and is no kernel
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    kernels.sort(key=lambda k: -k[1])
    return wall, sum(k[1] for k in kernels), kernels[:top]


def fold_main_path(dev, tmp):
    """Phase 12's main path through the CLI: ``train`` (checkpoints, evals,
    metrics.jsonl), then ``fold`` of the held-out sequence.  Returns (the
    train command's metrics, its logged losses, its eval rows, its saved
    TrainConfig, the folded PDB's line)."""
    from protstruc_tpu_torch.__main__ import main as cli
    from protstruc_tpu_torch.models.checkpoint import all_steps
    from protstruc_tpu_torch.pdbio.parser import parse_pdb
    from protstruc_tpu_torch.train import TrainConfig
    import numpy as np

    ck, out_pdb = tmp / "ck", tmp / "fold_1REX.pdb"
    train_paths = [str(DATA / f) for f in LOO_FILES if f not in (HELD_OUT, DUPLICATE)]
    argv = ["train", *train_paths, "--checkpoint-dir", str(ck), "--steps", str(FOLD_STEPS),
            "--save-every", str(FOLD_SAVE_EVERY), *FOLD_ARGV, "--eval", str(DATA / HELD_OUT),
            "--device", str(dev)]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        check(cli(argv) == 0, "train returned non-zero")
    metrics = json.loads(out.getvalue().strip().splitlines()[-1])
    rows = [json.loads(ln) for ln in (ck / "metrics.jsonl").read_text().splitlines()]
    losses = [r["loss"] for r in rows if "loss" in r]
    evals = [r for r in rows if "eval_ca_lddt" in r]
    check(metrics["steps"] == FOLD_STEPS and len(losses) == FOLD_STEPS,
          f"train: {metrics}; {len(losses)} loss records")
    check(all(map(math.isfinite, losses)), f"non-finite losses {losses}")
    saves = list(range(FOLD_SAVE_EVERY, FOLD_STEPS + 1, FOLD_SAVE_EVERY))
    check([r["step"] for r in evals] == saves
          and all(math.isfinite(r[k]) for r in evals for k in ("eval_ca_lddt", "eval_ca_rmsd")),
          f"eval rows {evals}")
    check(all_steps(str(ck)) == saves, f"checkpoints {all_steps(str(ck))}")
    cfg = TrainConfig.from_json((ck / "config.json").read_text())
    check(cfg.use_flash_attn and cfg.fused_tri and not cfg.bf16, f"saved config {cfg}")

    seq = ":".join(parse_pdb(str(DATA / HELD_OUT)).seq_dict().values())
    out = io.StringIO()
    with contextlib.redirect_stdout(out), warnings.catch_warnings():
        warnings.simplefilter("ignore")  # a structure-conditioned checkpoint folds out of distribution
        check(cli(["fold", "--checkpoint-dir", str(ck), "--seq", seq, "--out", str(out_pdb),
                   "--device", str(dev)]) == 0, "fold returned non-zero")
    folded = parse_pdb(str(out_pdb))
    backbone = folded.atom_xyz[:, :4]
    check(folded.n_residues == len(seq.replace(":", "")) and bool(np.isfinite(backbone).all()),
          f"folded PDB: {folded.n_residues} residues for {len(seq)}, finite {np.isfinite(backbone).all()}")
    return metrics, losses, evals, cfg, out.getvalue().strip()


def fold_models(torch, dev, cfg):
    """One batch of real structures (BATCH_FILES) and a FoldModel per path
    from one init: the kernel path (``cfg``: flash and fused_tri on) and the
    plain path (both off).  Returns (batch, {kernel: (model, cfg)}, the
    initial state_dict)."""
    import protstruc_tpu_torch as pt
    from protstruc_tpu_torch.train import _build_model

    sb = pt.StructureBatch.from_pdb([str(DATA / f) for f in BATCH_FILES], device=dev)
    models, init = {}, None
    for kernel in (True, False):
        c = dataclasses.replace(cfg, use_flash_attn=kernel, fused_tri=kernel)
        model = _build_model(c, dev)
        if init is None:
            model.reset_parameters(torch.Generator().manual_seed(cfg.seed))
            init = {k: v.clone() for k, v in model.state_dict().items()}
        model.load_state_dict(init)
        models[kernel] = (model, c)
    return sb, models, init


def fold_featurize(torch, batch, model, cfg, kernel):
    """The train loop's crop and featurization (seeded crop, K3 or its plain
    version); returns (feats, the cropped ground truth xyz)."""
    from protstruc_tpu_torch.train import _featurize

    with contextlib.nullcontext() if kernel else plain_k3():
        feats, _, crop = _featurize(batch, cfg, model.trunk_cfg,
                                    generator=torch.Generator().manual_seed(CROP_SEED))
    return feats, crop.xyz


def flash_timings(torch, dev, fa, label, dtype, B, H, dh, L):
    """K8 and K9 at one shape beside their plain versions and SDPA with the
    additive mask (forward without autograd; backward as one autograd.grad
    over a kept graph).  Returns {fwd, bwd: (kernel ms, plain ms, SDPA ms,
    bound ms, bound_by)}."""
    import torch.nn.functional as F

    q, k, v, bias, kmask, do = flash_inputs(torch, dev, dtype, label, B, H, dh, L)
    out, lse = fa.flash_fwd(q, k, v, bias, kmask)
    delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
    fwd_args, bwd_args = (q, k, v, bias, kmask), (q, k, v, bias, kmask, do, lse, delta)
    fwd_plain, fwd_ms, _ = alternate(lambda: fa._flash_fwd_plain(*fwd_args), lambda: fa.flash_fwd(*fwd_args))
    bwd_plain, bwd_ms, _ = alternate(lambda: fa._flash_bwd_plain(*bwd_args), lambda: fa.flash_bwd(*bwd_args))
    ds, dk, dv = fa.flash_bwd(*bwd_args)

    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    mask = bias.masked_fill(~kmask[:, None, None, :], float("-inf")).detach().requires_grad_()

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

    lib_fwd = cuda_time_ms(sdpa_fwd)
    o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    g = do.transpose(1, 2)
    lib_bwd = cuda_time_ms(lambda: torch.autograd.grad(o, (qt, kt, vt, mask), g, retain_graph=True))
    fwd_bound = bound(nbytes(q, k, v, bias, kmask, out, lse), flash_ops(kmask, H, dh, 2), dtype)
    bwd_bound = bound(nbytes(q, k, v, bias, kmask, do, lse, delta, ds, dk, dv),
                      flash_ops(kmask, H, dh, 4), dtype)
    return {"fwd": (fwd_ms, fwd_plain, lib_fwd, *fwd_bound),
            "bwd": (bwd_ms, bwd_plain, lib_bwd, *bwd_bound)}


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import protstruc_tpu_torch as pt
    from protstruc_tpu_torch.__main__ import serve_loop
    from protstruc_tpu_torch.models.trfold import loss_fn, train_step
    from protstruc_tpu_torch.models.ipa import fold_loss_fn
    from protstruc_tpu_torch.ops import cuda_lib, flash_attn, model_features, pair_maps, tri_mul
    from protstruc_tpu_torch.ops.pair_maps import _pair_maps_plain, pairwise_maps
    from protstruc_tpu_torch.train import TrainOptimizer
    from protstruc_tpu_torch.train import train_step as fold_train_step
    from protstruc_tpu_torch.utils.aot import _featurize, precompile_featurizer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # -- 1. device ------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    say(smi)
    say(f"phase 1 device: {kind} sm_{cap[0]}{cap[1]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, count {torch.cuda.device_count()} [{smi}]")
    check(cap == (9, 0), f"the kernels are built for sm_90a; this card is sm_{cap[0]}{cap[1]}")

    # -- 2. build -------------------------------------------------------------
    builds = build_all(cuda_lib, pair_maps, tri_mul, model_features, flash_attn)
    for name, kernels in (("pair_maps", "K1"), ("model_features", "K3"), ("tri_mul", "K4-K7"),
                          ("flash_attn", "K8/K9")):
        lib_path, how, build_s = builds[name]
        say(f"phase 2 build: {how} {lib_path.name} ({kernels}) in {build_s:.2f} s "
            f"({cuda_lib.find_nvcc()}, the four started together)")
        for ln in ptxas_lines(lib_path.with_suffix(".log")):
            say(f"  ptxas: {ln}")

    # -- 3. parity at small sizes ---------------------------------------------
    rng = np.random.RandomState(1)
    small = {f"B2 L{L}": torch.from_numpy((rng.randn(2, L, 15, 3) * 10).astype(np.float32)).to(dev)
             for L in (37, 300)}
    small["probes"] = probes(torch, dev)
    worst_small = 0.0
    for label, x in small.items():
        got = pairwise_maps(x)
        torch.cuda.synchronize()
        worst_small = max(worst_small, compare_maps(_pair_maps_plain(x), got, label))
    sub = pairwise_maps(small["B2 L300"], maps=("d_cb", "phi"))
    full = pairwise_maps(small["B2 L300"])
    check(tuple(sub) == ("d_cb", "phi"), "map subset order")
    for k in sub:
        check(torch.equal(sub[k].nan_to_num(), full[k].nan_to_num()), f"subset {k} differs")
    say(f"phase 3 parity small: ok, max err {worst_small:.3e}; map subset ok")

    # -- 4. parity at full size -----------------------------------------------
    xyz_np = np.random.RandomState(0).randn(B_FULL, L_FULL, 15, 3).astype(np.float32) * 10
    xyz = torch.from_numpy(xyz_np).to(dev)
    got = pairwise_maps(xyz)
    torch.cuda.synchronize()
    worst_full, above = 0.0, {k: 0 for k in got}
    chunk = 32
    for b0 in range(0, B_FULL, chunk):
        ref = _pair_maps_plain(xyz[b0:b0 + chunk])
        for k in ref:
            err, n = compare(ref[k], got[k][b0:b0 + chunk], f"full {k}")
            worst_full = max(worst_full, err)
            above[k] += n
        del ref
    say(f"phase 4 parity full B={B_FULL} L={L_FULL}: ok, max err {worst_full:.3e}; "
        f"entries above 1e-5: {above}")
    del got

    # -- 5. main path ---------------------------------------------------------
    paths = [str(DATA / p) for p in PDBS]
    cpu_sb = pt.StructureBatch.from_pdb(paths, device="cpu")
    cpu_g = cpu_sb.inter_residue_geometry()
    cpu_d, cpu_m = cpu_sb.backbone_dihedrals()
    cpu_f = cpu_sb.backbone_orientations()
    singles = {p: pt.StructureBatch.from_pdb(str(DATA / p), device="cpu") for p in PDBS[:2]}

    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        reqs = [{"op": "ping"}]
        reqs += [{"op": "featurize", "path": str(DATA / p), "out": str(tmp / f"{p}.npz")}
                 for p in singles]
        reqs += [{"op": "featurize", "path": str(tmp / "missing.pdb"), "out": str(tmp / "x.npz")},
                 {"op": "analyze", "path": str(DATA / PDBS[0])},
                 {"op": "shutdown"}]
        out = io.StringIO()

        pair_maps.LAUNCHES = 0
        t0 = time.perf_counter()
        sb = pt.StructureBatch.from_pdb(paths, device="cuda")
        g = sb.inter_residue_geometry()
        d, m = sb.backbone_dihedrals()
        frames = sb.backbone_orientations()
        torch.cuda.synchronize()
        feat = precompile_featurizer(batch_sizes=(1,), buckets=(256, 512), device="cuda")
        rc = serve_loop(io.StringIO("\n".join(json.dumps(r) for r in reqs)), out,
                        buckets=(256, 512), device="cuda")
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        launches = pair_maps.LAUNCHES

        check(sb.device.type == "cuda" and g["d_cb"].is_cuda, "main path did not run on the card")
        compare_maps(cpu_g, {k: v.cpu() for k, v in g.items()},
                     f"from_pdb B={sb.batch_size} L={sb.n_residues} vs CPU")
        compare(cpu_d, d.cpu(), "dihedrals")
        compare(cpu_m, m.cpu(), "dihedral_mask")
        compare(cpu_f, frames.cpu(), "frames")
        check(feat.shapes == [(1, 256), (1, 512)], f"warmed shapes {feat.shapes}")

        check(rc == 0, f"serve_loop returned {rc}")
        lines = [json.loads(ln) for ln in out.getvalue().splitlines()]
        check(len(lines) == len(reqs) + 1, f"{len(lines)} replies to {len(reqs)} requests")
        check(lines[0] == {"ok": True, "ready": True, "shapes": [[1, 256], [1, 512]]},
              f"ready line {lines[0]}")
        check(lines[1] == {"ok": True}, f"ping reply {lines[1]}")
        for reply, (p, single) in zip(lines[2:4], singles.items()):
            check(reply.get("ok") and reply["n_residues"] == single.n_residues,
                  f"featurize {p}: {reply}")
            npz = np.load(reply["out"])
            ref = dict(single.inter_residue_geometry())
            ref["dihedrals"], ref["dihedral_mask"] = single.backbone_dihedrals()
            ref["frames"] = single.backbone_orientations()
            check(sorted(npz.files) == sorted(ref), f"npz keys {sorted(npz.files)}")
            compare_maps(ref, {k: torch.from_numpy(npz[k]) for k in ref}, f"served {p}")
        check(not lines[4]["ok"] and lines[4]["error"].startswith("FileNotFoundError"),
              f"bad path reply {lines[4]}")
        check(not lines[5]["ok"] and "not yet ported" in lines[5]["error"],
              f"analyze reply {lines[5]}")
        check(lines[6] == {"ok": True, "bye": True}, f"shutdown reply {lines[6]}")
    check(launches > 0, "the main path launched K1 no time")
    say(f"phase 5 main path: ok in {main_s:.2f} s; {len(reqs)} requests served; "
        f"K1 launches {launches}")

    # -- 6. timing ------------------------------------------------------------
    plain_ms, kernel_ms, rounds = alternate(lambda: _pair_maps_plain(xyz), lambda: pairwise_maps(xyz))
    say(f"phase 6 timing K1 B={B_FULL} L={L_FULL} [{smi}]: kernel {kernel_ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms (plain/kernel/kernel/plain {', '.join(f'{r:.4f}' for r in rounds)})")
    am = torch.ones((B_FULL, L_FULL, 15), dtype=torch.bool, device=dev)
    ci = torch.zeros((B_FULL, L_FULL), dtype=torch.int32, device=dev)
    peak = {}

    def run(use_kernel):
        def fn():
            with torch.inference_mode():
                _featurize(xyz, am, ci, use_kernel)
        return fn

    for name, use_kernel in (("kernel", True), ("plain", False)):
        torch.cuda.reset_peak_memory_stats()
        run(use_kernel)()
        torch.cuda.synchronize()
        peak[name] = torch.cuda.max_memory_allocated() / 2**30
    feat_plain, feat_kernel, rounds = alternate(run(False), run(True))
    bytes_out = B_FULL * L_FULL * L_FULL * 24
    say(f"phase 6 timing featurize B={B_FULL} L={L_FULL} [{smi}]: "
        f"kernel path {feat_kernel:.4f} ms = {B_FULL / feat_kernel * 1e3:.1f} structures/s "
        f"(peak {peak['kernel']:.2f} GiB), plain path {feat_plain:.4f} ms = "
        f"{B_FULL / feat_plain * 1e3:.1f} structures/s (peak {peak['plain']:.2f} GiB) "
        f"(plain/kernel/kernel/plain {', '.join(f'{r:.4f}' for r in rounds)}); "
        f"K1 writes {bytes_out / kernel_ms / 1e6:.1f} GB/s of maps")

    # -- 7. triangle kernels ---------------------------------------------------
    tri_worst = tri_kernel_parity(torch, dev)
    say(f"phase 7 parity K4-K7: ok, max abs err {tri_worst}")

    # -- 8. train path ---------------------------------------------------------
    xyz_train = np.random.RandomState(0).randn(4, L_FULL, 15, 3).astype(np.float32) * 5.0
    cfg = dict(TRAIN_WIDTH, dtype=torch.bfloat16)
    pair_maps.LAUNCHES = 0
    for k in tri_mul.LAUNCHES:
        tri_mul.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    feats, models, init = train_models(torch, dev, cfg, xyz_train)
    fused_losses = run_steps(feats, models[True], TRAIN_STEPS)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = dict(tri_mul.LAUNCHES)
    k1_train = pair_maps.LAUNCHES
    check(feats["d_cb"].is_cuda, "the train path did not featurize on the card")
    check(all(np.isfinite(fused_losses)), f"non-finite losses {fused_losses}")
    for k, n in train_launches.items():
        check(n > 0, f"the train path launched {k} no time")
    check(k1_train > 0, "the train path launched K1 no time")
    plain_losses = run_steps(feats, models[False], TRAIN_STEPS)
    compare_losses(fused_losses, plain_losses, 2e-2, "bf16 B=4 L=512")
    say(f"phase 8 train path bf16 B=4 L={L_FULL} {TRAIN_WIDTH}: ok in {train_s:.2f} s; "
        f"losses fused {fused_losses}, unfused {plain_losses}; launches K1 {k1_train}, "
        f"{train_launches}")

    xyz_small = np.random.RandomState(3).randn(1, 128, 15, 3).astype(np.float32) * 5.0
    feats32, models32, _ = train_models(torch, dev, dict(TRAIN_WIDTH, dtype=torch.float32), xyz_small)
    grads = {}
    for fused, (model, params, _, _) in models32.items():
        loss_fn(params, model, feats32).backward()
        grads[fused] = {k: p.grad.detach().clone() for k, p in params.items()}
        model.zero_grad(set_to_none=True)
    worst_leaf, worst_rel = grad_error(torch, grads[False], grads[True])
    check(worst_rel <= 1e-4, f"f32 gradient of {worst_leaf}: relative error {worst_rel:.3e} > 1e-4")
    l32 = {fused: run_steps(feats32, entry, TRAIN_STEPS) for fused, entry in models32.items()}
    compare_losses(l32[True], l32[False], 1e-5, "f32 B=1 L=128")
    say(f"phase 8 train path f32 B=1 L=128: ok; losses fused {l32[True]}, unfused {l32[False]}; "
        f"largest relative gradient error {worst_rel:.3e} ({worst_leaf}) over {len(grads[True])} leaves")
    del feats32, models32, grads

    # -- 9. timing: train step and K4-K7 ---------------------------------------
    # Three steps already moved the parameters far from the init (the loss
    # grows), so every timed step starts again from the initial parameters:
    # each times the same workload, on sound values.
    step_ms, peak, step_losses = {}, {}, {True: [], False: []}

    def stepper(fused):
        model, params, opt_state, tx = models[fused]
        state = model.state_dict()
        leaves = [(state[k], v) for k, v in init.items()]

        def step():
            with torch.no_grad():
                for leaf, v in leaves:
                    leaf.copy_(v)
            step_losses[fused].append(train_step(params, opt_state, feats, model, tx)[2])
        return step

    for fused in (True, False):
        torch.cuda.reset_peak_memory_stats()
        stepper(fused)()
        torch.cuda.synchronize()
        peak[fused] = torch.cuda.max_memory_allocated() / 2**30
    step_ms[False], step_ms[True], rounds = alternate(stepper(False), stepper(True))
    for fused, losses in step_losses.items():
        losses = torch.stack(losses).float().cpu()
        check(bool(torch.isfinite(losses).all()), f"timed steps fused_tri={fused}: losses {losses}")
        step_losses[fused] = (float(losses.min()), float(losses.max()), len(losses))
    say(f"phase 9 timing train step bf16 B=4 L={L_FULL} [{smi}]: fused_tri {step_ms[True]:.4f} ms/step "
        f"(peak {peak[True]:.2f} GiB), unfused {step_ms[False]:.4f} ms/step (peak {peak[False]:.2f} GiB) "
        f"(unfused/fused/fused/unfused {', '.join(f'{r:.4f}' for r in rounds)}); each step from the "
        f"initial parameters, losses (min, max, steps) fused {step_losses[True]}, "
        f"unfused {step_losses[False]}")
    del models, feats, init
    torch.cuda.empty_cache()

    tri_ms = {}
    cases = tri_inputs(torch, dev, torch.bfloat16, 128, B=4, L=L_FULL)
    for name in TRI_KERNELS:
        kernel, plain = tri_mul.KERNELS[name]
        err = tri_kernel_vs_plain(torch, tri_mul, name, cases[name], "bf16 C=128 train shape")
        tri_worst[name] = max(tri_worst[name], err)
        got = kernel(*cases[name])
        N, C = cases[name][0].shape
        tri_bound = bound(nbytes(*cases[name], *(got if isinstance(got, tuple) else (got,))),
                          TRI_PRODUCTS[name] * 2 * N * C * C, torch.bfloat16)
        del got
        torch.cuda.empty_cache()
        plain_ms_k, kernel_ms_k, rounds = alternate(lambda: plain(*cases[name]), lambda: kernel(*cases[name]))
        tri_ms[name] = (kernel_ms_k, plain_ms_k, *tri_bound)
        say(f"phase 9 timing {name} bf16 N={N} C={C} [{smi}]: kernel {kernel_ms_k:.4f} ms, "
            f"plain {plain_ms_k:.4f} ms (plain/kernel/kernel/plain {', '.join(f'{r:.4f}' for r in rounds)}); "
            f"bound {tri_bound[0]:.4f} ms ({tri_bound[1]})")
    del cases
    torch.cuda.empty_cache()

    # -- 10. K3 ------------------------------------------------------------------
    t0 = time.perf_counter()
    k3_worst, k3_mismatches = k3_parity(torch, dev)
    say(f"phase 10 parity K3: ok in {time.perf_counter() - t0:.2f} s, max plane err {k3_worst:.3e}, "
        f"{k3_mismatches} bins differ (each within {K3_EDGE} A of an edge)")

    # -- 11. K8/K9 ---------------------------------------------------------------
    t0 = time.perf_counter()
    flash_worst = flash_parity(torch, dev)
    say(f"phase 11 parity K8/K9: ok in {time.perf_counter() - t0:.2f} s, max abs err {flash_worst}")

    # -- 12. main path of the FoldModel slice -------------------------------------
    counters = (model_features, tri_mul, flash_attn)
    with tempfile.TemporaryDirectory() as tmp:
        reset_launches(*counters)
        t0 = time.perf_counter()
        metrics, fold_losses, evals, fold_cfg, fold_line = fold_main_path(dev, pathlib.Path(tmp))
        torch.cuda.synchronize()
        fold_s = time.perf_counter() - t0
        fold_launches = {"model_features": model_features.LAUNCHES,
                         **{f"tri_mul_{k}": n for k, n in tri_mul.LAUNCHES.items()},
                         **{f"flash_attn_{k}": n for k, n in flash_attn.LAUNCHES.items()}}
    for k, n in fold_launches.items():
        check(n > 0, f"the FoldModel main path launched {k} no time")
    say(f"phase 12 main path train -> fold: ok in {fold_s:.2f} s; {metrics}; losses {fold_losses}; "
        f"evals {evals}; fold: {fold_line}; launches {fold_launches}")

    sb, fold_models_, fold_init = fold_models(torch, dev, fold_cfg)
    fold_loss, fold_grads = {}, {}
    for kernel, (model, c) in fold_models_.items():
        feats, xyz_true = fold_featurize(torch, sb, model, c, kernel)
        params = dict(model.named_parameters())
        loss = fold_loss_fn(params, model, feats, xyz_true)
        loss.backward()
        fold_loss[kernel] = float(loss.detach())
        fold_grads[kernel] = {k: p.grad.detach().clone() if p.grad is not None else torch.zeros_like(p)
                              for k, p in params.items()}
        model.zero_grad(set_to_none=True)
    loss_rel = abs(fold_loss[True] - fold_loss[False]) / abs(fold_loss[False])
    check(math.isfinite(fold_loss[True]) and loss_rel <= 1e-4,
          f"FoldModel loss: kernel path {fold_loss[True]!r} vs plain {fold_loss[False]!r}")
    leaf, leaf_rel = grad_error(torch, fold_grads[False], fold_grads[True])
    check(leaf_rel <= 1e-3, f"FoldModel gradient of {leaf}: relative error {leaf_rel:.3e} > 1e-3")
    say(f"phase 12 kernel vs plain path, one batch of {BATCH_FILES} cropped to {fold_cfg.crop_len}: "
        f"loss {fold_loss[True]!r} vs {fold_loss[False]!r} ({loss_rel:.3e} relative); largest "
        f"relative gradient error {leaf_rel:.3e} ({leaf}) over {len(fold_grads[True])} leaves")
    del fold_grads

    # -- 13. timing ----------------------------------------------------------------
    fold_step_ms, fold_peak, fold_step_losses = {}, {}, {True: [], False: []}

    def fold_stepper(kernel):
        model, c = fold_models_[kernel]
        params = dict(model.named_parameters())
        opt = TrainOptimizer(params, c)
        opt_init = copy.deepcopy(opt.state_dict())
        state = model.state_dict()
        leaves = [(state[k], v) for k, v in fold_init.items()]

        def step():
            with torch.no_grad():
                for leaf_, v in leaves:
                    leaf_.copy_(v)
            opt.load_state_dict(opt_init)
            feats, xyz_true = fold_featurize(torch, sb, model, c, kernel)
            fold_step_losses[kernel].append(fold_train_step(model, params, opt, feats, None, xyz_true))
        return step

    steppers = {kernel: fold_stepper(kernel) for kernel in (True, False)}
    for kernel, step in steppers.items():
        torch.cuda.reset_peak_memory_stats()
        step()
        torch.cuda.synchronize()
        fold_peak[kernel] = torch.cuda.max_memory_allocated() / 2**30
    fold_step_ms[False], fold_step_ms[True], rounds = alternate(steppers[False], steppers[True])
    for kernel, step in steppers.items():
        wall, busy, top = device_profile(torch, step)
        say(f"phase 13 profile FoldModel train step, {'kernel' if kernel else 'plain'} path, one step "
            f"under torch.profiler: device busy {busy:.2f} of {wall:.2f} ms wall "
            f"(idle {100 * (1 - busy / wall):.1f}%); top kernels "
            + "; ".join(f"{name[:60]} {ms:.2f} ms x{n}" for name, ms, n in top))
    for kernel, losses in fold_step_losses.items():
        losses = torch.stack(losses).float().cpu()
        check(bool(torch.isfinite(losses).all()), f"timed FoldModel steps kernel={kernel}: losses {losses}")
        fold_step_losses[kernel] = (float(losses.min()), float(losses.max()), len(losses))
    say(f"phase 13 timing FoldModel train step f32 B=4 crop {fold_cfg.crop_len} [{smi}]: kernel path "
        f"{fold_step_ms[True]:.4f} ms/step (peak {fold_peak[True]:.2f} GiB), plain path "
        f"{fold_step_ms[False]:.4f} ms/step (peak {fold_peak[False]:.2f} GiB) "
        f"(plain/kernel/kernel/plain {', '.join(f'{r:.4f}' for r in rounds)}); each step from the "
        f"initial parameters, losses (min, max, steps) kernel {fold_step_losses[True]}, "
        f"plain {fold_step_losses[False]}")
    del steppers, fold_models_, fold_init, sb
    torch.cuda.empty_cache()

    k3_plain_ms, k3_ms, rounds = alternate(lambda: model_features._model_features_plain(xyz),
                                           lambda: model_features.model_features(xyz))
    bins, ang = model_features.model_features(xyz)
    k3_bound = bound(slot_bytes(xyz, K3_SLOTS) + nbytes(bins, ang),
                     K3_OPS_PER_PAIR * B_FULL * L_FULL ** 2, torch.float32)
    del bins, ang
    say(f"phase 13 timing K3 B={B_FULL} L={L_FULL} bf16 planes [{smi}]: kernel {k3_ms:.4f} ms, plain "
        f"{k3_plain_ms:.4f} ms (plain/kernel/kernel/plain {', '.join(f'{r:.4f}' for r in rounds)}); "
        f"bound {k3_bound[0]:.4f} ms ({k3_bound[1]})")

    flash_ms = {}
    for label, dtype, B, H, dh, L in (("train", torch.float32, 4, 4, 32, 256),
                                      ("attn", torch.bfloat16, 1, 8, 32, 4096)):
        flash_ms[label] = flash_timings(torch, dev, flash_attn, label, dtype, B, H, dh, L)
        torch.cuda.empty_cache()
        for part, (k_ms, p_ms, lib_ms, b_ms, b_by) in flash_ms[label].items():
            say(f"phase 13 timing K{8 if part == 'fwd' else 9} ({part}) {label} {str(dtype)[6:]} B={B} "
                f"H={H} dh={dh} L={L} [{smi}]: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, SDPA "
                f"{'forward' if part == 'fwd' else 'backward'} {lib_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by})")

    k1_bound = bound(slot_bytes(xyz, K1_SLOTS) + 6 * B_FULL * L_FULL ** 2 * 4,
                     K1_OPS_PER_PAIR * B_FULL * L_FULL ** 2, torch.float32)

    def entry(name, source, replaces, launches_, err, ms, plain, bound_ms, bound_by, library_ms):
        return {"name": name, "route": "cuda", "source": f"protstruc_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches_, "max_abs_err": err, "ms": ms,
                "plain_ms": plain, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}

    kernels = [entry("pair_maps", "pair_maps.cu", "protstruc_tpu/ops/pallas_pairwise.py:146", launches,
                     max(worst_small, worst_full), kernel_ms, plain_ms, *k1_bound, None),
               entry("model_features", "model_features.cu", "protstruc_tpu/ops/pallas_pairwise.py:671",
                     fold_launches["model_features"], k3_worst, k3_ms, k3_plain_ms, *k3_bound, None)]
    kernels += [entry(f"tri_mul_{name}", "tri_mul.cu", TRI_REPLACES[name], train_launches[name],
                      tri_worst[name], *tri_ms[name], None) for name in TRI_KERNELS]
    train_flash = flash_ms["train"]
    kernels += [entry(f"flash_attn_{part}", "flash_attn.cu", replaces,
                      fold_launches[f"flash_attn_{part}"], flash_worst[part], *train_flash[part][:2],
                      *train_flash[part][3:], train_flash[part][2])
                for part, replaces in (("fwd", "protstruc_tpu/ops/flash_attn.py:79"),
                                       ("bwd", "protstruc_tpu/ops/flash_attn.py:184"))]
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
