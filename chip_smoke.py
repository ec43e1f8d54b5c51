#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Run from the root of a checkout.  It drives ``protstruc_tpu_torch`` on the
card in phases, prints one line per phase, and exits non-zero at the first
failure (no CUDA, a kernel that does not build or launch, a disagreement):

1. device: the card's name and power limit (nvidia-smi);
2. build: K1 (csrc/pair_maps.cu) and K4-K7 (csrc/tri_mul.cu) with nvcc, from
   the checkout's sources, the two builds started together;
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
   version's under the budgets below.

Parity tolerances on the card: distance maps atol 1e-5 + rtol 1e-5; omega,
theta, phi atol 1e-4 (the largest error and the count above 1e-5 are
printed); NaN patterns identical; masks bitwise.  K4-K7: the JAX package's
budgets (tests/test_tri_mul.py:49-60), f32 ``max|d| <= 2e-5 max(1,
max|ref|)``, bf16 ``max|d| <= 5e-2 max|ref|``.  Train path: bf16 losses of
the fused and unfused paths within 2e-2 relative per step; f32 within 1e-5
relative, and each gradient leaf within 1e-4 of its largest entry.  The line
before the last is one JSON object describing each kernel; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import concurrent.futures
import io
import json
import pathlib
import re
import subprocess
import sys
import tempfile
import time

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
            k = re.search(r"\d+([a-z_]+_kernel)I(f|13__nv_bfloat16)E", m.group(1))
            name = f"{k.group(1)}<{'float' if k.group(2) == 'f' else 'bf16'}>" if k else m.group(1)
        elif "spill" in ln and name:
            spill = ln.strip()
        elif "registers" in ln and name:
            out.append(f"{name}: {ln.split(':', 1)[1].strip()}; {spill}")
            name = None
    return out


def build_all(cuda_lib, pair_maps, tri_mul):
    """Build K1 and K4-K7 at once (one nvcc each, started together); returns
    {library: (path, built or loaded, seconds)}."""
    libs = {"pair_maps": (pair_maps.load_library, cuda_lib.library_path("pair_maps", pair_maps._SOURCES)),
            "tri_mul": (tri_mul.load_library, tri_mul.library_path())}

    def one(item):
        name, (load, path) = item
        prebuilt = path.is_file()
        t0 = time.perf_counter()
        load()
        return name, (path, "loaded prebuilt" if prebuilt else "built", time.perf_counter() - t0)

    with concurrent.futures.ThreadPoolExecutor(len(libs)) as ex:
        return dict(ex.map(one, libs.items()))


def zero_grad_entries(torch, key, g):
    """Entries whose exact gradient is 0: the pair-bias bias and the key bias
    of ``qkv`` each add a per-head constant to every logit of a softmax row,
    so both paths return rounding noise there."""
    mask = torch.zeros_like(g, dtype=torch.bool)
    if key.endswith("attn.pair_bias.bias"):
        mask[...] = True
    elif key.endswith("attn.qkv.bias"):
        mask[1] = True
    return mask


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
        state = make_train_state(model, feats, torch.Generator().manual_seed(0))
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
    from protstruc_tpu_torch.ops import cuda_lib, pair_maps, tri_mul
    from protstruc_tpu_torch.ops.pair_maps import _pair_maps_plain, pairwise_maps
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
    builds = build_all(cuda_lib, pair_maps, tri_mul)
    lib_path, how, build_s = builds["pair_maps"]
    say(f"phase 2 build: {how} {lib_path.name} "
        f"in {build_s:.2f} s ({cuda_lib.find_nvcc()})")
    for ln in ptxas_lines(lib_path.with_suffix(".log")):
        say(f"  ptxas: {ln}")
    tri_path, how, tri_build_s = builds["tri_mul"]
    say(f"phase 2 build: {how} {tri_path.name} in {tri_build_s:.2f} s (K4-K7, built alongside K1)")
    for ln in ptxas_lines(tri_path.with_suffix(".log")):
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
    cpu_sb = pt.StructureBatch.from_pdb(paths)
    cpu_g = cpu_sb.inter_residue_geometry()
    cpu_d, cpu_m = cpu_sb.backbone_dihedrals()
    cpu_f = cpu_sb.backbone_orientations()
    singles = {p: pt.StructureBatch.from_pdb(str(DATA / p)) for p in PDBS[:2]}

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
    worst_leaf, worst_rel = None, 0.0
    top = max(float(g.abs().max()) for g in grads[False].values())
    for k, ref in grads[False].items():
        got, zero = grads[True][k], zero_grad_entries(torch, k, ref)
        noise = max(float(got[zero].abs().max()) if zero.any() else 0.0,
                    float(ref[zero].abs().max()) if zero.any() else 0.0)
        check(noise <= 1e-5 * top, f"{k}: zero-gradient entries {noise:.3e} vs top {top:.3e}")
        if zero.all():
            continue
        rel = float((got - ref)[~zero].abs().max()) / max(float(ref[~zero].abs().max()), 1e-30)
        if rel > worst_rel:
            worst_leaf, worst_rel = k, rel
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
        torch.cuda.empty_cache()
        plain_ms_k, kernel_ms_k, rounds = alternate(lambda: plain(*cases[name]), lambda: kernel(*cases[name]))
        tri_ms[name] = (kernel_ms_k, plain_ms_k)
        say(f"phase 9 timing {name} bf16 N={4 * L_FULL * L_FULL} C=128 [{smi}]: kernel {kernel_ms_k:.4f} ms, "
            f"plain {plain_ms_k:.4f} ms (plain/kernel/kernel/plain {', '.join(f'{r:.4f}' for r in rounds)})")
    del cases

    kernels = [{
        "name": "pair_maps",
        "route": "cuda",
        "source": "protstruc_tpu_torch/csrc/pair_maps.cu",
        "replaces": "protstruc_tpu/ops/pallas_pairwise.py:146",
        "launches": launches,
        "max_abs_err": max(worst_small, worst_full),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]
    kernels += [{
        "name": f"tri_mul_{name}",
        "route": "cuda",
        "source": "protstruc_tpu_torch/csrc/tri_mul.cu",
        "replaces": TRI_REPLACES[name],
        "launches": train_launches[name],
        "max_abs_err": tri_worst[name],
        "ms": tri_ms[name][0],
        "plain_ms": tri_ms[name][1],
    } for name in TRI_KERNELS]
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
