#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Run from the root of a checkout.  It drives ``protstruc_tpu_torch`` on the
card in phases, prints one line per phase, and exits non-zero at the first
failure (no CUDA, a kernel that does not build or launch, a disagreement):

1. device: the card's name and power limit (nvidia-smi);
2. build: K1 (csrc/pair_maps.cu) with nvcc, from the checkout's sources;
3. parity at small sizes: K1 vs its plain PyTorch version on the card, on
   ragged L = 37 and 300 and on degenerate probes;
4. parity at full size: B=256, L=512 on ``randn * 10`` (numpy seed 0);
5. main path: ``StructureBatch.from_pdb`` on bundled PDBs, then
   ``precompile_featurizer(device="cuda")`` and ``serve_loop`` over JSONL
   requests; K1's launch counter is reset just before and must grow;
6. timing (CUDA events, 2 warm-up + 10 timed, plain/kernel/kernel/plain):
   K1 alone vs its plain version, and full featurization at B=256, L=512 on
   the kernel path vs the plain path, as structures/s.

Parity tolerances on the card: distance maps atol 1e-5 + rtol 1e-5; omega,
theta, phi atol 1e-4 (the largest error and the count above 1e-5 are
printed); NaN patterns identical; masks bitwise.  The line before the last is
one JSON object describing each kernel; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import io
import json
import pathlib
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
    from protstruc_tpu_torch.ops import cuda_lib, pair_maps
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
    check(cap == (9, 0), f"K1 is built for sm_90a; this card is sm_{cap[0]}{cap[1]}")

    # -- 2. build -------------------------------------------------------------
    lib_path = cuda_lib.library_path("pair_maps", pair_maps._SOURCES)
    prebuilt = lib_path.is_file()
    t0 = time.perf_counter()
    pair_maps.load_library()
    build_s = time.perf_counter() - t0
    log = lib_path.with_suffix(".log")
    ptxas = [ln.strip() for ln in log.read_text().splitlines()
             if "registers" in ln or "spill" in ln] if log.is_file() else []
    say(f"phase 2 build: {'loaded prebuilt' if prebuilt else 'built'} {lib_path.name} "
        f"in {build_s:.2f} s ({cuda_lib.find_nvcc()})")
    for ln in ptxas:
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

    say(json.dumps({"kernels": [{
        "name": "pair_maps",
        "route": "cuda",
        "source": "protstruc_tpu_torch/csrc/pair_maps.cu",
        "replaces": "protstruc_tpu/ops/pallas_pairwise.py:146",
        "launches": launches,
        "max_abs_err": max(worst_small, worst_full),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
