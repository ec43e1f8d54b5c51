"""Compare the machine code (SASS) of K4-K7's and K8/K9's kernels in two trees.

    python -m protstruc_tpu_torch.experiments.sass_diff OLD_TREE [NEW_TREE]

Builds ``csrc/tri_mul.cu`` and ``csrc/flash_attn.cu`` of OLD_TREE (say, a
parent commit unpacked with ``git archive``) and of NEW_TREE (default: this
checkout) with the port's nvcc flags (``cuda_lib.NVCC_FLAGS_FMA``), all four
builds at once, into ``protstruc_tpu_torch/_build/sass_diff/``; then lists,
for each OLD_TREE kernel, whether NEW_TREE has the same SASS (``cuobjdump
-sass``, addresses and encodings dropped), with the first differing
instructions where it does not, and prints the ptxas lines of both trees.

Kernels are held to the OLD_TREE kernel of the same name.  A NEW_TREE kernel
whose name OLD_TREE lacks but which, without its last template argument
``false``, names an OLD_TREE kernel that NEW_TREE no longer builds (a kernel
that gained a flag, such as ``kRagged``, built both ways) is held to that
kernel; the other NEW_TREE kernels are listed as new.  Needs nvcc,
``cuobjdump`` and ``cu++filt`` (the CUDA toolkit's); no card.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import pathlib
import re
import subprocess
import sys

from protstruc_tpu_torch.ops import cuda_lib

SOURCES = ("tri_mul", "flash_attn")
OUT = cuda_lib.BUILD_DIR / "sass_diff"


def build(tree: pathlib.Path, tag: str, src: str):
    """nvcc of ``tree``'s ``csrc/<src>.cu`` into ``OUT/<tag>_<src>.so``;
    returns (path, return code, the compiler's output)."""
    out = OUT / f"{tag}_{src}.so"
    cmd = [cuda_lib.find_nvcc(), *cuda_lib.NVCC_FLAGS_FMA, "-o", str(out),
           str(tree / "protstruc_tpu_torch" / "csrc" / f"{src}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    (OUT / f"{tag}_{src}.log").write_text(proc.stdout + proc.stderr)
    return out, proc.returncode, proc.stdout + proc.stderr


def sass(lib: pathlib.Path, bindir: pathlib.Path):
    """{demangled kernel name: [instruction text, ...]} of ``lib``."""
    text = subprocess.run([str(bindir / "cuobjdump"), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    funcs, name = {}, None
    for ln in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", ln)
        if m and name:
            funcs[name].append(m.group(1))
    dem = subprocess.run([str(bindir / "cu++filt")], input="\n".join(funcs), capture_output=True,
                         text=True, check=True).stdout.splitlines()
    return dict(zip(dem, funcs.values()))


def key(dem: str):
    """A kernel's name without namespaces, its template arguments spelled as
    in the source; a kernel templated on flags alone that is overloaded on
    its rows' dtype (``RowArgs<T>``) gets that dtype as its first argument."""
    for a, b in (("(anonymous namespace)::", ""), ("<unnamed>::", ""), ("(bool)0", "false"),
                 ("(bool)1", "true")):
        dem = dem.replace(a, b)
    m = re.match(r"void (\w+)<(.*?)>\((.*)\)$", dem)
    if not m:
        return dem
    base, args, params = m.group(1), [a.strip() for a in m.group(2).split(",")], m.group(3)
    row = re.search(r"RowArgs<(.*?)>", params)
    if row and all(a in ("true", "false") for a in args):
        args = [row.group(1), *args]
    return f"{base}<{', '.join(args)}>"


def pair(old: dict, new: dict):
    """{NEW_TREE name: the OLD_TREE name it is held to}, and the NEW_TREE
    names held to none."""
    held, fresh = {}, []
    for k in new:
        flagless = k[:-len(", false>")] + ">" if k.endswith(", false>") else None
        if k in old:
            held[k] = k
        elif flagless in old and flagless not in new:
            held[k] = flagless
        else:
            fresh.append(k)
    return held, fresh


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old_tree", type=pathlib.Path)
    ap.add_argument("new_tree", type=pathlib.Path, nargs="?",
                    default=pathlib.Path(__file__).resolve().parents[2])
    args = ap.parse_args(argv)
    nvcc = cuda_lib.find_nvcc()
    if nvcc is None:
        print("sass_diff: no nvcc", file=sys.stderr)
        return 1
    bindir = pathlib.Path(nvcc).parent
    OUT.mkdir(parents=True, exist_ok=True)
    trees = {"old": args.old_tree.resolve(), "new": args.new_tree.resolve()}
    jobs = [(tag, src) for tag in trees for src in SOURCES]
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as ex:
        built = dict(zip(jobs, ex.map(lambda j: build(trees[j[0]], *j), jobs)))
    for (tag, src), (_, rc, log) in built.items():
        print(f"build {tag} {src} ({trees[tag]}): rc {rc}", flush=True)
        if rc:
            print(log[-6000:])
            return 1
    for src in SOURCES:
        keyed = {tag: {key(dem): ins for dem, ins in sass(built[(tag, src)][0], bindir).items()}
                 for tag in trees}
        held, fresh = pair(keyed["old"], keyed["new"])
        for k in fresh:
            print(f"  new: {k} ({len(keyed['new'][k])} instructions)")
        for k in sorted(set(keyed["old"]) - set(held.values())):
            print(f"  MISSING in the new tree: {k}")
        same = 0
        for k_new, k in sorted(held.items(), key=lambda kv: kv[1]):
            a, b = keyed["old"][k], keyed["new"][k_new]
            if a == b:
                same += 1
            else:
                diff = [(i, x, y) for i, (x, y) in enumerate(zip(a, b)) if x != y]
                print(f"  DIFFERS {k_new} (old {k}): {len(a)} vs {len(b)} instructions, "
                      f"{len(diff) + abs(len(a) - len(b))} differ")
                for i, x, y in diff[:12]:
                    print(f"    {i}: {x}  |  {y}")
        print(f"{src}: {same} of {len(keyed['old'])} kernels of the old tree have the same SASS "
              f"in the new tree", flush=True)
        for tag in trees:
            for ln in cuda_lib.ptxas_lines(OUT / f"{tag}_{src}.log"):
                print(f"  ptxas {tag}: {ln}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
