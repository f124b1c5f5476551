#!/usr/bin/env python3
"""Compare the SASS of the hand-written kernels in
``src/repro_torch/kernels/csrc/`` with the same kernels of an earlier
version of those sources, compiled with the flags of
``kernels/build.py``.  Needs nvcc and cuobjdump.

    mkdir -p build/old_csrc
    git archive <rev> src/repro_torch/kernels/csrc \
        | tar -x -C build/old_csrc --strip-components=4
    python3 chip_probes/sass_ungated.py build/old_csrc \
        [--replaced REGEX ...]

Every ``*.cu`` found in both directories is compiled twice.  A kernel
is matched with the old kernel of the same mangled name; where there is
none and its last template argument is a bool followed by a trailing
``const int*`` parameter (a validity gate added since, as B5's was to
``tri_inv_leaf_kernel``), the instantiation
with the flag 0 is matched with the old kernel without that argument
and parameter, and the one with the flag 1 is listed as gated.  Every
kernel of a source the old directory lacks (B1 and B5's
``tri_inv_levels.cu``, say) is listed as new, as is any other kernel with
no counterpart in the old build; an old kernel of a source both
directories hold that no new kernel matches is listed as gone, unless
its name matches one of the ``--replaced`` patterns (Python regexes,
searched in the mangled name: kernels a redesign replaced on purpose,
such as ``tri_gemm_kernel``, the tiles of an earlier ``trmm.cu`` that
its chunked ``ordered_gemm_kernel`` and ``ordered_gemm_fold`` replaced:
``--replaced tri_gemm_kernel``), when it is listed as replaced; a
pattern that names no such kernel fails.  Prints one line per kernel and
``SASS_UNGATED_IDENTICAL True`` when every matched kernel is,
instruction for instruction, the old one and none is gone.  The path
hash in the mangled name of a kernel in an anonymous namespace is left
out of the match.  Each new kernel's line also counts
its FFMA, DFMA and HMMA instructions, and the last lines list the new
kernels that use the tensor cores (HMMA) and those with neither FFMA
nor DFMA.
"""

import argparse
import pathlib
import re
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "src/repro_torch/kernels/csrc"
CUDA = pathlib.Path("/usr/local/cuda/bin")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-cubin"]
GATE = re.compile(r"^(.*)Lb([01])E(EEv.*)PKi$")
# a kernel in an anonymous namespace carries a hash of its file's path
ANON = re.compile(r"\d+_GLOBAL__N__\w+?_cu_[0-9a-f]+")


def sass(src: pathlib.Path, out: pathlib.Path) -> dict:
    """{mangled kernel name: [instruction, ...]} of one source's cubin."""
    subprocess.run([str(CUDA / "nvcc"), *FLAGS, "-o", str(out), str(src)],
                   check=True)
    text = subprocess.run([str(CUDA / "cuobjdump"), "-sass", str(out)],
                          capture_output=True, text=True, check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(ANON.sub("ANON", m.group(1)), [])
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?);", line)
        if m and cur is not None:
            cur.append(m.group(1).strip())
    return funcs


def ops(body: list) -> str:
    """FFMA, DFMA and HMMA counts of one kernel's instructions."""
    # the opcode, past a predicate guard such as "@!P0"
    names = [i.split()[i.startswith("@")].split(".")[0] for i in body]
    count = {op: names.count(op) for op in ("FFMA", "DFMA", "HMMA")}
    return " ".join(f"{op}={n}" for op, n in count.items())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("old_dir", type=pathlib.Path)
    ap.add_argument("--replaced", nargs="*", default=[],
                    help="regexes of old kernels replaced on purpose")
    args = ap.parse_args()
    old_dir = args.old_dir
    replaced = {pat: 0 for pat in args.replaced}
    same_all, compared = True, 0
    hmma, no_fma = [], []

    def new_kernel(src, name, body):
        print(src.name, "new", name, len(body), "instructions", ops(body))
        if "HMMA=0" not in ops(body):
            hmma.append(name)
        if "FFMA=0 DFMA=0" in ops(body):
            no_fma.append(name)

    with tempfile.TemporaryDirectory() as tmp:
        for src in sorted(CSRC.glob("*.cu")):
            new = sass(src, pathlib.Path(tmp) / f"new_{src.stem}.cubin")
            if not (old_dir / src.name).exists():
                for name, body in sorted(new.items()):
                    new_kernel(src, name, body)
                continue
            old = sass(old_dir / src.name,
                       pathlib.Path(tmp) / f"old_{src.stem}.cubin")
            matched = set()
            for name, body in sorted(new.items()):
                base, m = name, GATE.match(name)
                if name not in old and m:
                    if m.group(2) == "1":
                        print(src.name, "gated", name, len(body),
                              "instructions")
                        continue
                    base = m.group(1) + m.group(3)
                if base not in old:
                    new_kernel(src, name, body)
                    continue
                matched.add(base)
                same = old[base] == body
                same_all &= same
                compared += 1
                print(src.name, "ungated", name, "vs", base, len(body),
                      len(old[base]), "SAME" if same else "DIFFERENT")
            for name in sorted(set(old) - matched):
                hits = [p for p in replaced if re.search(p, name)]
                for pat in hits:
                    replaced[pat] += 1
                if hits:
                    print(src.name, "replaced", name)
                    continue
                same_all = False
                print(src.name, "gone", name)
    for pat, hits in replaced.items():
        if not hits:
            same_all = False
            print("replaced pattern names no gone kernel:", pat)
    same_all &= compared > 0
    print("NEW_KERNELS_WITH_HMMA", hmma)
    print("NEW_KERNELS_WITHOUT_FFMA_OR_DFMA", no_fma)
    print("SASS_UNGATED_IDENTICAL", same_all)
    return 0 if same_all else 1


if __name__ == "__main__":
    sys.exit(main())
