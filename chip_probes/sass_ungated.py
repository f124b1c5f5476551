#!/usr/bin/env python3
"""Compare the SASS of the ungated ``trsm_chain_kernel`` instantiations
(kernel B3) in ``src/repro_torch/kernels/csrc/trsm_block.cu`` with the
same instantiations of an earlier version of that file, compiled with
the flags of ``kernels/build.py``.  Needs nvcc and cuobjdump.

    git show <rev>:src/repro_torch/kernels/csrc/trsm_block.cu > old.cu
    python3 chip_probes/sass_ungated.py old.cu

Prints one line per instantiation and ``SASS_UNGATED_IDENTICAL True``
when every ungated one is instruction for instruction the old one's.
"""

import pathlib
import re
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
CUDA = pathlib.Path("/usr/local/cuda/bin")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-cubin"]


def sass(src: pathlib.Path, out: pathlib.Path) -> dict:
    """{kernel name: [instruction, ...]} of one source's cubin."""
    subprocess.run([str(CUDA / "nvcc"), *FLAGS, "-o", str(out), str(src)],
                   check=True)
    text = subprocess.run([str(CUDA / "cuobjdump"), "-sass", str(out)],
                          capture_output=True, text=True, check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?);", line)
        if m and cur is not None:
            cur.append(m.group(1).strip())
    return funcs


def template_args(name: str) -> str:
    m = re.search(r"trsm_chain_kernelI(.*?)EEEv", name)
    return m.group(1) if m else name


def main() -> int:
    old_src = pathlib.Path(sys.argv[1])
    with tempfile.TemporaryDirectory() as tmp:
        old = {template_args(k): v for k, v in
               sass(old_src, pathlib.Path(tmp) / "old.cubin").items()}
        new = sass(ROOT / "src/repro_torch/kernels/csrc/trsm_block.cu",
                   pathlib.Path(tmp) / "new.cubin")
    same_all = True
    for name, body in new.items():
        args = template_args(name)
        if args.endswith("ELb1"):
            print("gated", args, len(body), "instructions")
            continue
        base = args.removesuffix("ELb0")
        same = old.get(base) == body
        same_all &= same
        print("ungated", args, "vs", base, len(body),
              len(old.get(base, [])), "SAME" if same else "DIFFERENT")
    print("SASS_UNGATED_IDENTICAL", same_all)
    return 0 if same_all else 1


if __name__ == "__main__":
    sys.exit(main())
