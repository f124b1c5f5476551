"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into its own shared library under
``build/repro_torch_kernels/`` at the repository root, then loaded with
``ctypes``.  Nothing includes PyTorch's headers, so a build takes
seconds.  The first call builds every source at once, one ``nvcc`` per
source, all started together; the library name carries a hash of the
sources and flags, so an edited source can never load a stale build.

Pointers and the CUDA stream cross the boundary as ``c_void_p``; every
C entry point returns ``cudaGetLastError()`` after its launches, and
:func:`check` raises when that is not 0 (a refused launch never runs
and no later synchronize reports it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" \
    / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (pathlib.Path(cand) / "bin" / "nvcc").exists():
            return str(pathlib.Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA "
                           "kernels are built on first use")
    return found


def _lib_path(src: pathlib.Path) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, pathlib.Path]:
    """Compile every ``csrc/*.cu`` that has no current build, in
    parallel; returns {name: library path}.  Raises with nvcc's output
    when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {src.stem: _lib_path(src) for src in sorted(CSRC.glob("*.cu"))}
    procs = []
    for src in sorted(CSRC.glob("*.cu")):
        lib = out[src.stem]
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
               str(src)]
        procs.append((lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors = []
    for lib, tmp, proc in procs:
        log, _ = proc.communicate()
        (BUILD_DIR / f"{lib.stem}.log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"{lib.name}:\n{log}")
            continue
        os.replace(tmp, lib)
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            paths = build_all()
            if name not in paths:
                raise KeyError(f"no kernel source csrc/{name}.cu")
            lib = _libs[name] = ctypes.CDLL(str(paths[name]))
        return lib


def check(status: int, what: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
