"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into a shared
library with a plain C interface, loaded with `ctypes`.  Libraries go to
`build/torch_kernels/` at the repository root, named with a hash of the
source, the headers beside it (`csrc/*.cuh`) and the flags, so an edited
source or header rebuilds and a stale library is never loaded.  Building happens at first use, never at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LOADED: dict[str, ctypes.CDLL] = {}
# nvcc's output (ptxas' registers, shared memory and spills per kernel) of
# each source built by this process
BUILD_OUTPUT: dict[str, str] = {}


def nvcc() -> str:
    """Path of `nvcc`: $CUDA_HOME/bin, else the toolkit's default
    location, else the PATH."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on the PATH")
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # a source may include any of them
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    digest = digest.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: list[str]) -> list[Path]:
    """Compile every named source that has no library yet, all `nvcc`
    processes started together; raises with the compiler output if one
    fails.  Returns the library paths."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = [library_path(n) for n in names]
    jobs = []
    for name, path in zip(names, paths):
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        jobs.append((name, path, tmp, proc))
    failed = []
    for name, path, tmp, proc in jobs:
        out, _ = proc.communicate()
        BUILD_OUTPUT[name] = out.decode(errors="replace")
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{BUILD_OUTPUT[name]}")
            continue
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        (path,) = build([name])
        lib = ctypes.CDLL(str(path))
        _LOADED[name] = lib
    return lib
