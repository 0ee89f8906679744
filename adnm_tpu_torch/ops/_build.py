"""Build the package's C++ sources and load them with ctypes: the CUDA
kernels with nvcc, the host-side radar decode with g++.

Each library is compiled on first use from ``adnm_tpu_torch/csrc/`` into
``adnm_tpu_torch/build/`` beside it (git-ignored), or into a per-user
cache where the package is installed read-only. A CUDA library is built
for Hopper only (``sm_90a``); every library is a shared object with a
plain C interface. The file name carries a hash of the sources and the
compiler flags, so an edited source is rebuilt and a stale library is
never loaded. A missing compiler or a failed build raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE = Path(__file__).resolve().parents[1]
CSRC = PACKAGE / "csrc"
BUILD_DIR = (PACKAGE / "build" if os.access(PACKAGE, os.W_OK)
             else Path.home() / ".cache" / "adnm_tpu_torch" / "kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# the JAX package's own flags for its copy of the host decode
# (adnm_tpu/data/native.py), so both libraries compute the same floats
GXX_FLAGS = ("-O3", "-shared", "-fPIC")


@dataclasses.dataclass(frozen=True)
class Built:
    path: Path
    log: str  # nvcc's output (ptxas register and spill report), "" when cached


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin): "
                       "the CUDA kernels cannot be built")


def find_gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: the host library cannot be built")
    return gxx


def library_path(name: str, sources: tuple[str, ...], flags: tuple[str, ...] = NVCC_FLAGS
                 ) -> Path:
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        h.update(src.encode())
        h.update((CSRC / src).read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_library(name: str, sources: tuple[str, ...], host: bool = False) -> Built:
    """Compile ``sources`` (file names under csrc/) into one shared library,
    unless a library built from the same sources and flags exists: CUDA
    sources with nvcc, or with ``host`` C++ sources with g++ (linked with
    pthreads)."""
    flags = GXX_FLAGS if host else NVCC_FLAGS
    out = library_path(name, sources, flags)
    if out.exists():
        return Built(out, "")
    compiler = find_gxx() if host else find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=f".{name}-", suffix=".so")
    os.close(fd)
    cmd = [compiler, *flags, "-o", tmp, *(str(CSRC / s) for s in sources),
           *(("-lpthread",) if host else ())]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{os.path.basename(compiler)} failed ({proc.returncode}) building {name}:\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return Built(out, proc.stdout + proc.stderr)


def load_library(name: str, sources: tuple[str, ...], host: bool = False) -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    return ctypes.CDLL(str(build_library(name, sources, host).path))
