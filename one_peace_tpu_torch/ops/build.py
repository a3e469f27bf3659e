"""Build the hand-written CUDA kernels of ``one_peace_tpu_torch/csrc``.

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, at its first launch (or all at once through
``build_libraries``), into ``build/torch_kernels/`` beside the package.  The
library's name carries a hash of its source, of every header under
``csrc/`` (``*.cuh``, which the sources include) and of the flags, so an
edited source or header is rebuilt and an unchanged one is reused.  The
wrappers load the libraries with ``ctypes``.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
# the element type that a kernel's C side takes, as its ``dtype`` argument
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` goes: its name hashes the
    source, every ``csrc/*.cuh`` header (names and bytes) and the flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_library(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` into a shared library unless a library of
    the same source, headers and flags is already built; return its path.
    The compiler's output (``-Xptxas -v``: registers, shared memory, spills)
    is kept beside it with a ``.log`` suffix."""
    source = CSRC / f"{name}.cu"
    lib = library_path(name)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


def build_libraries() -> Dict[str, Path]:
    """Build every source under ``csrc/`` at once, one nvcc process each;
    returns {source name: library path}."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with ThreadPoolExecutor(len(names)) as pool:
        futures = {name: pool.submit(build_library, name) for name in names}
        return {name: f.result() for name, f in futures.items()}
