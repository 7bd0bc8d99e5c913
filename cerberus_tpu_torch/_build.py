"""Build the port's CUDA kernels with `nvcc` and load them with `ctypes`.

A source `csrc/<name>.cu` becomes a shared library with a plain C
interface, `build/cerberus_tpu_torch/lib<name>-<hash>.so` beside the
package, where <hash> covers the source, the headers `csrc/*.cuh` it may
include and the flags: an edited source or header builds anew on first
use, an unchanged one is loaded as it is. What `nvcc` printed (with
`-Xptxas -v`: each kernel's registers, shared memory and spills) is kept
beside the library as `lib<name>-<hash>.log`.
`torch.utils.cpp_extension` is not used: a source that includes PyTorch's
headers takes minutes to compile, a plain C one seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "cerberus_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found (looked on PATH and in {cuda_home})")
    return path


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless its library exists; returns its path."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.read_bytes())
    lib = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        out = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
        if out.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{out.stdout}")
        lib.with_suffix(".log").write_text(out.stdout)
        os.replace(tmp, lib)
    return lib


def build_log(name: str) -> str:
    """What nvcc printed when it built csrc/<name>.cu (built first if
    needed)."""
    return build(name).with_suffix(".log").read_text()


def load(name: str) -> ctypes.CDLL:
    """The library of csrc/<name>.cu, built first if needed."""
    return ctypes.CDLL(str(build(name)))
