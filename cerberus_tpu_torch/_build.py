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

The native sensor runtime `native/sensor_sync.cpp` (at the repository's
root, shared with the JAX package) is built the same way with `g++`, into
`build/cerberus_tpu_torch/libsensor_sync-<hash>.so` (`build_native`); the
prebuilt `native/libsensor_sync.so` beside it is never loaded.
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
NATIVE_SRC = (Path(__file__).resolve().parent.parent / "native"
              / "sensor_sync.cpp")
GXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found (looked on PATH and in {cuda_home})")
    return path


def _compile(compiler: list, flags: list, sources: list, name: str) -> Path:
    """lib<name>-<hash>.so of sources[0] (the others: headers it includes),
    compiled unless it exists; a failed compile raises RuntimeError."""
    h = hashlib.sha256(" ".join(flags).encode())
    for path in sources:
        h.update(path.read_bytes())
    lib = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        out = subprocess.run([*compiler, *flags, "-o", str(tmp),
                              str(sources[0])],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
        if out.returncode != 0:
            raise RuntimeError(f"{compiler[0]} failed for {sources[0].name}:"
                               f"\n{out.stdout}")
        lib.with_suffix(".log").write_text(out.stdout)
        os.replace(tmp, lib)
    return lib


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless its library exists; returns its path."""
    return _compile([_nvcc()], NVCC_FLAGS,
                    [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))], name)


def build_native() -> Path:
    """Compile native/sensor_sync.cpp with g++ unless its library exists;
    returns its path. Raises RuntimeError if g++ is missing or fails."""
    gxx = os.environ.get("CXX") or shutil.which("g++")
    if not gxx:
        raise RuntimeError("g++ not found on PATH: the native sensor sync "
                           "cannot be built")
    return _compile([gxx], GXX_FLAGS, [NATIVE_SRC], "sensor_sync")


def build_log(name: str) -> str:
    """What nvcc printed when it built csrc/<name>.cu (built first if
    needed)."""
    return build(name).with_suffix(".log").read_text()


def load(name: str) -> ctypes.CDLL:
    """The library of csrc/<name>.cu, built first if needed."""
    return ctypes.CDLL(str(build(name)))
