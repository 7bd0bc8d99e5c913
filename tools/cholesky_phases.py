#!/usr/bin/env python3
"""Where the time of the blocked Cholesky kernels goes, phase by phase.

    python3 tools/cholesky_phases.py

Needs an NVIDIA GPU and nvcc. Writes a copy of cerberus_tpu_torch/csrc/
into build/cholesky_phases/ in which thread 0 of block 0 reads clock64()
after each block barrier of csrc/blocked_cholesky.cuh and adds the cycles
since the previous reading to its phase's counter; warp 0 also reads it
when it has factored a diagonal tile, which splits the phase in which it
does so from the trailing update that runs beside it. Builds that copy with
the port's nvcc flags, runs the port's wrappers on it at the paths' shapes
(20 launches each) and prints, per shape, the mean cycles per launch of
each phase and the time of one launch (50 launched back to back behind a
device-side sleep, between one pair of CUDA events). The copy is a
measurement aid: the readings add a few instructions per barrier.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from cerberus_tpu_torch import _build  # noqa: E402
from cerberus_tpu_torch.ops import cholesky_solve as cs  # noqa: E402
from cerberus_tpu_torch.ops import lane_cholesky as lc  # noqa: E402

OUT = ROOT / "build" / "cholesky_phases"

# counter -> phase; the readings are placed in this order in the source
PHASES = ["load", "first panel: copy in", "first diagonal tile",
          "TRSM", "next diagonal tile's update",
          "trailing update after the diagonal factor", "after the loop",
          "inverses of the diagonal tiles", "forward: diagonal tile",
          "forward: rows below", "back: diagonal tile", "back: columns left",
          "diagonal factor (warp 0, beside the trailing update)"]
FACTOR_MARKS = [1, 2, 3, 4, 5, 6, 7]     # the barriers of factor(), in order
SUBST_MARKS = [8, 9, 10, 11]             # those of substitute()
DIAG_MARK = 12

PROFILE_DEFS = """
__device__ unsigned long long g_phase_cycles[16];
__device__ __forceinline__ void phase_mark(int k, long long& last) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const long long t = clock64();
    atomicAdd(&g_phase_cycles[k], (unsigned long long)(t - last));
    last = t;
  }
}
"""

ENTRIES = """
int phase_cycles(unsigned long long* out, int reset) {
  if (reset) {
    unsigned long long z[16] = {};
    return (int)cudaMemcpyToSymbol(blocked_cholesky::g_phase_cycles, z,
                                   sizeof(z));
  }
  return (int)cudaMemcpyFromSymbol(out, blocked_cholesky::g_phase_cycles,
                                   sizeof(unsigned long long) * 16);
}
"""


def _mark_barriers(text, signature, marks):
    """Add a `last` argument to the function and a reading after each of
    its block barriers."""
    assert signature + ") {\n" in text, signature
    text = text.replace(signature + ") {\n",
                        signature + ", long long& last) {\n", 1)
    parts = text.split("__syncthreads();")
    assert len(parts) - 1 == len(marks), (len(parts) - 1, marks)
    out = parts[0]
    for k, part in zip(marks, parts[1:]):
        out += f"__syncthreads(); phase_mark({k}, last);" + part
    return out


def instrumented_sources():
    """Write the instrumented copy of csrc/ to OUT."""
    csrc = ROOT / "cerberus_tpu_torch" / "csrc"
    src = (csrc / "blocked_cholesky.cuh").read_text()
    src = src.replace("namespace blocked_cholesky {",
                      "namespace blocked_cholesky {\n" + PROFILE_DEFS, 1)
    f = src.index("__device__ void factor(")
    g = src.index("__device__ void substitute(")
    h = src.index("__global__ void __launch_bounds__")
    fac = _mark_barriers(src[f:g], "int nt", FACTOR_MARKS)
    diag = "      factor_diagonal<T, NB>(next, inv_d + (K + 1) * NB);"
    assert fac.count(diag) == 1
    fac = fac.replace(diag, "      { factor_diagonal<T, NB>(next, inv_d + "
                      f"(K + 1) * NB); phase_mark({DIAG_MARK}, last); }}")
    sub = _mark_barriers(src[g:h], "int nt", SUBST_MARKS)
    ker = src[h:]
    for old, new in (
            ("  load_system<T, NB>",
             "  long long last = clock64();\n  load_system<T, NB>"),
            ("  __syncthreads();\n  factor<T, NB>(tiles, panel_buf, inv_d, "
             "nt);\n  substitute<T, NB>(tiles, v, x + sys * n, n, nt);",
             "  __syncthreads(); phase_mark(0, last);\n  factor<T, NB>(tiles, "
             "panel_buf, inv_d, nt, last);\n  substitute<T, NB>(tiles, v, "
             "x + sys * n, n, nt, last);")):
        assert ker.count(old) == 1, old
        ker = ker.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "blocked_cholesky.cuh").write_text(src[:f] + fac + sub + ker)
    for name in ("lane_cholesky.cu", "cholesky_solve.cu"):
        text = (csrc / name).read_text()
        text = text.replace('extern "C" {', 'extern "C" {\n' + ENTRIES, 1)
        (OUT / name).write_text(text)


def build(name):
    lib = OUT / f"lib{name}.so"
    out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                          str(OUT / f"{name}.cu")],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    if out.returncode:
        raise RuntimeError(out.stdout)
    return ctypes.CDLL(str(lib))


def measure(label, lib, fn, reps=20, calls=50):
    fn()
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * 16)()
    lib.phase_cycles(buf, 1)
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    lib.phase_cycles(buf, 0)
    cycles = np.array(buf[:len(PHASES)], dtype=float) / reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    print(f"{label}: ms={start.elapsed_time(end) / calls:.4f} "
          f"cycles={cycles.sum():.0f}")
    for name, c in zip(PHASES, cycles):
        if c:
            print(f"    {name}: {c:.0f}")


def spd(B, n, dtype, dev):
    rng = np.random.default_rng(0)
    J = rng.normal(size=(B, n + 5, n))
    A = np.swapaxes(J, 1, 2) @ J + 0.5 * np.eye(n)
    b = rng.normal(size=(B, n))
    return (torch.as_tensor(A, dtype=dtype, device=dev),
            torch.as_tensor(b, dtype=dtype, device=dev))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this tool runs only on the card")
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    instrumented_sources()
    libs = {name: build(name) for name in ("lane_cholesky", "cholesky_solve")}
    for mod in (lc, cs):
        mod._LIB = None
        mod._build = type("Build", (), {"load": staticmethod(libs.get)})
    for dtype, B in ((torch.float64, 1), (torch.float32, 128),
                     (torch.float32, 1)):
        A, b = spd(B, 222, dtype, dev)
        measure(f"lane_cholesky_solve {dtype} B={B} n=222",
                libs["lane_cholesky"], lambda: lc.lane_cholesky_solve(A, b))
    H, b = spd(3, 384, torch.float32, dev)
    lam = torch.full((3,), 1e-2, device=dev)
    measure("cholesky_solve B=3 n=384", libs["cholesky_solve"],
            lambda: cs.cholesky_solve(H, b, lam))


if __name__ == "__main__":
    main()
