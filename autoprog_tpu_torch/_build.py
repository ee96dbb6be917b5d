"""Build the CUDA kernels under `csrc/` at first use and load them.

`nvcc` compiles every `csrc/*.cu` into one shared library with a plain C
interface (no PyTorch headers, so the build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<name>.so csrc/*.cu

The library lands in `build/kernels/` beside the package (git-ignored),
named by a hash of the sources and flags, so an edited source rebuilds and
an unchanged one loads the existing file. The compiler's output, with the
`-Xptxas -v` register and shared-memory report, is kept next to it as
`<name>.log`. The library is loaded with `ctypes`: pointers and the stream
are `c_void_p`, and each entry point returns `cudaGetLastError()` (or -1
for a shape it refuses), which the caller turns into an exception.

A missing `nvcc` or a failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
#: C signature of every entry point: (restype, argtypes)
SIGNATURES = {
    # qkv, out, B, n, C, H, scale, scores_f32, dtype, stream
    "mhsa_qkv_fwd": (_I, [_P, _P, _I, _I, _I, _I, _F, _I, _I, _P]),
    # qkv, dout, dqkv, stats, B, n, C, H, scale, scores_f32, dtype, stream
    "mhsa_qkv_bwd": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P]),
}


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels of autoprog_tpu_torch cannot be built")


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"autoprog_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless the library for them exists; return it."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(out.name + f".{os.getpid()}.tmp")
    cu = [str(p) for p in _sources() if p.suffix == ".cu"]
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *cu]
    res = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(
        " ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build if needed and load the kernel library (once per process)."""
    lib = ctypes.CDLL(str(build()))
    for name, (restype, argtypes) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def check(rc: int, what: str) -> None:
    """Raise unless a kernel entry point returned 0."""
    if rc == -1:
        raise ValueError(f"{what}: shape refused by the kernel")
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
