"""Build the CUDA kernels under `csrc/` at first use and load them.

`nvcc` compiles each `csrc/*.cu` into a shared library of its own with a
plain C interface (no PyTorch headers, so a build takes seconds), all
sources at once, one compiler process each:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<stem>_<hash>.so csrc/<stem>.cu

The libraries land in `build/kernels/` beside the package (git-ignored),
each named by a hash of its source, the shared headers and the flags, so an
edited source rebuilds and an unchanged one loads the existing file. The
compiler's output, with the `-Xptxas -v` register and shared-memory report,
is kept next to it as `<name>.log`. The libraries are loaded with `ctypes`:
pointers and the stream are `c_void_p`, and each entry point returns
`cudaGetLastError()` (or -1 for a shape it refuses), which the caller turns
into an exception.

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
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
#: C signature of every entry point: (restype, argtypes)
SIGNATURES = {
    # qkv, out, B, n, C, H, scale, scores_f32, dtype, stream
    "mhsa_qkv_fwd": (_I, [_P, _P, _I, _I, _I, _I, _F, _I, _I, _P]),
    # qkv, dout, dqkv, stats, B, n, C, H, scale, scores_f32, dtype, stream
    "mhsa_qkv_bwd": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P]),
    # q, k, v, out, (image, row, head) strides of q, k, v, B, n, H, d, scale, dtype, stream
    "mhsa_fwd": (_I, [_P] * 4 + [_L] * 9 + [_I, _I, _I, _I, _F, _I, _P]),
    # q, k, v, dout, dq, dk, dv, stats, strides of q, k, v, dout, B, n, H, d, scale,
    # dtype, stream
    "mhsa_bwd": (_I, [_P] * 8 + [_L] * 12 + [_I, _I, _I, _I, _F, _I, _P]),
    # qkv, out, B, n, C, H, scale, variant, stream
    "mhsa_variant_fwd": (_I, [_P, _P, _I, _I, _I, _I, _F, _I, _P]),
    # qkv, out, B, n, C, H, scale, G, phase, stream
    "mhsa_group_fwd": (_I, [_P, _P, _I, _I, _I, _I, _F, _I, _I, _P]),
    # qkv, dout, dqkv, stats, B, n, C, H, scale, G, phase, stream
    "mhsa_group_bwd": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P]),
    # v, logits, out, B, H, W, C, heads, scale, dtype, stream
    "outlook_fused_fwd": (_I, [_P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P]),
    # v, logits, gout, dv, dlogits, B, H, W, C, heads, scale, dtype, stream
    "outlook_fused_bwd": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P]),
    # patches, logits, out, B, n, C, heads, scale, head_minor, dtype, stream
    "outlook_attend": (_I, [_P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P]),
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


def library_paths() -> Dict[str, Path]:
    """Where the library of each `.cu` source lives (built or not)."""
    base = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        if p.suffix == ".cuh":
            base.update(p.name.encode())
            base.update(p.read_bytes())
    out = {}
    for p in _sources():
        if p.suffix == ".cu":
            h = base.copy()
            h.update(p.read_bytes())
            out[str(p)] = BUILD_DIR / f"{p.stem}_{h.hexdigest()[:16]}.so"
    return out


def build() -> List[Path]:
    """Compile every source whose library is missing, all compilers started
    together; return the libraries."""
    paths = library_paths()
    missing = {src: out for src, out in paths.items() if not out.exists()}
    if missing:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        jobs = []
        for src, out in missing.items():
            tmp = out.with_name(out.name + f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), src]
            jobs.append((out, tmp, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for out, tmp, cmd, proc in jobs:
            text, _ = proc.communicate()
            out.with_suffix(".log").write_text(" ".join(cmd) + "\n" + text)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed.append(f"nvcc failed ({proc.returncode}) on {cmd[-1]}:\n{text[-4000:]}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("\n".join(failed))
    return list(paths.values())


class _Kernels:
    """The entry points of every library, by name."""


@functools.lru_cache(maxsize=None)
def load() -> _Kernels:
    """Build if needed and load the kernel libraries (once per process)."""
    libs = [ctypes.CDLL(str(p)) for p in build()]
    kernels = _Kernels()
    for name, (restype, argtypes) in SIGNATURES.items():
        owners = [lib for lib in libs if hasattr(lib, name)]
        if len(owners) != 1:
            raise RuntimeError(f"{name}: exported by {len(owners)} kernel libraries")
        fn = getattr(owners[0], name)
        fn.restype = restype
        fn.argtypes = argtypes
        setattr(kernels, name, fn)
    return kernels


def check(rc: int, what: str) -> None:
    """Raise unless a kernel entry point returned 0."""
    if rc == -1:
        raise ValueError(f"{what}: shape refused by the kernel")
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
