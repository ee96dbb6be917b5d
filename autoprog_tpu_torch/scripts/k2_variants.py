"""Variants of K2's kernels timed in one process, for tuning `csrc/outlook.cu`.

    python -m autoprog_tpu_torch.scripts.k2_variants NAME=EDITS [NAME=EDITS ...]

Each NAME=EDITS compiles a copy of `csrc/outlook.cu` (beside a copy of
`csrc/mhsa_common.cuh`) into `build/k2_variants/NAME/` with `_build`'s nvcc
flags, all compilers started together. EDITS is a `|`-separated list of
`OLD->NEW` text replacements, each of which must occur in the source; an
empty EDITS is the source as it stands. For example

    base= 'ahead2=AHEAD = 1;->AHEAD = 2;'

Each variant prints its row kernels' registers and spill bytes (`ptxas -v`),
is checked once against the plain twins (max abs error of out, dv and
dlogits, and the launch plan), and is then timed, forward and backward, at
the volo_d1 outlooker's map [128, 28, 28, 192] with 6 heads in bf16: CUDA
events around 50 launches, three rounds with the variants in turns (the
order reversed every other round), the least and every round printed. A
replacement that turns a call off (`f(`-> `if (0) f(`) times a kernel
without that phase: the ablations of PERF.md, section 6. The edits name
text of the source as it stands, so they are given on the command line and
not kept here. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional

import torch

from autoprog_tpu_torch import _build

OUT = _build.BUILD_DIR.parent / "k2_variants"
SHAPE = (128, 28, 192, 6)      # B, H = W, C, heads


def apply_edits(src: str, edits: str) -> str:
    """`src` with every `OLD->NEW` of the `|`-separated `edits` replaced."""
    for edit in filter(None, edits.split("|")):
        old, new = edit.split("->", 1)
        if old not in src:
            raise ValueError(f"{old!r} does not occur in the source")
        src = src.replace(old, new)
    return src


def build(variants: Dict[str, str]) -> Dict[str, ctypes.CDLL]:
    """{name: the loaded library} of every variant that compiled."""
    source = (_build.CSRC / "outlook.cu").read_text()
    jobs = {}
    for name, edits in variants.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        shutil.copy(_build.CSRC / "mhsa_common.cuh", d)
        (d / "outlook.cu").write_text(apply_edits(source, edits))
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / "outlook.cu")]
        jobs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)
    libs = {}
    for name, proc in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"{name}: build failed\n{log[-3000:]}", flush=True)
            continue
        for m in re.finditer(r"Compiling entry function '\S+?(outlook_\w+_rows)I(\w+?)E.*?"
                             r"(\d+) bytes spill stores, (\d+) bytes spill loads.*?Used (\d+) "
                             r"registers", log, re.S):
            print(f"{name}: {m.group(1)}<{'float' if m.group(2) == 'f' else 'bf16'}> "
                  f"{m.group(5)} registers, spill {m.group(3)} / {m.group(4)} bytes", flush=True)
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        for fn in ("outlook_fused_fwd", "outlook_fused_bwd"):
            getattr(lib, fn).restype, getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
        libs[name] = lib
    return libs


def main(argv: Optional[List[str]] = None) -> Dict[str, List[float]]:
    from autoprog_tpu_torch.ops import outlook_fused as O
    from autoprog_tpu_torch.scripts.timing import card_name, time_call
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise RuntimeError("k2_variants needs a CUDA device")
    variants = dict(a.split("=", 1) for a in argv)
    libs = build(variants)
    B, H, C, heads = SHAPE
    gen = torch.Generator("cuda").manual_seed(0)
    v = torch.randn(B, H, H, C, device="cuda", generator=gen).bfloat16()
    logits = (2 * torch.randn(B, H // 2, H // 2, heads * 81, device="cuda",
                              generator=gen)).bfloat16()
    gout = torch.randn(B, H, H, C, device="cuda", generator=gen).bfloat16()
    scale = (C // heads) ** -0.5
    out, dv, dl = torch.empty_like(v), torch.empty_like(v), torch.empty_like(logits)
    stream = torch.cuda.current_stream().cuda_stream
    calls = {}
    for name, lib in libs.items():
        plans = [(ctypes.c_int * 6)(), (ctypes.c_int * 6)()]
        fwd = (lambda lib=lib, p=plans[0]: lib.outlook_fused_fwd(
            v.data_ptr(), logits.data_ptr(), out.data_ptr(), B, H, H, C, heads, scale, 1, 0,
            ctypes.addressof(p), stream))
        bwd = (lambda lib=lib, p=plans[1]: lib.outlook_fused_bwd(
            v.data_ptr(), logits.data_ptr(), gout.data_ptr(), dv.data_ptr(), dl.data_ptr(), B,
            H, H, C, heads, scale, 1, 0, ctypes.addressof(p), stream))
        if fwd() or bwd():
            raise RuntimeError(f"{name}: launch failed")
        torch.cuda.synchronize()
        ref = O.outlook_attention_fused_reference(v, logits, heads, scale)
        rdv, rdl = O.outlook_attention_backward_reference(v, logits, gout, heads, scale)
        errs = [(a.float() - b.float()).abs().max().item()
                for a, b in ((out, ref), (dv, rdv), (dl, rdl))]
        print(f"{name}: max abs err out / dv / dlogits {errs}; plans {list(plans[0])} "
              f"{list(plans[1])}", flush=True)
        calls[name] = (fwd, bwd)
    times = {name: [[], []] for name in calls}
    names = list(calls)
    for turn in range(3):
        for name in (names if turn % 2 == 0 else names[::-1]):
            for side in (0, 1):
                times[name][side].append(time_call(calls[name][side], 50))
    print(f"[{B}, {H}, {H}, {C}] heads={heads} bf16 on {card_name(torch.device('cuda'))}",
          flush=True)
    for name in names:
        f, b = times[name]
        print(f"{name}: fwd {min(f):.4f} bwd {min(b):.4f} ms (rounds {['%.4f' % x for x in f]} "
              f"{['%.4f' % x for x in b]})", flush=True)
    return {name: [min(times[name][0]), min(times[name][1])] for name in names}


if __name__ == "__main__":
    main()
