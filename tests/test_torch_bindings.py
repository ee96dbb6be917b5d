"""The ctypes signatures of the CUDA kernels' entry points against their C
declarations, on the CPU.

`autoprog_tpu_torch/_build.py` loads each `csrc/*.cu` library with ctypes
and gives every entry point its `argtypes` from `SIGNATURES`. A signature
that drifts from the source does not fail to load: ctypes then passes a
pointer as a 32-bit int, or a float as an int, and the kernel reads garbage
on the card. Here the `extern "C"` block of every source is parsed and each
parameter's C type mapped to its ctypes type (`const void*` / `void*` /
`T*` -> c_void_p, `int` -> c_int, `long long` -> c_longlong, `float` ->
c_float), one case per entry point.
"""

import ctypes
import re

import pytest

from autoprog_tpu_torch import _build

_C_TO_CTYPES = {"int": ctypes.c_int, "float": ctypes.c_float, "long long": ctypes.c_longlong}


def _extern_block(src: str) -> str:
    start = src.index('extern "C" {')
    depth, i = 0, src.index("{", start)
    for j in range(i, len(src)):
        depth += {"{": 1, "}": -1}.get(src[j], 0)
        if depth == 0:
            return src[i + 1:j]
    raise ValueError("unbalanced extern \"C\" block")


def _ctype(decl: str):
    decl = " ".join(decl.split())
    if "*" in decl:
        return ctypes.c_void_p
    words = decl.split()
    return _C_TO_CTYPES[" ".join(w for w in words[:-1] if w != "const")]


def c_entry_points():
    """{name: (restype, [argtypes])} of the top-level functions declared in
    the `extern "C"` block of every source."""
    out = {}
    for path in sorted(_build.CSRC.glob("*.cu")):
        block = re.sub(r"//[^\n]*", "", _extern_block(path.read_text()))
        # top-level definitions only: strip every brace-enclosed body
        flat, depth = [], 0
        for ch in block:
            if ch == "{":
                depth += 1
            elif ch == "}":
                depth -= 1
                flat.append(";")
            elif depth == 0:
                flat.append(ch)
        for m in re.finditer(r"(\w[\w\s\*]*?)\s+(\w+)\s*\(([^)]*)\)\s*;", "".join(flat)):
            ret, name, params = m.groups()
            args = [_ctype(p) for p in params.split(",") if p.strip()]
            out[name] = (_ctype(ret.strip() + " r"), args)
    return out


ENTRIES = c_entry_points()


def test_every_entry_point_of_the_sources_has_a_signature():
    assert ENTRIES, "no extern \"C\" entry point found under csrc/"
    assert sorted(ENTRIES) == sorted(_build.SIGNATURES)


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_signature_matches_the_c_declaration(name):
    restype, argtypes = _build.SIGNATURES[name]
    assert name in ENTRIES, f"{name} is not declared in any csrc/*.cu"
    c_restype, c_argtypes = ENTRIES[name]
    assert restype is c_restype
    assert len(argtypes) == len(c_argtypes), (argtypes, c_argtypes)
    for k, (got, want) in enumerate(zip(argtypes, c_argtypes)):
        assert got is want, f"{name} argument {k}: {got.__name__} where the source has " \
                            f"{want.__name__}"


def test_variant_kernel_names_follow_the_sources_enum():
    """`mhsa_variant_launches` fills its counts in the order of the `Kernel`
    enum of `csrc/mhsa_variants.cu`; `attn_variants.KERNEL_NAMES` must name
    them in that order, and every kernel a route expects must be one of
    them."""
    from autoprog_tpu_torch.scripts import attn_variants as V
    src = (_build.CSRC / "mhsa_variants.cu").read_text()
    body = re.search(r"enum Kernel \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = [w.strip() for w in body.split(",") if w.strip()]
    assert names[-1] == "KERNELS"
    assert tuple(w.removeprefix("K_").lower() for w in names[:-1]) == V.KERNEL_NAMES
    # one count beside each launch of the file
    launches = len(re.findall(r"<<<.*?>>>\(", src, re.S))
    assert launches == len(V.KERNEL_NAMES) == len(re.findall(r"\+\+launches\[K_\w+\];", src))
    for resident, streaming in V.KERNELS_BY_ROUTE.values():
        assert set(resident.split("+")) | set(streaming.split("+")) <= set(V.KERNEL_NAMES)
