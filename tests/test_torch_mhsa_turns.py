"""The SASS comparison of `scripts/mhsa_turns.py`, on the CPU: kernels that
differ only in register and predicate numbers or branch targets are told
apart from kernels whose instructions differ."""

from autoprog_tpu_torch.scripts import mhsa_turns as T

_DUMP = """
	code for sm_90a
		Function : _ZN{ns}14mhsa_fwd_res_aEv
	.headerflags	@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                      /* 0x00000a00ff017b82 */
        /*0010*/                   IMAD.MOV.U32 R{r}, RZ, RZ, 0x3f800000 ;     /* 0x3f800000ff047424 */
        /*0020*/               @!P{p} BRA 0x{target} ;                        /* 0x0000000000008947 */
        /*0030*/                   EXIT ;                                     /* 0x000000000000794d */
		Function : _ZN{ns}8mhsa_bwdEv
        /*0000*/                   FADD R2, R2, {const} ;                     /* 0x0000000000000000 */
"""


def _dump(ns="_GLOBAL__N__1a2b3c4d_11_mhsa_qkv_cu_0badf00d", r=4, p=0, target="0030",
          const="1"):
    return T.parse_sass(_DUMP.format(ns=ns, r=r, p=p, target=target, const=const))


def test_parse_drops_the_anonymous_namespace_hash():
    a = _dump()
    b = _dump(ns="_GLOBAL__N__99ff00aa_11_mhsa_qkv_cu_12345678")
    assert list(a) == list(b) == ["_ZN14mhsa_fwd_res_aEv", "_ZN8mhsa_bwdEv"]
    assert T.short_kernel("_ZN4412mhsa_fwd_resILi32ELi7EEEvNS_4SlabIK13__nv_bf") == \
        "mhsa_fwd_res<32, 7>"
    assert a["_ZN14mhsa_fwd_res_aEv"][1] == "IMAD.MOV.U32 R4, RZ, RZ, 0x3f800000"


def test_register_renaming_is_told_apart_from_other_changes():
    base = _dump()
    assert T.compare_sass(base, _dump()) == {
        "same": sorted(base), "same_but_registers": [], "other": []}
    renamed = T.compare_sass(_dump(r=6, p=1, target="0040"), base)
    assert renamed["same_but_registers"] == ["_ZN14mhsa_fwd_res_aEv"]
    # a constant is no register: a changed immediate is another kernel
    changed = T.compare_sass(_dump(const="2"), base)
    assert changed["other"] == [{"name": "_ZN8mhsa_bwdEv", "instructions": [1, 1],
                                 "unmatched": 1}]
    # a kernel the other tree lacks
    assert [k["instructions"] for k in T.compare_sass(base, {})["other"]] == [[4, 0], [1, 0]]
