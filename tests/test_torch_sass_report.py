"""The SASS report's parsers (image_stitch_tpu_torch/sass_report.py) on
listings in the form that ptxas and cuobjdump print. Compiling and
disassembling need the CUDA toolkit and run on the GPU machine."""

from image_stitch_tpu_torch.sass_report import parse_ptxas, parse_sass

SASS = """
        Function : _ZN12_GLOBAL__N_16kernelEv
        .headerflags    @"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS"
        /*0000*/                   LDC R1, c[0x0][0x28] ;           /* 0x00000a00ff017b82 */
                                                                    /* 0x000fe20000000800 */
        /*0010*/                   IADD3 R0, R0, 0x1, RZ ;          /* 0x0000000100007810 */
        /*0020*/                   NOP ;                            /* 0x0000000000007918 */
        /*0030*/               @P0 BRA 0x10 ;                       /* 0xfffffffc00000947 */
        /*0040*/                   ISETP.GE.AND P1, PT, R0, 0x8, PT ; /* 0x0 */
        /*0050*/              @!P1 BRA.U 0x0 ;                      /* 0x0 */
        /*0060*/                   EXIT ;                           /* 0x000000000000794d */
        /*0070*/                   BRA 0x70;                        /* 0xfffffff000007947 */
        Function : _Z5otherv
        /*0000*/                   EXIT ;                           /* 0x0 */
"""

PTXAS = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_16kernelEv' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_16kernelEv
    0 bytes stack frame, 52 bytes spill stores, 48 bytes spill loads
ptxas info    : Used 64 registers, 324 bytes smem, 384 bytes cmem[0]
ptxas info    : Compiling entry function '_Z5otherv' for 'sm_90a'
ptxas info    : Function properties for _Z5otherv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 8 registers, 384 bytes cmem[0]
"""


def test_parse_sass_counts_instructions_and_loops():
    """NOPs are not counted; a loop runs from a backward branch's target to
    the branch, innermost first; the branch to itself after EXIT is none."""
    got = parse_sass(SASS)
    assert got["_ZN12_GLOBAL__N_16kernelEv"] == {
        "instructions": 7, "loops": [(0x10, 0x30, 2), (0x0, 0x50, 5)]}
    assert got["_Z5otherv"] == {"instructions": 1, "loops": []}


def test_parse_ptxas_reads_registers_spills_and_smem():
    got = parse_ptxas(PTXAS)
    assert got["_ZN12_GLOBAL__N_16kernelEv"] == {
        "spill_stores": 52, "spill_loads": 48, "registers": 64, "smem": 324}
    assert got["_Z5otherv"] == {"spill_stores": 0, "spill_loads": 0, "registers": 8}
