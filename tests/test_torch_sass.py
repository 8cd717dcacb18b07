"""``tools.sass``'s readers of the compiler's reports, on the CPU: ptxas's
``-v`` log and a ``cuobjdump -sass`` listing, in the formats the CUDA 12
toolkit prints (the tool itself needs nvcc and runs on the card's
machine)."""

import pytest

from cl_multiview_stereo_tpu_torch.tools import sass

ASSIGN = "_ZN12_GLOBAL__N_113assign_kernelEPKfS1_S1_Piiiiiiiifff"
GATHER = "_ZN12_GLOBAL__N_118consistency_kernelILb1EEEvPKfS2_"

PTXAS_LOG = f"""ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{ASSIGN}' for 'sm_90a'
ptxas info    : Function properties for {ASSIGN}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 72 registers, used 1 barriers, 7800 bytes smem, 448 bytes cmem[0]
ptxas info    : Compiling entry function '{GATHER}' for 'sm_90a'
ptxas info    : Function properties for {GATHER}
    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 48 registers, used 0 barriers, 400 bytes cmem[0]
"""

LISTING = f"""
Fatbin elf code:
================
arch = sm_90a
code version = [1,7]
host = linux
compile_size = 64bit

	code for sm_90a
		Function : {ASSIGN}
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                      /* 0x00000a00ff017b82 */
                                                                                /* 0x000fe40000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;                          /* 0x0000000000007919 */
        /*0020*/               @P0 BRA 0x60 ;                                  /* 0x0000000000000947 */
        /*0030*/                   EXIT ;                                      /* 0x000000000000794d */
        /*0040*/                   BRA 0x40;                                   /* 0xfffffffc00fc7947 */
        /*0050*/                   NOP;                                        /* 0x0000000000007918 */
		..........

		Function : {GATHER}
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED"
        /*0000*/                   MUFU.RSQ R3, R2 ;                           /* 0x0000000200037308 */
        /*0010*/                   NOP;                                        /* 0x0000000000007918 */
"""


@pytest.mark.parametrize("sym, want", [
    (ASSIGN, "assign_kernel"),
    (GATHER, "consistency_kernel<true>"),
    ("_ZN12_GLOBAL__N_118consistency_kernelILb0EEEvPKf", "consistency_kernel<false>"),
    ("vote_kernel", "vote_kernel"),
])
def test_short_name(sym, want):
    assert sass.short_name(sym) == want


def test_ptxas_report_reads_registers_and_spills():
    assert sass.ptxas_report(PTXAS_LOG) == {
        "assign_kernel": {"registers": 72, "spill_bytes": 0},
        "consistency_kernel<true>": {"registers": 48, "spill_bytes": 12},
    }


def test_sass_counts_leave_out_nops():
    """Each function's instruction lines, a predicated one included, the
    encoding's second lines and the NOPs left out."""
    assert sass.sass_counts(LISTING) == {"assign_kernel": 5, "consistency_kernel<true>": 1}
