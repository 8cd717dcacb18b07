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
    ("_ZN39_GLOBAL__N__90fbc643_7_slic_cu_4ee610eb11vote_kernelILi4EEEvPKiPiiii", "vote_kernel<4>"),
    ("_ZN40_GLOBAL__N__8f2e47ec_8_color_cu_30fcb7b710lab_kernelIhEEvPKT_Pfii", "lab_kernel<unsigned char>"),
    ("_ZN40_GLOBAL__N__8f2e47ec_8_color_cu_30fcb7b710lab_kernelIfEEvPKT_Pfii", "lab_kernel<float>"),
    ("_ZN12_GLOBAL__N_113raster_kernelILi4ELi4ELb0EEEvPKiPKfS4_S4_S4_Pfiiiii", "raster_kernel<4, 4, false>"),
    ("_ZN12_GLOBAL__N_113raster_kernelILi1ELi1ELb1EEEvPKiPKfS4_S4_S4_Pfiiiii", "raster_kernel<1, 1, true>"),
    ("_ZN46_GLOBAL__N__84e836c1_13_crosscheck_cu_fe5ccc4a16fuse_vote_kernelILi9EiEEvPKfS2_Pfiiiiiiff",
     "fuse_vote_kernel<9, int>"),
    ("_ZN46_GLOBAL__N__84e836c1_13_crosscheck_cu_fe5ccc4a16fuse_warp_kernelILi2ELi3ExEEvPKfPfiiiiiif",
     "fuse_warp_kernel<2, 3, long long>"),
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


MOVES = "_ZN12_GLOBAL__N_119smooth_moves_kernelEPKfS1_S1_S1_Pfiiiiiiixiiiif"
LOOPS = f"""
		Function : {MOVES}
        /*0000*/                   MUFU.RCP R3, R2 ;                           /* 0x0000000200037308 */
        /*0010*/                   FFMA R4, -R2, R3, 1 ;                       /* 0x0000000200037308 */
        /*0020*/                   LDS.128 R8, [R0] ;                          /* 0x0000000200037308 */
        /*0030*/                   MUFU.EX2 R5, R4 ;                           /* 0x0000000200037308 */
        /*0040*/                   FADD R6, R6, R5 ;                           /* 0x0000000200037308 */
        /*0050*/               @P0 BRA 0x20 ;                                  /* 0x0000000200037308 */
        /*0060*/                   MUFU.EX2 R5, R4 ;                           /* 0x0000000200037308 */
        /*0070*/                   MUFU.RCP R7, R2 ;                           /* 0x0000000200037308 */
        /*0080*/                   FCHK P1, R4, R2 ;                           /* 0x0000000200037308 */
        /*0090*/               @P1 BRA 0xd0 ;                                  /* 0x0000000200037308 */
        /*00a0*/                   FADD R6, R6, R5 ;                           /* 0x0000000200037308 */
        /*00b0*/                   NOP;                                        /* 0x0000000200037308 */
        /*00c0*/              @!P2 BRA 0x60 ;                                  /* 0x0000000200037308 */
        /*00d0*/              @!P3 BRA 0x10 ;                                  /* 0x0000000200037308 */
        /*00e0*/                   EXIT ;                                      /* 0x0000000200037308 */
        /*00f0*/                   BRA 0xf0;                                   /* 0x0000000200037308 */
"""


def test_sfu_counts_and_inner_loops():
    """The special-function ops and FCHK of a kernel by op, and its
    innermost loops (a backward branch's span holding no other): the fast
    tap loop at 0x20 with one EX2, the full loop at 0x60 with its divide's
    RCP and FCHK; the loop around both and the end's self-branch are not
    innermost loops."""
    code = sass.sass_code(LOOPS)["smooth_moves_kernel"]
    assert len(code) == 15 and code[0] == (0, "MUFU.RCP R3, R2")
    assert sass.sfu_counts(code) == {"FCHK": 1, "MUFU.EX2": 2, "MUFU.RCP": 2}
    assert sass.inner_loops(code) == [
        {"at": "0x20", "instructions": 4, "sfu": {"MUFU.EX2": 1}},
        {"at": "0x60", "instructions": 6, "sfu": {"FCHK": 1, "MUFU.EX2": 1, "MUFU.RCP": 1}},
    ]
