"""minio_tpu_torch.utils.sass on hand-written SASS listings: the hot loop
it picks and the cycles per trip of its loop-carried chain, worked out by
hand under the module's latency model."""

import pytest

from minio_tpu_torch.utils import sass

# a 64-bit accumulator through a wide multiply: R2:R3 -> IMAD.WIDE (5) ->
# IADD3 low (4) -> IADD3.X high (4) = 13 cycles per trip
CHAIN = """
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   IMAD.WIDE.U32 R4, R2, R3, RZ ;
        /*0020*/                   IADD3 R2, P0, R4, R2, RZ ;
        /*0030*/                   IADD3.X R3, R5, R3, RZ, P0, !PT ;
        /*0040*/                   ISETP.NE.AND P1, PT, R2, RZ, PT ;
        /*0050*/               @P1 BRA 0x10 ;
        /*0060*/                   EXIT ;
"""

# an outer loop around an inner one, a shuffle loop after them, and an
# independent shared load in the inner loop that the chain must not count
NESTED = """
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   LDS R8, [R0] ;
        /*0020*/                   IMAD.WIDE.U32 R4, R6, R7, R4 ;
        /*0030*/                   LDS.64 R10, [R0+0x10] ;
        /*0040*/                   LOP3.LUT R6, R4, R8, RZ, 0x3c, !PT ;
        /*0050*/                   IADD3 R0, R0, 0x4, RZ ;
        /*0060*/                   ISETP.NE.AND P0, PT, R0, R9, PT ;
        /*0070*/               @P0 BRA 0x20 ;
        /*0080*/                   IADD3 R12, R12, 0x1, RZ ;
        /*0090*/                   ISETP.NE.AND P1, PT, R12, R13, PT ;
        /*00a0*/               @P1 BRA 0x10 ;
        /*00b0*/                   SHFL.BFLY PT, R14, R6, 0x1, 0x1f ;
        /*00c0*/                   IMAD.WIDE.U32 R4, R14, R7, R4 ;
        /*00d0*/                   IMAD.WIDE.U32 R4, R14, R7, R4 ;
        /*00e0*/                   BRA 0xb0 ;
        /*00f0*/                   EXIT ;
"""

# a predicated branch with a register operand before its target
PRED_BRANCH = """
        /*0100*/                   IMAD.WIDE.U32 R4, R2, R3, R4 ;
        /*0110*/                   MOV R2, R4 ;
        /*0120*/              @!P0 BRA P1, 0x100 ;
"""


def test_parse_reads_dests_sources_and_branches():
    ins = sass.parse(CHAIN)
    assert [i.addr for i in ins] == [0, 0x10, 0x20, 0x30, 0x40, 0x50, 0x60]
    assert ins[1].dests == ["R4", "R5"] and ins[1].srcs == ["R2", "R3"]
    assert ins[2].dests == ["R2", "P0"] and ins[2].srcs == ["R4", "R2"]
    assert ins[3].dests == ["R3"] and "P0" in ins[3].srcs
    assert ins[4].dests == ["P1"]
    assert ins[5].target == 0x10 and ins[5].srcs == ["P1"]


@pytest.mark.parametrize("text, loop, slots, cycles", [
    (CHAIN, ["0x10", "0x50"], 5, 13.0),
    # R4:R5 -> IMAD.WIDE (5) -> LOP3 R6 (4) -> next IMAD.WIDE: 9 per trip
    (NESTED, ["0x20", "0x70"], 6, 9.0),
    # R4:R5 -> IMAD.WIDE (5) -> MOV R2 (4) -> next IMAD.WIDE: 9 per trip
    (PRED_BRANCH, ["0x100", "0x120"], 3, 9.0),
])
def test_analyse_picks_the_inner_loop_and_its_chain(text, loop, slots,
                                                    cycles):
    got = sass.analyse(text)
    assert got["loop"] == loop
    assert got["issue_slots"] == slots
    assert got["chain_cycles"] == cycles
    assert got["latency_model"] == sass.LATENCY
    assert sum(got["opcodes"].values()) == slots


def test_wide_multiply_reads_its_addend_pair():
    ins = sass.parse(NESTED)
    assert ins[2].srcs == ["R6", "R7", "R4", "R5"]
    assert ins[3].dests == ["R10", "R11"] and ins[3].srcs == ["R0"]
    shfl = next(i for i in ins if i.base == "SHFL")
    assert shfl.dests == ["R14"] and shfl.srcs == ["R6"]


def test_need_and_avoid_pick_among_inner_loops():
    # the copy loop holds more wide multiplies (addresses) but also
    # LDGSTS; asking for LDS and avoiding LDGSTS picks the hash loop
    copy_loop = """
        /*0200*/                   IMAD.WIDE R2, R9, 0x10, R2 ;
        /*0210*/                   IMAD.WIDE R4, R9, 0x10, R4 ;
        /*0220*/                   IMAD.WIDE.U32 R6, R9, 0x10, R6 ;
        /*0230*/                   LDGSTS.E.BYPASS.128 [R8], desc[UR4][R2.64] ;
        /*0240*/               @P2 BRA 0x200 ;
"""
    text = NESTED + copy_loop
    assert sass.analyse(text)["loop"] == ["0x200", "0x240"]
    got = sass.analyse(text, need=("IMAD.WIDE", "LDS"),
                       avoid=("SHFL", "LDGSTS"))
    assert got["loop"] == ["0x20", "0x70"]
    ins = sass.parse(copy_loop)
    assert ins[3].dests == [] and ins[3].srcs == ["R8", "UR4", "R2", "R3"]


def test_no_matching_loop_raises():
    with pytest.raises(ValueError):
        sass.analyse(CHAIN, need=("FFMA",))


def test_function_text_picks_the_named_function():
    dump = ("\n\tcode for sm_90a\n\t\tFunction : _Z5otherv\n" + CHAIN +
            "\n\t\tFunction : _ZN12_GLOBAL__N_112hh256_kernelEPKh\n" +
            PRED_BRANCH)
    assert sass.analyse(sass.function_text(dump, "hh256_kernel"))[
        "loop"] == ["0x100", "0x120"]
    with pytest.raises(ValueError):
        sass.function_text(dump, "missing_kernel")


def test_packet_loop_reports_an_unreadable_library(tmp_path):
    # a missing library raises, so no caller takes a floor it could not read
    with pytest.raises(FileNotFoundError):
        sass.packet_loop(str(tmp_path / "libhh256.so"))
