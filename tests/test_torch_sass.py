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


# sha256 with warp specialisation: a producer staging loop (cp.async),
# a producer schedule loop (shared loads and stores, three funnel shifts)
# and the round warp's loop (shared loads, two funnel shifts). The round
# chain: R26 -> SHF (4) -> LOP3 (4) -> IADD3 (4) = 12 cycles per trip;
# the shared load (23) hangs off the address chain, 4 cycles per trip.
WARP_SPECIALISED = """
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   LDGSTS.E.BYPASS.128 [R2], desc[UR4][R4.64] ;
        /*0020*/                   IADD3 R2, R2, 0x10, RZ ;
        /*0030*/                   SHF.R.U32.HI R9, RZ, 0x4, R2 ;
        /*0040*/                   ISETP.NE.AND P0, PT, R2, R3, PT ;
        /*0050*/               @P0 BRA 0x10 ;
        /*0060*/                   LDS.128 R12, [R6] ;
        /*0070*/                   SHF.R.W.U32 R16, R12, 0x7, R12 ;
        /*0080*/                   SHF.R.W.U32 R17, R12, 0x12, R12 ;
        /*0090*/                   SHF.R.U32.HI R18, RZ, 0x3, R12 ;
        /*00a0*/                   LOP3.LUT R16, R16, R17, R18, 0x96, !PT ;
        /*00b0*/                   IADD3 R13, R13, R16, R14 ;
        /*00c0*/                   STS.128 [R7], R12 ;
        /*00d0*/                   IADD3 R6, R6, 0x40, RZ ;
        /*00e0*/                   ISETP.NE.AND P1, PT, R6, R8, PT ;
        /*00f0*/               @P1 BRA 0x60 ;
        /*0100*/                   LDS.128 R20, [R10] ;
        /*0110*/                   SHF.R.W.U32 R24, R26, 0x6, R26 ;
        /*0120*/                   SHF.R.W.U32 R25, R26, 0xb, R26 ;
        /*0130*/                   LOP3.LUT R24, R24, R25, R27, 0x96, !PT ;
        /*0140*/                   IMAD.IADD R27, R27, 0x1, R20 ;
        /*0150*/                   IADD3 R26, R24, R20, R26 ;
        /*0160*/                   VIADD R10, R10, 0x200 ;
        /*0170*/                   ISETP.NE.AND P2, PT, R10, R11, PT ;
        /*0180*/               @P2 BRA 0x100 ;
        /*0190*/                   EXIT ;
"""

# sha256 as one thread per row doing schedule and rounds from global
# loads (the kernel of git 649558e): the chain R12 -> SHF -> LOP3 -> IADD3
# is 12 cycles per trip; the load (400) and its byte permute feed it once
# and then fall behind, their address advancing 4 cycles per trip
ONE_THREAD = """
        /*0000*/                   LDG.E.128.CONSTANT R4, desc[UR4][R2.64] ;
        /*0010*/                   PRMT R8, R4, 0x123, RZ ;
        /*0020*/                   SHF.R.W.U32 R9, R12, 0x6, R12 ;
        /*0030*/                   SHF.R.W.U32 R10, R12, 0xb, R12 ;
        /*0040*/                   LOP3.LUT R9, R9, R10, R13, 0x96, !PT ;
        /*0050*/                   IADD3 R12, R9, R8, R12 ;
        /*0060*/                   IADD3 R2, P0, R2, 0x40, RZ ;
        /*0070*/                   IADD3.X R3, RZ, R3, RZ, P0, !PT ;
        /*0080*/                   ISETP.NE.AND P1, PT, R2, R14, PT ;
        /*0090*/               @P1 BRA 0x0 ;
        /*00a0*/                   EXIT ;
"""


@pytest.mark.parametrize("text, loop, pipes, adds", [
    # the round warp's loop, not the producers' (more funnel shifts, but
    # shared stores) nor the staging loop (cp.async)
    (WARP_SPECIALISED, ["0x100", "0x180"],
     {"mem": 1, "alu": 5, "fma": 2, "other": 1}, {"alu": 1, "fma": 2}),
    (ONE_THREAD, ["0x0", "0x90"],
     {"mem": 1, "alu": 8, "other": 1}, {"alu": 3, "fma": 0}),
])
def test_sha256_block_loop_reads_the_round_loop(text, loop, pipes, adds):
    got = sass.sha256_block_loop(text)
    assert got["loop"] == loop
    assert got["chain_cycles"] == 12.0
    assert got["pipes"] == pipes
    assert got["adds"] == adds
    assert sum(got["pipes"].values()) == got["issue_slots"]


def test_funnel_shift_rule_alone_takes_the_producer_loop():
    # why block_loop asks for shared loads and passes over shared stores
    got = sass.analyse(WARP_SPECIALISED, need=("SHF",), avoid=("SHFL",))
    assert got["loop"] == ["0x60", "0xf0"]


def test_block_loop_reports_an_unreadable_library(tmp_path):
    with pytest.raises(FileNotFoundError):
        sass.block_loop(str(tmp_path / "libsha256.so"))


# chacha20 as one thread per block with its row and package from 64-bit
# divides (the kernel of git e8d2d0c): the divide is a CALL.REL to nvcc's
# subroutine, then the straight run of the rounds (a quarter round's
# adds, xors and rotates), then the stores behind a branch
UNROLLED_DIV64 = """
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   ISETP.GE.U32.AND P0, PT, R0, R2, PT ;
        /*0020*/               @P0 EXIT ;
        /*0030*/                   CALL.REL.NOINC `($__internal_0_$__cuda_sm20_div_s64) ;
        /*0040*/                   IADD3 R4, R4, R5, RZ ;
        /*0050*/                   LOP3.LUT R7, R7, R4, RZ, 0x3c, !PT ;
        /*0060*/                   PRMT R7, R7, 0x1032, RZ ;
        /*0070*/                   IADD3 R6, R6, R7, RZ ;
        /*0080*/                   LOP3.LUT R5, R5, R6, RZ, 0x3c, !PT ;
        /*0090*/                   SHF.L.W.U32.HI R5, R5, 0xc, R5 ;
        /*00a0*/                   IMAD.IADD R4, R4, 0x1, R5 ;
        /*00b0*/                   ISETP.GE.AND P1, PT, R8, 0x40, PT ;
        /*00c0*/              @!P1 BRA 0x100 ;
        /*00d0*/                   STG.E.128 desc[UR4][R10.64], R4 ;
        /*00e0*/                   EXIT ;
        /*0100*/                   STG.E.U8 desc[UR4][R10.64], R4 ;
        /*0110*/                   EXIT ;
        /*0120*/                   IADD3 R2, R2, 0x1, RZ ;
        /*0130*/                   RET.REL.NODEC R20 0x0 ;
"""

# the tiled kernel: a staging loop, the barrier, the rounds with adds as
# IMAD by a constant-bank one, no call
UNROLLED_TILED = """
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   LDGSTS.E.BYPASS.128 [R2], desc[UR4][R4.64] ;
        /*0020*/                   IADD3 R0, R0, 0x100, RZ ;
        /*0030*/                   ISETP.GE.AND P0, PT, R0, R9, PT ;
        /*0040*/              @!P0 BRA 0x10 ;
        /*0050*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0060*/                   LDS.128 R4, [UR6] ;
        /*0070*/                   IMAD R4, R5, c[0x0][0x250], R4 ;
        /*0080*/                   LOP3.LUT R7, R7, R4, RZ, 0x3c, !PT ;
        /*0090*/                   PRMT R7, R7, 0x1032, RZ ;
        /*00a0*/                   IMAD R6, R7, c[0x0][0x250], R6 ;
        /*00b0*/                   LOP3.LUT R5, R5, R6, RZ, 0x3c, !PT ;
        /*00c0*/                   SHF.L.W.U32.HI R5, R5, 0xc, R5 ;
        /*00d0*/                   IADD3 R4, R5, R4, RZ ;
        /*00e0*/                   IMAD.MOV.U32 R8, RZ, RZ, R4 ;
        /*00f0*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0100*/                   STS.128 [R3], R4 ;
        /*0110*/                   EXIT ;
"""


@pytest.mark.parametrize("text, run, pipes, adds, divide64", [
    (UNROLLED_DIV64, ["0x30", "0xc0"], {"other": 2, "alu": 7, "fma": 1},
     {"alu": 2, "fma": 1}, True),
    # the run spans the barriers (no branch); IMAD.MOV is not an add
    (UNROLLED_TILED, ["0x50", "0x110"],
     {"other": 3, "mem": 2, "fma": 3, "alu": 5}, {"alu": 1, "fma": 2},
     False),
], ids=["div64", "tiled"])
def test_unrolled_reads_the_straight_run(text, run, pipes, adds, divide64):
    got = sass.unrolled(text)
    assert got["run"] == run
    assert got["pipes"] == pipes
    assert got["adds"] == adds
    assert got["divide64"] is divide64
    assert sum(got["pipes"].values()) == got["run_instructions"]
    assert got["function_instructions"] == len(sass.parse(text))


def test_straight_runs_split_at_branches_targets_and_returns():
    runs = sass.straight_runs(sass.parse(UNROLLED_DIV64))
    assert [(r[0].addr, r[-1].addr) for r in runs] == [
        (0x0, 0x20), (0x30, 0xc0), (0xd0, 0xe0), (0x100, 0x110),
        (0x120, 0x130)]
    assert sass.unrolled(UNROLLED_DIV64)["calls"] == ["CALL.REL.NOINC"]


def test_keystream_block_reports_an_unreadable_library(tmp_path):
    with pytest.raises(FileNotFoundError):
        sass.keystream_block(str(tmp_path / "libchacha20.so"))
