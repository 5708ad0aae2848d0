"""The SASS counting of ``repro_torch.kernels.sass`` on hand-written
instruction lists (the disassembler itself runs only on the card's machine).

Instructions are ``(address, opcode, operands)``; a predicated one carries
its predicate before a ``|`` in the operands, as ``functions`` parses it.
"""
import re

from repro_torch.kernels import sass

# a loop 0x10-0x60 whose body has a rare branch to an out-of-line call
# (0x30 -> 0x50 skips the fast block 0x30-0x40) and one unconditional jump
LOOP = [
    (0x00, "MOV", "R1, RZ"),
    (0x10, "LDG.E.128", "R4, desc[UR4][R2.64]"),
    (0x20, "ISETP.GT.U32.AND", "P0, PT, R8, 0x7df, PT"),
    (0x30, "BRA", "@P0 | 0x50"),
    (0x40, "DFMA", "R10, R4, R6, R10"),
    (0x48, "BRA", "0x58"),
    (0x50, "CALL.REL.NOINC", "0x100"),
    (0x58, "DFMA", "R12, R4, R6, R12"),
    (0x60, "BRA", "@P1 | 0x10"),
    (0x70, "STG.E.64", "desc[UR4][R14.64], R10"),
    (0x80, "EXIT", ""),
]


def test_loops_are_backward_branches():
    lps = sass.loops(LOOP)
    assert [(lp["start"], lp["end"], lp["n"]) for lp in lps] == [(0x10, 0x60, 8)]
    assert lps[0]["ops"]["DFMA"] == 2 and lps[0]["ops"]["BRA"] == 3


def test_hot_path_skips_the_out_of_line_call():
    hot = sass.hot_path(LOOP)
    # 0x10 0x20 0x30 0x40 0x48 0x58 0x60: the fast block, not the call
    assert (hot["start"], hot["end"], hot["n"]) == (0x10, 0x60, 7)
    assert "CALL" not in hot["ops"] and hot["ops"]["DFMA"] == 2


def test_shortest_path_takes_an_optional_branch_round_a_block():
    # @P0 BRA 0x40 skips two instructions: the shortest way takes it
    code = [(0x00, "ISETP.NE.AND", "P0, PT, R1, RZ, PT"),
            (0x10, "BRA", "@P0 | 0x40"),
            (0x20, "S2R", "R2, SR_TID.X"),
            (0x30, "BAR.SYNC", "0x0"),
            (0x40, "STG.E", "desc[UR4][R4.64], R2")]
    assert sass.shortest_path(code, 0x00, 0x40)["n"] == 3
    # no loop with FMAs: the hot path runs from the entry to the last store
    assert sass.hot_path(code)["n"] == 3


def test_no_hot_path_where_the_arithmetic_loops_without_fmas():
    # a row loop of products and sums (the general-width ELL SpMV): the
    # shortest way to the store would skip it, so no hot path is claimed
    code = [(0x00, "ISETP.GE.AND", "P0, PT, R1, 0x1, PT"),
            (0x10, "BRA", "@!P0 | 0x50"),
            (0x20, "DMUL", "R4, R6, R8"),
            (0x30, "DADD", "R10, R10, R4"),
            (0x40, "BRA", "@P1 | 0x20"),
            (0x50, "STG.E.64", "desc[UR4][R2.64], R10")]
    assert sass.hot_path(code) is None


def test_instruction_pattern_reads_predicates():
    line = "        /*0a90*/  @!P5 LDG.E.CONSTANT R102, desc[UR8][R14.64] ;"
    m = sass._INSN.search(line)
    assert (m.group(1), m.group(2).strip(), m.group(3)) == (
        "0a90", "@!P5", "LDG.E.CONSTANT")


def test_match_selects_the_main_path_instantiations():
    """f64 frsz2_32 at q = 8 for the block kernels (the combine with its
    shared-exponent path), the vector-load matvec (and the first matvec and
    combine, for an older checkout), the f64 ELL SpMVs; nothing else of the
    three sources."""
    pat = re.compile(sass.MATCH)
    lay = "frsz2::Layout<64, 52, 11>"
    picked = [
        f"void frsz2_block::block_dots_partial<{lay}, unsigned int, 8>(x)",
        f"void frsz2_block::block_combine_kernel<{lay}, unsigned int, 8>(x)",
        f"void frsz2_block::block_combine_kernel<{lay}, unsigned int, 8, "
        "true>(x)",
        f"void frsz2::matvec_rows_kernel<{lay}, unsigned int, true>(x)",
        f"void frsz2::matvec_rows_kernel<{lay}, unsigned int, 1>(x)",
        f"void frsz2::matvec_partial_kernel<{lay}, unsigned int>(x)",
        "void ell::ell_tile_kernel<double, ell::DenseX<double>, 7>(x)",
    ]
    skipped = [
        f"void frsz2_block::block_combine_kernel<{lay}, unsigned int, 16>(x)",
        f"void frsz2_block::block_combine_kernel<{lay}, unsigned int, 8, "
        "false>(x)",
        f"void frsz2_block::block_combine_kernel<{lay}, unsigned short, 8>(x)",
        "void frsz2_block::block_combine_kernel<frsz2::Layout<32, 23, 8>, "
        "unsigned int, 8>(x)",
        f"void frsz2::matvec_rows_kernel<{lay}, unsigned int, false>(x)",
        "void frsz2::matvec_finish_kernel<double>(x)",
        f"void frsz2::rmatvec_kernel<{lay}, unsigned int>(x)",
    ]
    assert all(pat.search(n) for n in picked)
    assert not any(pat.search(n) for n in skipped)
    assert sass.SOURCES == ("frsz2_block.cu", "frsz2_dot.cu", "ell_spmv.cu")


def test_hot_path_of_a_ring_turn_takes_no_remainder_branch():
    """A loop over whole ring turns (no per-row exit) followed by the
    straight remainder: the hot path is the loop's full turn, every row of
    it, not a row count cut short."""
    code = [(0x00, "MOV", "R1, RZ"),
            (0x10, "LDS.128", "R4, [R2]"),
            (0x20, "DFMA", "R10, R4, R6, R10"),
            (0x30, "LDS.128", "R4, [R2+0x1000]"),
            (0x40, "DFMA", "R12, R4, R6, R12"),
            (0x50, "ISETP.GE.AND", "P0, PT, R3, R7, PT"),
            (0x60, "BRA", "@!P0 | 0x10"),
            (0x70, "ISETP.GE.AND", "P1, PT, R3, R8, PT"),
            (0x80, "BRA", "@P1 | 0xa0"),
            (0x90, "DFMA", "R10, R4, R6, R10"),
            (0xa0, "STG.E.64", "desc[UR4][R14.64], R10"),
            (0xb0, "EXIT", "")]
    hot = sass.hot_path(code)
    assert (hot["start"], hot["end"], hot["n"]) == (0x10, 0x60, 6)
    assert hot["ops"]["DFMA"] == 2


def test_hot_path_runs_every_row_of_an_unrolled_turn():
    """A turn of two rows with a uniform early exit before each (a
    ``break`` past the last row): the hot path runs both rows' FMAs, not
    the exit, and still skips the out-of-line call."""
    code = [(0x00, "ISETP.GE.AND", "P0, PT, R3, R7, PT"),
            (0x10, "BRA", "@P0 | 0x90"),
            (0x20, "DFMA", "R10, R4, R6, R10"),
            (0x30, "ISETP.GE.AND", "P1, PT, R5, R7, PT"),
            (0x40, "BRA", "@P1 | 0x90"),
            (0x50, "ISETP.GT.U32.AND", "P2, PT, R8, 0x7df, PT"),
            (0x60, "BRA", "@P2 | 0x80"),
            (0x70, "BRA", "0x88"),
            (0x80, "CALL.REL.NOINC", "0x100"),
            (0x88, "DFMA", "R12, R4, R6, R12"),
            (0x90, "BRA", "@P3 | 0x0")]
    hot = sass.hot_path(code)
    assert (hot["start"], hot["end"]) == (0x00, 0x90)
    assert hot["ops"]["DFMA"] == 2 and "CALL" not in hot["ops"]
    assert hot["n"] == 10
    # without the FMA rule the shortest way takes the first exit
    assert sass.shortest_path(code, 0x00, 0x90)["n"] == 3
