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
    combine, for an older checkout), the f64 rmatvec at l = 32 and 16 (the
    vector-load route, and the first design for an older checkout), the f64
    ELL SpMVs (the batched one at
    w = 7), the decode attention at l = 16, D = 128, G = 8 (the tiled kernel
    and, for an older checkout, the first one); nothing else of those four
    sources (the codec's: ``test_codec_kernels_and_their_values_a_thread``)."""
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
        f"void frsz2::rmatvec_rows_kernel<{lay}, unsigned int, 4, true>(x)",
        f"void frsz2::rmatvec_rows_kernel<{lay}, unsigned short, 8, 1>(x)",
        f"void frsz2::rmatvec_kernel<{lay}, unsigned int>(x)",
        f"void frsz2::rmatvec_kernel<{lay}, unsigned short>(x)",
        "void ell::ell_tile_kernel<double, ell::DenseX<double>, 7>(x)",
        "void ell::ell_tile_batched_kernel<double, 7>(x)",
        "void frsz2::attn::split_kernel<float, unsigned short, 128, 8>(x)",
        "void frsz2::attn::split_kernel<__nv_bfloat16, unsigned short, 128, "
        "8>(x)",
        "void frsz2::attn::split_kernel<float, unsigned short, 4, 8>(x)",
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
        f"void frsz2::rmatvec_rows_kernel<{lay}, unsigned int, 4, false>(x)",
        f"void frsz2::rmatvec_rows_kernel<{lay}, unsigned char, 16, true>(x)",
        "void frsz2::rmatvec_rows_kernel<frsz2::Layout<32, 23, 8>, unsigned "
        "int, 4, true>(x)",
        f"void frsz2::rmatvec_kernel<{lay}, unsigned char>(x)",
        "void frsz2::rmatvec_kernel<frsz2::Layout<32, 23, 8>, unsigned "
        "short>(x)",
        "void ell::ell_tile_batched_kernel<float, 7>(x)",
        "void ell::ell_tile_batched_kernel<double, 27>(x)",
        "void frsz2::attn::split_kernel<float, unsigned char, 128, 8>(x)",
        "void frsz2::attn::split_kernel<float, unsigned short, 64, 8>(x)",
        "void frsz2::attn::split_kernel<float, unsigned short, 128, 4>(x)",
        "void frsz2::attn::merge_kernel<float>(x)",
    ]
    assert all(pat.search(n) for n in picked)
    assert not any(pat.search(n) for n in skipped)
    assert sass.SOURCES == ("frsz2_block.cu", "frsz2_dot.cu", "ell_spmv.cu",
                            "decode_attn.cu", "frsz2_codec.cu")


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


# the tiled decode attention, shrunk: a tile loop 0x10-0xb0 holding the
# logits' FFMAs, a guarded K loop that always calls (0x30-0x48), and a P.V
# loop (0x80-0x98) of 32 FFMAs a pass (written as one with a count)
ATTN = [
    (0x00, "S2R", "R0, SR_TID.X"),
    (0x10, "BAR.SYNC", "0x0"),
    (0x18, "BRA", "@P0 | 0x30"),
    (0x20, "FFMA", "R4, R5, R6, R4"),
    (0x28, "BRA", "0x50"),
    (0x30, "CALL.REL.NOINC", "0x200"),
    (0x38, "FFMA", "R4, R5, R6, R4"),
    (0x48, "BRA", "@P1 | 0x30"),
    (0x50, "SHFL.BFLY", "PT, R7, R4, 0x10, 0x1f"),
    (0x58, "BAR.SYNC", "0x0"),
    (0x60, "MUFU.EX2", "R8, R9"),
    (0x68, "BAR.SYNC", "0x0"),
    (0x70, "BRA", "@P2 | 0xa8"),
    (0x80, "LDS.64", "R10, [R11]"),
    (0x88, "FFMA", "R12, R13, R14, R12"),
    (0x90, "FADD", "R15, R15, -8388608"),
    (0x98, "BRA", "@P3 | 0x80"),
    (0xa8, "IADD3", "R1, R1, 0x40, RZ"),
    (0xb0, "BRA", "@P4 | 0x10"),
    (0xc0, "STG.E", "desc[UR4][R2.64], R4"),
    (0xd0, "EXIT", ""),
]


def test_attn_per_position_counts_a_tile_and_its_pv_passes(monkeypatch):
    """The tile loop's hot pass takes the fast K path (no call) and the P.V
    loop once; the P.V loop's other passes are added, and the tile's warps
    share its positions.  With 1 head (32 FFMAs a P.V pass: here one FFMA
    stands for them) the P.V loop holds one position a pass."""
    monkeypatch.setattr(sass, "ATTN_HEADS", 1)
    monkeypatch.setattr(sass, "ATTN_D", 32)
    geo = dict(kWarps=4, kTile=64, kPvCols=4)
    unit = sass.attn_per_position(ATTN, geo)
    # tile pass: 0x10 0x18 0x20 0x28 0x50 0x58 0x60 0x68 0x70 0x80 0x88 0x90
    # 0x98 0xa8 0xb0 = 15; P.V pass 0x80-0x98 = 4; 1/4 FFMA a head-column;
    # 32 * 4 / (32 / 4) = 16 position lanes
    assert unit["design"] == "tiled"
    assert (unit["pass_n"], unit["pv_n"]) == (15, 4)
    assert unit["positions_a_pv_pass"] == 0.25
    per_tile = 15 + (64 / 16 / 0.25 - 1) * 4
    assert unit["per_tile_warp"] == per_tile
    assert unit["per_position"] == per_tile * 4 / 64


def test_attn_per_position_of_the_first_design_is_its_loop_pass(monkeypatch):
    """One loop with FFMAs: a pass is one position of a warp."""
    monkeypatch.setattr(sass, "ATTN_HEADS", 1)
    monkeypatch.setattr(sass, "ATTN_D", 32)
    code = [(0x00, "LDG.E.64", "R2, desc[UR4][R4.64]"),
            (0x10, "FFMA", "R6, R2, R3, R6"),
            (0x18, "FFMA", "R7, R2, R3, R7"),
            (0x20, "FFMA", "R8, R2, R3, R8"),
            (0x28, "SHFL.BFLY", "PT, R9, R6, 0x10, 0x1f"),
            (0x30, "BRA", "@P0 | 0x0"),
            (0x40, "EXIT", "")]
    unit = sass.attn_per_position(code, {})
    # (2 * 32 / 32 + 1) * 1 = 3 FFMAs a position: one position a pass
    assert unit == dict(design="a warp a position", pass_n=6,
                        positions_a_pass=1.0, per_position=6.0)


def test_ell_per_slot_counts_the_column_loop_for_q8():
    code = [(0x00, "LDS", "R1, [R2]"),
            (0x10, "LDG.E.64", "R4, desc[UR4][R6.64]"),
            (0x20, "DMUL", "R8, R4, R10"),
            (0x30, "DADD", "R12, R12, R8"),
            (0x40, "STG.E.64", "desc[UR4][R14.64], R12"),
            (0x50, "BRA", "@P0 | 0x10"),
            (0x60, "EXIT", "")]
    one = sass.ell_per_slot(code, batched=False)
    assert one == dict(way_n=5, per_slot=5 / sass.ELL_W)
    many = sass.ell_per_slot(code, batched=True, geo=dict(kCols=4))
    loop_n = 5                                  # 0x10 .. 0x50
    q8 = 5 + (sass.ELL_Q // 4 - 1) * loop_n
    assert many == dict(way_n=5, loop_n=loop_n, q8_n=q8,
                        per_slot=q8 / (sass.ELL_W * sass.ELL_Q))


def test_divergence_branch_falls_through_on_the_hot_path():
    """``BRA.DIV`` (the shuffles' fallback, taken only by a diverged warp)
    carries no predicate but is conditional: the hot path falls through."""
    code = [(0x00, "FFMA", "R4, R5, R6, R4"),
            (0x10, "BRA.DIV", "UR4, 0x60"),
            (0x20, "SHFL.BFLY", "PT, R7, R4, 0x10, 0x1f"),
            (0x30, "FFMA", "R8, R7, R6, R8"),
            (0x40, "BRA", "@P0 | 0x0"),
            (0x50, "EXIT", ""),
            (0x60, "WARPSYNC", "0xffffffff"),
            (0x70, "BRA", "0x20")]
    hot = sass.hot_path(code)
    assert (hot["start"], hot["end"], hot["n"]) == (0x00, 0x40, 5)
    assert hot["ops"]["SHFL"] == 1 and "WARPSYNC" not in hot["ops"]


def test_geometry_is_read_from_the_counted_sources(tmp_path):
    """The counts take the kernels' geometry from the sources they compile:
    this package's are the decode attention's 4 warps, 64-position tiles
    (the split rule's tile, ``decode_attn.TILE``) and 4 P.V columns a
    thread, and the batched ELL's 4 columns a pass; an older source without
    them yields none."""
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attn as KA

    geo = sass.geometry(build.CSRC)
    assert geo == dict(kWarps=4, kTile=KA.TILE, kPvCols=4, kCols=4)
    for src in sass.GEOMETRY:
        (tmp_path / src).write_text("constexpr int kOther = 3;\n")
    assert sass.geometry(tmp_path) == {}


# a grid-stride codec loop 0x10-0x90: a vector load, or element loads when
# the chunk is not whole (0x20 -> 0x50); a vector store; an exponent store
# once a block (0x70 skips it)
CODEC = [
    (0x00, "S2R", "R0, SR_TID.X"),
    (0x10, "ISETP.GE.AND", "P0, PT, R2, R3, PT"),
    (0x20, "BRA", "@P0 | 0x50"),
    (0x30, "LDG.E.128", "R4, desc[UR4][R8.64]"),
    (0x40, "BRA", "0x60"),
    (0x50, "LDG.E.64", "R4, desc[UR4][R8.64]"),
    (0x58, "LDG.E.64", "R6, desc[UR4][R8.64+0x8]"),
    (0x60, "STG.E.64", "desc[UR4][R10.64], R4"),
    (0x70, "BRA", "@P1 | 0x88"),
    (0x80, "STG.E", "desc[UR4][R12.64], R5"),
    (0x88, "IADD3", "R2, R2, R1, RZ"),
    (0x90, "BRA", "@P2 | 0x10"),
    (0xa0, "EXIT", ""),
]


def test_codec_per_value_takes_the_vector_pass():
    u = sass.codec_per_value(CODEC, 2)
    # 0x10 0x20 0x30 0x40 0x60 0x70 0x88 0x90: the vector load and store,
    # no element loads, no exponent store
    assert u["design"] == "grid-stride" and u["pass_n"] == 8
    assert u["per_value"] == 4.0


def test_codec_per_value_of_a_kernel_without_a_loop():
    code = [(0x00, "LDG.E.64", "R2, desc[UR4][R4.64]"),
            (0x10, "FLO.U32", "R6, R3"),
            (0x20, "STG.E", "desc[UR4][R8.64], R6"),
            (0x30, "BRA", "@P0 | 0x50"),
            (0x40, "STG.E", "desc[UR4][R10.64], R7"),
            (0x50, "EXIT", "")]
    u = sass.codec_per_value(code, 1)
    assert u["design"] == "a value a thread" and u["pass_n"] == 5


def test_codec_kernels_and_their_values_a_thread():
    pat = re.compile(sass.MATCH)
    f64 = "frsz2::Layout<64, 52, 11>, unsigned int"
    cases = {  # demangled name -> values a thread (1: the first design)
        f"void frsz2::compress_kernel<{f64}, false, 4>(x)": 4,
        f"void frsz2::compress_kernel<{f64}, 0, 4>(x)": 4,
        f"void frsz2::decompress_kernel<{f64}, 2>(x)": 2,
        f"void frsz2::compress_kernel<{f64}, false>(x)": 1,
        f"void frsz2::compress_kernel<{f64}, 0>(x)": 1,
        f"void frsz2::decompress_kernel<{f64}>(x)": 1,
        "void frsz2::cachew::cache_write_kernel<3, unsigned short, 16>(a)": 8,
        "void frsz2::compress_kernel<frsz2::Layout<32, 23, 8>, unsigned "
        "short, true>(x)": 1}
    for name, v in cases.items():
        assert pat.search(name), name
        assert sass.codec_values(name) == v, name
    assert sass.codec_values("void frsz2::cachew::cache_write_kernel<0, "
                             "unsigned short, 32>(a)") == 4
    # other instantiations are not counted
    for name in (f"void frsz2::compress_kernel<{f64}, false, 2>(x)",
                 f"void frsz2::compress_kernel<{f64}, true, 4>(x)",
                 f"void frsz2::decompress_kernel<{f64}, 4>(x)",
                 "void frsz2::cachew::cache_write_kernel<3, unsigned short, 8>(a)",
                 "void frsz2::cachew::cache_write_kernel<0, unsigned char, 8>(a)"):
        assert not pat.search(name), name


def test_per_code_takes_the_unrolled_loop_of_the_fewest_a_code():
    """The first rmatvec's loop unrolled by two beside its remainder loop
    (one DFMA a code): the unrolled pass, 7 instructions for 2 codes, not
    the remainder's 5 for 1; the redesign counts two DFMAs a code (its
    one-FMA decode and the accumulation), and skips the out-of-line call."""
    code = [(0x00, "LDG.E.U16", "R4, [R2]"),
            (0x10, "DFMA", "R10, R4, R6, R10"),
            (0x20, "LDG.E.U16", "R5, [R2+0x2]"),
            (0x30, "DFMA", "R10, R5, R6, R10"),
            (0x40, "IADD3", "R2, R2, 0x4, RZ"),
            (0x50, "ISETP.GE.AND", "P0, PT, R2, R7, PT"),
            (0x60, "BRA", "@!P0 | 0x0"),
            (0x70, "LDG.E.U16", "R4, [R2]"),
            (0x80, "DFMA", "R10, R4, R6, R10"),
            (0x90, "ISETP.GE.AND", "P1, PT, R2, R8, PT"),
            (0xa0, "BRA", "@!P1 | 0x70")]
    got = sass.per_code(code, 1)
    assert got == dict(pass_n=7, codes_a_pass=2, per_code=3.5)
    redesign = [(0x00, "LDG.E.128", "R4, [R2]"),
                (0x10, "ISETP.GT.U32.AND", "P2, PT, R8, 0x7df, PT"),
                (0x20, "BRA", "@P2 | 0x60"),
                (0x30, "DFMA", "R12, R4, R14, R16"),
                (0x40, "DFMA", "R18, R5, R14, R16"),
                (0x50, "BRA", "0x68"),
                (0x60, "CALL.REL.NOINC", "0x100"),
                (0x68, "DFMA", "R10, R12, R6, R10"),
                (0x70, "DFMA", "R11, R18, R6, R11"),
                (0x80, "BRA", "@P3 | 0x0")]
    got = sass.per_code(redesign, 2)
    assert got["codes_a_pass"] == 2 and got["pass_n"] == 9
