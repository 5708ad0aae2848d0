"""Instruction counts of the Hopper kernels' loops, read from their SASS.

    python -m repro_torch.kernels.sass [--csrc DIR]

Builds ``frsz2_block.cu``, ``frsz2_dot.cu``, ``ell_spmv.cu``,
``decode_attn.cu`` and ``frsz2_codec.cu`` from ``--csrc`` (default: this
package's ``csrc/``; give another checkout's to compare two versions) with
the flags of :mod:`repro_torch.kernels.build`, disassembles them with
``cuobjdump -sass`` and prints, for each main-path instantiation (the
frsz2_32 block dots and block combine of f64 values at q = 8, the frsz2_32
f64 matvec, the f64 ELL SpMV, dense, batched at w = 7 and with a frsz2_32
operand, and the decode attention at yi-9b's heads, l = 16, D = 128, G = 8,
f32 and bf16 q, the frsz2_32 f64 row compress (bs 32, truncate) and
decompress, and the serving cache write of bf16 K/V at l = 16, D = 128 (16
lanes a row), or, in an older checkout, the row compress of f32 values at
l = 16 that the cache write called): its instruction count, each loop (a
backward branch and the instructions it jumps over) with its length and a
histogram of its opcodes, and its hot path (:func:`hot_path`: the
instructions one pass executes when it takes no rare branch). For the
decode attention it prints the warp instructions a cache position costs
(:func:`attn_per_position`), for the dense ELL the instructions a slot of
one column (:func:`ell_per_slot`: the batched launch at q = 8), for the
codec the instructions a value (:func:`codec_per_value`). Needs ``nvcc``
and ``cuobjdump``, so it runs on the card's machine; it launches nothing.
"""
from __future__ import annotations

import argparse
import collections
import pathlib
import re
import shutil
import subprocess
import tempfile

from repro_torch.kernels import build

SOURCES = ("frsz2_block.cu", "frsz2_dot.cu", "ell_spmv.cu", "decode_attn.cu",
           "frsz2_codec.cu")
#: the main-path instantiations: the matvec as redesigned (vector loads)
#: and as first designed (``matvec_partial_kernel``, for ``--csrc`` of an
#: older checkout)
MATCH = (r"block_dots_partial<frsz2::Layout<64, 52, 11>, unsigned int, 8>"
         r"|block_combine_kernel<frsz2::Layout<64, 52, 11>, unsigned int, 8"
         r"(, (true|1))?>"
         r"|matvec_(rows_kernel<frsz2::Layout<64, 52, 11>, unsigned int, "
         r"(true|1)>"
         r"|partial_kernel<frsz2::Layout<64, 52, 11>, unsigned int>)"
         r"|ell_\w+_kernel<double, ell::(CodedX<double, frsz2::Layout"
         r"<64, 52, 11>, unsigned int>|DenseX<double>)"
         r"|ell_tile_batched_kernel<double, 7>"
         r"|attn::split_kernel<(float|__nv_bfloat16), unsigned short, "
         r"(4|128), 8>"
         r"|(?<!de)compress_kernel<frsz2::Layout<64, 52, 11>, unsigned int, "
         r"(false|0)(, 4)?>"
         r"|decompress_kernel<frsz2::Layout<64, 52, 11>, unsigned int(, 2)?>"
         r"|compress_kernel<frsz2::Layout<32, 23, 8>, unsigned short, "
         r"(true|1)>"
         r"|cache_write_kernel<3, unsigned short, 16>")

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
_FUNC = re.compile(r"Function : (\S+)")
_CALL_COST = 10 ** 6
_ARITH = ("DFMA", "DMUL", "DADD", "FFMA", "FMUL", "FADD")

#: the counted shapes (the instantiations :data:`MATCH` selects): the decode
#: attention's head width and group tile; the batched ELL's compiled width
#: and the block path's q
ATTN_D, ATTN_HEADS = 128, 8
ELL_W, ELL_Q = 7, 8
#: the kernels' geometry, read from the sources that are counted
#: (:func:`geometry`): ``decode_attn.cu``'s warps a block, positions a tile
#: and columns of d a thread owns in P.V; ``ell_spmv.cu``'s columns a pass
#: of the batched column loop
GEOMETRY = {"decode_attn.cu": ("kWarps", "kTile", "kPvCols"),
            "ell_spmv.cu": ("kCols",)}
_CONST = re.compile(r"^constexpr int (k\w+) = (\d+);", re.M)


def geometry(csrc: pathlib.Path) -> dict[str, int]:
    """The :data:`GEOMETRY` constants that the sources in ``csrc`` define
    (an older design may lack some)."""
    geo = {}
    for src, names in GEOMETRY.items():
        consts = dict(_CONST.findall((csrc / src).read_text()))
        geo.update({n: int(consts[n]) for n in names if n in consts})
    return geo


def _tool(name: str) -> str:
    nvcc = build._nvcc()
    cand = pathlib.Path(nvcc).with_name(name)
    if cand.exists():
        return str(cand)
    found = shutil.which(name)
    if not found:
        raise RuntimeError(f"{name} not found beside {nvcc} or on PATH")
    return found


def compile_sources(csrc: pathlib.Path, out: pathlib.Path) -> list[pathlib.Path]:
    libs = []
    for name in SOURCES:
        lib = out / f"lib{pathlib.Path(name).stem}.so"
        res = subprocess.run([build._nvcc(), *build.FLAGS, "-I", str(csrc),
                              "-o", str(lib), str(csrc / name)],
                             capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{res.stdout}{res.stderr}")
        libs.append(lib)
    return libs


def _demangle(names: list[str]) -> dict[str, str]:
    try:
        filt = _tool("cu++filt")
    except RuntimeError:
        filt = shutil.which("c++filt")
    if not filt:
        return {n: n for n in names}
    res = subprocess.run([filt], input="\n".join(names), capture_output=True,
                         text=True, check=True)
    return dict(zip(names, res.stdout.splitlines()))


def functions(lib: pathlib.Path) -> dict[str, list[tuple[int, str, str]]]:
    """Mangled name -> [(address, opcode, operands)] from ``cuobjdump``."""
    text = subprocess.run([_tool("cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    funcs: dict[str, list] = {}
    cur = None
    for line in text.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _INSN.search(line)
        if m and cur is not None:
            pred = (m.group(2) or "").strip()
            cur.append((int(m.group(1), 16), m.group(3),
                        (pred + " | " if pred else "") + m.group(4).strip()))
    return funcs


def loops(insns) -> list[dict]:
    """Every backward branch as a loop: its range, length and opcodes
    (the opcode's first field, e.g. ``DFMA``, ``LDS``), innermost first."""
    found = []
    for a, op, args in insns:
        if not op.startswith("BRA"):
            continue
        m = re.search(r"0x([0-9a-f]+)", args)
        if not m or int(m.group(1), 16) > a:
            continue
        lo = int(m.group(1), 16)
        body = [o for x, o, _ in insns if lo <= x <= a]
        hist = collections.Counter(o.split(".")[0] for o in body)
        found.append(dict(start=lo, end=a, n=len(body),
                          ops=dict(hist.most_common())))
    return sorted(found, key=lambda d: d["n"])


def _targets(op: str, args: str) -> tuple[bool, int | None]:
    """(falls through, branch target or None) of one instruction.  A
    predicated branch falls through when its predicate is false, and
    ``BRA.DIV`` (taken only by a diverged warp) when the warp is
    converged."""
    pred = "|" in args
    if op.startswith("BRA"):
        m = re.search(r"0x([0-9a-f]+)", args)
        return pred or ".DIV" in op, int(m.group(1), 16) if m else None
    if op.startswith("EXIT"):
        return pred, None
    return True, None


def shortest_path(insns, start: int, end: int, most: tuple = ()) -> dict:
    """The fewest instructions that take control from ``start`` to ``end``
    (both addresses, ``end`` included), backward branches ignored: an
    iteration of a loop (or one pass of straight code) that takes no
    optional branch, e.g. no once-a-stage barrier, and no call (the rare
    fallback of the scaled decode).  With ``most`` (opcodes, e.g. the
    FMAs), the fewest among the paths that execute the most of those: an
    early exit past the last row (a uniform ``break`` in an unrolled ring
    turn) skips work, so it is not the hot path.
    Returns its length and the histogram of its opcodes."""
    body = [x for x in insns if start <= x[0] <= end]
    index = {a: i for i, (a, _, _) in enumerate(body)}
    inf = (float("inf"), float("inf"))

    def gain(op):
        return -1 if op.split(".")[0] in most or op in most else 0

    dist = [inf] * len(body)
    prev = [None] * len(body)
    dist[0] = (gain(body[0][1]), 1)
    for i, (a, op, args) in enumerate(body):
        if dist[i] == inf:
            continue
        through, target = _targets(op, args)
        succ = ([i + 1] if through and i + 1 < len(body) else []) + (
            [index[target]] if target is not None and target > a
            and target in index else [])
        for j in succ:
            # a call leaves the hot path (the decode's out-of-line fallback)
            w = _CALL_COST if body[j][1].startswith("CALL") else 1
            cand = (dist[i][0] + gain(body[j][1]), dist[i][1] + w)
            if cand < dist[j]:
                dist[j], prev[j] = cand, i
    path, i = [], len(body) - 1
    while i is not None and dist[i] != inf:
        path.append(body[i][1].split(".")[0])
        i = prev[i]
    return dict(n=len(path), ops=dict(collections.Counter(path).most_common()))


def hot_path(insns) -> dict | None:
    """The hot path of a kernel: the shortest iteration of its innermost
    loop holding the contraction's FMAs that executes all of them (the
    block dots and combine, the matvec); for a kernel
    whose arithmetic is in no loop (the ELL SpMV of a compiled width: one
    row a lane, loops only to copy the tile), the shortest way from its
    entry to its last global store; else None (the shortest way there would
    skip its loops)."""
    lps = loops(insns)
    fma = [lp for lp in lps if lp["ops"].get("DFMA") or lp["ops"].get("FFMA")]
    if fma:
        lp = fma[0]
        return dict(start=lp["start"], end=lp["end"],
                    **shortest_path(insns, lp["start"], lp["end"],
                                    most=("DFMA", "FFMA")))
    stores = [a for a, op, _ in insns if op.startswith("STG")]
    if not stores or any(lp["ops"].get(o) for lp in lps for o in _ARITH):
        return None
    return dict(start=insns[0][0], end=stores[-1],
                **shortest_path(insns, insns[0][0], stores[-1]))


def _path(insns, start, end, op):
    return shortest_path(insns, start, end, most=(op,))


def attn_per_position(insns, geo: dict[str, int]) -> dict | None:
    """Warp instructions a cache position (of one kv head) costs on the
    decode attention's hot path, at D = 128, G = 8 (``geo``: the source's
    :func:`geometry`).

    Its main loop is the one whose hot path runs the most FFMAs (a loop
    the compiler split into overlapping ranges may have no path through
    it).  The first design walked one position a warp a pass, so a pass of
    that loop is a position (its
    FFMAs, (2 * D / 32 + 1) * G a position, say how many positions a pass
    holds).  The tiled design's main loop is a tile: one pass (the P.V loop
    inside it counted once) plus the P.V loop's other passes (T / TP
    positions a thread, TP = 32 * warps / (D / kPvCols) position lanes,
    kPvCols * G FFMAs each; the P.V loop is the inner loop whose hot path
    calls nothing: the guarded K decode's loop always does), times the
    block's warps, over the tile's T positions."""
    lps = [lp for lp in loops(insns) if lp["ops"].get("FFMA")]
    paths = [(lp, _path(insns, lp["start"], lp["end"], "FFMA")) for lp in lps]
    paths = [(lp, p) for lp, p in paths if p["n"]]
    if not paths:
        return None
    main, hot = max(paths, key=lambda c: (c[1]["ops"].get("FFMA", 0), -c[1]["n"]))
    inner = []
    for lp in lps:
        if lp is not main and main["start"] <= lp["start"] <= lp["end"] <= main["end"]:
            p = _path(insns, lp["start"], lp["end"], "FFMA")
            if "CALL" not in p["ops"]:
                inner.append(p)
    if not inner:
        u = hot["ops"].get("FFMA", 0) / ((2 * ATTN_D // 32 + 1) * ATTN_HEADS)
        return dict(design="a warp a position", pass_n=hot["n"],
                    positions_a_pass=u, per_position=hot["n"] / u)
    pv = max(inner, key=lambda p: p["ops"].get("FFMA", 0))
    warps, tile, cols = geo["kWarps"], geo["kTile"], geo["kPvCols"]
    lanes = 32 * warps // (ATTN_D // cols)
    u = pv["ops"]["FFMA"] / (cols * ATTN_HEADS)
    per_tile = hot["n"] + (tile / lanes / u - 1) * pv["n"]
    return dict(design="tiled", pass_n=hot["n"], pv_n=pv["n"],
                positions_a_pv_pass=u, per_tile_warp=per_tile,
                per_position=per_tile * warps / tile)


def ell_per_slot(insns, batched: bool,
                 geo: dict[str, int] | None = None) -> dict | None:
    """Instructions a slot of one column costs the dense ELL SpMV at
    w = 7 (the way from the entry to the last store that runs every DMUL).
    The single-operand kernel ran once per column of a batch, so its way
    over w slots is a column.  The batched kernel's way passes its column
    loop once (``geo["kCols"]`` columns, from :func:`geometry`); at q = 8
    the loop runs ``ELL_Q / kCols - 1`` more times."""
    stores = [a for a, op, _ in insns if op.startswith("STG")]
    if not stores:
        return None
    way = _path(insns, insns[0][0], stores[-1], "DMUL")
    if not batched:
        return dict(way_n=way["n"], per_slot=way["n"] / ELL_W)
    lps = [lp for lp in loops(insns) if lp["ops"].get("DMUL")]
    if not lps:
        return None
    lp = max(lps, key=lambda d: d["ops"]["DMUL"])
    body = _path(insns, lp["start"], lp["end"], "DMUL")
    n = way["n"] + (ELL_Q // geo["kCols"] - 1) * body["n"]
    return dict(way_n=way["n"], loop_n=body["n"], q8_n=n,
                per_slot=n / (ELL_W * ELL_Q))


def _width(op: str) -> int:
    m = re.search(r"\.(64|128)\b", op)
    return int(m.group(1)) if m else 32


def codec_per_value(insns, values: int) -> dict | None:
    """Instructions a value on a codec kernel's hot path.  The redesigned
    kernels: one pass of the grid-stride loop (the outermost loop holding a
    global store) that takes the widest load and the widest store (the
    vector accesses, not the element fallback) and no optional branch (an
    exponent store once a block is skipped; an inner shuffle loop counts
    once), over the ``values`` a thread codes in a pass.  The first design
    (a value a thread, no loop): the way from the entry to its last global
    store, which passes the code store."""
    mem = [op for _, op, _ in insns if op.startswith(("LDG", "STG"))]
    wide = set()
    for kind in ("LDG", "STG"):
        ops_k = [op for op in mem if op.startswith(kind)]
        if ops_k:
            w = max(_width(op) for op in ops_k)
            wide |= {op for op in ops_k if _width(op) == w}
    lps = [lp for lp in loops(insns) if lp["ops"].get("STG")]
    if lps:
        lp = max(lps, key=lambda d: d["n"])
        start, end = lp["start"], lp["end"]
    else:
        stores = [a for a, op, _ in insns if op.startswith("STG")]
        if not stores:
            return None
        start, end = insns[0][0], stores[-1]
    p = shortest_path(insns, start, end, most=tuple(sorted(wide)))
    return dict(design="grid-stride" if lps else "a value a thread",
                pass_n=p["n"], values_a_pass=values,
                per_value=p["n"] / values)


#: the values a thread of the row codec codes: its template argument after
#: the layout, the code type and, for compress, the rounding
_CODEC_V = re.compile(r"(?:(?<!de)compress_kernel<frsz2::Layout<[^>]*>, unsigned "
                      r"\w+, (?:true|false|0|1)|decompress_kernel<frsz2::Layout"
                      r"<[^>]*>, unsigned \w+), (\d+)>")


def codec_values(name: str) -> int:
    """Values a thread codes in a pass of a codec kernel, from its template
    arguments: the row codec's last one (1 for the first design, which has
    none); the cache write's 16 bytes of K/V values a lane (4 f32, value
    kind 0, or 8 f16/bf16)."""
    m = re.search(r"cache_write_kernel<(\d+),", name)
    if m:
        return 4 if m.group(1) == "0" else 8
    m = _CODEC_V.search(name)
    return int(m.group(1)) if m else 1


def report(csrc: pathlib.Path) -> list[dict]:
    pat = re.compile(MATCH)
    geo = geometry(csrc)
    with tempfile.TemporaryDirectory(dir=build.BUILD.parent) as d:
        libs = compile_sources(csrc, pathlib.Path(d))
        rows = []
        for lib in libs:
            funcs = functions(lib)
            names = _demangle(sorted(funcs))
            for mangled, insns in sorted(funcs.items()):
                # template arguments may print as "(int)8": drop the casts
                name = re.sub(r"\((unsigned )?(int|bool|long long)\)", "",
                              names.get(mangled, mangled))
                if not pat.search(name):
                    continue
                hist = collections.Counter(o.split(".")[0] for _, o, _ in insns)
                unit = None
                if "split_kernel" in name:
                    unit = attn_per_position(insns, geo)
                elif "DenseX" in name or "batched" in name:
                    unit = ell_per_slot(insns, "batched" in name, geo)
                elif "compress_kernel" in name or "cache_write" in name:
                    unit = codec_per_value(insns, codec_values(name))
                rows.append(dict(source=lib.name, kernel=name, n=len(insns),
                                 ops=dict(hist.most_common()),
                                 loops=loops(insns), hot=hot_path(insns),
                                 unit=unit))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", default=str(build.CSRC))
    args = ap.parse_args(argv)
    build.BUILD.parent.mkdir(parents=True, exist_ok=True)
    rows = report(pathlib.Path(args.csrc).resolve())
    for r in rows:
        print(f"[sass] {r['kernel']}: {r['n']} instructions")
        for lp in r["loops"]:
            top = ", ".join(f"{k} {v}" for k, v in list(lp["ops"].items())[:12])
            print(f"[sass]   loop {lp['start']:#06x}-{lp['end']:#06x}: "
                  f"{lp['n']} instructions ({top})")
        hot = r["hot"]
        if hot:
            top = ", ".join(f"{k} {v}" for k, v in hot["ops"].items())
            print(f"[sass]   hot path {hot['start']:#06x}-{hot['end']:#06x}: "
                  f"{hot['n']} instructions ({top})")
        if r["unit"]:
            unit = ", ".join(f"{k} {v:.4g}" if isinstance(v, float) else
                             f"{k} {v}" for k, v in r["unit"].items())
            print(f"[sass]   {unit}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
