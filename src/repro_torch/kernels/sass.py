"""Instruction counts of the Hopper kernels' loops, read from their SASS.

    python -m repro_torch.kernels.sass [--csrc DIR]

Builds ``frsz2_block.cu``, ``frsz2_dot.cu`` and ``ell_spmv.cu`` from
``--csrc`` (default: this package's ``csrc/``; give another checkout's to
compare two versions) with the flags of :mod:`repro_torch.kernels.build`,
disassembles them with ``cuobjdump -sass`` and prints, for each main-path
instantiation (the frsz2_32 block dots and block combine of f64 values at
q = 8, the frsz2_32 f64 matvec, and the f64 ELL SpMV, dense and with a
frsz2_32 operand): its instruction count, each loop (a backward
branch and the instructions it jumps over) with its length and a histogram
of its opcodes, and its hot path (:func:`hot_path`: the instructions one
pass executes when it takes no rare branch).  Needs ``nvcc`` and
``cuobjdump``, so it runs on the card's machine; it launches nothing.
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

SOURCES = ("frsz2_block.cu", "frsz2_dot.cu", "ell_spmv.cu")
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
         r"<64, 52, 11>, unsigned int>|DenseX<double>)")

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
_FUNC = re.compile(r"Function : (\S+)")
_CALL_COST = 10 ** 6
_ARITH = ("DFMA", "DMUL", "DADD", "FFMA", "FMUL", "FADD")


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
    """(falls through, branch target or None) of one instruction."""
    pred = "|" in args
    if op.startswith("BRA"):
        m = re.search(r"0x([0-9a-f]+)", args)
        return pred, int(m.group(1), 16) if m else None
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
        return -1 if op.split(".")[0] in most else 0

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


def report(csrc: pathlib.Path) -> list[dict]:
    pat = re.compile(MATCH)
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
                rows.append(dict(source=lib.name, kernel=name, n=len(insns),
                                 ops=dict(hist.most_common()),
                                 loops=loops(insns), hot=hot_path(insns)))
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
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
