"""Shared checks of the redesigned matvec and block combine on the card.

``chip_smoke.py`` and ``tests/test_torch_cuda.py`` both hold the kernels to
these, so the two cannot drift apart: the row counts that cross the kernels'
tilings, bit comparison of values, seeded codes, and the two checks across
the scaled decode's guard.  Each check runs the kernel through ``ops`` (so
it launches on a CUDA generator's device) and compares with the plain
``decompress``.
"""
from __future__ import annotations

import torch

from repro_torch.core import frsz2 as F
from repro_torch.kernels import ops

#: rows across the matvec's 8-row ring turns and 128-row groups, and block
#: rows across the combine's ring turns and Y tiles (p = 8: M = 8 ... 808)
EDGE_ROWS = (1, 2, 7, 33, 64, 65, 101)

#: (value dtype, exponent bias) of the checks across the guard
GUARD_DTYPES = ((torch.float64, 1023), (torch.float32, 127))


def bits(t: torch.Tensor) -> torch.Tensor:
    """The integer view of a float tensor of 2, 4 or 8 bytes."""
    return t.view({8: torch.int64, 4: torch.int32, 2: torch.int16}[
        t.element_size()])


def same_values(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bits after ``+ 0.0`` (so -0 and +0 meet), NaN where the other
    is NaN (NaN payloads are not compared)."""
    na, nb = torch.isnan(a), torch.isnan(b)
    a0 = torch.where(na, torch.zeros_like(a), a) + 0.0
    b0 = torch.where(nb, torch.zeros_like(b), b) + 0.0
    return torch.equal(na, nb) and torch.equal(bits(a0), bits(b0))


def rand_codes(shape, l: int, gen: torch.Generator) -> torch.Tensor:
    """Seeded l-bit codes of every sign and size, in the codec's container."""
    c = torch.randint(0, 1 << l, shape, generator=gen, device=gen.device)
    if l > 8:
        c = c - (c >= (1 << (l - 1))).long() * (1 << l)
    return c.to(F.code_dtype(l))


def guard_exponents(l: int, bias: int, gen: torch.Generator) -> torch.Tensor:
    """Block exponents across the scaled decode's guards: the flush zone
    0..l-2, its edge l-1 and a few above, a seeded spread, the one-FMA
    decode's top edge 2*bias + l - 54 (f64) and its neighbours, 2*bias - 1,
    2*bias and 2*bias + 1 (Inf/NaN patterns)."""
    spread = torch.randint(0, 2 * bias + 2, (8,), generator=gen,
                           device=gen.device)
    top = 2 * bias + l - 54
    return torch.cat([torch.arange(l + 9, device=gen.device), spread,
                      torch.tensor([top - 1, top, top + 1, 2 * bias - 1,
                                    2 * bias, 2 * bias + 1],
                                   device=gen.device)]).to(torch.int32)


def matvec_across_guard(dtype, bias: int, l: int,
                        gen: torch.Generator) -> tuple[list[int], int]:
    """The matvec on rows whose one exponent crosses the guard: a code in
    one column, zeros elsewhere, x one-hot there, so each row's product is
    the decoded code.  Returns (columns whose rows differ from
    ``decompress``, rows checked)."""
    dev = gen.device
    spec = F.FrszSpec(bs=32, l=l, dtype=dtype)
    E = guard_exponents(l, bias, gen)
    R = E.numel()
    bad = []
    for c in (0, 5, 33, 63):
        codes = torch.zeros((R, 2, 32), dtype=F.code_dtype(l), device=dev)
        codes.view(R, 64)[:, c] = rand_codes((R,), l, gen)
        bc = F.BlockCompressed(codes=codes,
                               exps=E[:, None].repeat(1, 2).contiguous(),
                               n=64, spec=spec)
        x = torch.zeros((64,), dtype=dtype, device=dev)
        x[c] = 1.0
        if not same_values(ops.matvec(bc, x, kernel=True),
                           ops.decompress(bc, kernel=False)[:, c]):
            bad.append(c)
    return bad, 4 * R


def combine_across_guard(dtype, bias: int, l: int,
                         gen: torch.Generator) -> tuple[bool, int]:
    """The combine over one segment row whose codec blocks carry exponents
    across the guard, Y = 1: the output is the decoded row (fma(1, v, 0)).
    Returns (equal to ``decompress``, codes checked)."""
    dev = gen.device
    spec = F.FrszSpec(bs=32, l=l, dtype=dtype)
    E = guard_exponents(l, bias, gen)
    E = torch.cat([E, E[:(-E.numel()) % 4]])    # whole 16-byte words
    nb = E.numel()
    bc = F.BlockCompressed(codes=rand_codes((1, nb, 32), l, gen),
                           exps=E[None].contiguous(), n=nb * 32, spec=spec)
    Y = torch.ones((1, 1, 1), dtype=dtype, device=dev)
    got = ops.block_combine(bc, Y, p=1, kernel=True)[0]
    return same_values(got, ops.decompress(bc, kernel=False)[0]), nb * 32
