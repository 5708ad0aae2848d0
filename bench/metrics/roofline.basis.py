"""``roofline.basis``: the least bytes of the traced requests' basis work
(``bench.counts.basis_bytes``) at the card's memory rate, over the device
time of the basis kernels: for an FRSZ2 basis the codec (kernels 1 and 2)
and the fused dots and combine (3 and 4, and the block 7 and 8); for a
native basis the cuBLAS matrix-vector products that do its dots and
combine (and their split-K reductions).  A block basis of a native format
is read by cuBLAS kernels that the block QR uses too: no cell has one."""
import re

from bench import counts

CODED = [re.compile(p) for p in (
    r"frsz2::(de)?compress_kernel", r"frsz2::r?matvec_rows_kernel",
    r"frsz2::matvec_finish_kernel", r"frsz2_block::block_dots_partial",
    r"frsz2_block::block_dots_finish", r"frsz2_block::block_combine_kernel")]
NATIVE = [re.compile(p) for p in (r"gemv", r"splitKreduce_kernel")]


def read(run):
    rate = counts.hbm_bytes_per_s(run.device)
    t = run.trace
    if rate is None or t is None:
        return None
    seconds = t.seconds_matching(CODED if counts.coded(run.fmt) else NATIVE)
    if seconds <= 0:
        return None
    need = sum(counts.basis_bytes(r, run.n, run.fmt, block=run.block)
               for r in run.traced)
    return 100.0 * need / rate / seconds
