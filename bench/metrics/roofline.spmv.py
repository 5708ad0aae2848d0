"""``roofline.spmv``: the least bytes of the traced requests' operator
applications (``bench.counts.spmv_bytes``: values and column indices, the
operand and the result once each, per live step and per residual) at the
card's memory rate, over the device time of the ELL kernels (5, 5b and
6)."""
import re

from bench import counts

PATTERNS = [re.compile(r"ell::ell_(row|tile)(_batched)?_kernel")]


def read(run):
    rate = counts.hbm_bytes_per_s(run.device)
    t = run.trace
    if rate is None or t is None:
        return None
    seconds = t.seconds_matching(PATTERNS)
    if seconds <= 0:
        return None
    need = sum(counts.spmv_bytes(r, run.n, run.nnz, run.fmt, block=run.block)
               for r in run.traced)
    return 100.0 * need / rate / seconds
